"""Headline benchmark: fem2d p-Laplace (p=1) barrier solve.

Reference baseline (BASELINE.md, /root/reference/docs/src/guide.md:252):
fem2d L=7 (n = 57,344 broken dofs), Float64 — native 96.694 s / MPI+MUMPS
118.070 s on an M4 MacBook Pro (1 rank, 10 BLAS threads).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where
value is the solve wall-time in seconds (after a warm-up solve that pays
all jit compilation — mirroring BenchmarkTools medians which exclude Julia
compilation) and vs_baseline = reference_native_seconds / our_seconds
(>1 means faster than the reference).

Env overrides: MGB_BENCH_L (default 7), MGB_BENCH_DTYPE (f64|f32),
MGB_BENCH_PROBLEM (fem2d|fem3d; fem3d uses MGB_BENCH_K, default 3, and
has no published reference number — the reference benchmarks only fem2d),
MGB_BENCH_REPS (timed-solve repetitions; default 3 up to L=7, 1 at L=8
— the JSON reports the median and the min-max spread).

One process on one GPU; the JSON names the platform, device kind and the
nvidia-smi card name and power limit.  Without a GPU it exits non-zero,
except for a CPU smoke run with JAX_PLATFORMS=cpu set by hand
(`make bench-smoke`), whose JSON says cpu.
"""

from __future__ import annotations

import json
import os
import sys
import time

BASELINE_NATIVE_S = {1: 0.018, 2: 0.028, 3: 0.074, 4: 0.480, 5: 2.508, 6: 26.384, 7: 96.694, 8: 659.276}


def _platform() -> dict:
    """The device the run is on.  A GPU is required unless the caller set
    JAX_PLATFORMS=cpu by hand (a CPU smoke run that says so in its JSON)."""
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}
    if dev.platform == "gpu":
        from chip_smoke import card_line

        info["card"] = card_line()
    elif not (dev.platform == "cpu"
              and os.environ.get("JAX_PLATFORMS") == "cpu"):
        raise SystemExit(
            f"bench.py needs a GPU (found {dev.platform}); set "
            "JAX_PLATFORMS=cpu for a CPU smoke run"
        )
    return info


def main():
    problem = os.environ.get("MGB_BENCH_PROBLEM", "fem2d")
    L = int(os.environ.get("MGB_BENCH_L", "7" if problem == "fem2d" else "3"))
    dtype_name = os.environ.get("MGB_BENCH_DTYPE", "f64")

    import jax
    import jax.numpy as jnp
    import multigridbarrier_tpu as mgb

    device = _platform()
    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    backend = mgb.backend_cpu(dtype=dtype)

    t0 = time.perf_counter()
    if problem == "fem3d":
        k = int(os.environ.get("MGB_BENCH_K", "3"))
        g = mgb.fem3d(L=L, k=k, backend=backend)
        metric_name = f"fem3d L={L} k={k} p=1 barrier solve wall-time"
    else:
        g = mgb.fem2d(L=L, backend=backend)
        metric_name = f"fem2d L={L} p=1 barrier solve wall-time"
    t_geom = time.perf_counter() - t0
    print(f"# geometry L={L} n={g.n} built in {t_geom:.1f}s", file=sys.stderr)

    def solve():
        # default tol = sqrt(eps(T)) — the reference amgb default used by
        # its published benchmark runs (tools/benchmark_fem2d.jl)
        sol = mgb.amgb(
            g,
            p=1.0,
            tol=None if dtype_name == "f64" else 1e-4,
            logfile=sys.stderr,
        )
        jax.block_until_ready(sol.z)
        return sol

    # warm-up: pays jit compilation for every level/phase
    t0 = time.perf_counter()
    sol = solve()
    warm = time.perf_counter() - t0
    print(
        f"# warmup {warm:.1f}s its={sol.SOL_main.its.tolist()}", file=sys.stderr
    )

    # Repeated timed solves quantify run noise (the reference's own
    # methodology is BenchmarkTools medians for L<=5, single-run above —
    # SURVEY.md section 6): median-of-3 through L=7, 1 at L=8.
    if problem == "fem2d":
        reps_default = 3 if L <= 7 else 1
    else:
        reps_default = 1
    reps = int(os.environ.get("MGB_BENCH_REPS", str(reps_default)))
    times = []
    for rep in range(max(1, reps)):
        t0 = time.perf_counter()
        sol = solve()
        times.append(time.perf_counter() - t0)
        print(f"# timed[{rep}] {times[-1]:.3f}s", file=sys.stderr)
    times.sort()
    elapsed = times[len(times) // 2] if len(times) % 2 else 0.5 * (
        times[len(times) // 2 - 1] + times[len(times) // 2]
    )
    spread = times[-1] - times[0]

    base = BASELINE_NATIVE_S.get(L) if problem == "fem2d" else None
    dofs_per_sec = g.n / elapsed
    print(
        f"# timed median {elapsed:.3f}s of {len(times)} "
        f"(min {times[0]:.3f} max {times[-1]:.3f} spread {spread:.3f})  "
        f"DOFs/s/device {dofs_per_sec:.3e}  "
        f"iters {int(sol.SOL_main.its.sum())}",
        file=sys.stderr,
    )
    tag = f"{dtype_name}, {device['platform']}"
    # final objective: the honesty check (round-2 finding — any speedup
    # claim must be validated against the converged c_dot_Dz; recorded
    # floor bands live in tests/test_ground_truth.py)
    objective = float(sol.SOL_main.c_dot_Dz[-1]) if sol.SOL_main.c_dot_Dz else None
    print(
        json.dumps(
            {
                "metric": f"{metric_name} ({tag})",
                "value": round(elapsed, 4),
                "unit": "s",
                "vs_baseline": round(base / elapsed, 3) if base else None,
                "n_timed": len(times),
                "spread_s": round(spread, 4),
                "objective": objective,
                **device,
            }
        )
    )


if __name__ == "__main__":
    main()
