"""Strong-scaling sweep over virtual (or real) device counts — the
multi-rank scaling measurement the reference never published
(SURVEY.md §6: "No multi-rank scaling numbers are published anywhere").

For each device count this reports wall time AND the number of XLA
collectives (all-reduce / all-gather / collective-permute / reduce-scatter)
GSPMD inserted into each compiled per-level Newton kernel — the
equivalent of the reference's hand-planned MPI message counts.  On a
virtual CPU mesh the wall times share one socket (they measure overhead,
not speedup); the collective counts are exactly what a real multi-chip run
would execute over the interconnect, which is why the artifact is worth committing
before real hardware is available.

Run on CPU with virtual devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/scaling.py --L 5 --devices 1,2,4,8 --out artifacts/scaling_L5.json
"""

import argparse
import json
import re
import sys
import time

sys.path.insert(0, ".")

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "collective-permute",
    "reduce-scatter",
    "all-to-all",
)


def collective_counts(ctx, z, t):
    """Count GSPMD collectives in each compiled per-level Newton-loop HLO."""
    import jax.numpy as jnp

    HIST = 5
    out = {}
    for lvl, (loop, n_smooth) in sorted(ctx._loops.items()):
        Ps, bases, embeds, rloc = ctx._level_args(lvl)
        dtype = z.dtype
        hist = {
            key: jnp.zeros(HIST, dtype=dtype)
            for key in (
                "lam2", "alpha", "phi", "dphi", "cy", "cgits", "cgrel"
            )
        }
        nf = ctx.spec.nfields
        m = ctx._bases[lvl].m
        lowered = loop.lower(
            Ps,
            bases,
            embeds,
            rloc,
            ctx.x,
            ctx.w,
            ctx.c,
            z,
            jnp.asarray(t, dtype=dtype),
            jnp.asarray(0.0625, dtype=dtype),
            jnp.zeros(n_smooth, dtype=dtype),
            hist,
            jnp.asarray(0, jnp.int32),
            jnp.zeros((nf, m + 1), dtype=dtype),
        )
        txt = lowered.compile().as_text()
        counts = {
            name: len(re.findall(rf"{name}(?:-start)?\(", txt))
            for name in COLLECTIVES
        }
        out[f"level{lvl}"] = {k: v for k, v in counts.items() if v}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--dim", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    ap.add_argument(
        "--collectives",
        action="store_true",
        help="count GSPMD collectives in the compiled level kernels",
    )
    ap.add_argument(
        "--dense-threshold", type=int, default=None,
        help="override Backend.dense_threshold (e.g. 0 so the fine solver "
        "selected by MGB_FINE_SOLVER is exercised at small L; the default "
        "2048 routes fem2d L<=5 fine levels through the dense path)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import multigridbarrier_tpu as mgb
    from multigridbarrier_tpu.backend import Backend, make_mesh

    build = {1: mgb.fem1d, 2: mgb.fem2d, 3: mgb.fem3d}[args.dim]
    avail = len(jax.devices())
    platform = jax.devices()[0].platform
    base = None
    rows = []
    for nd in [int(s) for s in args.devices.split(",")]:
        if nd > avail:
            print(f"# skipping {nd} devices ({avail} available)")
            continue
        bkw = {}
        if args.dense_threshold is not None:
            bkw["dense_threshold"] = args.dense_threshold
        backend = (
            Backend(dtype=jnp.float64, **bkw)
            if nd == 1
            else Backend(dtype=jnp.float64, mesh=make_mesh(nd), **bkw)
        )
        g = build(L=args.L, backend=backend)
        sol = mgb.amgb(g, p=args.p)  # warmup/compile
        jax.block_until_ready(sol.z)
        t0 = time.perf_counter()
        sol = mgb.amgb(g, p=args.p)
        jax.block_until_ready(sol.z)
        dt = time.perf_counter() - t0
        if base is None:
            base = dt
        row = dict(
            devices=nd,
            seconds=round(dt, 3),
            speedup=round(base / dt, 2),
            efficiency=round(base / dt / nd, 2),
            its=int(sol.SOL_main.its.sum()),
        )
        if args.collectives:
            # count on the phase-2 f64 context's compiled kernels
            ctxs = list(getattr(g, "_ctx_cache", {}).values())
            if ctxs:
                row["collectives_per_level_kernel"] = collective_counts(
                    ctxs[-1], sol.z, 1.0
                )
        rows.append(row)
        print(json.dumps(row))

    if args.out:
        artifact = dict(
            benchmark=f"fem{args.dim}d L={args.L} p={args.p} strong scaling",
            platform=platform,
            n=int(build(L=args.L).n),
            note=(
                "virtual-device CPU mesh: wall times share one socket and "
                "measure sharding overhead, not speedup; collective counts "
                "are what a real multi-chip mesh would execute over ICI"
                if platform == "cpu"
                else "real device mesh"
            ),
            rows=rows,
        )
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
