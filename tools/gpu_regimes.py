"""fem2d L=7 on one GPU: element-Hessian assembly timings and an A/B of the
native-f64 solver defaults against the emulated-f64 regime.

Run on a machine with a GPU (one process, one card):

    python tools/gpu_regimes.py

1. Times `_assemble_He` (two batched einsums left to XLA) at the L=7
   fine-level shapes, in f64 and in f32: 50 back-to-back calls after one
   compile, one block_until_ready at the end.
2. Solves fem2d L=7 p=1 (tol=sqrt(eps)) under two regimes, one after the
   other in this process, each with a warm-up solve (compile included)
   and a timed solve:
     native  the platform defaults (options.PlatformPolicy);
     emul    MGB_ND_F32PC=1 MGB_ND_CHEAP=df MGB_ND_INV=1
             MGB_ND_CHOL=blocked MGB_ND_PCG=0 (built for software f64).
Prints one line per measurement and, last, the whole record as JSON.
Exits non-zero when JAX's default device is not a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import multigridbarrier_tpu as mgb  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multigridbarrier_tpu.solver.amgb import _assemble_He  # noqa: E402
from chip_smoke import card_line, fine_level_ctx, log  # noqa: E402

L = 7
EMUL = {
    "MGB_ND_F32PC": "1",
    "MGB_ND_CHEAP": "df",
    "MGB_ND_INV": "1",
    "MGB_ND_CHOL": "blocked",
    "MGB_ND_PCG": "0",
}


def time_assembly(g, reps: int = 50) -> dict:
    """Per-call time of _assemble_He at g's fine-level shapes."""
    P = fine_level_ctx(g)[0]._P[-1]
    nelem, nq, k, C = P.shape
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((nelem, nq, k, k))
    Y = Y @ np.swapaxes(Y, -1, -2)  # SPD row Hessians, like w * F2
    out = {"shape_P": [nelem, nq, k, C]}
    fn = jax.jit(_assemble_He)
    for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        Pd, Yd = jnp.asarray(P, dt), jnp.asarray(Y, dt)
        jax.block_until_ready(fn(Pd, Yd))
        # back-to-back calls queue on the device, so the wall time per
        # call approaches the kernels' device time
        t0 = time.perf_counter()
        for _ in range(reps):
            He = fn(Pd, Yd)
        jax.block_until_ready(He)
        out[name + "_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        log(f"assemble_He {name} P={tuple(P.shape)} "
            f"{out[name + '_ms']:.4f} ms per call ({reps} queued calls)")
    return out


def run_regime(g, name: str, env: dict) -> dict:
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        res = {"env": env}
        for phase in ("warmup", "timed"):
            t0 = time.perf_counter()
            sol = mgb.amgb(g, p=1.0)
            jax.block_until_ready(sol.z)
            dt = time.perf_counter() - t0
            c = float(sol.SOL_main.c_dot_Dz[-1])
            res[phase] = {"s": dt, "its": sol.SOL_main.its.tolist(),
                          "c_dot_Dz": c}
            log(f"regime {name} {phase} {dt:.3f}s "
                f"its={sol.SOL_main.its.tolist()} c_dot_Dz={c:.10f}")
        return res
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's default device is {dev.platform}",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"device kind={dev.device_kind} card: {card}")
    t0 = time.perf_counter()
    g = mgb.fem2d(L=L, backend=mgb.backend_cpu())
    log(f"geometry L={L} n={g.n} built in {time.perf_counter() - t0:.2f}s")
    rec = {"card": card, "device_kind": dev.device_kind, "L": L,
           "assemble_He": time_assembly(g)}
    rec["native"] = run_regime(g, "native", {})
    rec["emul"] = run_regime(g, "emul", EMUL)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
