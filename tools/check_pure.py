"""Pure-f64 solve probe with verbose per-t output (A/B tool)."""

import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import multigridbarrier_tpu as mgb

L = int(os.environ.get("MGB_PARITY_L", "5"))
g = mgb.fem2d(L=L)
t0 = time.perf_counter()
s = mgb.amgb(g, p=1.0, mixed=False, verbose=True)
print(
    f"pure f64 L={L}: c_dot_Dz={s.SOL_main.c_dot_Dz[-1]:.12e} "
    f"its={s.SOL_main.its.tolist()} total={int(s.SOL_main.its.sum())} "
    f"wall={time.perf_counter() - t0:.1f}s"
)
