"""Exact-solve ground truth: dense Cholesky at EVERY level (the
reference's MUMPS trajectory, SURVEY.md §3.5) by raising dense_threshold
above the finest subspace.  Slow — use for small L only."""

import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import multigridbarrier_tpu as mgb

L = int(os.environ.get("MGB_PARITY_L", "5"))
backend = mgb.backend_cpu(dense_threshold=1 << 30)
g = mgb.fem2d(L=L, backend=backend)
t0 = time.perf_counter()
s = mgb.amgb(g, p=1.0, mixed=False, verbose=True)
print(
    f"exact f64 L={L}: c_dot_Dz={s.SOL_main.c_dot_Dz[-1]:.12e} "
    f"its={s.SOL_main.its.tolist()} total={int(s.SOL_main.its.sum())} "
    f"wall={time.perf_counter() - t0:.1f}s"
)
