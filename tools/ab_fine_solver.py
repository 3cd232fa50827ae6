"""End-to-end A/B of the host fine solver vs MG-CG at small scale.
Run: JAX_PLATFORMS=cpu MGB_FINE_SOLVER=host \
     python -u tools/ab_fine_solver.py
"""
import os, sys, time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.backend import backend_cpu

L = int(os.environ.get("DBG_L", "4"))
be = backend_cpu(dense_threshold=int(os.environ.get("DBG_THRESH", "200")))
g = mgb.fem2d(L=L, backend=be)
t0 = time.perf_counter()
sol = mgb.amgb(g, verbose=True)
el = time.perf_counter() - t0
print(
    f"MODE={os.environ.get('MGB_FINE_SOLVER','host')} L={L} "
    f"c={float(sol.SOL_main.c_dot_Dz[-1]):.10f} "
    f"its={sol.SOL_main.its.tolist()} wall={el:.1f}s"
)
