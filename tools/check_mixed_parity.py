"""Mixed-vs-pure-f64 parity check at a given L (CPU).

Validates the mixed-precision contract at scales too slow for the CI suite:
objective agreement at the duality-gap scale and a working f64 endgame
(nonzero f64 fine-level iterations that actually move the objective).
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax.numpy as jnp

import multigridbarrier_tpu as mgb

L = int(os.environ.get("MGB_PARITY_L", "6"))
g = mgb.fem2d(L=L)

t0 = time.perf_counter()
s64 = mgb.amgb(g, p=1.0, mixed=False)
t64 = time.perf_counter() - t0
c64 = s64.SOL_main.c_dot_Dz[-1]
i64 = int(s64.SOL_main.its.sum())
print(f"pure  f64: c_dot_Dz={c64:.12e} its={s64.SOL_main.its.tolist()} "
      f"total={i64} wall={t64:.1f}s", flush=True)

t0 = time.perf_counter()
smx = mgb.amgb(g, p=1.0, mixed=True, verbose=True)
tmx = time.perf_counter() - t0
cmx = smx.SOL_main.c_dot_Dz[-1]
imx = int(smx.SOL_main.its.sum())
print(f"mixed    : c_dot_Dz={cmx:.12e} its={smx.SOL_main.its.tolist()} "
      f"total={imx} wall={tmx:.1f}s", flush=True)

rel = abs(c64 - cmx) / abs(c64)
du = float(jnp.max(jnp.abs(s64.z[:, 0] - smx.z[:, 0])))
scale = float(jnp.max(jnp.abs(s64.z[:, 0])))
print(f"objective rel diff: {rel:.3e}")
print(f"u sup diff / scale: {du / scale:.3e}")
ok = rel < 1e-4 and du / scale < 1e-2
print("PARITY_OK" if ok else "PARITY_FAIL")
sys.exit(0 if ok else 1)
