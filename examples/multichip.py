"""Multi-device solve over a ('dof',) mesh — the reference's
`mpiexec -n N` workflow (/root/reference/docs/src/guide.md:63-81) as
single-controller GSPMD.

Run (8 virtual devices on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/multichip.py
On a multi-GPU host it uses every visible card.
"""

import numpy as np
import jax
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import multigridbarrier_tpu as mgb

print("devices:", jax.devices())

backend = mgb.backend_mesh()  # mesh over all local devices
print("mesh size:", backend.n_devices)

g = mgb.fem2d(L=3, backend=backend)
sol = mgb.amgb(g, p=1.0, tol=1e-7, verbose=True)

# compare against the single-device solve (the reference's
# distributed-vs-native invariant, tolerance tol*1000)
sol1 = mgb.amgb(mgb.fem2d(L=3), p=1.0, tol=1e-7)
diff = np.abs(np.asarray(sol.z) - np.asarray(sol1.z)).max()
print(f"multi-vs-single device max diff: {diff:.3e}")
assert diff < 1e-4
