"""Measure the mgcg (truncated two-grid) fine solver at scale on the mesh.

Round-4 verdict #6 done-criterion: fem2d L=6 on the 8-virtual-device CPU
mesh with MGB_FINE_SOLVER=mgcg, objective vs the exact-direction ground
truth 15.4183231432 (CLAUDE.md round-2 session-4/5).  The two-grid cycle
(MGB_MGCG_LEVELS=auto) + deep CG budget (MGB_CG_MAXITER_DEEP=1000) fixed
the depth ceiling at L<=5 on one device (L=5 rel 4.5e-8); this is the
first L=6 + mesh measurement of the same configuration.

Run:
  JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    MGB_FINE_SOLVER=mgcg python -u tools/measure_mgcg_mesh.py
Env: DBG_L (default 6), DBG_DEVICES (default 8; 1 = single-device control).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUND_TRUTH = {4: 50.6180823538, 5: 27.360702532, 6: 15.4183231432}


def main():
    L = int(os.environ.get("DBG_L", "6"))
    ndev = int(os.environ.get("DBG_DEVICES", "8"))

    import jax
    import jax.numpy as jnp

    import multigridbarrier_tpu as mgb
    from multigridbarrier_tpu.backend import Backend, make_mesh

    mesh = make_mesh(ndev) if ndev > 1 else None
    # L=5's fine level (nf*m = 1922) routes DENSE at the default
    # threshold 2048 (the round-2 "dense_threshold trap") — measuring
    # mgcg there needs a lowered threshold; L>=6 engages it by default.
    thresh = int(os.environ.get("DBG_THRESH", "2048"))
    be = Backend(dtype=jnp.float64, mesh=mesh, dense_threshold=thresh)
    g = mgb.fem2d(L=L, backend=be)
    t0 = time.perf_counter()
    sol = mgb.amgb(g, p=1.0, logfile=sys.stderr)
    jax.block_until_ready(sol.z)
    el = time.perf_counter() - t0
    c = float(sol.SOL_main.c_dot_Dz[-1])
    truth = GROUND_TRUTH.get(L)
    rel = abs(c - truth) / abs(truth) if truth else float("nan")
    print(
        f"MODE={os.environ.get('MGB_FINE_SOLVER', '(default)')} L={L} "
        f"devices={ndev} c={c:.10f} truth={truth} rel={rel:.3e} "
        f"its={sol.SOL_main.its.tolist()} wall={el:.1f}s"
    )


if __name__ == "__main__":
    main()
