"""Mixed-precision (f32 early path) contract tests.

For f64 solves whose fine level uses MG-CG, amgb runs the t <= 1e5 leg of
the central path in float32 and hands off to the f64 context (a lever
where f64 runs far below the f32 rate).  The
contract: the f64 endgame alone sets the final accuracy, so the mixed
solution must agree with a pure-f64 solve at the barrier method's own
duality-gap scale, at comparable iteration cost.
"""

import jax.numpy as jnp
import numpy as np

import multigridbarrier_tpu as mgb


def test_mixed_matches_f64_fem2d():
    g = mgb.fem2d(L=5)
    s64 = mgb.amgb(g, p=1.0, mixed=False)
    smx = mgb.amgb(g, p=1.0, mixed=True)
    c64 = s64.SOL_main.c_dot_Dz[-1]
    cmx = smx.SOL_main.c_dot_Dz[-1]
    # Objective parity at the mixed path's honest accuracy scale: with the
    # bounded-CG production defaults BOTH paths are truncation-limited at
    # the ~1e-3 relative scale (the two trajectories truncate differently),
    # so the contract here is the f32-leg scale, mirroring the reference's
    # Float32 tolerance (tol*1000 with tol=1e-4, test/test_utils.jl:118).
    assert abs(c64 - cmx) / abs(c64) < 1e-2
    # solution parity: u-field sup-norm, relative to solution scale
    du = float(jnp.max(jnp.abs(s64.z[:, 0] - smx.z[:, 0])))
    scale = float(jnp.max(jnp.abs(s64.z[:, 0])))
    assert du / scale < 5e-2
    # the merged log covers both legs: ts climbs through t_switch to t_end
    ts = smx.SOL_main.ts
    assert ts[0] < 1.0 and ts[-1] > 1e7
    # f32 twin context was actually built and cached on the geometry
    assert hasattr(g, "_f32_twin_cache")


def test_mixed_default_policy():
    # dense-fine problems (L=4: nf*m < dense_threshold) stay pure f64 —
    # the f32 dense Cholesky degrades at path conditioning and the
    # problem is sub-second anyway
    g4 = mgb.fem2d(L=4)
    mgb.amgb(g4, p=1.0)
    assert not hasattr(g4, "_f32_twin_cache")


def test_mixed_kwarg_override():
    # explicit mixed=True engages the f32 leg even below the policy size
    g = mgb.fem2d(L=4)
    s64 = mgb.amgb(g, p=1.0, mixed=False)
    smx = mgb.amgb(g, p=1.0, mixed=True)
    assert hasattr(g, "_f32_twin_cache")
    c64, cmx = s64.SOL_main.c_dot_Dz[-1], smx.SOL_main.c_dot_Dz[-1]
    assert abs(c64 - cmx) / abs(c64) < 1e-4
