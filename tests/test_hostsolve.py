"""Host sparse direct fine-level solver (solver/hostsolve.py).

The host path replaces MG-CG on fine levels (single-device backends):
exact sparse directions keep the iterate ON the central path (see
tests/test_ground_truth.py for why direction quality is a correctness
property here, not a performance knob).  These tests pin

* assembly parity: HostPattern's segment-reduced CSR equals
  linsolve.dense_assemble entry-for-entry on the same state;
* solve parity: the host direct solve matches dense_solve;
* end-to-end: a host-path solve lands on the exact-direct objective.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.backend import backend_cpu
from multigridbarrier_tpu.solver.hostsolve import HostDirectLevel, HostPattern
from multigridbarrier_tpu.solver.linsolve import (
    LevelSystem,
    dense_assemble,
    dense_solve,
)

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")


@pytest.fixture(scope="module")
def state():
    """Finest-level Newton state of fem2d L=3 at the initial iterate."""
    g = mgb.fem2d(L=3)
    spec = A._normalize_D(A.default_D(2))
    Qset = A.default_Q(2, 1.0)
    dtype = g.x.dtype
    c = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dtype)(xi), dtype))(g.x)
    z0 = jax.vmap(lambda xi: jnp.asarray(A.default_g(2, dtype)(xi), dtype))(g.x)
    ctx = A._SolverCtx(g, spec, Qset.barrier, c)
    level = ctx.levels - 1
    basis = ctx._bases[level]
    Pl = ctx._P[level]
    nf, k = spec.nfields, spec.k
    nelem, nq, nl = basis.rloc.shape
    y = A._apply_D(ctx.ops, spec, z0)
    F1 = jax.grad(Qset.barrier, argnums=1)
    F2 = jax.hessian(Qset.barrier, argnums=1)
    Y2w = jax.vmap(F2)(ctx.x, y) * ctx.w[:, None, None]
    He = A._assemble_He(Pl, Y2w.reshape(nelem, nq, k, k))
    F1v = jax.vmap(F1)(ctx.x, y)
    gy = (ctx.w[:, None] * (1.0 * c + F1v)).reshape(nelem, nq, k)
    gf = jnp.einsum("eqj,eqjc->ec", gy, Pl)
    gv = basis.scatter_add(
        gf.reshape(nelem, nf, nl).transpose(0, 2, 1).reshape(-1, nf)
    ).T
    return dict(basis=basis, He=He, gv=gv, nf=nf, m=basis.m)


def _pattern_vals(state):
    pattern = HostPattern(
        np.asarray(state["basis"].idx), state["m"], state["nf"]
    )
    vals = jax.ops.segment_sum(
        state["He"].reshape(-1),
        jnp.asarray(pattern.full_ids).reshape(-1),
        num_segments=pattern.nseg,
    )
    return pattern, np.asarray(vals, np.float64)


def test_host_assembly_matches_dense(state):
    H_dense = np.asarray(
        dense_assemble(
            LevelSystem(state["He"], state["basis"].idx, state["m"]),
            state["nf"],
        )
    )
    pattern, vals = _pattern_vals(state)
    A_host = pattern.fill(vals).toarray()
    assert A_host.shape == H_dense.shape
    scale = np.abs(H_dense).max()
    assert np.abs(H_dense - A_host).max() <= 1e-14 * scale


def test_host_solve_matches_dense(state):
    pattern, vals = _pattern_vals(state)
    solver = HostDirectLevel(pattern)
    b = -np.asarray(state["gv"], np.float64).reshape(-1)
    x_host, its, rel = solver.solve(vals, b)
    assert rel < 1e-12
    x_dense = np.asarray(
        dense_solve(
            LevelSystem(state["He"], state["basis"].idx, state["m"]),
            state["nf"],
            -state["gv"],
        )
    ).reshape(-1)
    scale = max(np.abs(x_dense).max(), 1.0)
    assert np.abs(x_host - x_dense).max() <= 1e-9 * scale


def test_host_factor_reuse_pcg(state):
    """A 1-step-stale factor must precondition the perturbed system to
    rtol in a few CG iterations (self-concordance spectral equivalence —
    the property the whole reuse policy rests on)."""
    pattern, vals = _pattern_vals(state)
    solver = HostDirectLevel(pattern, stale_cap=30)
    b = -np.asarray(state["gv"], np.float64).reshape(-1)
    x0, _, _ = solver.solve(vals, b)
    assert solver.n_factor == 1
    # perturbed system (a plausible neighboring Newton Hessian)
    rng = np.random.default_rng(0)
    vals2 = vals * (1.0 + 0.05 * rng.standard_normal(vals.shape))
    A2 = pattern.fill(vals2.copy()).copy()
    # symmetrize to stay SPD-ish for CG
    A2 = 0.5 * (A2 + A2.T)
    x2, its, rel = solver._pcg(A2, b, x0, 30)[0], None, None
    r = np.linalg.norm(b - A2 @ x2) / np.linalg.norm(b)
    assert r < 1e-6


def test_host_end_to_end_objective():
    """Full solve with the host path forced on every level above a tiny
    dense threshold lands on the exact-direct objective (ground truth:
    tools/check_exact.py, pinned in tests/test_ground_truth.py)."""
    be = backend_cpu(dense_threshold=200)
    g = mgb.fem2d(L=4, backend=be)
    sol = mgb.amgb(g, p=1.0)
    c = float(sol.SOL_main.c_dot_Dz[-1])
    c_exact = 50.618082533590
    assert abs(c - c_exact) < 5e-7 * abs(c_exact)
