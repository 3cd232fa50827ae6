"""On-device nested-dissection multifrontal Cholesky (solver/ndsolve.py).

Pins the three layers separately:
* algorithm: factor/solve is EXACT (machine precision vs dense solve)
  on synthetic SPD grid problems, nf=1 and nf=2, with pad slots;
* integration: the same `vals` segment array drives ndsolve and
  hostsolve.HostPattern — parity on a real assembled Newton matrix;
* end-to-end: a forced-ND fem2d solve lands on the host-path objective.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.backend import Backend
from multigridbarrier_tpu.solver.ndsolve import (
    NDFactorizer,
    NDSymbolic,
    node_coords,
)

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")


def _grid_problem(G, nf, pad, seed=0):
    """G x G grid of quad elements with random SPD element matrices;
    returns (idx, coords, vals HostPattern-layout, dense A node-major)."""
    m = G * G
    els = []
    for i in range(G - 1):
        for j in range(G - 1):
            n00 = i * G + j
            e = [n00, n00 + 1, n00 + G, n00 + G + 1]
            if pad:
                e.append(m)
            els.append(e)
    idx = np.asarray(els, np.int64)
    nl = idx.shape[1]
    coords = (
        np.stack(np.meshgrid(np.arange(G), np.arange(G), indexing="ij"), -1)
        .reshape(m, 2)
        .astype(float)
    )
    keys = (idx[:, :, None] * (m + 1) + idx[:, None, :]).reshape(-1)
    uniq, inv = np.unique(keys, return_inverse=True)
    nuniq = len(uniq)
    rng = np.random.default_rng(seed)
    vals = np.zeros(nf * nf * nuniq)
    N = m * nf
    Ad = np.zeros((N, N))
    for e in range(idx.shape[0]):
        C = 4 * nf
        B = rng.standard_normal((C, C))
        Me = B @ B.T + 6 * np.eye(C)
        for a in range(4):
            for b in range(4):
                pid = inv[(e * nl + a) * nl + b]
                for f1 in range(nf):
                    for f2 in range(nf):
                        v = Me[a * nf + f1, b * nf + f2]
                        vals[(f1 * nf + f2) * nuniq + pid] += v
                        Ad[idx[e, a] * nf + f1, idx[e, b] * nf + f2] += v
    return idx, coords, vals, Ad


@pytest.mark.parametrize(
    "nf,pad,leaf,use_inv,splitsum,G,ea",
    [(1, False, 4, False, False, 6, "fanin"),
     (2, True, 4, False, False, 6, "fanin"),
     (2, True, 4, True, False, 6, "fanin"),
     (2, True, 16, True, False, 6, "fanin"),
     (2, True, 4, False, True, 6, "fanin"),
     # relay extend-add (the scatter-free path, MGB_ND_EA=relay),
     # both column-selection variants
     (2, True, 4, True, False, 6, "relay"),
     (1, False, 4, False, False, 6, "relay"),
     (2, True, 4, True, False, 6, "relay_gather"),
     # row-level extend-add scatter (the L=8 window guard,
     # MGB_ND_EA_ROWMB=0 forces it at every depth)
     (2, True, 4, True, False, 6, "relay_rows"),
     (2, True, 4, True, False, 6, "relay_gather_rows"),
     # large-leaf configs (the fewer-depths lever, MGB_ND_LEAF=64):
     # a 12x12 grid so leaf 64 still produces a real separator tree
     (2, True, 64, True, False, 12, "fanin"),
     (2, True, 64, False, False, 12, "fanin"),
     (2, True, 64, True, False, 12, "relay")],
)
def test_factor_solve_exact_on_grid(nf, pad, leaf, use_inv, splitsum, G, ea):
    import os

    idx, coords, vals, Ad = _grid_problem(G, nf, pad)
    sym = NDSymbolic(idx, coords.shape[0], nf, coords, leaf=leaf)
    prev = {k: os.environ.get(k)
            for k in ("MGB_ND_SPLITSUM", "MGB_ND_EA", "MGB_ND_RELAY_COLS",
                      "MGB_ND_EA_ROWMB")}
    try:
        # pin BOTH ways so ambient A/B env can't collapse the matrix
        os.environ["MGB_ND_SPLITSUM"] = "1" if splitsum else "0"
        os.environ["MGB_ND_EA"] = ea.split("_")[0]
        os.environ["MGB_ND_RELAY_COLS"] = (
            "gather" if "_gather" in ea else "mm"
        )
        os.environ["MGB_ND_EA_ROWMB"] = (
            "0" if ea.endswith("_rows") else "4"
        )
        fz = NDFactorizer(sym, use_inv=use_inv)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cst = fz.consts()
    fac = fz.factor(jnp.asarray(vals), cst)
    for Ls, Lsb in fac:
        assert bool(jnp.all(jnp.isfinite(Ls)) & jnp.all(jnp.isfinite(Lsb)))
    rng = np.random.default_rng(1)
    b = rng.standard_normal(Ad.shape[0])
    x = np.asarray(fz.solve(fac, jnp.asarray(b), cst))
    x_ref = np.linalg.solve(Ad, b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-12


def test_df_base_kernels_factor_solve():
    """MGB_ND_BASE=df routes the f64 factor's base-block Cholesky and
    triangular inverse through pair-f32 double-float kernels (~2^-44).
    On the well-conditioned grid problem the solve must land ~1e-10 of
    the dense reference — far beyond f32's 2^-24 — and an f32 factor
    must be unaffected (df applies to f64 only)."""
    import os

    idx, coords, vals, Ad = _grid_problem(10, 2, True)
    sym = NDSymbolic(idx, coords.shape[0], 2, coords, leaf=8)
    prev = os.environ.get("MGB_ND_BASE")
    try:
        os.environ["MGB_ND_BASE"] = "df"
        fz = NDFactorizer(sym, use_inv=True)
        fz.chol = "blocked"
        fz.tri_inv = "blocked"
        fz.panel = 16
    finally:
        if prev is None:
            os.environ.pop("MGB_ND_BASE", None)
        else:
            os.environ["MGB_ND_BASE"] = prev
    cst = fz.consts()
    fac = fz.factor(jnp.asarray(vals), cst)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(Ad.shape[0])
    x = np.asarray(fz.solve(fac, jnp.asarray(b), cst))
    x_ref = np.linalg.solve(Ad, b)
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-9, rel
    # the df path must actually have run: its factor differs from the
    # xla-base factor in the low bits (identical bits would mean the
    # knob was ignored)
    fz.base_impl = "xla"
    fac_x = fz.factor(jnp.asarray(vals), cst)
    dmax = max(
        float(jnp.max(jnp.abs(a[0] - b_[0])))
        for a, b_ in zip(fac, fac_x)
    )
    assert dmax > 0.0
    # f32 factors must ignore the knob (base ops already native there)
    fz.base_impl = "df"
    fac32 = fz.factor(jnp.asarray(vals), cst, dtype=jnp.float32)
    for Ls, Lsb in fac32:
        assert Ls.dtype == jnp.float32


def test_df_engine_end_to_end():
    """MGB_ND_CHEAP=df through the fused gate (the accelerator default
    engine) must land on the exact objective at forced-ND L=4 — path
    honesty is structural (certified PCG on the exact Hessian), so any
    drift here means the gate broke.  Also regression-pins the
    const-hoisting fastpath bug (round 5): the df kernels' fori bodies
    must not create hoisted trace constants, or the SECOND execution of
    the fused program dies with a buffer-count mismatch."""
    import os

    prev = {k: os.environ.get(k) for k in ("MGB_ND_F32PC", "MGB_ND_CHEAP")}
    try:
        os.environ["MGB_ND_F32PC"] = "1"
        os.environ["MGB_ND_CHEAP"] = "df"
        b = Backend(dtype=jnp.float64, dense_threshold=120)
        sol = mgb.amgb(mgb.fem2d(L=4, backend=b), p=1.0)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - 50.618082533590) < 5e-7 * 50.618, c


def test_real_newton_matrix_parity():
    """ndsolve and scipy agree on a real fem2d Newton matrix assembled
    from the SAME device vals array (HostPattern layout)."""
    import scipy.sparse.linalg as spla

    g = mgb.fem2d(L=3)
    spec = A._normalize_D(A.default_D(2))
    Qset = A.default_Q(2, 1.0)
    dtype = g.x.dtype
    c = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dtype)(xi), dtype))(g.x)
    z0 = jax.vmap(lambda xi: jnp.asarray(A.default_g(2, dtype)(xi), dtype))(
        g.x
    )
    ctx = A._SolverCtx(g, spec, Qset.barrier, c)
    level = ctx.levels - 1
    basis = ctx._bases[level]
    pat = ctx._get_host_pattern(level)
    h = ctx._get_host(level)
    vals, gv, *_ = h["pre"](
        ctx._P[level], basis, ctx.x, ctx.w, ctx.c, z0,
        jnp.asarray(1.0, dtype), h["full_ids"],
    )
    vals_np = np.asarray(vals, np.float64)
    m, nf = pat.m, pat.nf
    coords = node_coords(basis.idx, m, np.asarray(g.x), basis.nq)
    sym = NDSymbolic(np.asarray(basis.idx), m, nf, coords, leaf=8)
    fz = NDFactorizer(sym)
    cst = fz.consts()
    fac = fz.factor(jnp.asarray(vals_np), cst)
    b_fm = np.asarray(gv, np.float64).reshape(nf, m + 1)[:, :m]
    b_nd = b_fm.T.reshape(-1)
    x_nd = np.asarray(fz.solve(fac, jnp.asarray(b_nd), cst))
    lu = spla.splu(pat.fill(vals_np).tocsc())
    x_fm = lu.solve(np.asarray(gv, np.float64).reshape(-1))
    x_ref = x_fm.reshape(nf, m + 1)[:, :m].T.reshape(-1)
    assert np.linalg.norm(x_nd - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_end_to_end_forced_nd():
    """Forced-ND fem2d solve matches the host-path objective (the fine
    levels route through _run_level_nd when dense_threshold is low)."""
    import os

    b = Backend(dtype=jnp.float64, dense_threshold=256)
    prev = os.environ.get("MGB_FINE_SOLVER")
    try:
        os.environ["MGB_FINE_SOLVER"] = "nd"
        s_nd = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
        os.environ["MGB_FINE_SOLVER"] = "host"
        s_h = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
    finally:
        if prev is None:
            os.environ.pop("MGB_FINE_SOLVER", None)
        else:
            os.environ["MGB_FINE_SOLVER"] = prev
    c_nd = s_nd.SOL_main.c_dot_Dz[-1]
    c_h = s_h.SOL_main.c_dot_Dz[-1]
    assert abs(c_nd - c_h) < 1e-6 * abs(c_h), (c_nd, c_h)


@pytest.mark.parametrize("cheap_var", ["MGB_ND_REUSE", "MGB_ND_F32PC"])
def test_end_to_end_forced_nd_reuse(cheap_var):
    """Cheap-direction modes (_run_level_nd_reuse) must give the same
    converged objective as the factor-every-step ND path: an accepted
    direction is PCG-certified at cg_rtol, so the paths agree to the
    solver contract.  MGB_ND_REUSE=1 = stale-f64-factor preconditioner;
    MGB_ND_F32PC=1 = fresh shifted-equilibrated f32 factor (carries the
    path alone up to t~1e3, certified f64 beyond).  (Measured at fem2d
    L=6: identical c_dot_Dz 15.4183231432 and identical 108 fine its
    for both modes.)"""
    import os

    b = Backend(dtype=jnp.float64, dense_threshold=256)
    prev = {
        k: os.environ.get(k) for k in ("MGB_FINE_SOLVER", cheap_var)
    }
    try:
        os.environ["MGB_FINE_SOLVER"] = "nd"
        s0 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
        os.environ[cheap_var] = "1"
        s1 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    c0 = s0.SOL_main.c_dot_Dz[-1]
    c1 = s1.SOL_main.c_dot_Dz[-1]
    assert abs(c1 - c0) < 1e-6 * abs(c0), (c1, c0)
    # the reuse path must actually have produced PCG-certified
    # directions somewhere (cgits recorded in the per-level traces)
    assert s1.SOL_main.its[-1] > 0


def test_krylov32_warm_start_matches_plain_f32pc():
    """MGB_ND_KRYLOV32=1 (stage-1 f32 Krylov warm start inside f32pc
    directions) must not change what the certification gate accepts:
    the f64 stage still runs to cg_rtol on the exact Hessian, so the
    converged objective matches the plain f32pc path to the solver
    contract.  (Measured on CPU: bit-identical c_dot_Dz and identical
    its at fem2d L=4 and L=6.)"""
    import os

    b = Backend(dtype=jnp.float64, dense_threshold=64)
    keys = ("MGB_FINE_SOLVER", "MGB_ND_F32PC", "MGB_ND_FUSED_GATE",
            "MGB_ND_KRYLOV32")
    prev = {k: os.environ.get(k) for k in keys}
    try:
        os.environ["MGB_FINE_SOLVER"] = "nd"
        os.environ["MGB_ND_F32PC"] = "1"
        os.environ["MGB_ND_FUSED_GATE"] = "1"
        os.environ["MGB_ND_KRYLOV32"] = "0"
        s0 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
        os.environ["MGB_ND_KRYLOV32"] = "1"
        s1 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    c0 = s0.SOL_main.c_dot_Dz[-1]
    c1 = s1.SOL_main.c_dot_Dz[-1]
    assert abs(c1 - c0) < 1e-6 * abs(c0), (c1, c0)


def test_f32_staging_escape_keeps_solve_exact():
    """MGB_ND_F32_TMAX engages the f32-factor programs; on barrier
    Hessians the f32 Cholesky goes non-finite mid-path (leaf separator
    blocks are f32-singular, see tools/probe_f32_direction.py) and the
    dynamic escape must hand over to the f64 programs without changing
    the converged objective (CLAUDE.md: check final c_dot_Dz, not just
    convergence flags)."""
    import os

    b = Backend(dtype=jnp.float64, dense_threshold=256)
    prev = {
        k: os.environ.get(k) for k in ("MGB_FINE_SOLVER", "MGB_ND_F32_TMAX")
    }
    try:
        os.environ["MGB_FINE_SOLVER"] = "nd"
        s64 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
        os.environ["MGB_ND_F32_TMAX"] = "1e9"  # f32 programs at every t
        s32 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    c64 = s64.SOL_main.c_dot_Dz[-1]
    c32 = s32.SOL_main.c_dot_Dz[-1]
    assert abs(c32 - c64) < 1e-6 * abs(c64), (c32, c64)


def test_tri_inv_blocked_matches_solve():
    """Block-doubling explicit triangular inverse == substitution inverse
    (non-power-of-two sizes exercise the identity padding)."""
    from multigridbarrier_tpu.solver.ndsolve import _tri_inv_blocked

    rng = np.random.default_rng(3)
    for n_d, s in [(4, 33), (2, 64), (1, 130)]:
        B = rng.standard_normal((n_d, s, s))
        A = B @ np.transpose(B, (0, 2, 1)) + s * np.eye(s)[None]
        Ls = np.linalg.cholesky(A)
        Li = np.asarray(_tri_inv_blocked(jnp.asarray(Ls)))
        err = np.linalg.norm(Li @ Ls - np.eye(s)[None], axis=(1, 2))
        assert err.max() < 1e-11, (s, err.max())


def test_chol_blocked_matches_xla():
    """Panel-blocked batched Cholesky == jnp.linalg.cholesky."""
    from multigridbarrier_tpu.solver.ndsolve import _chol_blocked

    rng = np.random.default_rng(5)
    for n_d, s in [(3, 40), (2, 96), (1, 130)]:
        B = rng.standard_normal((n_d, s, s))
        A = B @ np.transpose(B, (0, 2, 1)) + s * np.eye(s)[None]
        L_ref = np.linalg.cholesky(A)
        L_b = np.asarray(_chol_blocked(jnp.asarray(A)))
        rel = np.linalg.norm(L_b - L_ref, axis=(1, 2)) / np.linalg.norm(
            L_ref, axis=(1, 2)
        )
        assert rel.max() < 1e-13, (s, rel.max())


def test_end_to_end_forced_nd_3d():
    """3D coverage of the ND fine solver: hexahedral Q_k geometry (nf=2,
    k=5 operators), 3-axis geometric bisection.  Forced through ND via a
    low dense_threshold; the default-threshold solve (dense fine level)
    is the ground truth."""
    import os

    s_ref = mgb.amgb(mgb.fem3d(L=2, k=2), p=1.0, tol=1e-6)
    b = Backend(dtype=jnp.float64, dense_threshold=64)
    prev = os.environ.get("MGB_FINE_SOLVER")
    try:
        os.environ["MGB_FINE_SOLVER"] = "nd"
        s_nd = mgb.amgb(mgb.fem3d(L=2, k=2, backend=b), p=1.0, tol=1e-6)
    finally:
        if prev is None:
            os.environ.pop("MGB_FINE_SOLVER", None)
        else:
            os.environ["MGB_FINE_SOLVER"] = prev
    c_ref = s_ref.SOL_main.c_dot_Dz[-1]
    c_nd = s_nd.SOL_main.c_dot_Dz[-1]
    assert abs(c_nd - c_ref) < 1e-5 * abs(c_ref), (c_nd, c_ref)


def test_pipelined_fused_gate_matches_sync():
    """MGB_ND_PIPELINE=1 (accelerator default; forced here on CPU) must
    reproduce the synchronous fused-gate path exactly: speculation only
    reorders host dispatch — every direction is still certified-or-
    fresh-f64 by the on-device gate, and a mispredicted speculation is
    discarded, never applied.  The converged objective must agree to the
    certification contract; iteration COUNTS may differ slightly — the
    speculated attempt policy lags one step, so a certification attempt
    can flip from certified-f32pc to fresh-f64 (both valid directions,
    numerically different paths).  (Measured: fem2d L=4/dth=64 identical
    c and [6,12,7,100] its; L=3/dth=64 c agrees to 1e-12, fine its
    47 vs 52.)"""
    import os

    b = Backend(dtype=jnp.float64, dense_threshold=64)
    keys = ("MGB_FINE_SOLVER", "MGB_ND_F32PC", "MGB_ND_FUSED_GATE",
            "MGB_ND_PIPELINE")
    prev = {k: os.environ.get(k) for k in keys}
    try:
        os.environ["MGB_FINE_SOLVER"] = "nd"
        os.environ["MGB_ND_F32PC"] = "1"
        os.environ["MGB_ND_FUSED_GATE"] = "1"
        os.environ["MGB_ND_PIPELINE"] = "0"
        s0 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
        os.environ["MGB_ND_PIPELINE"] = "1"
        s1 = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    c0 = s0.SOL_main.c_dot_Dz[-1]
    c1 = s1.SOL_main.c_dot_Dz[-1]
    # The two runs take intentionally different Newton paths (47 vs 52
    # fine its above), so they agree only to the documented floor-stop
    # variation (~2e-6 relative across platforms), not to 1e-9 — the
    # 1e-12 measured here is one BLAS build's luck, not a contract.
    assert abs(c1 - c0) < 1e-5 * abs(c0), (c1, c0)


def test_end_to_end_host_tmin_handoff():
    """MGB_HOST_TMIN endgame handoff: an ND-routed fine level hands the
    direction solve to the host SuperLU engine for t >= tmin and the
    trajectory must still land on the exact objective (the handoff was
    built for an accelerator endgame whose factor was not accurate
    enough at L=8).  Forced-ND L=4 with the
    handoff from t=1e4 exercises both engines inside one path."""
    import os

    b = Backend(dtype=jnp.float64, dense_threshold=120)
    prev = os.environ.get("MGB_HOST_TMIN")
    try:
        os.environ["MGB_HOST_TMIN"] = "1e4"
        sol = mgb.amgb(mgb.fem2d(L=4, backend=b), p=1.0)
    finally:
        if prev is None:
            os.environ.pop("MGB_HOST_TMIN", None)
        else:
            os.environ["MGB_HOST_TMIN"] = prev
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - 50.618082533590) < 5e-7 * 50.618, c
