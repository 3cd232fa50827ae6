"""Dense + MG-CG Newton linear solvers (part of the MUMPS/cuDSS
replacement, SURVEY.md §2.4).

Place in the CURRENT solver hierarchy (amgb._run_level routing): coarse
levels (nf*m <= dense_threshold) use this module's dense Cholesky+IR;
fine levels default to the on-device nested-dissection multifrontal
solver (`solver/ndsolve.py`, MGB_FINE_SOLVER=nd), with
`MGB_FINE_SOLVER=host` (`solver/hostsolve.py`) and this module's
MG-CG (`=mgcg`, the sharded scale-out fallback — measured
accuracy-limited ~6e-5 relative at L>=6) as alternatives.

The Newton system

    H = R' (D' diag(w .* F2) D) R      (SPD on the barrier interior)

is solved here in one of two ways, chosen statically by subspace size:

* dense: the per-element Hessians are scatter-added into a global dense
  matrix and factored with Cholesky (coarse levels; exact).
* mgcg: matrix-free preconditioned CG where H v is a batched element
  matmul + gather/segment-sum, preconditioned by a geometric multigrid
  V-cycle over the *same* element-local hierarchy.  Because every level's
  inclusion matrix targets the same broken space (R_l = R_{l+1} E_l), the
  rediscretized coarse Hessian equals the Galerkin operator E' H E exactly,
  so this is true Galerkin multigrid at zero SpGEMM cost (the reference
  pays a distributed SpGEMM chain per Newton step for the same object,
  reference test/test_amg_structure.jl:114-133).

Vectors use the field-major layout (nf, m+1): m real coefficients plus one
zero pad slot per field (see runtime/elements.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp


class LevelSystem(NamedTuple):
    """One level's assembled element Hessians.

    He:  (nelem, nf*nl, nf*nl) per-element Hessian blocks
    idx: (nelem, nl) global node ids (pad slot = m)
    m:   static subspace size
    scatter_idx: (m+1, width) node-major gather table (see
        runtime/elements.py scatter_table), or None to fall back to
        segment_sum.  Where scatters with duplicate indices serialize, the
        gather form is the difference between micro- and milliseconds per
        H@v.
    """

    He: jnp.ndarray
    idx: jnp.ndarray
    m: int
    scatter_idx: jnp.ndarray = None
    pair_idx: jnp.ndarray = None  # (nelem, nl, nl) node-pair ids
    # (elements.node_pair_table); enables principal-submatrix Schwarz


def _node_sum(sys_: LevelSystem, flat: jnp.ndarray) -> jnp.ndarray:
    """(nelem*nl, f) per-slot contributions -> (m+1, f), zero pad row."""
    if sys_.scatter_idx is not None:
        padded = jnp.concatenate(
            [flat, jnp.zeros((1, flat.shape[1]), dtype=flat.dtype)], axis=0
        )
        out = jnp.sum(padded[sys_.scatter_idx], axis=1)
    else:
        out = jax.ops.segment_sum(
            flat, sys_.idx.reshape(-1), num_segments=sys_.m + 1
        )
    return out.at[sys_.m].set(0.0)


def hvp(sys_: LevelSystem, vp: jnp.ndarray) -> jnp.ndarray:
    """H @ v, matrix-free: gather -> batched matmul -> gather-table sum.

    vp: (nf, m+1) padded field-major coefficients; returns same shape with a
    zero pad slot.  This is the entire SpMV of the reference's Newton solve
    (SURVEY.md §3.5) as three XLA ops.
    """
    He, idx, m = sys_.He, sys_.idx, sys_.m
    nelem, nl = idx.shape
    nf = vp.shape[0]
    ve = vp[:, idx]  # (nf, nelem, nl)
    ve = ve.transpose(1, 0, 2).reshape(nelem, nf * nl)
    hve = jnp.einsum("eab,eb->ea", He, ve)
    flat = hve.reshape(nelem, nf, nl).transpose(0, 2, 1).reshape(-1, nf)
    return _node_sum(sys_, flat).T


def hvp_lane(He_lane: jnp.ndarray, sys_: LevelSystem, vp: jnp.ndarray):
    """H @ v with He stored lane-major (C, C, nelem): the contraction
    becomes C^2 lane-wise FMAs over nelem-long vectors instead of a batched
    tiny matmul padded to matrix-unit tiles (tools/bench_hvp.py times both
    forms).  The f64 CG operator Aop is the single most expensive op per
    CG iteration, so mgcg_solve uses this form for float64 systems (the
    V-cycle keeps the batched layout)."""
    idx, m = sys_.idx, sys_.m
    nelem, nl = idx.shape
    nf = vp.shape[0]
    ve = vp[:, idx]  # (nf, nelem, nl)
    ve = ve.transpose(1, 0, 2).reshape(nelem, nf * nl).T  # (C, nelem)
    hve = jnp.einsum("abe,be->ae", He_lane, ve)  # (C, nelem)
    flat = hve.reshape(nf, nl, nelem).transpose(2, 1, 0).reshape(-1, nf)
    return _node_sum(sys_, flat).T


def diag_of(sys_: LevelSystem) -> jnp.ndarray:
    """diag(H) as (nf, m+1); pad slot set to 1 (harmless inverse)."""
    He, idx, m = sys_.He, sys_.idx, sys_.m
    nelem, nl = idx.shape
    nf = He.shape[1] // nl
    d = jnp.diagonal(He, axis1=1, axis2=2).reshape(nelem, nf, nl)
    flat = d.transpose(0, 2, 1).reshape(-1, nf)
    out = _node_sum(sys_, flat).T
    return out.at[:, m].set(1.0)


def dense_assemble(sys_: LevelSystem, nf: int) -> jnp.ndarray:
    """Scatter element Hessians into the global dense matrix of size
    N = nf*(m+1), with identity on pad rows (their He entries are zero by
    construction, so this keeps the matrix SPD)."""
    He, idx, m = sys_.He, sys_.idx, sys_.m
    nelem, nl = idx.shape
    N = nf * (m + 1)
    fid = jnp.arange(nf)[None, :, None] * (m + 1) + idx[:, None, :]
    fid = fid.reshape(nelem, nf * nl)
    # flat 1-D segment-sum instead of a 2-D batched scatter: N x N
    # advanced-index scatters have compiled pathologically slowly
    # (hundreds of seconds even for tiny N), while 1-D segment sums are
    # the same primitive the hot path already uses
    flat_ids = (fid[:, :, None] * N + fid[:, None, :]).reshape(-1)
    H = jax.ops.segment_sum(
        He.reshape(-1), flat_ids, num_segments=N * N
    ).reshape(N, N)
    padids = jnp.arange(nf) * (m + 1) + m
    return H.at[padids, padids].add(1.0)


def dense_solve(
    sys_: LevelSystem, nf: int, bp: jnp.ndarray, shifts=None
) -> jnp.ndarray:
    """Direct solve via dense Cholesky (H is SPD).

    Barrier Hessians reach cond ~ 1e17 near path convergence.  An UNSHIFTED
    backward-stable factorization still yields excellent Newton directions
    there (the errors align with the benign subspace — this is why the
    reference can rely on MUMPS, SURVEY.md §3.5), whereas a regularizing
    shift of the diagonal destroys precisely the near-null components that
    carry the remaining Newton decrement.  So: factor unshifted first and
    escalate through `shifts` only on breakdown (negative pivot -> NaN),
    mirroring MUMPS' static pivot perturbation.

    bp: (nf, m+1) -> (nf, m+1)."""
    if shifts is None:
        # dtype-relative ladder: a shift below eps(dtype) does nothing
        eps = float(jnp.finfo(bp.dtype).eps)
        shifts = (0.0, 500 * eps, 50000 * eps)
    H0 = dense_assemble(sys_, nf)
    ii = jnp.arange(H0.shape[0])
    b = bp.reshape(-1)
    m = sys_.m

    def zero_pad(x):
        return x.reshape(nf, m + 1).at[:, m].set(0.0)

    def attempt(shift):
        H = H0.at[ii, ii].mul(1.0 + shift) if shift else H0
        cf = jax.scipy.linalg.cho_factor(H)
        x = jax.scipy.linalg.cho_solve(cf, b)
        # two rounds of f64 iterative refinement with matrix-free residuals
        # (fresh He contraction, independent of factorization error) — the
        # post-solve IR that lets MUMPS survive cond ~ 1/eps Newton systems
        for _ in range(2):
            r = b - hvp(sys_, zero_pad(x)).reshape(-1)
            x = x + jax.scipy.linalg.cho_solve(cf, r)
        return x

    x = attempt(shifts[0])
    for s in shifts[1:]:
        x = jax.lax.cond(
            jnp.all(jnp.isfinite(x)),
            lambda x: x,
            lambda _: attempt(s),
            x,
        )
    return zero_pad(x)


# ----------------------------------------------------------------------------
# Multigrid V-cycle preconditioner
# ----------------------------------------------------------------------------


def _as_apply(minv):
    """Normalize a smoother preconditioner to a callable: either a diagonal
    array ((nf, m+1) Jacobi) or an apply-callable (e.g. element Schwarz)."""
    if callable(minv):
        return minv
    return lambda r: minv * r


def lambda_max_est(sys_: LevelSystem, minv, iters: int = 6) -> jnp.ndarray:
    """Estimate lambda_max(M^-1 H) by power iteration (deterministic start),
    where M^-1 is the smoother's preconditioner (Jacobi diagonal or element
    Schwarz).

    Barrier Hessians have unbounded dynamic range along the central path
    (cond ~ t^2), but the preconditioned operator stays O(1); the smoother
    must still track its top eigenvalue each Newton step or the V-cycle
    turns indefinite and CG diverges."""
    apply_m = _as_apply(minv)
    nf, mp1 = sys_.He.shape[1] // sys_.idx.shape[1], sys_.m + 1
    dtype = sys_.He.dtype
    # fixed quasi-random start vector (no jax PRNG: cheap + deterministic)
    i = jnp.arange(nf * mp1, dtype=dtype).reshape(nf, mp1)
    v = jnp.cos(i * 7.13) + 0.3
    v = v.at[:, sys_.m].set(0.0)

    def body(_, carry):
        v, lam = carry
        w = apply_m(hvp(sys_, v))
        lam = jnp.sqrt(jnp.vdot(w, w) / jnp.maximum(jnp.vdot(v, v), 1e-300))
        return w / jnp.maximum(jnp.sqrt(jnp.vdot(w, w)), 1e-300), lam

    _, lam = jax.lax.fori_loop(
        0, iters, body, (v, jnp.asarray(1.0, dtype=dtype))
    )
    return lam * 1.05  # safety margin


# ----------------------------------------------------------------------------
# Element-block additive Schwarz smoother
# ----------------------------------------------------------------------------


class SchwarzState(NamedTuple):
    """Factored subdomain blocks for the overlapping additive Schwarz
    smoother.

    The smoother's preconditioner is

        M^-1 = sum_e  A_e' W_e B_e^{-1} W_e A_e

    where A_e gathers element e's local dofs, W_e is a partition of unity
    and B_e is the PRINCIPAL SUBMATRIX of the assembled global (scaled)
    Newton matrix restricted to e's node set — assembled in element-local
    form with one segment-sum over the static node-pair table plus one
    gather (elements.node_pair_table), never forming a global sparse
    matrix.  Each term is SPD and the cover is complete, so M^-1 is SPD —
    a valid CG/V-cycle smoother with the classical lambda_max(M^-1 H) =
    O(valence) bound.

    Why principal submatrices and not the element integral blocks He_e:
    He_e only carries the stiffness the element itself contributes, so a
    direction can be He_e-soft yet globally stiff (neighbors own it).
    Inverting the lifted He_e then amplifies such directions by up to
    1/lift — measured as lambda_max(M^-1 H) = 4e6 (block-relative lift) /
    5.3e3 (absolute lift) with most of the spectrum below the Chebyshev
    window, saturating CG mid-path (fem2d L=5 wedged for an hour at
    t=1e5); diagonal-share weights or (1-share) diagonal completion fix
    the mid path but mute the ELEMENT-LOCAL near-null directions
    (cone-boundary activity at single quadrature points) that dominate
    the deep barrier endgame, locking levels above the true f64 floor.
    B_e >= He_e contains every neighbor contribution on e's nodes, so
    block-soft == globally-soft: aggressive block inversion is consistent
    with the global operator at both ends of the path — the job MUMPS
    does for the reference (SURVEY.md §3.5).

    Point-Jacobi (diag scaling) cannot see the element-scale anisotropy
    barrier Hessians develop along the central path (near-boundary
    quadrature weights vary by orders of magnitude WITHIN an element);
    solving full subdomain blocks captures it, and the batched
    triangular solves are batched dense work."""

    chol: jnp.ndarray  # (nelem, C, C) lower Cholesky factors
    we: jnp.ndarray  # (nelem, C) partition-of-unity weights (pad slots 0)


def schwarz_setup(sys_: LevelSystem, nf: int) -> SchwarzState:
    He, idx, m = sys_.He, sys_.idx, sys_.m
    nelem, nl = idx.shape
    if sys_.pair_idx is None:
        raise ValueError(
            "schwarz_setup requires LevelSystem.pair_idx "
            "(elements.node_pair_table)"
        )
    # ---- assemble principal submatrices B_e = A_e H A_e' ------------------
    # Field-pair expansion: every field shares the node-pair structure, so
    # the full pair id is (f1*nf + f2)*stride + node_pair_id and the
    # segment count is shape-derived (static under jit).
    stride = nelem * nl * nl
    pn = sys_.pair_idx.astype(jnp.int32)  # (nelem, nl, nl)
    fp = jnp.arange(nf, dtype=jnp.int32)
    fpair = (fp[:, None] * nf + fp[None, :]) * stride  # (nf, nf)
    # He layout: (nelem, C, C) with C = nf*nl, slot c = f*nl + a
    full_id = (
        fpair[None, :, None, :, None]
        + jnp.broadcast_to(
            pn[:, None, :, None, :], (nelem, nf, nl, nf, nl)
        )
    ).reshape(nelem, nf * nl, nf * nl)
    sums = jax.ops.segment_sum(
        He.reshape(-1), full_id.reshape(-1), num_segments=nf * nf * stride
    )
    B = sums[full_id]  # (nelem, C, C) principal submatrices
    # ---- partition of unity + regularization ------------------------------
    # 1/valence weights: integer-exact, so identical on every device mesh
    # (a diagonal-share PoU computed from f32 blocks differs in the last
    # bit per sharding and breaks 1-vs-N solve parity at the f64 floor).
    ones = jnp.ones((nelem * nl,), dtype=He.dtype)
    counts = jax.ops.segment_sum(ones, idx.reshape(-1), num_segments=m + 1)
    winv = jnp.where(counts > 0, 1.0 / jnp.maximum(counts, 1.0), 0.0)
    winv = winv.at[m].set(0.0)
    wn = winv[idx]  # (nelem, nl)
    we = jnp.repeat(wn[:, None, :], nf, axis=1).reshape(nelem, nf * nl)
    # Callers pass globally Jacobi-scaled systems, so diag(B) = 1 on every
    # real dof; constrained/pad slots have all-zero rows and get an
    # identity diagonal.  The small lift bounds the block condition for
    # the f32 Cholesky (needs cond <~ 1e7; the scaled global matrix
    # reaches ~1e8+ near the f64 floor).
    d = jnp.diagonal(B, axis1=1, axis2=2)
    # Measured A/B (fem2d mgcg path): 3e-3 beats 1e-4 in BOTH accuracy
    # and wall time (L=5: 27.4s vs 32.2s, identical 145 its, exact
    # c=27.3607025 both; L=6: c 15.4192 vs 15.4210 against the exact
    # 15.4183, ~600s both — the L>=6 mid-path saturation remains the
    # open mgcg problem, see CLAUDE.md).  3e-2 locks the path (earlier
    # A/B) — do not raise further.
    lift_abs = float(os.environ.get("MGB_SCHWARZ_LIFT", "3e-3"))
    lift = lift_abs + jnp.where(d > 0, 0.0, 1.0)
    B_reg = B + jax.vmap(jnp.diag)(lift)
    chol = jnp.linalg.cholesky(B_reg)
    return SchwarzState(chol=chol, we=we)


def schwarz_apply(sys_: LevelSystem, st: SchwarzState, r: jnp.ndarray):
    """M^-1 r for the weighted additive Schwarz preconditioner.

    r: (nf, m+1) -> same shape.  One gather + two batched triangular
    solves + one node scatter — about the cost of 1.5 hvp applications."""
    idx, m = sys_.idx, sys_.m
    nelem, nl = idx.shape
    nf = r.shape[0]
    re = r[:, idx].transpose(1, 0, 2).reshape(nelem, nf * nl) * st.we
    xe = jax.scipy.linalg.cho_solve((st.chol, True), re[..., None])[..., 0]
    xe = xe * st.we
    flat = xe.reshape(nelem, nf, nl).transpose(0, 2, 1).reshape(-1, nf)
    out = _node_sum(sys_, flat).T
    return out.at[:, m].set(0.0)


_CHEB_RATIO = float(os.environ.get("MGB_CHEB_RATIO", "8.0"))


def chebyshev(
    sys_: LevelSystem, minv, lmax, xp, bp, degree: int = 3, ratio: float = None
):
    """Chebyshev-accelerated smoothing on [lmax/ratio, lmax] of M^-1 H
    (Saad 3rd ed., Alg. 12.1 adapted to a preconditioned operator), where
    M^-1 is Jacobi (diagonal array) or element Schwarz (callable).  A
    polynomial in M^-1 H => symmetric in the M inner product, so
    V(cheb,cheb) remains a valid SPD preconditioner for CG."""
    apply_m = _as_apply(minv)
    if ratio is None:
        ratio = _CHEB_RATIO
    lmin = lmax / ratio
    d = 0.5 * (lmax + lmin)
    c = 0.5 * (lmax - lmin)
    r = bp - hvp(sys_, xp)
    p = jnp.zeros_like(bp)
    alpha = jnp.asarray(0.0, dtype=bp.dtype)
    beta = jnp.asarray(0.0, dtype=bp.dtype)
    for i in range(degree):
        z = apply_m(r)
        if i == 0:
            p = z
            alpha = 1.0 / d
        else:
            beta = (c * alpha / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = z + beta * p
        xp = xp + alpha * p
        r = r - alpha * hvp(sys_, p)
    return xp


def vcycle(
    systems: Sequence[LevelSystem],
    minvs: Sequence,
    lmaxs: Sequence[jnp.ndarray],
    embeds: Sequence,
    coarse_solve,
    bp: jnp.ndarray,
    nf: int,
    degree: int = 3,
) -> jnp.ndarray:
    """One V-cycle with Chebyshev-accelerated smoothing on the finest of
    `systems`; minvs[l] is the level's smoother preconditioner (Jacobi
    diagonal array or Schwarz apply-callable, see chebyshev).

    embeds[i]: inclusion of level-i subspace into level-(i+1) (the
    geometry's `embed['dirichlet']`, nested by construction; any object
    with matvec/rmatvec).  coarse_solve(bp_0) -> x_0 solves the coarsest
    level exactly (typically a prefactored f64 Cholesky).  Because every
    level's inclusion targets the same broken space, these rediscretized
    coarse operators ARE the Galerkin operators (linsolve module doc)."""

    def cycle(l, bp_l):
        sys_l, minv_l, lmax_l = systems[l], minvs[l], lmaxs[l]
        if l == 0:
            return coarse_solve(bp_l)
        xp = chebyshev(
            sys_l, minv_l, lmax_l, jnp.zeros_like(bp_l), bp_l, degree
        )
        r = bp_l - hvp(sys_l, xp)
        E = embeds[l - 1]  # (m_l, m_{l-1})
        r_c = E.rmatvec(r[:, : sys_l.m].T).T  # (nf, m_{l-1})
        r_cp = jnp.concatenate(
            [r_c, jnp.zeros((nf, 1), dtype=r_c.dtype)], axis=1
        )
        e_c = cycle(l - 1, r_cp)
        e_f = E.matvec(e_c[:, : systems[l - 1].m].T).T  # (nf, m_l)
        xp = xp + jnp.concatenate(
            [e_f, jnp.zeros((nf, 1), dtype=e_f.dtype)], axis=1
        )
        return chebyshev(sys_l, minv_l, lmax_l, xp, bp_l, degree)

    return cycle(len(systems) - 1, bp)


class _ScaledTransfer(NamedTuple):
    """Level transfer conjugated by the symmetric Jacobi scalings.

    If Hhat_l = S_l H_l S_l with S_l = diag(d_l^{-1/2}), the prolongation
    that preserves the Galerkin relation Hhat_c = Ehat' Hhat_f Ehat is
    Ehat = S_f^{-1} E S_c (elementwise scale -> E -> scale).  Node-major
    operands (m, nf) to match vcycle's usage of Ell.matvec/rmatvec."""

    E: object
    sc: jnp.ndarray  # (m_c, nf)  S_c diagonal
    sf_inv: jnp.ndarray  # (m_f, nf)  S_f^{-1} diagonal

    def matvec(self, xc):  # (m_c, nf) -> (m_f, nf)
        return self.E.matvec(self.sc * xc) * self.sf_inv

    def rmatvec(self, rf):  # (m_f, nf) -> (m_c, nf)
        return self.E.rmatvec(self.sf_inv * rf) * self.sc


def mgcg_solve(
    systems: Sequence[LevelSystem],
    embeds: Sequence,
    bp: jnp.ndarray,
    nf: int,
    rtol: float = 1e-10,
    maxiter: int = 200,
    degree: int = 3,
    shift: float = 0.0,
    stagnation: int = 12,
    lmaxs_in=None,
    x0_in=None,
    coarse_nd=None,
    coarse_nd_args=None,
):
    """Multigrid-preconditioned CG on the finest level of `systems`.

    Barrier Hessians become *numerically singular* along the central path
    (scaled lambda_min -> machine eps as t grows); a direct factorization
    (the reference's MUMPS, SURVEY.md §3.5) shrugs this off via backward
    stability, an iterative method cannot.  Three countermeasures make
    MG-CG a drop-in replacement:

    * Jacobi-prescaled f32 V-cycle (see the scaling comment in the body):
      keeps the mixed-precision preconditioner positive definite at any
      path conditioning.
    * Quadratic-model progress tracking with breakdown/stagnation exits
      (see the loop comment): every healthy iterate is a descent direction
      carrying the captured Newton decrement; breakdown returns the last
      valid iterate (the zero vector only at the genuine f64 floor, where
      a zero Newton step is the converged state).
    * Optional Levenberg shift (H + shift*diag(H)); default 0 — a shift
      damps exactly the near-null Newton components that carry the
      remaining decrement (see dense_solve docstring), so it is reserved
      for callers that hit genuine breakdowns.

    Returns (xp, iterations, relative_residual at exit).  Static shapes;
    the loop is a lax.while_loop with no host syncs.
    """
    # Truncated hierarchy (MGB_MGCG_LEVELS = T >= 2): keep only the top T
    # levels and solve the new coarsest level EXACTLY (dense f64 Cholesky)
    # instead of recursing through smoothed coarser levels.  Motivation
    # (the measured depth ceiling, CLAUDE.md round-2 session-7): the
    # V-cycle's mid-level Schwarz/Chebyshev smoothers cannot track
    # barrier-weight anisotropy, and the preconditioned spectrum spreads
    # BROADLY (tools/probe_mgcg_spectrum.py: 183/450 eigenvalues above 2x
    # median) — not a few deflatable outliers, so deflation and window
    # tuning were both measured-rejected.  Two-grid (T=2) removes every
    # mid-level smoother: the only approximation left is fine-level
    # element-block Schwarz, which handles exactly the element-local
    # stiff modes barrier weights create; everything coarse-representable
    # is corrected exactly.
    #
    # Round-4 measurements (fem2d, CPU, vs exact-direction ground truths):
    # the old ~5e-5 relative depth ceiling was the CG BUDGET, not a
    # preconditioner floor — full-hierarchy CG with maxiter 4000/q_eps 0
    # reaches 3.2e-7 at L=5 (2930s); two-grid + maxiter 1000 + q_eps 0
    # reaches 4.5e-8 in 240s (160 its — the exact-direction iteration
    # count).  The deeper budget is therefore wired to truncation below:
    # only a cycle strong enough to use it gets it.  Memory note: the
    # dense coarse factor is O((nf*m_{fine-1})^2), so 'auto' activates
    # two-grid only when nf*(m_c+1) <= MGB_MGCG_COARSE_CAP (default
    # 4096); beyond that the full hierarchy (and classic budget) is kept
    # — an ND-factored coarse solve is the documented growth path.
    # Above the dense cap the coarse level is factored by the ND
    # multifrontal instead (coarse_nd = the level's NDFactorizer,
    # coarse_nd_args = {"consts", "full_ids", "nseg"} threaded as jit
    # arguments — round-4 verdict item 6: MUMPS has no such cap and the
    # two-grid fix must not stop at nf*m = 4096).
    use_nd_coarse = False
    tg_env = os.environ.get("MGB_MGCG_LEVELS", "auto")
    if tg_env == "auto":
        cap = int(os.environ.get("MGB_MGCG_COARSE_CAP", "4096"))
        if len(systems) > 2 and nf * (systems[-2].m + 1) <= cap:
            tg = 2
        elif len(systems) > 2 and coarse_nd is not None:
            tg = 2
            use_nd_coarse = True
        else:
            tg = 0
    else:
        tg = int(tg_env or 0)
        use_nd_coarse = (
            2 <= tg < len(systems)
            and coarse_nd is not None
            and nf * (systems[-2].m + 1)
            > int(os.environ.get("MGB_MGCG_COARSE_CAP", "4096"))
        )
    n_drop = len(systems) - tg if 2 <= tg < len(systems) else 0
    if n_drop:
        systems = systems[n_drop:]
        embeds = embeds[n_drop:]
        if lmaxs_in is not None:
            lmaxs_in = lmaxs_in[n_drop:]
        maxiter = max(
            maxiter, int(os.environ.get("MGB_CG_MAXITER_DEEP", "1000"))
        )
    # smoother degree override (the fine smoother is the ONLY
    # approximation left in the truncated cycle, so its degree is the
    # accuracy/cost dial there)
    degree = int(os.environ.get("MGB_MG_DEGREE", str(degree)))
    fine = systems[-1]
    diag_fine = diag_of(fine)
    dinvs = [1.0 / diag_of(s) for s in systems]
    if use_nd_coarse:
        # exact multifrontal factor of the coarse operator: the element
        # Hessians reduce to the deduplicated pair-value layout by ONE
        # segment_sum (HostPattern full_ids == the ND vals layout), then
        # the same on-device factorization the fine ND path runs
        # coarse_nd is STATIC (closed over): .fz the NDFactorizer, .nseg
        # the segment count; the (large) index maps ride in
        # coarse_nd_args as traced jit arguments (HTTP-413 rule)
        coarse_cf = None
        vals0 = jax.ops.segment_sum(
            systems[0].He.reshape(-1),
            coarse_nd_args["full_ids"].reshape(-1),
            num_segments=coarse_nd.nseg,
        )
        coarse_fac = coarse_nd.fz.factor(vals0, coarse_nd_args["consts"])
    else:
        coarse_cf = jax.scipy.linalg.cho_factor(
            dense_assemble(systems[0], nf)
        )
        coarse_fac = None

    sh = jnp.asarray(shift, dtype=bp.dtype)

    # lane-major He for the f64 operator (see hvp_lane); transposed once per
    # Newton step, amortized over every CG iteration's Aop
    use_lane = bp.dtype == jnp.float64 and (
        os.environ.get("MGB_LANE_AOP", "1") != "0"
    )
    He_lane = jnp.transpose(fine.He, (1, 2, 0)) if use_lane else None

    def Aop(v):
        hv = hvp_lane(He_lane, fine, v) if use_lane else hvp(fine, v)
        return hv + sh * diag_fine * v

    # Mixed precision: the preconditioner only steers the Krylov space, so
    # its smoothing sweeps run in float32 (half the bytes of f64)
    # while CG residuals/updates stay at solve precision — the converged
    # accuracy is set by the outer iteration, the f32 inner pass just makes
    # it cheap.
    #
    # Symmetric Jacobi pre-scaling BEFORE the f32 cast is what keeps this
    # sound along the whole central path: unscaled barrier Hessians span
    # 1e6+ in magnitude, and rounding them to f32 perturbs eigenvalues by
    # ~eps32*lmax — below zero once cond exceeds ~1e7 — making the V-cycle
    # indefinite and CG break down (measured via tools/debug_handoff.py:
    # negative pAp/rz at t >= 1e6).  Scaling each level to unit diagonal,
    # Hhat_l = S_l H_l S_l with S_l = diag(d_l)^{-1/2}, bounds the f32
    # representation error by eps32*O(1); the cycle on Hhat (with
    # scaling-conjugated transfers, see _ScaledTransfer) is the exact
    # similarity transform of the unscaled cycle, so convergence theory and
    # the lmax estimates (spectra are similar) carry over unchanged, and
    #     H^{-1} = S_f Vhat S_f
    # turns the scaled cycle back into an SPD preconditioner for H.
    f32c = (
        jnp.float64
        if os.environ.get("MGB_CYCLE_DTYPE", "f32") == "f64"
        and bp.dtype == jnp.float64
        else jnp.float32
    )
    use_scaled = os.environ.get("MGB_SCALED_PRECOND", "1") != "0"
    m0 = systems[0].m
    if use_scaled:
        svecs = [jnp.sqrt(d) for d in dinvs]  # (nf, m+1) S_l diagonals
        systems32 = []
        for s_, sv in zip(systems, svecs):
            nelem_l, nl_l = s_.idx.shape
            se = sv[:, s_.idx]  # (nf, nelem, nl)
            se = se.transpose(1, 0, 2).reshape(nelem_l, nf * nl_l)
            He_hat = (s_.He * se[:, :, None] * se[:, None, :]).astype(f32c)
            systems32.append(s_._replace(He=He_hat))
        dinvs32 = [jnp.asarray(1.0, dtype=f32c)] * len(systems)  # unit diag
        sv32 = [sv.astype(f32c) for sv in svecs]
        embeds32 = [
            _ScaledTransfer(
                E=E,
                sc=sv32[i][:, : systems[i].m].T,
                sf_inv=(1.0 / sv32[i + 1][:, : systems[i + 1].m]).T,
            )
            for i, E in enumerate(embeds)
        ]
        s0_inv = 1.0 / svecs[0]  # = sqrt(diag_0), (nf, m0+1)
        s_fine = svecs[-1]
    else:  # unscaled cast (round-1 behavior; kept for A/B diagnosis)
        systems32 = [
            s._replace(He=s.He.astype(f32c)) for s in systems
        ]
        dinvs32 = [d.astype(f32c) for d in dinvs]
        embeds32 = [
            type(E)(cols=E.cols, vals=E.vals.astype(f32c), shape=E.shape)
            for E in embeds
        ]
        s0_inv = None
        s_fine = None

    # Smoother preconditioner per level: element-block additive Schwarz by
    # default (see SchwarzState — point-Jacobi cannot resolve the
    # element-scale anisotropy of late-path barrier Hessians and CG spins
    # to maxiter), Jacobi via MGB_SMOOTHER=jacobi or on the unscaled
    # diagnostic path (unscaled f32 blocks can be too ill-conditioned to
    # factor).
    use_schwarz = (
        use_scaled
        and os.environ.get("MGB_SMOOTHER", "schwarz") == "schwarz"
        and all(s.pair_idx is not None for s in systems32[1:])
    )
    if use_schwarz:
        states32 = [None] + [schwarz_setup(s, nf) for s in systems32[1:]]
        minvs32 = [dinvs32[0]] + [
            (lambda s=s, st=st: lambda r: schwarz_apply(s, st, r))()
            for s, st in zip(systems32[1:], states32[1:])
        ]
    else:
        minvs32 = dinvs32

    # lambda_max estimates of the SMOOTHED f32 operator M^-1 Hhat (level 0
    # is solved exactly — no smoother, no estimate).  Estimated on the f32
    # pair the cycle actually smooths; carried across a level run via
    # lmaxs_in in solve precision (lambda_max is O(1) and drifts slowly
    # along the Newton path, so the level's first estimate stays valid
    # with the built-in 1.05 margin).
    def _est(i):
        return lambda_max_est(systems32[i], minvs32[i], iters=6).astype(
            bp.dtype
        )

    one = jnp.asarray(1.0, dtype=bp.dtype)
    if lmaxs_in is not None:
        lmaxs = [one]
        for i in range(1, len(systems)):
            lm = jax.lax.cond(
                lmaxs_in[i - 1] > 0,
                lambda _, i=i: lmaxs_in[i - 1] * one,
                lambda _, i=i: _est(i),
                0,
            )
            lmaxs.append(lm)
    else:
        lmaxs = [one] + [_est(i) for i in range(1, len(systems))]
    lmaxs_out = jnp.stack(lmaxs[1:]) if len(lmaxs) > 1 else jnp.zeros(
        0, dtype=bp.dtype
    )
    if n_drop:  # keep the caller's carried-lmaxs length contract
        lmaxs_out = jnp.concatenate(
            [jnp.ones(n_drop, dtype=bp.dtype), lmaxs_out]
        )
    lmaxs32 = [l.astype(f32c) for l in lmaxs]

    def _coarse_direct(r_pad):
        """Exact solve of the UNSCALED coarse operator; r_pad/(return)
        are (nf, m0+1) field-major padded at factor precision."""
        if use_nd_coarse:
            # ND solve works in node-major flat dofs (dof = node*nf+f)
            b_nd = r_pad[:, :m0].T.reshape(-1)
            x_nd = coarse_nd.fz.solve(
                coarse_fac, b_nd, coarse_nd_args["consts"]
            )
            x = jnp.concatenate(
                [
                    x_nd.reshape(m0, nf).T,
                    jnp.zeros((nf, 1), x_nd.dtype),
                ],
                axis=1,
            )
            return x
        x = jax.scipy.linalg.cho_solve(
            coarse_cf, r_pad.reshape(-1).astype(coarse_cf[0].dtype)
        )
        return x.reshape(nf, m0 + 1)

    def coarse_solve(bp0_hat):
        # Hhat_0^{-1} = S_0^{-1} H_0^{-1} S_0^{-1}; the factor is the
        # UNSCALED f64 factorization (dense Cholesky or ND multifrontal),
        # so the exact coarse solve is untouched by the scaling (solve at
        # factor precision, return at cycle precision)
        if use_scaled:
            r = (bp0_hat.astype(s0_inv.dtype) * s0_inv)
            x = _coarse_direct(r.astype(bp.dtype)).astype(s0_inv.dtype)
            x = (x * s0_inv).astype(f32c)
        else:
            x = _coarse_direct(bp0_hat.astype(bp.dtype)).astype(f32c)
        return x.at[:, m0].set(0.0)

    def precond(r):
        rhat = ((r * s_fine) if use_scaled else r).astype(f32c)
        out = vcycle(
            systems32,
            minvs32,
            lmaxs32,
            embeds32,
            coarse_solve,
            rhat,
            nf,
            degree=degree,
        )
        out = out.astype(bp.dtype)
        return s_fine * out if use_scaled else out

    b2 = jnp.vdot(bp, bp)
    eps = jnp.asarray(jnp.finfo(bp.dtype).tiny, dtype=bp.dtype)

    # Progress is measured by the QUADRATIC MODEL q(x) = x'Hx/2 - b'x, not
    # by the residual norm.  Healthy PCG decreases q monotonically by
    # dq = rz^2/(2 pAp) per step even while ||r|| wanders above ||b|| for
    # dozens of iterations (measured on barrier endgame systems,
    # tools/debug_handoff.py), and -2q is exactly the captured Newton
    # decrement — so the last healthy iterate is ALWAYS the right thing to
    # return, with b'x > 0 guaranteeing a descent direction.  Residual-based
    # best-iterate tracking (the round-1 design) returned the ZERO vector on
    # wandering-but-solvable systems, silently no-op'ing the Newton step.
    #
    # Exits:
    # * converged: recursive residual below rtol*||b||.
    # * breakdown (healthy=False): pAp or rz non-positive — the
    #   preconditioner or H itself lost positive-definiteness at working
    #   precision (the deep f64 floor, cond ~ 1/eps).  The guarded update
    #   (alpha = 0 on a bad step) means x is still the last valid iterate;
    #   at the genuine floor that is the zero vector, and a zero Newton
    #   step there IS the converged state (_path_follow stop-code
    #   semantics).
    # * q-stagnation: `stagnation` consecutive steps each capturing less
    #   than q_eps of the accumulated decrement — nothing more is
    #   extractable at working precision; return what was captured.
    # * floor bail: at cond(H) ~ 1/eps the recursive residual decouples
    #   from the true one and fake q-decrements accumulate forever (rounding
    #   noise), so CG would burn maxiter.  The floor's observable signature
    #   is the residual never dropping below ||b|| (solvable-hard systems
    #   dip below by ~iteration 17, measured); bail at `floor_cap` in that
    #   case and return the CURRENT iterate — if it is garbage the line
    #   search rejects it and the Newton loop reports an explicit LOCKED,
    #   never a silent no-op.
    # With the truncated (exact-coarse) cycle the stagnation exit is
    # disabled by default: the last ~1e-5..1e-8 of the Newton decrement
    # arrives slowly through the spread spectrum and q-stagnation was
    # measured to be exactly what froze the depth ceiling (see the
    # truncation comment at the top).  The floor bail and breakdown
    # guards still bound the beyond-f64 burn.
    q_eps = jnp.asarray(
        float(
            os.environ.get("MGB_CG_QEPS", "0" if n_drop else "1e-5")
        ),
        dtype=bp.dtype,
    )
    # With the Schwarz smoother, mid-path solves legitimately wander above
    # ||b|| for ~30-80 iterations before collapsing (measured fem2d L=5);
    # the floor bail must sit above that, while still bounding the
    # beyond-f64 deep-floor burn.
    floor_cap = int(
        os.environ.get("MGB_CG_FLOOR_CAP", str(max(2 * stagnation, 96)))
    )

    # Warm start from the previous Newton step's direction (x0_in).  Deep
    # in the barrier endgame consecutive Newton systems change slowly
    # (alpha ~ 1 steps of shrinking size), so the previous direction
    # already captures most of the new system's decrement and CG only has
    # to solve for the correction — the saturated 200-iteration tails
    # collapse to tens of iterations.  Guards below:
    # * accept the warm start only if it is a DESCENT direction whose
    #   captured decrement is positive (q(x0) < 0); otherwise start cold —
    #   a stale/garbage start would otherwise be returned on an immediate
    #   breakdown and turn the "zero step == converged floor" semantics
    #   into a wrong-direction Newton step.
    # * q accumulation starts at q(x0) so the quadratic-model exits keep
    #   measuring TOTAL captured decrement.
    if x0_in is not None:
        Ax0 = Aop(x0_in)
        q_x0 = 0.5 * jnp.vdot(x0_in, Ax0) - jnp.vdot(bp, x0_in)
        ok0 = jnp.isfinite(q_x0) & (q_x0 < 0)
        x0 = jnp.where(ok0, x0_in, 0.0)
        r0 = jnp.where(ok0, bp - Ax0, bp)
        q0 = jnp.where(ok0, q_x0, 0.0)
    else:
        x0 = jnp.zeros_like(bp)
        r0 = bp
        q0 = jnp.asarray(0.0, dtype=bp.dtype)
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)
    healthy0 = (rz0 > 0) & jnp.isfinite(rz0)
    state0 = (x0, r0, p0, rz0, 0, q0, 0, healthy0, b2)

    def cond(state):
        x, r, p, rz, it, q, stagq, healthy, rb2 = state
        converged = jnp.vdot(r, r) <= rtol * rtol * b2 + eps
        at_floor = (rb2 >= b2) & (it >= floor_cap)
        return (
            (~converged)
            & healthy
            & (~at_floor)
            & (it < maxiter)
            & (stagq < stagnation)
        )

    def body(state):
        x, r, p, rz, it, q, stagq, healthy, rb2 = state
        Ap = Aop(p)
        pAp = jnp.vdot(p, Ap)
        ok_step = (pAp > 0) & (rz > 0) & jnp.isfinite(pAp)
        alpha = jnp.where(ok_step, rz / (pAp + eps), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rb2 = jnp.minimum(rb2, jnp.vdot(r, r))
        dq = 0.5 * alpha * rz  # q decrease this step; >= 0 by construction
        q = q - dq
        stagq = jnp.where(dq > q_eps * (-q) + eps, 0, stagq + 1)
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        healthy = ok_step & (rz_new > 0) & jnp.isfinite(rz_new)
        beta = rz_new / (rz + eps)
        p = z + beta * p
        return x, r, p, rz_new, it + 1, q, stagq, healthy, rb2

    # -- Ritz deflation (MGB_CG_DEFLATE = k, 0 disables) ------------------
    # Root cause of the measured depth ceiling (fem2d L>=6: best c
    # 15.4192 vs exact 15.4183): the Schwarz+Chebyshev-smoothed operator
    # M^-1 H carries a handful of outlier eigenvalues (lmax cluster
    # 300-900 over an O(1) bulk, CLAUDE.md round-2) plus near-floor small
    # modes; CG keeps re-discovering those extremes every solve and the
    # q-stagnation exit fires before the decrement in that subspace is
    # captured.  Fix: run a HARVEST phase of plain PCG whose iterates
    # double as the preconditioned Lanczos process — v_j = z_j/sqrt(r_j'
    # z_j) are M-orthonormal Lanczos vectors of M^-1 H and the CG
    # scalars give the tridiagonal T (T[j,j] = 1/a_j + b_{j-1}/a_{j-1},
    # T[j,j+1] = sqrt(b_j)/a_j) — then restart CG on the Vuik/
    # Nicolaides-deflated system with W = the extreme Ritz vectors:
    #     P = I - H W E^+ W',  E = W' H W,
    #     r <- P r each step, final x += W E^+ W'(b - H x).
    # The W-space correction solves the outlier subspace DIRECTLY (a kxk
    # eigh-pseudoinverse, robust at the f64 floor), so the restarted CG
    # only faces the clustered bulk.  Monotonicity of the captured
    # decrement is preserved: the initial Q-correction is the exact
    # minimizer of q over x1 + span(W), and the projected iteration
    # decreases the projected q by a*rz/2 per step as before.
    # default 0: measured-REJECTED as a depth fix — see the
    # MGB_CG_DEFLATE registry entry (options.py) for the A/B record
    deflate_k = int(os.environ.get("MGB_CG_DEFLATE", "0"))
    K1 = min(int(os.environ.get("MGB_CG_HARVEST", "40")), maxiter)
    if deflate_k <= 0 or K1 < deflate_k + 4:
        x, r, p, rz, it, q, stagq, healthy, rb2 = jax.lax.while_loop(
            cond, body, state0
        )
        rel = jnp.sqrt(jnp.vdot(r, r) / (b2 + eps))
        return x.at[:, fine.m].set(0.0), it, rel, lmaxs_out

    k_defl = deflate_k
    Vbuf0 = jnp.zeros((K1 + 1,) + bp.shape, dtype=bp.dtype)
    Vbuf0 = Vbuf0.at[0].set(z0 / jnp.sqrt(jnp.maximum(rz0, eps)))
    al0 = jnp.zeros(K1, dtype=bp.dtype)
    be0 = jnp.zeros(K1, dtype=bp.dtype)

    def cond1(state):
        return cond(state[0]) & (state[0][4] < K1)

    def body1(state):
        inner, Vbuf, al, be = state
        x, r, p, rz, it, q, stagq, healthy, rb2 = inner
        inner2 = body(inner)
        x2, r2, p2, rz2, it2, q2, stagq2, healthy2, rb22 = inner2
        # recover this step's alpha/beta from the state transition
        alpha = jnp.where(rz > 0, (q - q2) * 2.0 / jnp.maximum(rz, eps),
                          0.0)
        beta = rz2 / (rz + eps)
        al = al.at[it].set(alpha)
        be = be.at[it].set(beta)
        z2 = p2 - beta * p  # z of the NEXT iteration (body: p = z + b p)
        Vbuf = Vbuf.at[it + 1].set(
            z2 / jnp.sqrt(jnp.maximum(rz2, eps))
        )
        return inner2, Vbuf, al, be

    (inner1, Vbuf, al, be) = jax.lax.while_loop(
        cond1, body1, (state0, Vbuf0, al0, be0)
    )
    x1, r1, p1, rz1, it1, q1, stagq1, healthy1, rb21 = inner1
    converged1 = jnp.vdot(r1, r1) <= rtol * rtol * b2 + eps
    # valid Lanczos steps: alphas 0..it1-1 and vectors 0..it1
    jidx = jnp.arange(K1)

    def phase2(_):
        valid = jidx < it1
        a_safe = jnp.where(valid & (al > 0), al, 1.0)
        b_prev = jnp.concatenate([jnp.zeros(1, bp.dtype), be[:-1]])
        a_prev = jnp.concatenate([jnp.ones(1, bp.dtype), a_safe[:-1]])
        diag = 1.0 / a_safe + b_prev / a_prev
        # padding rows get a sentinel above any real eigenvalue (lmax of
        # the smoothed operator is measured O(1e3)) so their zero-vector
        # eigenpairs are never selected at the smallest end; a padding
        # pair selected at the largest end contributes a zero column to
        # W, which the eigh-pseudoinverse of E ignores.
        diag = jnp.where(valid, diag, 1e8)
        offd = jnp.where(
            jidx[:-1] < it1 - 1,
            jnp.sqrt(jnp.maximum(be[:-1], 0.0)) / a_safe[:-1],
            0.0,
        )
        T = jnp.diag(diag) + jnp.diag(offd, 1) + jnp.diag(offd, -1)
        theta, Y = jnp.linalg.eigh(T)  # ascending
        # Which extreme to deflate: the TOP Ritz pairs by default — the
        # measured pathology is the lmax outlier cluster (300-900 over
        # an O(1) bulk), and large Ritz pairs are the first to converge
        # in a 40-step Lanczos process, so their vectors are accurate.
        # Small Ritz pairs converge SLOWEST; deflating half-converged
        # small modes injects the E^+ solve's error exactly into the
        # near-null directions that carry the remaining Newton decrement
        # (the same failure mode as a Levenberg shift, dense_solve doc)
        # — measured at fem2d L=6: a 6-small/2-large split converged
        # SHALLOWER than no deflation (c 15.41963 vs 15.4192).
        k_lo = int(os.environ.get("MGB_CG_DEFLATE_LO", "0"))
        k_lo = min(k_lo, k_defl)
        k_hi = k_defl - k_lo
        sel = jnp.concatenate([jidx[:k_lo], jidx[K1 - k_hi:]])
        Ysel = Y[:, sel]  # (K1, k)
        # W = V @ Ysel over the valid vectors (padding rows of V are 0)
        W = jnp.einsum("jk,j...->k...", Ysel, Vbuf[:K1])  # (k, nf, m+1)
        HW = jax.vmap(Aop)(W)
        E = jnp.einsum("k...,l...->kl", W, HW)
        ew, U = jnp.linalg.eigh(E)
        ew_floor = jnp.maximum(jnp.max(jnp.abs(ew)), eps) * (
            100.0 * jnp.finfo(bp.dtype).eps
        )
        ew_inv = jnp.where(ew > ew_floor, 1.0 / ew, 0.0)

        def Einv(v):  # (k,) -> (k,) pseudo-inverse apply
            return U @ (ew_inv * (U.T @ v))

        def wdot(arr):  # (k, ...) x (...) -> (k,)
            return jnp.einsum("k...,...->k", W, arr)

        def correct(xc):
            """x + W E^+ W'(b - H x): exact q-minimizer over x + span W."""
            rc = bp - Aop(xc)
            return (
                xc + jnp.einsum("k,k...->...", Einv(wdot(rc)), W),
                rc,
            )

        def proj(v):  # P v = v - H W E^+ W' v
            return v - jnp.einsum("k,k...->...", Einv(wdot(v)), HW)

        x20, r20raw = correct(x1)
        r20 = proj(r20raw)
        z20 = precond(r20)
        rz20 = jnp.vdot(r20, z20)
        healthy20 = (rz20 > 0) & jnp.isfinite(rz20)
        st0 = (x20, r20, z20, rz20, it1, q1, 0, healthy20, rb21)

        def body2(state):
            x, r, p, rz, it, q, stagq, healthy, rb2 = state
            Ap = proj(Aop(p))
            pAp = jnp.vdot(p, Ap)
            ok_step = (pAp > 0) & (rz > 0) & jnp.isfinite(pAp)
            alpha = jnp.where(ok_step, rz / (pAp + eps), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            rb2 = jnp.minimum(rb2, jnp.vdot(r, r))
            dq = 0.5 * alpha * rz
            q = q - dq
            stagq = jnp.where(dq > q_eps * (-q) + eps, 0, stagq + 1)
            z = precond(r)
            rz_new = jnp.vdot(r, z)
            healthy = ok_step & (rz_new > 0) & jnp.isfinite(rz_new)
            beta = rz_new / (rz + eps)
            p = z + beta * p
            return x, r, p, rz_new, it + 1, q, stagq, healthy, rb2

        x2, r2, p2, rz2, it2, q2, stagq2, healthy2, rb22 = (
            jax.lax.while_loop(cond, body2, st0)
        )
        # final W-space correction; keep it only if it is finite AND did
        # not worsen the true residual (floor regimes can make the k x k
        # solve noise-dominated)
        x2c, _ = correct(x2)
        r2c = bp - Aop(x2c)
        ok = jnp.all(jnp.isfinite(x2c)) & (
            jnp.vdot(r2c, r2c) <= jnp.vdot(r2, r2)
        )
        xf = jnp.where(ok, x2c, x2)
        rf = jnp.where(ok, r2c, r2)
        return xf, rf, it2

    def no_phase2(_):
        return x1, r1, it1

    run2 = (~converged1) & healthy1 & (it1 >= k_defl + 4)
    xf, rf, itf = jax.lax.cond(run2, phase2, no_phase2, None)
    rel = jnp.sqrt(jnp.vdot(rf, rf) / (b2 + eps))
    return xf.at[:, fine.m].set(0.0), itf, rel, lmaxs_out
