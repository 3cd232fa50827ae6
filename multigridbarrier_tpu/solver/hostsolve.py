"""Host sparse direct Newton solver with factor reuse — one of the
fine-level MUMPS replacements (SURVEY.md §3.5) for subspaces too large
for the on-device dense Cholesky.

Place in the CURRENT solver hierarchy (amgb._run_level routing): the
production default for fine levels is the ON-DEVICE nested-dissection
multifrontal solver (`solver/ndsolve.py`, MGB_FINE_SOLVER=nd) — this
host-SuperLU path is the `MGB_FINE_SOLVER=host` alternative (useful on
CPU backends and as an exact-direction A/B reference), and
`MGB_FINE_SOLVER=mgcg` (`solver/linsolve.py`) is the sharded scale-out
fallback.  Coarse levels always use the dense Cholesky+IR solver.

Why a HOST direct solver on an accelerator framework
----------------------------------------------------
Mid-path barrier Hessians are numerically singular (cond 1e15+) with a
*physically meaningful* soft tail: the exact solver resolves it, while no
smoother-preconditioned iteration can (measured: 400 f64 PCG iterations
with Jacobi/additive/multiplicative-Schwarz smoothers all stall at
rel ~ 1 on a captured fem2d mid-path system, tools/probe_mult_schwarz.py).
The reference faces the same wall and leans on MUMPS — a *host CPU*
sparse direct solver (reference src/MultiGridBarrierMPI.jl:233-247,
docs/src/guide.md:221-238).  The accelerator translation of that design:

* the per-Newton-step FLOPs (barrier derivatives, element Hessian
  contractions, line-search evaluations) stay on device as fused
  batched contractions (amgb._build_host_pre/_build_host_post);
* the device reduces element Hessians to *deduplicated sparse values*
  with one segment-sum over a static field-pair table (HostPattern), so
  only the nnz values — not the element tensors — cross the link;
* the host holds a cached sparse LU factor and solves each step with
  factor-preconditioned CG, refactoring only when the factor goes stale.

Factor reuse is what makes this cheap: by self-concordance, consecutive
Newton Hessians along the path are spectrally equivalent, so a 1-step-
stale f64 factor preconditions CG to 1e-9 in 8-25 iterations across the
WHOLE path (cond 1e5 -> 1e19; measured, tools/probe_factor_reuse.py),
tail included.  A refactor is then only needed every few Newton steps —
amortizing the dominant factorization cost — and each CG iteration is a
host SpMV + two sparse triangular solves, milliseconds at L=8 scale.

The path does not use host callbacks inside jit: the Newton loop for
host-solved levels runs step-per-step from the host (amgb.run_level).
"""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


class HostPattern:
    """Static sparsity pattern of one level's global Newton matrix
    H[f1*(m+1)+i, f2*(m+1)+j], plus the device-side segment table that
    reduces element Hessians to its value array.

    full_ids: (nelem, C, C) int32, C = nf*nl — segment ids such that
        segment_sum(He.reshape(-1), full_ids.reshape(-1), nseg) yields the
        deduplicated value array `vals` (one slot per structurally nonzero
        (field-pair, node-pair)); built from the same inverse-unique pair
        construction as runtime.elements.node_pair_table.
    csr(vals): fills the prebuilt scipy CSR in O(nnz) (no sorting): the
        pattern stores the permutation from segment order to CSR order.
    Pad dofs (node id m per field) carry an identity diagonal exactly like
    linsolve.dense_assemble, keeping H SPD on the padded space.
    """

    def __init__(self, idx: np.ndarray, m: int, nf: int):
        idx = np.asarray(idx)
        nelem, nl = idx.shape
        self.m, self.nf = int(m), int(nf)
        keys = (
            idx[:, :, None].astype(np.int64) * (m + 1) + idx[:, None, :]
        ).reshape(-1)
        uniq, inv = np.unique(keys, return_inverse=True)
        nuniq = len(uniq)
        self.nseg = nf * nf * nuniq
        fid = (
            np.arange(nf, dtype=np.int64)[:, None] * nf
            + np.arange(nf, dtype=np.int64)[None, :]
        ) * nuniq
        full = (
            fid[None, :, None, :, None]
            + inv.reshape(nelem, nl, nl)[:, None, :, None, :].astype(np.int64)
        )
        C = nf * nl
        # (nelem, nf, nl, nf, nl) -> (nelem, C, C) with c = f*nl + a: the
        # axes are already in slot-major order, a straight reshape
        self.full_ids = full.reshape(nelem, C, C).astype(np.int32)

        # global COO of the segment slots
        g = np.arange(self.nseg, dtype=np.int64)
        f1 = g // (nf * nuniq)
        f2 = (g // nuniq) % nf
        pid = g % nuniq
        i = uniq[pid] // (m + 1)
        j = uniq[pid] % (m + 1)
        rows = f1 * (m + 1) + i
        cols = f2 * (m + 1) + j
        N = nf * (m + 1)
        self.N = N

        # pad-diagonal identity entries: reuse the (m, m) pair slots if the
        # mesh produced them (any element with a pad slot), else append
        mm = m * (m + 1) + m
        pos_mm = np.searchsorted(uniq, mm)
        have_mm = pos_mm < nuniq and uniq[pos_mm] == mm
        extra = 0 if have_mm else nf
        if not have_mm:
            f = np.arange(nf, dtype=np.int64)
            rows = np.concatenate([rows, f * (m + 1) + m])
            cols = np.concatenate([cols, f * (m + 1) + m])
        self.n_extra = extra

        order = np.lexsort((cols, rows))
        r_sorted = rows[order]
        self._order = order
        self._indices = cols[order].astype(np.int32)
        self._indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(r_sorted, minlength=N))]
        ).astype(np.int64)
        # CSR positions of the nf pad-diagonal entries (for the +1.0)
        if have_mm:
            pad_g = (np.arange(nf, dtype=np.int64) * nf + np.arange(nf)) * nuniq + pos_mm
        else:
            pad_g = self.nseg + np.arange(nf, dtype=np.int64)
        inv_order = np.empty_like(order)
        inv_order[order] = np.arange(len(order))
        self._pad_pos = inv_order[pad_g]
        self._A = sp.csr_matrix(
            (np.zeros(len(order)), self._indices, self._indptr), shape=(N, N)
        )

    def fill(self, vals: np.ndarray) -> sp.csr_matrix:
        """Fill the shared CSR with a fresh value array (O(nnz))."""
        if self.n_extra:
            vals = np.concatenate([vals, np.zeros(self.n_extra)])
        self._A.data[:] = vals[self._order]
        self._A.data[self._pad_pos] += 1.0
        return self._A


class HostDirectLevel:
    """Per-level host solver state: cached LU factor + reuse policy.

    solve(vals, b, x0) returns (x, its, rel):
    * fresh factor: direct solve + 2 rounds of iterative refinement with
      the exact (unshifted) matrix — MUMPS-grade backward stability, the
      reason direct methods shrug off cond ~ 1/eps Newton systems
      (see linsolve.dense_solve docstring).
    * stale factor: factor-preconditioned CG (quadratic-model guarded, as
      mgcg_solve) until rtol or `stale_cap` iterations; past the cap, the
      factor is declared stale, rebuilt, and the solve finishes direct.
    Factorization failures (exactly singular pivot at the deep f64 floor)
    escalate through diagonal shifts exactly like dense_solve; a solve
    that still fails returns zeros (-> LOCKED at the line search, the
    accepted floor semantics)."""

    def __init__(
        self,
        pattern: HostPattern,
        rtol: float = 1e-9,
        stale_cap: int = 40,
        shifts=(0.0, 500, 50000),
    ):
        self.pattern = pattern
        self.rtol = float(rtol)
        self.stale_cap = int(stale_cap)
        self.shifts = shifts
        self.lu = None
        self.n_factor = 0
        self.n_solve = 0
        self.t_factor = 0.0
        self.t_solve = 0.0
        # relative residual the last fresh direct+IR solve achieved —
        # the attainable-accuracy tracker behind the adaptive stale-PCG
        # acceptance bar (see _solve)
        self.rel_bar = float(rtol)
        # online unit costs for the self-tuning PCG budget (_cap)
        self.t_pcg = 0.0
        self.n_pcgit = 0

    # SuperLU mode: the Newton matrices are SPD, so symmetric-mode
    # ordering (MMD on A+A', diagonal pivoting) gives a fill that is a
    # property of the SPARSITY PATTERN alone.  Default partial pivoting
    # re-routes pivots on ill-conditioned mid-path matrices and the fill
    # explodes with conditioning: measured at fem2d L=7 (N=32k), default
    # COLAMD factors the benign t=1 matrix in 0.9s but mid-path matrices
    # in 7-10s, while symmetric mode is a flat 2.8s on both.  Diagonal
    # pivoting on a cond ~1e15 matrix is backstopped by the isfinite
    # check, iterative refinement, and a one-shot partial-pivoting
    # fallback when the refined residual is still poor.
    _SYM_KW = dict(
        permc_spec="MMD_AT_PLUS_A",
        diag_pivot_thresh=0.0,
        options=dict(SymmetricMode=True),
    )

    def _refactor(self, A: sp.csr_matrix, pivot: bool = False):
        t0 = time.perf_counter()
        eps = np.finfo(np.float64).eps
        Ac = A.tocsc()
        kw = {} if pivot or os.environ.get(
            "MGB_HOST_ORDERING"
        ) == "colamd" else self._SYM_KW
        for s in self.shifts:
            try:
                M = Ac if s == 0.0 else (
                    Ac + sp.diags(s * eps * Ac.diagonal())
                ).tocsc()
                lu = spla.splu(M, **kw)
                # reject factors with non-finite entries (splu can succeed
                # structurally yet overflow on a floor-singular matrix)
                if not (
                    np.all(np.isfinite(lu.U.data))
                    and np.all(np.isfinite(lu.L.data))
                ):
                    continue
                self.lu = lu
                # diagonal at factorization time: stale applications
                # rescale by S = sqrt(d_now/d_factor), which captures the
                # dominant endgame drift (barrier weights blowing up at
                # active constraints are a row/col scaling to first
                # order) and extends factor life accordingly
                self.d_fact = np.maximum(Ac.diagonal(), 1e-300)
                self.n_factor += 1
                self.t_factor += time.perf_counter() - t0
                return True
            except RuntimeError:
                continue
        self.t_factor += time.perf_counter() - t0
        if not pivot and not kw == {}:
            # symmetric-mode diagonal pivoting can fail outright on a
            # floor-singular matrix where threshold pivoting survives
            return self._refactor(A, pivot=True)
        return False

    def _direct(self, A, b):
        x = self.lu.solve(b)
        for _ in range(2):
            x = x + self.lu.solve(b - A @ x)
        return x

    def _pcg(self, A, b, x0, maxiter, rel_target=None):
        """Factor-preconditioned CG, quadratic-model guarded (the captured
        Newton decrement -2q is the progress measure; see mgcg_solve).
        Jacobi-rescaling the stale factor toward the current diagonal
        was tried and measured-REJECTED (fem2d L=6: 189 refactors vs 131
        plain, +20 percent wall) -- the rescaling perturbs the inactive
        subspace where the stale factor is still exact."""
        rt = self.rtol if rel_target is None else rel_target
        rtol2 = rt * rt * (b @ b)
        t0 = time.perf_counter()
        try:
            out = self._pcg_inner(A, b, x0, maxiter, rtol2)
            self.n_pcgit += out[1]
            return out
        finally:
            self.t_pcg += time.perf_counter() - t0

    def _pcg_inner(self, A, b, x0, maxiter, rtol2):
        if x0 is not None and np.all(np.isfinite(x0)):
            x = x0.copy()
            r = b - A @ x
            if 0.5 * (x @ (b - r)) - b @ x >= 0:  # not a descent start
                x = np.zeros_like(b)
                r = b.copy()
        else:
            x = np.zeros_like(b)
            r = b.copy()
        z = self.lu.solve(r)
        p = z.copy()
        rz = r @ z
        for it in range(maxiter):
            if r @ r <= rtol2:
                return x, it, False
            if not np.isfinite(rz) or rz <= 0:
                return x, it, True
            Ap = A @ p
            pAp = p @ Ap
            if not np.isfinite(pAp) or pAp <= 0:
                return x, it, True
            al = rz / pAp
            x += al * p
            r -= al * Ap
            z = self.lu.solve(r)
            rz_new = r @ z
            p = z + (rz_new / rz) * p
            rz = rz_new
        return x, maxiter, False

    def solve(self, vals: np.ndarray, b: np.ndarray, x0=None):
        t0 = time.perf_counter()
        try:
            return self._solve(vals, b, x0)
        finally:
            self.t_solve += time.perf_counter() - t0

    def _cap(self) -> int:
        """Self-tuning stale-PCG budget: spend up to ~one refactor's
        worth of wall time on stale-factor iterations before paying the
        refactor (equal marginal cost).  Both unit costs are measured
        online; stale_cap is the floor and 4x stale_cap the ceiling.
        At fem2d L=6 (factor 0.3s, CG it 8ms) this lands at the old
        fixed 40; at L=7 (factor 2.8s, CG it 26ms) it rises to ~100,
        exactly where expensive factors want a harder-working PCG."""
        if self.n_factor == 0 or self.n_pcgit < 8:
            return self.stale_cap
        t_fac = self.t_factor / self.n_factor
        t_it = max(self.t_pcg / self.n_pcgit, 1e-5)
        return int(min(max(self.stale_cap, t_fac / t_it), 4 * self.stale_cap))

    def _rel(self, A, b, x):
        if x is None or not np.all(np.isfinite(x)):
            return np.inf
        return float(
            np.linalg.norm(b - A @ x) / max(np.linalg.norm(b), 1e-300)
        )

    def _solve(self, vals: np.ndarray, b: np.ndarray, x0=None):
        """Stale-factor PCG with an ADAPTIVE acceptance bar, else
        refactor + direct/IR.

        At deep-path conditioning (cond ~ 1/eps) NO solver reaches a
        1e-9 relative residual — a fresh factor's direct+IR solve
        bottoms out at ~eps*cond, and the path-following layer accepts
        that as the f64 floor (lock semantics).  Demanding rtol from the
        stale-PCG stage while accepting the floor from the direct stage
        would force a refactor every Newton step (measured at fem2d
        L=6: 211 factors for 221 solves).  The acceptance bar for the
        stale stage is therefore max(rtol, 4x the relative residual the
        LAST FRESH DIRECT SOLVE achieved) — it tracks the attainable
        accuracy as the path conditioning degrades, and direction
        quality stays within a small factor of a freshly-factored
        solve's.  Refactors use symmetric-mode ordering (flat fill);
        partial pivoting is a fallback for outright factorization
        failure only.  The returned iterate is decrement-best across
        stages (a direct solve of a floor-singular system can be
        garbage the stale-PCG iterate isn't)."""
        A = self.pattern.fill(np.asarray(vals, np.float64))
        b = np.asarray(b, np.float64)
        self.n_solve += 1
        its = 0
        x_st = None
        # cap: a bar above ~1e-2 would accept no-progress iterates
        # outright (a zero vector has rel = 1) — beyond it, always pay
        # the refactor.  The bar also RESETS to rtol at the start of
        # every run_level call (amgb._run_level_host): attainable
        # accuracy is a property of the CURRENT (t, level) conditioning,
        # and a floor-grade bar carried from a previous endgame would
        # fake-converge an entire fresh path (measured: fem2d L=6 timed
        # rerun collapsed to 44 its / wrong objective before the reset).
        bar = min(max(self.rtol, 4.0 * self.rel_bar), 1e-2)
        if self.lu is not None:
            x_st, its, _broke = self._pcg(A, b, x0, self._cap(), bar)
            rel_st = self._rel(A, b, x_st)
            if rel_st <= bar:
                return x_st, its, rel_st
        if not self._refactor(A) and not self._refactor(A, pivot=True):
            if x_st is None:
                return np.zeros_like(b), its, np.inf
            return x_st, its, self._rel(A, b, x_st)
        x_d = self._direct(A, b)
        rel_d = self._rel(A, b, x_d)
        if np.isfinite(rel_d):
            self.rel_bar = rel_d
        x = self._better(A, b, x_d, x_st)
        if not np.all(np.isfinite(x)):
            x = np.zeros_like(b)
        return x, its, self._rel(A, b, x)

    def _better(self, A, b, x1, x2):
        """The iterate with the smaller captured quadratic q(x) =
        x'Ax/2 - b'x (equivalently larger Newton decrement)."""
        if x2 is None or not np.all(np.isfinite(x2)):
            return x1
        if x1 is None or not np.all(np.isfinite(x1)):
            return x2
        q1 = 0.5 * (x1 @ (A @ x1)) - b @ x1
        q2 = 0.5 * (x2 @ (A @ x2)) - b @ x2
        return x1 if q1 <= q2 else x2
