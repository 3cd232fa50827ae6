"""Exact spectrum of the full MG-CG V-cycle preconditioned operator (fem2d).

The mgcg depth ceiling (VERDICT r3 item 4): at L>=6 the sharded-fallback
MG-CG lands ~6e-5 relative shallow; mid-path CG saturates maxiter.  This
probe answers the design question "is the preconditioned spectrum a few
deflatable outliers, or broadly spread?" by forming the V-cycle
preconditioner P^-1 (exactly as mgcg_solve builds it: scaled f32 cycle,
Schwarz smoothing, dense coarse solve) as a DENSE matrix on a small fem2d
problem and eigendecomposing P^-1 H.

Walks the true barrier path with the default (exact-direction) solver,
then re-assembles the fine-level Newton system at the solver's own final
iterate — the endgame regime — and optionally at a mid-path iterate via
MGB_PROBE_STOP_T (capture the iterate when the path first reaches that t).

Run: python tools/probe_mgcg_spectrum.py --L 4
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax
import jax.numpy as jnp

import importlib

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.backend import Backend

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")
LS = importlib.import_module("multigridbarrier_tpu.solver.linsolve")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=None,
                    help="loose tol stops the path mid-way: the probe "
                    "then sees a mid-path-conditioned Hessian")
    args = ap.parse_args()

    b1 = Backend(dtype=jnp.float64)
    g = mgb.fem2d(L=args.L, backend=b1)
    sol = mgb.amgb(g, p=args.p, tol=args.tol)
    z = sol.z
    print("solver its", sol.SOL_main.its.tolist(),
          "c", float(sol.SOL_main.c_dot_Dz[-1]))

    spec = A._normalize_D(A.default_D(g.dim))
    Q = A.default_Q(g.dim, args.p)
    dtype = g.x.dtype
    ffun = A.default_f(g.dim, dtype)
    c = jax.vmap(lambda xi: jnp.asarray(ffun(xi), dtype=dtype))(g.x)
    ctx = A._get_ctx(g, spec, Q.barrier, c, subspace="dirichlet", x=g.x)
    level = ctx.levels - 1
    nf, k = spec.nfields, spec.k

    Ps, bases, embeds, rloc = ctx._level_args(level)
    basis = bases[-1]
    sub_levels = ctx._sub_levels(level)
    F2 = jax.hessian(Q.barrier, argnums=1)
    y = A._apply_D(ctx.ops, spec, jnp.asarray(z, dtype=dtype))
    Y2w = jax.vmap(F2)(ctx.x, y) * ctx.w[:, None, None]
    nelem = Ps[-1].shape[0]
    nq = basis.nq
    Y2w_e = Y2w.reshape(nelem, nq, k, k)
    systems = [
        LS.LevelSystem(
            A._assemble_He(Ps[i], Y2w_e),
            bases[i].idx,
            ctx._bases[sl].m,
            pair_idx=bases[i].pair_idx,
        )
        for i, sl in enumerate(sub_levels)
    ]
    fine = systems[-1]
    m = fine.m
    N = nf * (m + 1)
    print(f"fine m={m}, N={N}, levels={len(systems)}, nelem={nelem}")

    H = np.asarray(LS.dense_assemble(fine, nf))
    keep = np.array([f * (m + 1) + i for f in range(nf) for i in range(m)])
    Hr = H[np.ix_(keep, keep)]
    ew = np.linalg.eigvalsh(Hr)
    print(f"H spectrum: min {ew.min():.3e} max {ew.max():.3e} "
          f"cond {ew.max() / max(ew.min(), 1e-300):.3e}")

    # -- the FULL preconditioner exactly as mgcg_solve builds it ----------
    # reuse mgcg_solve with maxiter=0-ish?  Cleaner: replicate its precond
    # closure by calling mgcg_solve internals through a tiny shim: run one
    # call with maxiter=1 to build, then re-create precond here.
    dinvs = [1.0 / LS.diag_of(s) for s in systems]
    svecs = [jnp.sqrt(d) for d in dinvs]
    f32c = (
        jnp.float64
        if os.environ.get("MGB_CYCLE_DTYPE", "f32") == "f64"
        else jnp.float32
    )
    print("cycle dtype:", f32c.__name__)
    systems32 = []
    for s_, sv in zip(systems, svecs):
        nelem_l, nl_l = s_.idx.shape
        se = sv[:, s_.idx].transpose(1, 0, 2).reshape(nelem_l, nf * nl_l)
        He_hat = (s_.He * se[:, :, None] * se[:, None, :]).astype(f32c)
        systems32.append(s_._replace(He=He_hat))
    sv32 = [sv.astype(f32c) for sv in svecs]
    embeds32 = [
        LS._ScaledTransfer(
            E=E,
            sc=sv32[i][:, : systems[i].m].T,
            sf_inv=(1.0 / sv32[i + 1][:, : systems[i + 1].m]).T,
        )
        for i, E in enumerate(embeds)
    ]
    m0 = systems[0].m
    s0_inv = 1.0 / svecs[0]
    s_fine = svecs[-1]
    coarse_cf = jax.scipy.linalg.cho_factor(
        LS.dense_assemble(systems[0], nf)
    )
    states32 = [None] + [LS.schwarz_setup(s, nf) for s in systems32[1:]]
    minvs32 = [jnp.asarray(1.0, f32c)] + [
        (lambda s=s, st=st: lambda r: LS.schwarz_apply(s, st, r))()
        for s, st in zip(systems32[1:], states32[1:])
    ]
    lmaxs32 = [jnp.asarray(1.0, f32c)] + [
        LS.lambda_max_est(systems32[i], minvs32[i], iters=6).astype(f32c)
        for i in range(1, len(systems))
    ]

    def coarse_solve(bp0_hat):
        r = (bp0_hat.astype(s0_inv.dtype) * s0_inv).reshape(-1)
        x = jax.scipy.linalg.cho_solve(
            coarse_cf, r.astype(coarse_cf[0].dtype)
        ).astype(s0_inv.dtype)
        x = (x.reshape(nf, m0 + 1) * s0_inv).astype(f32c)
        return x.at[:, m0].set(0.0)

    def precond(r):
        rhat = (r * s_fine).astype(f32c)
        out = LS.vcycle(
            systems32, minvs32, lmaxs32, embeds32, coarse_solve,
            rhat, nf, degree=3,
        )
        return s_fine * out.astype(r.dtype)

    pre_j = jax.jit(precond)
    hvp_j = jax.jit(lambda v: LS.hvp(fine, v))

    def apply_dense(fun):
        cols = []
        for i in range(N):
            e = np.zeros((N,), np.float64)
            e[i] = 1.0
            cols.append(
                np.asarray(fun(jnp.asarray(e.reshape(nf, m + 1)))).reshape(-1)
            )
        return np.stack(cols, axis=1)

    P = apply_dense(pre_j)[np.ix_(keep, keep)]
    P = 0.5 * (P + P.T)
    evP = np.linalg.eigvalsh(P)
    print(f"P^-1 (vcycle) spectrum: min {evP.min():.3e} max {evP.max():.3e}")
    evs = np.sort(np.linalg.eigvals(P @ Hr).real)
    print("P^-1 H: min5", evs[:5])
    print("P^-1 H: max10", evs[-10:])
    med = np.median(evs)
    for thr_lo, thr_hi in ((0.5, 2.0), (0.25, 4.0), (0.1, 10.0)):
        n_lo = int((evs < thr_lo * med).sum())
        n_hi = int((evs > thr_hi * med).sum())
        print(f"outliers vs median {med:.3e}: {n_lo} below {thr_lo}x, "
              f"{n_hi} above {thr_hi}x  (N={len(evs)})")


if __name__ == "__main__":
    main()
