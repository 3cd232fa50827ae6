"""Exact spectrum of the MG-CG preconditioned operator on a tiny system.

Builds the fem1d L=4 forced-MGCG scenario (dense_threshold=8), walks the
barrier path to a chosen t, assembles the fine-level Newton system at the
solver's own iterate, and — because the subspace is only ~15 dofs —
forms the V-cycle preconditioner and the Schwarz smoother as DENSE
matrices and eigendecomposes them exactly.  This separates "Chebyshev
window mistargeted" from "preconditioner indefinite/degenerate" without
guessing from CG behavior.

Env: MGB_PROBE_T (default 1e7), MGB_SMOOTHER/MGB_SCHWARZ_LIFT etc. as in
the solver.
"""

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

T_PROBE = float(os.environ.get("MGB_PROBE_T", "1e7"))

b1 = Backend(dtype=jnp.float64, dense_threshold=8)
g = mgb.fem1d(L=4, backend=b1)
sol = mgb.amgb(g, p=2.0, tol=1e-7)
z = sol.z
print("solver its", sol.SOL_main.its.tolist(), "c", float(sol.SOL_main.c_dot_Dz[-1]))

spec = A._normalize_D(A.default_D(g.dim))
Q = A.default_Q(g.dim, 2.0)
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
t = jnp.asarray(T_PROBE, dtype=dtype)
# the Newton Hessian is t-independent of scaling here except through z;
# we probe the system the solver faced at its own final iterate
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
# drop pad rows/cols for spectra (they carry identity)
keep = np.array([f * (m + 1) + i for f in range(nf) for i in range(m)])
Hr = H[np.ix_(keep, keep)]
ew = np.linalg.eigvalsh(Hr)
print(f"H spectrum: min {ew.min():.3e} max {ew.max():.3e} cond {ew.max()/max(ew.min(),1e-300):.3e}")

# --- replicate mgcg_solve's scaled f32 setup --------------------------------
dinvs = [1.0 / LS.diag_of(s) for s in systems]
svecs = [jnp.sqrt(d) for d in dinvs]
f32c = jnp.float32
systems32 = []
for s_, sv in zip(systems, svecs):
    nelem_l, nl_l = s_.idx.shape
    se = sv[:, s_.idx].transpose(1, 0, 2).reshape(nelem_l, nf * nl_l)
    He_hat = (s_.He * se[:, :, None] * se[:, None, :]).astype(f32c)
    systems32.append(s_._replace(He=He_hat))

fine32 = systems32[-1]
st = LS.schwarz_setup(fine32, nf)
print("we stats: min %.3e max %.3e" % (float(st.we.min()), float(st.we.max())))


def apply_dense(fun, N, dtype=np.float64):
    cols = []
    for i in range(N):
        e = np.zeros((N,), dtype=np.float32)
        e[i] = 1.0
        cols.append(np.asarray(fun(jnp.asarray(e.reshape(nf, m + 1)))).reshape(-1))
    return np.stack(cols, axis=1).astype(dtype)


Hhat = apply_dense(lambda v: LS.hvp(fine32, v), N)
Minv = apply_dense(lambda v: LS.schwarz_apply(fine32, st, v), N)
Hr32 = Hhat[np.ix_(keep, keep)]
Mr = Minv[np.ix_(keep, keep)]
Mr = 0.5 * (Mr + Mr.T)
ewM = np.linalg.eigvalsh(Mr)
print(f"M^-1 spectrum: min {ewM.min():.3e} max {ewM.max():.3e}")
# generalized: eig of M^-1 H
evs = np.linalg.eigvals(Mr @ Hr32)
evs = np.sort(evs.real)
print("M^-1 H spectrum: min5", evs[:5], "max5", evs[-5:])
lm = LS.lambda_max_est(fine32, lambda r: LS.schwarz_apply(fine32, st, r), iters=6)
print("lambda_max_est:", float(lm), " true:", evs[-1])
ratio = LS._CHEB_RATIO
print(f"cheb window: [{evs[-1]/ratio:.3e}, {evs[-1]*1.05:.3e}]  "
      f"#eigs below window: {(evs < evs[-1]/ratio).sum()}/{len(evs)}")
