"""A/B the smoother family on a real fem2d barrier Hessian.

Builds fem2d L=3/4, walks the barrier path to convergence with the exact
dense solver (ground-truth iterate), assembles the fine Newton system at
a chosen t, then forms DENSE versions of

  * additive PoU Schwarz (current production smoother, schwarz_apply)
  * multiplicative symmetric element-block Schwarz (forward+backward
    sweep over exact principal submatrices, no weights, no lift beyond
    factorization safety)

and prints the generalized spectra of M^-1 H.  The additive variant's
known pathology is outliers ~ w^2/lift from weighted extensions of
block-null directions (see SchwarzState); multiplicative sweeps have no
additive inconsistency and should keep lambda(M^-1 H) in O(1).

Env: MGB_PROBE_L (default 3), MGB_PROBE_T (default 1e5).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib

import jax
import jax.numpy as jnp
import numpy as np

import multigridbarrier_tpu as mgb

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")
LS = importlib.import_module("multigridbarrier_tpu.solver.linsolve")

L = int(os.environ.get("MGB_PROBE_L", "3"))
T_PROBE = float(os.environ.get("MGB_PROBE_T", "1e5"))

backend = mgb.backend_cpu(dense_threshold=1 << 30)
g = mgb.fem2d(L=L, backend=backend)
# stop the path at t_end = 1/tol ~ T_PROBE: the iterate where mid-path CG
# saturation is observed (the FINAL iterate instead sits at the cond-1e17
# f64 floor where H is indefinite at assembly noise and any projection
# analysis is meaningless)
sol = mgb.amgb(g, p=1.0, tol=1.0 / T_PROBE)
z = sol.z
print("exact its", sol.SOL_main.its.tolist(), "c", float(sol.SOL_main.c_dot_Dz[-1]))

spec = A._normalize_D(A.default_D(g.dim))
Q = A.default_Q(g.dim, 1.0)
dtype = g.x.dtype
ffun = A.default_f(g.dim, dtype)
gfun = A.default_g(g.dim, dtype)
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
fine = LS.LevelSystem(
    A._assemble_He(Ps[-1], Y2w_e),
    bases[-1].idx,
    ctx._bases[sub_levels[-1]].m,
    pair_idx=bases[-1].pair_idx,
)
m = fine.m
N = nf * (m + 1)
keep = np.array([f * (m + 1) + i for f in range(nf) for i in range(m)])
print(f"L={L} fine m={m}, N={N}, nelem={nelem}")

H = np.asarray(LS.dense_assemble(fine, nf), dtype=np.float64)
Hr = H[np.ix_(keep, keep)]
ew = np.linalg.eigvalsh(Hr)
print(f"H spectrum: min {ew.min():.3e} max {ew.max():.3e} cond {ew.max()/max(ew.min(),1e-300):.3e}")

# Jacobi symmetric pre-scaling (what mgcg_solve does before the f32 cast);
# analysis stays f64 to separate smoother quality from rounding.
d = np.diag(H).copy()
s = 1.0 / np.sqrt(d)
Hhat = H * s[:, None] * s[None, :]

idx = np.asarray(fine.idx)  # (nelem, nl)
nl = idx.shape[1]
He = np.asarray(fine.He, dtype=np.float64)  # (nelem, C, C) C=nf*nl

# global dof ids per element block, field-major layout f*(m+1)+node
blk = (
    np.arange(nf)[None, :, None] * (m + 1) + idx[:, None, :]
).reshape(nelem, nf * nl)

# scaled principal submatrices B_e = A_e Hhat A_e'
Bs = np.stack([Hhat[np.ix_(b, b)] for b in blk])

# pad-slot columns (node id == m) must not participate
is_pad = (
    np.arange(nf)[None, :, None] * 0 + (idx[:, None, :] == m)
).reshape(nelem, nf * nl)

lift = 1e-4
for e in range(nelem):
    B = Bs[e]
    p = is_pad[e]
    B[p, :] = 0.0
    B[:, p] = 0.0
    B[np.diag_indices_from(B)] += lift + p.astype(np.float64)

Binv = np.linalg.inv(Bs)

# ---- additive PoU Schwarz (production) -------------------------------------
counts = np.zeros(N)
for e in range(nelem):
    counts[blk[e][~is_pad[e]]] += 1.0
w_node = np.where(counts > 0, 1.0 / np.maximum(counts, 1.0), 0.0)
Madd = np.zeros((N, N))
for e in range(nelem):
    b = blk[e]
    W = np.diag(w_node[b] * (~is_pad[e]))
    Madd[np.ix_(b, b)] += W @ Binv[e] @ W
Mr = Madd[np.ix_(keep, keep)]
Hr32 = Hhat[np.ix_(keep, keep)]
evs = np.sort(np.linalg.eigvals(Mr @ Hr32).real)
print(
    f"additive  M^-1 H: min {evs[0]:.3e} p50 {np.median(evs):.3e} "
    f"max {evs[-1]:.3e}  (>8x-below-max: {(evs < evs[-1]/8).sum()}/{len(evs)})"
)

# ---- PCG iteration counts (the metric that matters) -------------------------
# Run actual f64 PCG on Hhat with each candidate M^-1 and count iterations
# to ||r|| <= 1e-9 ||b||.  Spectral analysis is meaningless at cond 1e15;
# CG its are what the solver pays.
rng = np.random.default_rng(0)
b_rhs = rng.standard_normal(N)
b_rhs[[f * (m + 1) + m for f in range(nf)]] = 0.0


def pcg(apply_M, maxiter=400, tol=1e-9):
    x = np.zeros(N)
    r = b_rhs.copy()
    z = apply_M(r)
    p = r @ z and z.copy()
    p = z.copy()
    rz = r @ z
    b2 = b_rhs @ b_rhs
    for it in range(maxiter):
        if r @ r <= tol * tol * b2:
            return it, np.sqrt((r @ r) / b2)
        Ap = Hhat @ p
        pAp = p @ Ap
        if pAp <= 0 or rz <= 0:
            return -it, np.sqrt((r @ r) / b2)
        al = rz / pAp
        x += al * p
        r -= al * Ap
        z = apply_M(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return maxiter, np.sqrt((r @ r) / b2)


def addv(r):
    return Madd @ r


def cheb_add(r, degree=3, ratio=8.0):
    lmax = evs[-1] * 1.05
    lmin = lmax / ratio
    dd = 0.5 * (lmax + lmin)
    cc = 0.5 * (lmax - lmin)
    x = np.zeros(N)
    rr = r.copy()
    p = np.zeros(N)
    al = be = 0.0
    for i in range(degree):
        zz = Madd @ rr
        if i == 0:
            p = zz
            al = 1.0 / dd
        else:
            be = (cc * al / 2.0) ** 2
            al = 1.0 / (dd - be / al)
            p = zz + be * p
        x += al * p
        rr -= al * (Hhat @ p)
    return x


def mult_sweep(r):
    # symmetric multiplicative block sweep: x=0; forward over elements,
    # then backward; fresh local residual per block (production form).
    x = np.zeros(N)
    order = list(range(nelem)) + list(reversed(range(nelem)))
    for e in order:
        bb = blk[e]
        loc = r[bb] - Hhat[bb, :] @ x
        x[bb] += Binv[e] @ loc
    return x


for name, M in (
    ("jacobi", lambda r: r),  # Hhat has unit diagonal
    ("additive-1", addv),
    ("additive+cheb3[l/8,l]", cheb_add),
    ("mult-sym-sweep", mult_sweep),
):
    its, rel = pcg(M)
    print(f"PCG {name:24s}: its={its:4d} rel={rel:.3e}")
