"""Diagnose the f32->f64 handoff no-op (lam2 = -0.0 in the f64 endgame).

Runs the mixed solve at L (default 6) on CPU, takes the resulting iterate
(which equals the f32 handoff when the endgame no-ops), and replays one
fine-level f64 Newton step eagerly with a Python-level PCG loop so every
intermediate (gv, b2, precond output, residual trajectory) is visible.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax
import jax.numpy as jnp

import importlib

import multigridbarrier_tpu as mgb

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")
LS = importlib.import_module("multigridbarrier_tpu.solver.linsolve")

L = int(os.environ.get("MGB_DEBUG_L", "6"))
print(f"# building fem2d L={L}", flush=True)
g = mgb.fem2d(L=L)

MODE = os.environ.get("MGB_DEBUG_MODE", "mixed")  # mixed | pure
cache = f"/tmp/handoff_z_L{L}_{MODE}.npy"
if os.path.exists(cache):
    z = jnp.asarray(np.load(cache))
    print(f"# loaded cached {MODE} iterate", flush=True)
else:
    print(f"# {MODE} solve", flush=True)
    sol = mgb.amgb(g, p=1.0, verbose=True, mixed=(MODE == "mixed"))
    z = jnp.asarray(sol.z)
    print("# final its:", sol.SOL_main.its.tolist(), flush=True)
    np.save(cache, np.asarray(z))

# --- rebuild the f64 phase-2 context exactly as amgb does -------------------
dim = g.dim
dtype = g.x.dtype
spec = A._normalize_D(A.default_D(dim))
Qset = A.default_Q(dim, 1.0)
ffun = A.default_f(dim, dtype)
c = jax.vmap(lambda xi: jnp.asarray(ffun(xi), dtype=dtype))(g.x)
ctx = A._get_ctx(g, spec, Qset.barrier, c, subspace="dirichlet", x=g.x)

lvl = ctx.levels - 1
t = float(os.environ.get("MGB_DEBUG_T", "1e5"))

Ps, bases, embeds, rloc = ctx._level_args(lvl)
spec_k, nf = spec.k, spec.nfields
basis = bases[-1]
m, nl, nq = basis.m, basis.nl, basis.nq
Pl, idx = Ps[-1], basis.idx
nelem = Pl.shape[0]
x, w = ctx.x, ctx.w

barrier = Qset.barrier
F1 = jax.grad(barrier, argnums=1)
F2 = jax.hessian(barrier, argnums=1)

y = A._apply_D(ctx.ops, spec, z)
F0v = jax.vmap(barrier)(x, y)
print("barrier finite:", bool(jnp.all(jnp.isfinite(jnp.where(w[:, None] != 0, F0v[:, None], 0.0)))))

F1v = jax.vmap(F1)(x, y)
gy = (w[:, None] * (t * c + F1v)).reshape(nelem, nq, spec_k)
gf = jnp.einsum("eqj,eqjc->ec", gy, Pl)
gv = basis.scatter_add(
    gf.reshape(nelem, nf, nl).transpose(0, 2, 1).reshape(-1, nf)
).T
print("gv: finite", bool(jnp.all(jnp.isfinite(gv))), "norm", float(jnp.linalg.norm(gv)))

Y2w = jax.vmap(F2)(x, y) * w[:, None, None]
Y2w_e = Y2w.reshape(nelem, nq, spec_k, spec_k)
sub_levels = ctx._sub_levels(lvl)
systems = [
    LS.LevelSystem(A._assemble_He(Ps[i], Y2w_e), bases[i].idx, ctx._bases[sl].m)
    for i, sl in enumerate(sub_levels)
]
for i, s in enumerate(systems):
    print(f"sys[{i}]: He finite {bool(jnp.all(jnp.isfinite(s.He)))} "
          f"|He|max {float(jnp.max(jnp.abs(s.He))):.3e} m={s.m}")

bp = -gv
nf_ = nf

# --- replicate mgcg_solve internals in Python ---------------------------------
fine = systems[-1]
diag_fine = LS.diag_of(fine)
print("diag_fine: min", float(jnp.min(diag_fine[:, :fine.m])), "max", float(jnp.max(diag_fine)))
dinvs = [1.0 / LS.diag_of(s) for s in systems]
lmaxs = [jnp.asarray(1.0, dtype=bp.dtype)] + [
    LS.lambda_max_est(s, d, iters=6) for s, d in zip(systems[1:], dinvs[1:])
]
print("lmaxs:", [float(l) for l in lmaxs])
coarse_H = LS.dense_assemble(systems[0], nf_)
print("coarse H finite:", bool(jnp.all(jnp.isfinite(coarse_H))))
coarse_cf = jax.scipy.linalg.cho_factor(coarse_H)
print("coarse chol finite:", bool(jnp.all(jnp.isfinite(coarse_cf[0]))))

# scaled-cast preconditioner, mirroring mgcg_solve
f32c = jnp.float32
svecs = [jnp.sqrt(d) for d in dinvs]
systems32 = []
for s_, sv in zip(systems, svecs):
    nelem_l, nl_l = s_.idx.shape
    se = sv[:, s_.idx].transpose(1, 0, 2).reshape(nelem_l, nf_ * nl_l)
    systems32.append(
        s_._replace(He=(s_.He * se[:, :, None] * se[:, None, :]).astype(f32c))
    )
ones32 = [jnp.asarray(1.0, dtype=f32c)] * len(systems)
lmaxs32 = [l.astype(f32c) for l in lmaxs]
sv32 = [sv.astype(f32c) for sv in svecs]
embeds32 = [
    LS._ScaledTransfer(
        E=E,
        sc=sv32[i][:, : systems[i].m].T,
        sf_inv=(1.0 / sv32[i + 1][:, : systems[i + 1].m]).T,
    )
    for i, E in enumerate(embeds)
]
s0_inv = 1.0 / svecs[0]
m0 = systems[0].m


def coarse_solve(bp0_hat):
    r = (bp0_hat.astype(s0_inv.dtype) * s0_inv).reshape(-1)
    xc = jax.scipy.linalg.cho_solve(coarse_cf, r).astype(s0_inv.dtype)
    xc = (xc.reshape(nf_, m0 + 1) * s0_inv).astype(f32c)
    return xc.at[:, m0].set(0.0)


s_fine = svecs[-1]


def precond(r):
    out = LS.vcycle(systems32, ones32, lmaxs32, embeds32, coarse_solve,
                    (r * s_fine).astype(f32c), nf_, degree=3)
    return s_fine * out.astype(bp.dtype)


def Aop(v):
    return LS.hvp(fine, v)


b2 = float(jnp.vdot(bp, bp))
print("b2:", b2)
r = bp
z0 = precond(r)
print("precond(r0): finite", bool(jnp.all(jnp.isfinite(z0))),
      "norm", float(jnp.linalg.norm(z0)),
      "<r,z>", float(jnp.vdot(r, z0)))

xk = jnp.zeros_like(bp)
p = z0
rz = jnp.vdot(r, z0)
for it in range(25):
    Ap = Aop(p)
    pAp = float(jnp.vdot(p, Ap))
    alpha = float(rz) / pAp if pAp != 0 else float("nan")
    xk = xk + alpha * p
    r = r - alpha * Ap
    r2 = float(jnp.vdot(r, r))
    zk = precond(r)
    rz_new = jnp.vdot(r, zk)
    print(f"it={it:2d} pAp={pAp:.6e} alpha={alpha:.6e} r2/b2={r2 / b2:.6e} "
          f"rz={float(rz_new):.6e} zfin={bool(jnp.all(jnp.isfinite(zk)))}")
    beta = float(rz_new) / float(rz)
    p = zk + beta * p
    rz = rz_new
    if r2 / b2 < 1e-20:
        break

lam2 = -float(jnp.vdot(gv, xk))
print("final lam2 from python CG:", lam2)

# exact transcription of the library loop (same eps terms, same op order)
tiny = jnp.asarray(jnp.finfo(bp.dtype).tiny, dtype=bp.dtype)
xk = jnp.zeros_like(bp)
r = bp
zk = precond(r)
p = zk
rz = jnp.vdot(r, zk)
rb2 = jnp.vdot(bp, bp)
print("transcribed loop:")
for it in range(30):
    Ap = Aop(p)
    pAp = jnp.vdot(p, Ap)
    alpha = rz / (pAp + tiny)
    xk = xk + alpha * p
    r = r - alpha * Ap
    r2 = jnp.vdot(r, r)
    zk = precond(r)
    rz_new = jnp.vdot(r, zk)
    healthy = bool((pAp > 0) & (rz_new > 0) & jnp.isfinite(rz_new))
    print(f"  it={it:2d} pAp={float(pAp):.6e} rz_new={float(rz_new):.6e} "
          f"r2/b2={float(r2) / b2:.6e} healthy={healthy}")
    beta = rz_new / (rz + tiny)
    p = zk + beta * p
    rz = rz_new

# compare: what does the library mgcg_solve return?
dvp, its_cg, rel, _ = LS.mgcg_solve(systems, embeds, bp, nf_, rtol=ctx.cg_rtol,
                                    maxiter=ctx.cg_maxiter)
print("library mgcg: its", int(its_cg), "rel", float(rel),
      "|dvp|", float(jnp.linalg.norm(dvp)),
      "lam2", -float(jnp.vdot(gv, dvp)))
