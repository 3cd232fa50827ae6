"""Stage attribution of the host-pre program (barrier derivatives ->
element Hessians -> dedup segment_sum) on the live backend at a given
L.  Each truncated program is timed per-call (min of 3); deltas give
the per-stage split of the 'pre' cost.

Run on the device:  python tools/probe_pre_stages.py [L]
"""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import importlib

import multigridbarrier_tpu as mgb

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")
from multigridbarrier_tpu.solver.amgb import _apply_D, _masked_wsum

L = int(sys.argv[1]) if len(sys.argv) > 1 else 7


def timed(label, fn, *args, n=3):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    dt = min(ts)
    print(f"{label:40s} {dt*1e3:9.2f} ms   "
          f"[{' '.join(f'{t*1e3:.1f}' for t in ts)}]", flush=True)
    return dt


g = mgb.fem2d(L=L)
spec = A._normalize_D(A.default_D(2))
dt_ = g.x.dtype
c0 = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dt_)(xi), dt_))(g.x)
ctx = A._SolverCtx(g, spec, A.default_Q(2, 1.0).barrier, c0)
level = ctx.levels - 1
basis = ctx._bases[level]
Pl = ctx._P[level]
nf, k = spec.nfields, spec.k
nl, nq = basis.nl, basis.nq
nseg = ctx._get_host_pattern(level).nseg
barrier = ctx.barrier
F1 = jax.grad(barrier, argnums=1)
F2 = jax.hessian(barrier, argnums=1)
z0 = jax.vmap(lambda xi: jnp.asarray(A.default_g(2, dt_)(xi), dt_))(g.x)
t1 = jnp.asarray(1.0e3, dt_)
pat = ctx._get_host_pattern(level)
full_ids = jnp.asarray(pat.full_ids)


def stage(upto):
    def run(Pl, x, w, c, z, t, ids):
        nelem = Pl.shape[0]
        y = _apply_D(ctx.ops, spec, z)
        F0v = jax.vmap(barrier)(x, y)
        cy = jnp.sum(w * jnp.sum(c * y, axis=1))
        fy0 = _masked_wsum(w, F0v)
        if upto == "f01":
            return cy + fy0
        F1v = jax.vmap(F1)(x, y)
        gy = (w[:, None] * (t * c + F1v)).reshape(nelem, nq, k)
        gf = jnp.einsum("eqj,eqjc->ec", gy, Pl)
        gv = basis.scatter_add(
            gf.reshape(nelem, nf, nl).transpose(0, 2, 1).reshape(-1, nf)
        ).T
        if upto == "grad":
            return cy + fy0 + gv.sum()
        Y2w = jax.vmap(F2)(x, y) * w[:, None, None]
        if upto == "hess":
            return cy + fy0 + gv.sum() + Y2w.sum()
        He = A._assemble_He(Pl, Y2w.reshape(nelem, nq, k, k))
        if upto == "asmHe":
            return cy + fy0 + gv.sum() + He.sum()
        vals = jax.ops.segment_sum(
            He.reshape(-1), ids.reshape(-1), num_segments=nseg
        )
        return cy + fy0 + gv.sum() + vals.sum()

    return jax.jit(run)


print(f"L={L} nelem={Pl.shape[0]} nl={nl} nq={nq} k={k} nseg={nseg} "
      f"backend={jax.default_backend()}", flush=True)
t_prev = 0.0
for upto in ("f01", "grad", "hess", "asmHe", "segsum"):
    t_u = timed(f"pre upto={upto}", stage(upto), Pl, ctx.x, ctx.w, ctx.c,
                z0, t1, full_ids)
    print(f"    delta {upto}: {1e3*(t_u - t_prev):8.2f} ms", flush=True)
    t_prev = t_u
