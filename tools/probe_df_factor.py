"""End-to-end ND factor timing at real fem2d shapes: xla-f64 vs df-base
f64 vs f32 on the current backend.

Factor cost is value-independent (static schedule), so the vals array is
a synthetic SPD diagonal — this probe times the SCHEDULE, not numerics
(numerics are pinned by tests/test_ndsolve.py and the qbits probe).

Usage: python tools/probe_df_factor.py [L] [reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.solver.ndsolve import (
    NDFactorizer,
    NDSymbolic,
    node_coords,
)

L = int(sys.argv[1]) if len(sys.argv) > 1 else 7
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3

g = mgb.fem2d(L=L)
import importlib

A = importlib.import_module("multigridbarrier_tpu.solver.amgb")
spec = A._normalize_D(A.default_D(2))
dtype = g.x.dtype
c0 = jax.vmap(lambda xi: jnp.asarray(A.default_f(2, dtype)(xi), dtype))(g.x)
ctx = A._SolverCtx(g, spec, A.default_Q(2, 1.0).barrier, c0)
level = ctx.levels - 1
basis = ctx._bases[level]
m, nf = basis.m, spec.nfields
sym = NDSymbolic(
    np.asarray(basis.idx), m, nf,
    node_coords(basis.idx, m, np.asarray(g.x), basis.nq),
    leaf=int(os.environ.get("MGB_ND_LEAF", "16")),
)
print(f"L={L} m={m} nf={nf} groups={sym.ngroups}", flush=True)

# SPD synthetic vals: unit diagonal, zero off-diagonal
diag_ids = (
    (np.arange(nf, dtype=np.int64) * (nf + 1))[None, :] * sym.nuniq
    + sym.diag_pid[:, None]
).reshape(-1)
vals = np.zeros(nf * nf * sym.nuniq)
vals[diag_ids] = 1.0
vj = jnp.asarray(vals)

b = jnp.asarray(np.random.default_rng(0).standard_normal(m * nf))


def timed(label, fn, n=reps):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    tc = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    print(f"{label:40s} {min(ts)*1e3:9.1f} ms   (compile+1st {tc:7.1f}s) "
          f"[{' '.join(f'{t*1e3:.0f}' for t in ts)}]", flush=True)
    return out


for base_impl, dt in (("xla", jnp.float64), ("df", jnp.float64),
                      ("xla", jnp.float32)):
    os.environ["MGB_ND_BASE"] = base_impl
    fz = NDFactorizer(sym, dtype=jnp.float64)
    cst = fz.consts()
    fj = jax.jit(lambda v, c, _fz=fz, _dt=dt: _fz.factor(v, c, dtype=_dt))
    fac = timed(f"factor {base_impl} {np.dtype(dt).name}",
                lambda: fj(vj, cst))
    sj = jax.jit(lambda f, bb, c, _fz=fz: _fz.solve(f, bb, c))
    timed(f"solve  {base_impl} {np.dtype(dt).name}",
          lambda: sj(fac, b, cst))
    # sanity: solve of the identity system returns b
    x = np.asarray(sj(fac, b, cst))
    err = np.linalg.norm(x - np.asarray(b)) / np.linalg.norm(np.asarray(b))
    print(f"   identity-solve rel err {err:.2e}", flush=True)

print("done")
