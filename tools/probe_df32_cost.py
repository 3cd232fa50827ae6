"""Micro-cost probe: pair-f32 (dfmm) kernels vs f64 on the current backend.

Whether the df factor engine can win depends on one hardware fact: is a
sloppy pair-f32 op chain (~10-20 native f32 flops/op) faster than the
backend's f64 for the same op (base Cholesky, substitutions, elementwise
Schur)?  This probe measures it with chained fori_loops at real L=7
group shapes.

Run on the device:  python tools/probe_df32_cost.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from multigridbarrier_tpu.experimental import dfmm

N_CHAIN = int(os.environ.get("MGB_PROBE_CHAIN", "20"))


def chained(label, body, carry0, n=N_CHAIN):
    f = jax.jit(lambda c: jax.lax.fori_loop(0, n, lambda i, c: body(c), c))
    t0 = time.perf_counter()
    out = f(carry0)
    jax.block_until_ready(out)
    tc = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(f(carry0))
    dt = (time.perf_counter() - t0) / n
    print(f"{label:52s} {dt*1e3:9.3f} ms/app   (compile+1st {tc:6.1f}s)",
          flush=True)
    return dt


rng = np.random.default_rng(0)


def spd(n_d, s):
    B = rng.standard_normal((n_d, s, s))
    A = B @ np.swapaxes(B, -1, -2) + 4 * s * np.eye(s)[None]
    return A


def tiny_of(dt):
    return jnp.asarray(np.finfo(np.dtype(dt)).tiny, dt)


# -- base-panel Cholesky (n_d, 32, 32): the sequential backbone --------
for n_d in (2048, 128, 8):
    A = spd(n_d, 32)
    for dt in (jnp.float64, jnp.float32):
        Aj = jnp.asarray(A, dt)
        chained(
            f"chol32 xla {np.dtype(dt).name:8s} n_d={n_d}",
            lambda c, _t=tiny_of(dt): c + _t * jnp.linalg.cholesky(c),
            Aj,
        )
    Ad = dfmm.from_f64(jnp.asarray(A))

    def body_df(c):
        L = dfmm.chol_unrolled(c, 32)
        t = jnp.asarray(1e-30, jnp.float32)
        return (c[0] + t * L[0], c[1] + t * L[1])

    chained(f"chol32 dfmm pair-f32      n_d={n_d}", body_df, Ad)

# -- base-block triangular inverse vs eye ------------------------------
for n_d in (2048, 128):
    L0 = np.linalg.cholesky(spd(n_d, 32))
    eye = np.eye(32)[None] * np.ones((n_d, 1, 1))
    for dt in (jnp.float64, jnp.float32):
        Lj = jnp.asarray(L0, dt)
        ej = jnp.asarray(eye, dt)

        def body_tri(c, _e=ej, _t=tiny_of(dt)):
            X = jax.scipy.linalg.solve_triangular(c, _e, lower=True)
            return c + _t * X

        chained(f"triinv32 xla {np.dtype(dt).name:8s} n_d={n_d}",
                body_tri, Lj)
    Ld = dfmm.from_f64(jnp.asarray(L0))

    def body_tri_df(c):
        X = dfmm.tri_lower_inv_unrolled(c, 32)
        t = jnp.asarray(1e-30, jnp.float32)
        return (c[0] + t * X[0], c[1] + t * X[1])

    chained(f"triinv32 dfmm pair-f32    n_d={n_d}", body_tri_df, Ld)

# -- panel matmul (n_d, F, 32) @ (n_d, 32, 32): the O(F) rank-32 work --
for n_d, F in ((1, 1388), (8, 352), (128, 96)):
    R = rng.standard_normal((n_d, F, 32))
    M = rng.standard_normal((n_d, 32, 32))
    for dt in (jnp.float64, jnp.float32):
        Rj = jnp.asarray(R, dt)
        Mj = jnp.asarray(M, dt)
        chained(
            f"panelmm {np.dtype(dt).name:8s} n_d={n_d} F={F}",
            lambda c, _m=Mj, _t=tiny_of(dt): c + _t * (c @ _m),
            Rj,
        )
    Rd = dfmm.from_f64(jnp.asarray(R))
    Md = dfmm.from_f64(jnp.asarray(M))

    def body_mm_df(c, _m=Md):
        P = dfmm.matmul(c, _m)
        t = jnp.asarray(1e-30, jnp.float32)
        return (c[0] + t * P[0], c[1] + t * P[1])

    chained(f"panelmm df(f64-dot)       n_d={n_d} F={F}", body_mm_df, Rd)

# -- elementwise Schur-style update a - b*c at front shapes ------------
for n_d, F in ((1, 1388), (64, 176)):
    X = rng.standard_normal((n_d, F, F))
    Y = rng.standard_normal((n_d, F, F))
    for dt in (jnp.float64, jnp.float32):
        Xj = jnp.asarray(X, dt)
        Yj = jnp.asarray(Y, dt)
        chained(
            f"elemwise a-a*b {np.dtype(dt).name:8s} n_d={n_d} F={F}",
            lambda c, _y=Yj: c - jnp.asarray(0.001, c.dtype) * (c * _y),
            Xj,
        )
    Xd = dfmm.from_f64(jnp.asarray(X))
    Yd = dfmm.from_f64(jnp.asarray(Y))

    def body_el_df(c, _y=Yd):
        P = dfmm.mul(c, _y)
        s = dfmm.sub(c, (0.001 * P[0], 0.001 * P[1]))
        return s

    chained(f"elemwise df pair-f32      n_d={n_d} F={F}", body_el_df, Xd)

print("done")
