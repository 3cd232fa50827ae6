"""Double-float (pair-f32) arithmetic for the ND factor's small ops.

Why
---
On hardware that emulates f64 in software, the multifrontal factor's
cost sits not in the big matmuls but in the long chain of small batched
ops: base-panel Cholesky, triangular substitutions, elementwise Schur
updates.  The reference never faces this (MUMPS runs on f64 hardware,
reference docs/src/installation.md:13); such hardware needs a
sub-f64 number format that native f32 vector units execute.  On
native-f64 platforms (CPU, NVIDIA GPU) this engine is off by default
(MGB_ND_CHEAP / MGB_ND_BASE) and kept reachable for A/B runs.

What
----
Double-float ("pair-f32"): a value is an unevaluated sum hi + lo of two
f32, carrying ~48 significant bits (eps_df ~ 2^-48 with sloppy
renormalization).  Two properties make it the right fit here:

* hi + lo converts EXACTLY to f64 and back (Dekker split) — so the
  factor can hand its big matmuls to the native f64 dot (whose error
  eps64 < eps_df and whose rate is NOT the bottleneck) and keep pair
  arithmetic for exactly the op class that is emulation-bound.
* 48 bits is enough for the barrier endgame's certified-PCG gate for
  most of the path (probed by tools/probe_qbits_direction.py with the
  ndsolve qbits simulator), where f32's 24 bits died at t ~ 1e3-1e4.

Ops are the classic error-free transforms (Dekker 1971, Knuth TwoSum)
in "sloppy" composition (single renormalization per op).  TwoProd uses
Veltkamp splitting, which is exact only if the compiler evaluates the
``c - (c - a)`` chain as written (no fused multiply-add contraction).

The column/row extractions below are f32 one-hot contractions, which
must be exact: each passes ``precision=HIGHEST`` so that a GPU does not
run them in TF32 (~10 mantissa bits).

All functions take/return (hi, lo) tuples of same-shape f32 arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST
_SPLIT_C = 4097.0  # 2^12 + 1: Veltkamp split of 24-bit f32 (python
# float: weak-typed, stays f32 in f32 expressions and never becomes a
# hoisted trace constant)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; 6 flops, no magnitude order)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp split: a = hi + lo with 12-bit-mantissa halves."""
    c = _SPLIT_C * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e via Veltkamp splitting."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df(hi, lo=None):
    """Pack a df pair (lo defaults to zero)."""
    hi = jnp.asarray(hi, jnp.float32)
    return (hi, jnp.zeros_like(hi) if lo is None else jnp.asarray(lo, jnp.float32))


def from_f64(x):
    """Exact f64 -> pair-f32 (hi = round(x), lo = round(x - hi)).

    hi is rounded to f32 inside f64 with reduce_precision: XLA:GPU folds
    the round trip convert(convert(x, f32), f64) back to x (it allows
    excess precision by default), which would leave lo = 0 and the pair
    at f32 accuracy."""
    hi = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)
    return hi.astype(jnp.float32), (x - hi).astype(jnp.float32)


def to_f64(a):
    """Exact pair-f32 -> f64."""
    return a[0].astype(jnp.float64) + a[1].astype(jnp.float64)


def add(a, b):
    """df + df, sloppy (11 flops): error O(2^-48)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def neg(a):
    return -a[0], -a[1]


def sub(a, b):
    return add(a, neg(b))


def mul(a, b):
    """df * df, sloppy (~20 flops without FMA)."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def mul_f32(a, b32):
    """df * plain f32 (~16 flops)."""
    p, e = two_prod(a[0], b32)
    e = e + a[1] * b32
    return fast_two_sum(p, e)


def recip(a):
    """1 / df via one Newton step from the f32 reciprocal:
    r1 = r0 * (2 - a*r0); quadratic convergence takes eps32 -> eps_df."""
    r0 = 1.0 / a[0]
    # e = 1 - a*r0 computed in df (the cancellation-critical step)
    p = mul_f32(a, r0)
    e = sub(df(jnp.float32(1.0)), p)
    corr = mul_f32(e, r0)
    # r0 + corr must go through an error-free sum: a plain f32 add here
    # rounds the correction away and collapses the op to f32 quality
    s, e2 = fast_two_sum(r0, corr[0])
    return fast_two_sum(s, e2 + corr[1])


def div(a, b):
    return mul(a, recip(b))


def sqrt(a):
    """sqrt(df) via one Newton step from the f32 sqrt:
    s1 = s0 + (a - s0^2) / (2 s0)."""
    s0 = jnp.sqrt(jnp.maximum(a[0], 0.0))
    p, e = two_prod(s0, s0)
    d = sub(a, (p, e))
    inv2s = 0.5 / jnp.where(s0 > 0, s0, 1.0)
    corr0 = d[0] * inv2s
    corr1 = d[1] * inv2s
    s, ee = fast_two_sum(s0, corr0)
    return fast_two_sum(s, ee + corr1)


def rsqrt(a):
    """1/sqrt(df) via one Newton step from f32 rsqrt:
    r1 = r0 * (3 - a*r0^2) / 2.  A non-positive input produces NaN/Inf
    exactly like the f64 path — floor-singular pivots must SURFACE (the
    caller's NaN detection is the escalation mechanism, ndsolve
    docstring)."""
    r0 = jax.lax.rsqrt(a[0])
    r0sq_p, r0sq_e = two_prod(r0, r0)
    ar2 = mul(a, (r0sq_p, r0sq_e))
    e = sub(df(jnp.float32(1.0)), ar2)
    half_r0 = 0.5 * r0
    corr = mul_f32(e, half_r0)
    s, e2 = fast_two_sum(r0, corr[0])
    return fast_two_sum(s, e2 + corr[1])


# ---------------------------------------------------------------------------
# Batched dense kernels used by the ND factor's numeric phase
# ---------------------------------------------------------------------------


def matmul(a, b):
    """df (..., m, k) @ df (..., k, n) through the native f64 dot.

    The conversion each way is EXACT; the f64 product's rounding
    (eps64) is below the pair format's own eps_df, so this is the most
    accurate df matmul expressible on the device.
    """
    return from_f64(to_f64(a) @ to_f64(b))


def chol_unrolled(a, n: int):
    """Batched df Cholesky of (..., n, n) pairs by an UNROLLED
    right-looking column sweep in pure pair arithmetic — the base-panel
    factorization that replaces jnp.linalg.cholesky's f64 loop.  n is a
    static (small) panel width; every step is a fused elementwise f32
    chain over the batch.

    Column j: d = sqrt(A[j,j]); L[:,j] = A[:,j]/d (rows > j);
    A[i,k] -= L[i,j]*L[k,j] for i,k > j — expressed rank-1 on the
    whole trailing matrix with masks (static shapes, no scatters).
    """
    ah, al = a
    tril = jnp.tril(jnp.ones((n, n), jnp.float32))
    lh = jnp.zeros_like(ah)
    ll = jnp.zeros_like(al)
    for j in range(n):
        col = (ah[..., :, j], al[..., :, j])          # (..., n)
        dj = (col[0][..., j:j + 1], col[1][..., j:j + 1])
        rinv = rsqrt(dj)                              # 1/sqrt(pivot)
        cj = mul(col, (jnp.broadcast_to(rinv[0], col[0].shape),
                       jnp.broadcast_to(rinv[1], col[0].shape)))
        # zero above the diagonal (static mask)
        mask = tril[:, j]
        cjh = cj[0] * mask
        cjl = cj[1] * mask
        lh = lh.at[..., :, j].set(cjh)
        ll = ll.at[..., :, j].set(cjl)
        # rank-1 trailing update A -= c c^T (masked to columns > j)
        cmask = (jnp.arange(n) > j).astype(jnp.float32)
        outer = mul(
            (cjh[..., :, None], cjl[..., :, None]),
            (cjh[..., None, :] * cmask, cjl[..., None, :] * cmask),
        )
        ah, al = sub((ah, al), outer)
    return lh, ll


def chol_looped(a, n: int):
    """chol_unrolled as a lax.fori_loop: same arithmetic, O(1) program
    size instead of O(n) — the factor embeds one of these per panel.
    Dynamic column index j via masked full-width ops; static shapes
    throughout."""
    ah, al = a
    # iota as a traced op, NOT jnp.arange: a concrete constant referenced
    # inside the fori body becomes a hoisted const_arg of the enclosing
    # jit, and the runtime's fastpath drops hoisted consts on re-execution
    # ("supplied N buffers but compiled program expected N+k") — measured
    # on the fused-gate runner the first time these kernels went inside
    # lax.cond
    ar = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    lh0 = jnp.zeros_like(ah)

    def body(j, st):
        ah, al, lh, ll = st
        colmask = (ar == j).astype(jnp.float32)  # (n,)
        col = (
            jnp.einsum("...ij,j->...i", ah, colmask, precision=_HIGHEST),
            jnp.einsum("...ij,j->...i", al, colmask, precision=_HIGHEST),
        )
        dj = (
            jnp.einsum("...i,i->...", col[0], colmask,
                       precision=_HIGHEST)[..., None],
            jnp.einsum("...i,i->...", col[1], colmask,
                       precision=_HIGHEST)[..., None],
        )
        rinv = rsqrt(dj)
        cj = mul(col, (jnp.broadcast_to(rinv[0], col[0].shape),
                       jnp.broadcast_to(rinv[1], col[0].shape)))
        rowmask = (ar >= j).astype(jnp.float32)  # zero above diagonal
        cjh = cj[0] * rowmask
        cjl = cj[1] * rowmask
        lh = lh + cjh[..., :, None] * colmask
        ll = ll + cjl[..., :, None] * colmask
        cmask = (ar > j).astype(jnp.float32)
        outer = mul(
            (cjh[..., :, None], cjl[..., :, None]),
            (cjh[..., None, :] * cmask, cjl[..., None, :] * cmask),
        )
        ah, al = sub((ah, al), outer)
        return ah, al, lh, ll

    _, _, lh, ll = jax.lax.fori_loop(
        0, n, body, (ah, al, lh0, jnp.zeros_like(al))
    )
    return lh, ll


def tri_lower_inv_looped(l, n: int):
    """Forward substitution against the identity as a lax.fori_loop over
    rows (compile-size twin of tri_lower_inv_unrolled): row j's df dot
    over k < j is a masked full-width pairwise tree sum (static shapes;
    the mask supplies the k < j restriction)."""
    lh, ll = l
    ar = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)  # see chol_looped
    n2 = 1 << max(1, (n - 1)).bit_length()

    def tree_sum(th, tl):
        # pad the contraction axis (-2) to a power of two, then halve
        pad = n2 - th.shape[-2]
        if pad:
            widths = [(0, 0)] * (th.ndim - 2) + [(0, pad), (0, 0)]
            th = jnp.pad(th, widths)
            tl = jnp.pad(tl, widths)
        k = n2
        while k > 1:
            half = k // 2
            a0 = (th[..., :half, :], tl[..., :half, :])
            a1 = (th[..., half:k, :], tl[..., half:k, :])
            th, tl = add(a0, a1)
            k = half
        return th[..., 0, :], tl[..., 0, :]

    def body(j, st):
        xh, xl = st
        rowmask = (ar == j).astype(jnp.float32)
        lrow = (
            jnp.einsum("...ij,i->...j", lh, rowmask, precision=_HIGHEST),
            jnp.einsum("...ij,i->...j", ll, rowmask, precision=_HIGHEST),
        )  # (..., n) = L[j, :]
        kmask = (ar < j).astype(jnp.float32)
        terms = mul(
            ((lrow[0] * kmask)[..., :, None],
             (lrow[1] * kmask)[..., :, None]),
            (xh, xl),
        )
        sh, sl = tree_sum(terms[0], terms[1])
        erow = jnp.broadcast_to((ar == j).astype(jnp.float32), sh.shape)
        acc = sub((erow, jnp.zeros_like(erow)), (sh, sl))
        djj = (
            jnp.einsum("...j,j->...", lrow[0], rowmask,
                       precision=_HIGHEST)[..., None],
            jnp.einsum("...j,j->...", lrow[1], rowmask,
                       precision=_HIGHEST)[..., None],
        )
        rj = recip(djj)
        row = mul(acc, (jnp.broadcast_to(rj[0], acc[0].shape),
                        jnp.broadcast_to(rj[1], acc[0].shape)))
        xh = xh + row[0][..., None, :] * rowmask[:, None]
        xl = xl + row[1][..., None, :] * rowmask[:, None]
        return xh, xl

    xh0 = jnp.zeros_like(lh)
    return jax.lax.fori_loop(0, n, body, (xh0, jnp.zeros_like(ll)))


def tri_lower_inv_unrolled(l, n: int):
    """Batched df inverse of lower-triangular (..., n, n) pairs by
    unrolled forward substitution against the identity, column-parallel:
    X[j,:] = (I[j,:] - sum_{k<j} L[j,k] X[k,:]) / L[j,j].
    Row j depends on rows < j — n sequential steps of fused elementwise
    chains (each step handles ALL rhs columns at once)."""
    lh, ll = l
    xh = jnp.zeros_like(lh)
    xl = jnp.zeros_like(ll)
    eye = jnp.eye(n, dtype=jnp.float32)
    for j in range(n):
        # acc = I[j,:] - L[j,:j] @ X[:j,:]   (df dot along k)
        acc = (jnp.broadcast_to(eye[j], lh[..., 0, :].shape),
               jnp.zeros_like(lh[..., 0, :]))
        if j > 0:
            # contraction over k < j in df: sum of j rank-terms
            terms = mul(
                (lh[..., j, :j, None], ll[..., j, :j, None]),
                (xh[..., :j, :], xl[..., :j, :]),
            )
            # pairwise tree-sum in df to keep the error O(log j)
            th, tl = terms
            k = th.shape[-2]
            while k > 1:
                half = k // 2
                a0 = (th[..., :half, :], tl[..., :half, :])
                a1 = (th[..., half:2 * half, :], tl[..., half:2 * half, :])
                sh, sl = add(a0, a1)
                if k % 2:
                    sh = jnp.concatenate(
                        [sh, th[..., -1:, :]], axis=-2
                    )
                    sl = jnp.concatenate(
                        [sl, tl[..., -1:, :]], axis=-2
                    )
                th, tl = sh, sl
                k = th.shape[-2]
            acc = sub(acc, (th[..., 0, :], tl[..., 0, :]))
        dj = (lh[..., j, j, None], ll[..., j, j, None])
        rj = recip(dj)
        row = mul(acc, (jnp.broadcast_to(rj[0], acc[0].shape),
                        jnp.broadcast_to(rj[1], acc[0].shape)))
        xh = xh.at[..., j, :].set(row[0])
        xl = xl.at[..., j, :].set(row[1])
    return xh, xl
