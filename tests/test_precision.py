"""Precision guards for GPU compilation: every matrix product of the
pair-f32 (df) base kernels and of an f32 ND factorization asks for HIGHEST
precision (a default-precision f32 dot may run in TF32, ~10 mantissa bits,
on a GPU), and the f64 -> pair conversion survives XLA:GPU's excess-
precision folding of convert round trips."""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from multigridbarrier_tpu.solver.ndsolve import (
    NDFactorizer,
    NDSymbolic,
    _df_chol,
    _df_tri_inv,
)

from test_ndsolve import _grid_problem


def _dot_precisions(jaxpr):
    """precision params of every dot_general, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else (val,):
                if hasattr(sub, "eqns"):
                    found += _dot_precisions(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    found += _dot_precisions(sub.jaxpr)
    return found


def _assert_all_highest(closed):
    precs = _dot_precisions(closed.jaxpr)
    assert precs, "trace has no dot_general to check"
    for p in precs:
        assert p is not None, precs
        for q in p if isinstance(p, tuple) else (p,):
            assert q == lax.Precision.HIGHEST, precs


def _spd(n, batch=3):
    rng = np.random.default_rng(n)
    B = rng.standard_normal((batch, n, n))
    return jnp.asarray(B @ np.swapaxes(B, -1, -2) + n * np.eye(n)[None])


def test_df_chol_dots_are_highest():
    _assert_all_highest(jax.make_jaxpr(lambda a: _df_chol(a, 16))(_spd(16)))


def test_df_tri_inv_dots_are_highest():
    L = jnp.linalg.cholesky(_spd(16))
    _assert_all_highest(jax.make_jaxpr(lambda a: _df_tri_inv(a, 16))(L))


def test_f32_nd_factor_dots_are_highest():
    idx, coords, vals, _ = _grid_problem(8, 2, True)
    sym = NDSymbolic(idx, coords.shape[0], 2, coords, leaf=8)
    fz = NDFactorizer(sym, use_inv=True)
    cst = fz.consts()
    closed = jax.make_jaxpr(
        lambda v, c: fz.factor(v, c, dtype=jnp.float32)
    )(jnp.asarray(vals), cst)
    _assert_all_highest(closed)


def test_from_f64_avoids_convert_round_trip():
    """XLA:GPU folds convert(convert(x, f32), f64) back to x (excess
    precision), which zeroes the low word of a pair; from_f64 must round
    with reduce_precision inside f64 instead, and stay exact."""
    from multigridbarrier_tpu.experimental import dfmm

    x = jnp.asarray(np.random.default_rng(0).standard_normal(256))
    eqns = jax.make_jaxpr(dfmm.from_f64)(x).jaxpr.eqns
    assert any(e.primitive.name == "reduce_precision" for e in eqns)
    to64 = [e for e in eqns if e.primitive.name == "convert_element_type"
            and e.params["new_dtype"] == jnp.float64]
    assert not to64, to64
    hi, lo = dfmm.from_f64(x)
    assert np.count_nonzero(np.asarray(lo)) > 200
    back = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    assert np.max(np.abs(back - np.asarray(x)) / np.abs(np.asarray(x))) < 2.0 ** -47
