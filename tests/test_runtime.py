"""Runtime conformance tests — the differential-testing layer of the
reference (SURVEY.md §4 layer 2): every op computed with the batched
structures is compared against the identical computation with scipy/numpy.
"""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp

from multigridbarrier_tpu.runtime import (
    Ell,
    ell_from_scipy,
    BlockDiagOp,
    map_rows,
)


def _random_sparse(rng, m, n, density=0.3):
    A = sp.random(m, n, density=density, random_state=rng, format="csr")
    A.data[:] = rng.standard_normal(len(A.data))
    return A


def test_ell_matvec_rmatvec_dense():
    rng = np.random.default_rng(0)
    A = _random_sparse(rng, 37, 23)
    E = ell_from_scipy(A)
    v = rng.standard_normal(23)
    y = rng.standard_normal(37)
    np.testing.assert_allclose(np.asarray(E.matvec(jnp.asarray(v))), A @ v, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(E.rmatvec(jnp.asarray(y))), A.T @ y, atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(E.todense()), A.toarray(), atol=1e-12)
    # multi-column
    V = rng.standard_normal((23, 4))
    Y = rng.standard_normal((37, 4))
    np.testing.assert_allclose(np.asarray(E.matvec(jnp.asarray(V))), A @ V, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(E.rmatvec(jnp.asarray(Y))), A.T @ Y, atol=1e-12
    )


def test_ell_roundtrip_scipy():
    rng = np.random.default_rng(1)
    A = _random_sparse(rng, 12, 30)
    E = ell_from_scipy(A)
    B = E.to_scipy()
    assert (abs(A - B)).max() < 1e-14


def test_blockdiag_matches_scipy():
    rng = np.random.default_rng(2)
    blocks = rng.standard_normal((5, 7, 7))
    op = BlockDiagOp.from_blocks(jnp.asarray(blocks))
    A = op.to_scipy()
    v = rng.standard_normal(35)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(v))), A @ v, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(op.rmatvec(jnp.asarray(v))), A.T @ v, atol=1e-12
    )
    V = rng.standard_normal((35, 3))
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(V))), A @ V, atol=1e-12)


def test_identity_op():
    op = BlockDiagOp.identity(4, 3, jnp.float64)
    v = jnp.arange(12.0)
    np.testing.assert_allclose(np.asarray(op.matvec(v)), np.arange(12.0))
    np.testing.assert_allclose(np.asarray(op.rmatvec(v)), np.arange(12.0))


def test_map_rows_shapes():
    # scalar result -> (n,); row result -> (n, k): the reference
    # map_rows output contract (test/test_helpers.jl:123-152).
    x = jnp.arange(12.0).reshape(6, 2)
    w = jnp.arange(6.0)
    s = map_rows(lambda xi, wi: wi * (xi[0] + xi[1]), x, w)
    assert s.shape == (6,)
    np.testing.assert_allclose(
        np.asarray(s), np.asarray(w) * np.asarray(x).sum(1)
    )
    r = map_rows(lambda xi: jnp.stack([xi[0], xi[1], xi[0] * xi[1]]), x)
    assert r.shape == (6, 3)
