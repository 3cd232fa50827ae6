"""Element-Hessian assembly (amgb._assemble_He, two batched einsums left to
XLA) against a per-element loop over quadrature points and D rows."""

import numpy as np
import pytest
import jax.numpy as jnp

from multigridbarrier_tpu.solver.amgb import _assemble_He


def _loop_reference(P, Y):
    """He[e] = sum_q P[e,q]^T Y[e,q] P[e,q], one element at a time."""
    nelem, nq, k, C = P.shape
    He = np.zeros((nelem, C, C))
    for e in range(nelem):
        for q in range(nq):
            He[e] += P[e, q].T @ Y[e, q] @ P[e, q]
    return He


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-13), (np.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(5, 7, 4, 12), (3, 27, 5, 16)])
def test_assemble_He_matches_element_loop(shape, dtype, rtol):
    nelem, nq, k, C = shape
    rng = np.random.default_rng(sum(shape))
    P = rng.standard_normal(shape)
    Y = rng.standard_normal((nelem, nq, k, k))
    Y = Y @ np.swapaxes(Y, -1, -2)  # SPD row Hessians, like w * F2
    P, Y = P.astype(dtype), Y.astype(dtype)
    He = _assemble_He(jnp.asarray(P), jnp.asarray(Y))
    assert He.dtype == dtype and He.shape == (nelem, C, C)
    ref = _loop_reference(P.astype(np.float64), Y.astype(np.float64))
    err = np.linalg.norm(np.asarray(He, np.float64) - ref) / np.linalg.norm(ref)
    assert err < rtol, err
