"""Padded-ELL sparse matrices.

The reference's HPCSparseMatrix is a row-distributed CSR with a
structural-hash-keyed communication-plan cache that must be rebuilt every
Newton step because a fresh diagonal matrix is created per iteration
(reference tools/profile_hash.jl:42-66 — an explicitly measured overhead).
This design removes that failure mode: sparsity is padded once
per geometry to a fixed width K, so every SpMV is a static-shape
gather+contract and nothing is re-planned or re-compiled inside the
Newton loop (SURVEY.md §7 hard part (c)).

Rows are the shardable axis: `matvec` is embarrassingly row-parallel given
a replicated input vector; `rmatvec` is a local scatter-add followed by a
GSPMD-inserted psum.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "vals"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class Ell:
    """Fixed-width sparse matrix: row i holds entries vals[i, k] at columns
    cols[i, k].  Padding entries have vals == 0 and cols == 0 (harmless in
    matvec; they contribute 0 in rmatvec's segment sum)."""

    cols: jnp.ndarray  # (nrows, K) int
    vals: jnp.ndarray  # (nrows, K) float
    shape: tuple  # (nrows, ncols), static

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """y = A @ v for v of shape (ncols,) or (ncols, m) (multi-column)."""
        if v.ndim == 1:
            return jnp.einsum("rk,rk->r", self.vals, v[self.cols])
        # (nrows, K, m) gather, contracted over K
        return jnp.einsum("rk,rkm->rm", self.vals, v[self.cols])

    def rmatvec(self, y: jnp.ndarray) -> jnp.ndarray:
        """x = A.T @ y for y of shape (nrows,) or (nrows, m)."""
        flat_cols = self.cols.reshape(-1)
        if y.ndim == 1:
            contrib = (self.vals * y[:, None]).reshape(-1)
            return jax.ops.segment_sum(contrib, flat_cols, num_segments=self.ncols)
        contrib = (self.vals[..., None] * y[:, None, :]).reshape(-1, y.shape[1])
        return jax.ops.segment_sum(contrib, flat_cols, num_segments=self.ncols)

    def todense(self) -> jnp.ndarray:
        out = jnp.zeros(self.shape, dtype=self.vals.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.nrows)[:, None], self.cols.shape
        )
        return out.at[rows, self.cols].add(self.vals)

    def to_scipy(self):
        """Gather to a host scipy CSR (the `SparseMatrixCSC(A)` gather of the
        reference, src/MultiGridBarrierMPI.jl:525-527)."""
        import scipy.sparse as sp

        cols = np.asarray(self.cols).reshape(-1)
        vals = np.asarray(self.vals).reshape(-1)
        rows = np.repeat(np.arange(self.nrows), self.width)
        mask = vals != 0
        return sp.csr_matrix(
            (vals[mask], (rows[mask], cols[mask])), shape=self.shape
        )

    def astype(self, dtype) -> "Ell":
        return Ell(cols=self.cols, vals=self.vals.astype(dtype), shape=self.shape)


def ell_from_coo(rows, cols, vals, shape, width=None, dtype=None, itype=np.int32):
    """Build an Ell from host COO triplets (duplicates are summed)."""
    import scipy.sparse as sp

    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    return ell_from_scipy(A, width=width, dtype=dtype, itype=itype)


def ell_from_scipy(A, width=None, dtype=None, itype=np.int32) -> Ell:
    """Pad a scipy sparse matrix to fixed row width."""
    A = A.tocsr()
    A.sum_duplicates()
    nrows, ncols = A.shape
    counts = np.diff(A.indptr)
    K = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if width is not None:
        if width < K:
            raise ValueError(f"width {width} < max row nnz {K}")
        K = width
    from . import native

    res = native.csr_to_ell(
        A.indptr, A.indices, A.data, nrows, K,
        itype=itype, dtype=np.dtype(dtype or A.dtype),
    )
    if res is not None:
        cols, vals = res
    else:
        cols = np.zeros((nrows, K), dtype=itype)
        vals = np.zeros((nrows, K), dtype=dtype or A.dtype)
        if A.nnz:
            rowids = np.repeat(np.arange(nrows), counts)
            offsets = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
            cols[rowids, offsets] = A.indices
            vals[rowids, offsets] = A.data
    return Ell(cols=jnp.asarray(cols), vals=jnp.asarray(vals), shape=(nrows, ncols))
