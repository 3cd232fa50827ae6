"""Per-element block-diagonal operators.

Every differential operator of the broken quadrature-point space
(`operators[:id]/[:dx]/[:dy]/[:dz]` of the reference Geometry,
docs/src/api.md:84) is block-diagonal over elements: within one element the
polynomial is determined by its quadrature values, so differentiation is a
small dense nq x nq matrix per element, applied as a batched matmul
instead of the reference's distributed CSR SpMV
(test/test_apply_d.jl:43-49).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks"],
    meta_fields=["is_identity", "n"],
)
@dataclasses.dataclass(frozen=True)
class BlockDiagOp:
    """Operator on broken-space vectors of length n = nelem * nq.

    blocks: (nelem, nq, nq); row-block e maps the nq values of element e.
    is_identity short-circuits the :id operator to a no-op.
    """

    blocks: jnp.ndarray  # (nelem, nq, nq)
    is_identity: bool
    n: int  # = nelem * nq, static

    @property
    def nelem(self) -> int:
        return self.blocks.shape[0]

    @property
    def nq(self) -> int:
        return self.blocks.shape[1]

    @property
    def shape(self):
        return (self.n, self.n)

    @staticmethod
    def identity(nelem: int, nq: int, dtype) -> "BlockDiagOp":
        eye = jnp.broadcast_to(jnp.eye(nq, dtype=dtype), (nelem, nq, nq))
        return BlockDiagOp(blocks=eye, is_identity=True, n=nelem * nq)

    @staticmethod
    def from_blocks(blocks) -> "BlockDiagOp":
        blocks = jnp.asarray(blocks)
        nelem, nq, _ = blocks.shape
        return BlockDiagOp(blocks=blocks, is_identity=False, n=nelem * nq)

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """Apply to (n,) or (n, m) arrays."""
        if self.is_identity:
            return v
        if v.ndim == 1:
            ve = v.reshape(self.nelem, self.nq)
            return jnp.einsum("eij,ej->ei", self.blocks, ve).reshape(self.n)
        ve = v.reshape(self.nelem, self.nq, v.shape[1])
        return jnp.einsum("eij,ejm->eim", self.blocks, ve).reshape(
            self.n, v.shape[1]
        )

    def rmatvec(self, y: jnp.ndarray) -> jnp.ndarray:
        """Apply the transpose (adjoint SpMV of the reference,
        test/test_nonsquare.jl:41-72)."""
        if self.is_identity:
            return y
        if y.ndim == 1:
            ye = y.reshape(self.nelem, self.nq)
            return jnp.einsum("eji,ej->ei", self.blocks, ye).reshape(self.n)
        ye = y.reshape(self.nelem, self.nq, y.shape[1])
        return jnp.einsum("eji,ejm->eim", self.blocks, ye).reshape(
            self.n, y.shape[1]
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.block_diag(
            [np.asarray(b) for b in self.blocks], format="csr"
        )

    def astype(self, dtype) -> "BlockDiagOp":
        return BlockDiagOp(
            blocks=self.blocks.astype(dtype), is_identity=self.is_identity, n=self.n
        )
