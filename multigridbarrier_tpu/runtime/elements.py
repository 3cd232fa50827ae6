"""Element-local subspace bases — the batched FEM assembly layout.

The reference stores each multigrid inclusion matrix R_l (broken space <-
level-l conforming subspace) as a distributed CSR and assembles the Newton
matrix with an SpGEMM chain R' (D' diag(w.*y) D) R every iteration
(reference: test/test_map_rows_compare.jl:102-139, hot loop SURVEY.md §3.1),
re-hashing and re-planning communication each step
(tools/profile_hash.jl:42-66).

Here we exploit what the CSR hides: every broken point of finest element
`e` interacts only with the subspace nodes of the level-l ancestor of `e`,
so R_l is *element-local* — a dense (nq, nl) block per element plus an
(nl,) global-node index list.  All solver operations become batched dense
contractions plus one gather and one segment-sum scatter:

    R v     = einsum('eqa,efa->eqf', rloc, v[idx])            (gather + matmul)
    R' y    = segment_sum(einsum('eqa,eqf->eaf', rloc, y))    (matmul + scatter)
    R' M R  = batched (nl x nl) element matrices, never built globally

Boundary (Dirichlet-eliminated) nodes are padded to slot `m`, whose basis
value is 0; gathers read a zero pad row and scatters drop the pad slot.
Shapes are static: nothing re-plans or recompiles inside the Newton loop.

Sharding: the element axis is the reference's row-block distribution
(SURVEY.md §2.5) — shard (nelem, ...) arrays over the 'dof' mesh axis,
replicate the (m+1, nf) coefficient vectors; XLA GSPMD inserts the psum
behind segment_sum where the reference built MPI plans by hand.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["idx", "rloc", "scatter_idx", "pair_idx"],
    meta_fields=["m"],
)
@dataclasses.dataclass(frozen=True)
class LevelBasis:
    """Element-local view of one inclusion matrix R: (nelem*nq, m).

    idx:  (nelem, nl) int32 — global subspace-node id of each local basis
          function; padded entries hold `m` (one-past-the-end pad slot).
    rloc: (nelem, nq, nl) — value of local basis function a at broken point
          q of element e.  Padded columns are 0.
    m:    number of real subspace dofs (static).
    scatter_idx: (m+1, width) int32 — the scatter->gather duality table:
          row a lists the flat positions e*nl + slot with idx[e, slot] == a,
          padded with nelem*nl (a zero sentinel row).  Adjoint applications
          become gathers + small sums, for hardware where scatters with
          duplicate indices serialize.
    pair_idx: (nelem, nl, nl) int32 — inverse-unique ids of the global node
          pairs (idx[e,a], idx[e,b]); see node_pair_table.  Lets the
          Schwarz smoother assemble principal submatrices of the global
          Newton matrix in element-local form (one segment-sum + one
          gather, linsolve.schwarz_setup) without a global sparse matrix.
    """

    idx: jnp.ndarray
    rloc: jnp.ndarray
    m: int
    scatter_idx: jnp.ndarray = None
    pair_idx: jnp.ndarray = None

    @property
    def nelem(self) -> int:
        return self.idx.shape[0]

    @property
    def nl(self) -> int:
        return self.idx.shape[1]

    @property
    def nq(self) -> int:
        return self.rloc.shape[1]

    @property
    def n(self) -> int:
        return self.nelem * self.nq

    @property
    def shape(self):
        return (self.n, self.m)

    def pad_coeffs(self, v: jnp.ndarray) -> jnp.ndarray:
        """Append the zero pad row: (m, ...) -> (m+1, ...)."""
        pad = jnp.zeros((1,) + v.shape[1:], dtype=v.dtype)
        return jnp.concatenate([v, pad], axis=0)

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """R @ v for v: (m,) or (m, f) -> (n,) or (n, f)."""
        single = v.ndim == 1
        if single:
            v = v[:, None]
        ve = self.pad_coeffs(v)[self.idx]  # (nelem, nl, f)
        out = jnp.einsum("eqa,eaf->eqf", self.rloc, ve)
        out = out.reshape(self.n, v.shape[1])
        return out[:, 0] if single else out

    def scatter_add(self, flat: jnp.ndarray) -> jnp.ndarray:
        """Sum per-(element, slot) contributions into nodes: (nelem*nl, f)
        -> (m+1, f) with a zeroed pad row.

        segment_sum is the default (row gathers with tiny innermost dims
        waste vector lanes); `scatter_idx` remains available for layouts
        where the gather dual wins."""
        out = jax.ops.segment_sum(
            flat, self.idx.reshape(-1), num_segments=self.m + 1
        )
        return out.at[self.m].set(0.0)

    def rmatvec(self, y: jnp.ndarray) -> jnp.ndarray:
        """R.T @ y for y: (n,) or (n, f) -> (m,) or (m, f)."""
        single = y.ndim == 1
        if single:
            y = y[:, None]
        ye = y.reshape(self.nelem, self.nq, y.shape[1])
        contrib = jnp.einsum("eqa,eqf->eaf", self.rloc, ye)
        flat = contrib.reshape(self.nelem * self.nl, y.shape[1])
        out = self.scatter_add(flat)[: self.m]
        return out[:, 0] if single else out

    def to_scipy(self):
        import scipy.sparse as sp

        idx = np.asarray(self.idx)
        rloc = np.asarray(self.rloc)
        nelem, nq, nl = rloc.shape
        rows = np.repeat(np.arange(nelem * nq), nl)
        cols = np.broadcast_to(idx[:, None, :], (nelem, nq, nl)).reshape(-1)
        vals = rloc.reshape(-1)
        keep = cols < self.m
        return sp.csr_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=self.shape
        )

    def astype(self, dtype) -> "LevelBasis":
        return LevelBasis(
            idx=self.idx,
            rloc=self.rloc.astype(dtype),
            m=self.m,
            scatter_idx=self.scatter_idx,
            pair_idx=self.pair_idx,
        )


def node_pair_table(idx: np.ndarray, m: int, itype=np.int32) -> np.ndarray:
    """(nelem, nl, nl) inverse-unique ids of the node pairs
    (idx[e, a], idx[e, b]).

    Two (element, a, b) slots get the same id iff they address the same
    global (i, j) node pair, so `segment_sum(He.reshape(-1), ids)` followed
    by `[ids]` gathers every element the PRINCIPAL SUBMATRIX of the
    assembled global matrix restricted to its node set — the subdomain
    operator for the overlapping Schwarz smoother — without ever forming a
    global sparse matrix (the reference's SpGEMM/MUMPS path,
    src/MultiGridBarrierMPI.jl solve hook; SURVEY.md §3.5).  Static per
    basis; ids are < nelem*nl*nl, so shape-derived segment counts work
    inside jit."""
    idx = np.asarray(idx).astype(np.int64)
    nelem, nl = idx.shape
    keys = (idx[:, :, None] * (m + 1) + idx[:, None, :]).reshape(-1)
    _, inv = np.unique(keys, return_inverse=True)
    return inv.reshape(nelem, nl, nl).astype(itype)


def scatter_table(idx: np.ndarray, m: int, itype=np.int32) -> np.ndarray:
    """Build the node-major gather table for scatter_add: row a lists the
    flat positions e*nl + slot with idx[e, slot] == a, padded with
    nelem*nl (points at an appended zero row).  `itype` follows the
    backend index type (reference Ti control,
    src/MultiGridBarrierMPI.jl:233-234: Int64 for > 2B-entry problems)."""
    idx = np.asarray(idx)
    nelem, nl = idx.shape
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    # drop PAD slots (node id == m): the pad row is a discard row whose
    # gathered value is never read, but its slot count used to set the
    # table width for every real node — Dirichlet bases at fem2d L=7
    # produced a (16130, 1018) 66MB table (0.5GB at L=8) where the real
    # width is 6.
    nreal = int(np.searchsorted(sorted_ids, m))
    order = order[:nreal]
    sorted_ids = sorted_ids[:nreal]
    counts = np.bincount(sorted_ids, minlength=m + 1)
    width = int(counts[:m].max()) if m and nreal else 1
    table = np.full((m + 1, width), nelem * nl, dtype=itype)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(nreal) - starts[sorted_ids]
    table[sorted_ids, within] = order
    return table


def level_basis_from_csr(R, nq: int, dtype=None, itype=np.int32) -> LevelBasis:
    """Extract the element-local structure from a scipy CSR inclusion matrix.

    Requires rows of each element (nq consecutive rows) to reference a
    bounded set of columns — true for every FEM inclusion matrix here, where
    the columns of element e are the subspace nodes of its ancestor element.
    """
    import scipy.sparse as sp

    R = sp.csr_matrix(R)
    n, m = R.shape
    if n % nq:
        raise ValueError(f"rows {n} not a multiple of nq={nq}")
    nelem = n // nq

    from . import native

    res = native.csr_to_level_basis(
        R.indptr, R.indices, R.data, nelem, nq, m,
        dtype=np.dtype(dtype) if dtype is not None else R.dtype,
    )
    if res is not None:
        idx_n, rloc_n, _ = res
        return LevelBasis(
            idx=jnp.asarray(idx_n.astype(itype, copy=False)),
            rloc=jnp.asarray(rloc_n),
            m=int(m),
            scatter_idx=jnp.asarray(scatter_table(idx_n, int(m), itype=itype)),
            pair_idx=jnp.asarray(node_pair_table(idx_n, int(m), itype=itype)),
        )

    indptr, indices, data = R.indptr, R.indices, R.data
    # per-element column sets
    col_lists = []
    nl = 1
    for e in range(nelem):
        lo, hi = indptr[e * nq], indptr[(e + 1) * nq]
        cols = np.unique(indices[lo:hi])
        col_lists.append(cols)
        nl = max(nl, len(cols))

    idx = np.full((nelem, nl), m, dtype=itype)
    rloc = np.zeros((nelem, nq, nl), dtype=dtype or R.dtype)
    for e, cols in enumerate(col_lists):
        idx[e, : len(cols)] = cols
        pos = {c: a for a, c in enumerate(cols)}
        for q in range(nq):
            r = e * nq + q
            for k in range(indptr[r], indptr[r + 1]):
                rloc[e, q, pos[indices[k]]] += data[k]

    return LevelBasis(
        idx=jnp.asarray(idx),
        rloc=jnp.asarray(rloc),
        m=int(m),
        scatter_idx=jnp.asarray(scatter_table(idx, int(m), itype=itype)),
        pair_idx=jnp.asarray(node_pair_table(idx, int(m), itype=itype)),
    )
