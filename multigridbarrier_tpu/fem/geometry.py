"""Geometry — the multigrid FEM hierarchy container.

Mirrors the reference Geometry{T,X,W,M,D} contract
(/root/reference/docs/src/api.md:79-88):

- ``x``: (n, dim) quadrature-node coordinates
- ``w``: (n,) quadrature weights
- ``operators``: dict of differential operators on the broken space
  ('id', 'dx'[, 'dy'][, 'dz']), each an n x n block-diagonal operator
- ``subspaces``: dict name -> per-level inclusion matrices R_l (n x m_l)
  of the conforming FEM subspaces into the broken space (key 'dirichlet'
  observed in the reference, test/test_amg_structure.jl:32-58; 'full' also
  provided)
- ``refine``/``coarsen``: level-transfer operators between broken spaces of
  consecutive levels

plus two internal extras the batched design wants:

- ``embed``: per-subspace inter-level embeddings E_l (m_{l+1} x m_l) with
  R_{l+1} @ E_l == R_l (spaces are nested); used for multigrid transfers in
  the Newton linear solver.
- ``discretization``: static metadata (element topology, node tables) used
  for plotting, parabolic restarts and re-discretization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from ..backend import Backend
from ..runtime import BlockDiagOp, Ell, LevelBasis
from ..runtime.elements import node_pair_table, scatter_table


@dataclasses.dataclass(frozen=True)
class Discretization:
    """Static mesh metadata. `payload` holds builder-specific host arrays
    (e.g. triangle vertex tables) consumed by plotting and refinement."""

    name: str  # 'fem1d' | 'fem2d' | 'fem3d'
    dim: int
    L: int
    nelem: int
    nq: int  # quadrature/broken points per element
    payload: dict = dataclasses.field(default_factory=dict, repr=False)


@dataclasses.dataclass
class Geometry:
    discretization: Discretization
    x: jnp.ndarray  # (n, dim)
    w: jnp.ndarray  # (n,)
    operators: Dict[str, BlockDiagOp]
    subspaces: Dict[str, Tuple[Ell, ...]]
    refine: Tuple[Ell, ...]
    coarsen: Tuple[Ell, ...]
    embed: Dict[str, Tuple[Ell, ...]]
    backend: Backend
    # Element-local views of `subspaces` (same matrices, batched layout;
    # see runtime/elements.py).  The solver's canonical representation.
    bases: Dict[str, Tuple[LevelBasis, ...]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def levels(self) -> int:
        return len(self.subspaces["dirichlet"])

    def subspace_dims(self, key: str = "dirichlet") -> Tuple[int, ...]:
        return tuple(R.ncols for R in self.subspaces[key])

    def vertex_indices(self) -> np.ndarray:
        """Flat indices (into rows of ``x``) of broken points that sit at
        element vertices (reference: the `vertex_indices` raw-array hook,
        src/MultiGridBarrierMPI.jl:191-192; used for plotting/analysis).
        fem1d uses interior Gauss points, so no broken point is a vertex."""
        name = self.discretization.name
        nq = self.discretization.nq
        nelem = self.discretization.nelem
        if name == "fem2d":
            local = np.array([0, 1, 2])
        elif name == "fem3d":
            k = self.discretization.payload["k"]
            kp1 = k + 1
            corner = np.array([0, k])
            local = (
                corner[None, None, :]
                + kp1 * corner[None, :, None]
                + kp1 * kp1 * corner[:, None, None]
            ).ravel()
        else:
            return np.empty(0, dtype=np.int64)
        return (np.arange(nelem)[:, None] * nq + local[None, :]).ravel()

    @property
    def nelem_real(self) -> int:
        """Element count excluding mesh-divisibility padding."""
        return self.discretization.payload.get(
            "nelem_real", self.discretization.nelem
        )

    @property
    def n_real(self) -> int:
        """Broken-point count excluding mesh-divisibility padding: rows
        [n_real:] of x/w/z belong to inert padding elements (w = 0)."""
        return self.nelem_real * self.discretization.nq

    def with_backend(self, backend: Backend) -> "Geometry":
        """Re-home the geometry on a different backend (device mesh and/or
        dtype) — the `to_backend` migration of the reference
        (test/test_utils.jl:134-151)."""
        dt = backend.dtype
        cast_ell = lambda e: e.astype(dt)
        return Geometry(
            discretization=self.discretization,
            x=self.x.astype(dt),
            w=self.w.astype(dt),
            operators={k: op.astype(dt) for k, op in self.operators.items()},
            subspaces={
                k: tuple(cast_ell(R) for R in v) for k, v in self.subspaces.items()
            },
            refine=tuple(cast_ell(R) for R in self.refine),
            coarsen=tuple(cast_ell(R) for R in self.coarsen),
            embed={
                k: tuple(cast_ell(E) for E in v) for k, v in self.embed.items()
            },
            backend=backend,
            bases={
                k: tuple(B.astype(dt) for B in v) for k, v in self.bases.items()
            },
        )


def pad_elements(g: Geometry, mult: int) -> Geometry:
    """Pad the finest element axis to a multiple of `mult` with inert
    elements, so every sharded tensor's leading axis divides the device
    mesh exactly (the reference tolerates uneven MPI row partitions;
    GSPMD wants even shards — Backend.pad_multiple).

    Every per-level solver tensor (P_l, bases idx/rloc, x, w, c, z) is
    indexed by the *finest* element axis, so this one padding fixes
    divisibility for the whole hierarchy.  Inert elements are constructed
    to be exactly harmless:

    - w = 0 on their broken points (masked out of all weighted sums),
    - derivative operator blocks = 0 and basis rloc = 0, so Dz rows are
      (id: z0 values, gradients: 0) — strictly feasible for any barrier
      whose initial iterate is — and the Newton direction there is 0,
    - basis idx = m (the pad slot), so scatters drop their contributions.

    Coordinates duplicate the last real element (finite barrier/f/g
    evaluations).  `refine`/`coarsen` endpoints are re-shaped to the
    padded finest broken space (zero rows / zero columns).
    """
    disc = g.discretization
    nelem, nq = disc.nelem, disc.nq
    npad = (-nelem) % max(1, mult)
    if npad == 0:
        return g
    nelem_p = nelem + npad
    n_pad_rows = npad * nq
    dtype = g.x.dtype

    x_tail = jnp.tile(g.x[-nq:], (npad, 1))
    x_p = jnp.concatenate([g.x, x_tail], axis=0)
    w_p = jnp.concatenate(
        [g.w, jnp.zeros((n_pad_rows,), dtype=dtype)], axis=0
    )

    def pad_op(name: str, op: BlockDiagOp) -> BlockDiagOp:
        if op.is_identity:
            return BlockDiagOp.identity(nelem_p, nq, dtype)
        zeros = jnp.zeros((npad, nq, nq), dtype=op.blocks.dtype)
        return BlockDiagOp.from_blocks(
            jnp.concatenate([op.blocks, zeros], axis=0)
        )

    def pad_ell_rows(E: Ell) -> Ell:
        cols = jnp.concatenate(
            [E.cols, jnp.zeros((n_pad_rows, E.width), dtype=E.cols.dtype)]
        )
        vals = jnp.concatenate(
            [E.vals, jnp.zeros((n_pad_rows, E.width), dtype=E.vals.dtype)]
        )
        return Ell(cols=cols, vals=vals, shape=(E.nrows + n_pad_rows, E.ncols))

    def pad_ell_cols(E: Ell) -> Ell:
        return Ell(cols=E.cols, vals=E.vals, shape=(E.nrows, E.ncols + n_pad_rows))

    def pad_basis(B: LevelBasis) -> LevelBasis:
        itype = np.asarray(B.idx).dtype
        idx = np.concatenate(
            [np.asarray(B.idx), np.full((npad, B.nl), B.m, dtype=itype)]
        )
        rloc = jnp.concatenate(
            [B.rloc, jnp.zeros((npad, nq, B.nl), dtype=B.rloc.dtype)]
        )
        return LevelBasis(
            idx=jnp.asarray(idx),
            rloc=rloc,
            m=B.m,
            scatter_idx=jnp.asarray(scatter_table(idx, B.m, itype=itype)),
            pair_idx=jnp.asarray(node_pair_table(idx, B.m, itype=itype)),
        )

    payload = dict(disc.payload)
    payload.setdefault("nelem_real", nelem)
    refine = tuple(g.refine)
    coarsen = tuple(g.coarsen)
    if refine:
        refine = refine[:-1] + (pad_ell_rows(refine[-1]),)
    if coarsen:
        coarsen = coarsen[:-1] + (pad_ell_cols(coarsen[-1]),)
    return Geometry(
        discretization=dataclasses.replace(
            disc, nelem=nelem_p, payload=payload
        ),
        x=x_p,
        w=w_p,
        operators={k: pad_op(k, op) for k, op in g.operators.items()},
        subspaces={
            k: tuple(pad_ell_rows(R) for R in v)
            for k, v in g.subspaces.items()
        },
        refine=refine,
        coarsen=coarsen,
        embed=g.embed,
        backend=g.backend,
        bases={
            k: tuple(pad_basis(B) for B in v) for k, v in g.bases.items()
        },
    )
