"""Array runtime — the HPCSparseArrays.jl replacement.

The reference runtime (reconstructed in SURVEY.md §2.2) provides
row-distributed HPCVector/HPCMatrix/HPCSparseMatrix with MPI-collective
SpMV/SpGEMM/blockdiag/hcat/spdiagm plus the `map_rows` SPMD map primitive.
Here the same capability is carried by three structures that map directly
onto batched accelerator execution:

* `Ell` — padded fixed-width sparse matrix (gather SpMV / segment-sum
  adjoint SpMV); used for subspace inclusions and level-transfer operators.
* `BlockDiagOp` — per-element dense blocks applied as batched matmuls;
  used for every differential operator.
* `map_rows` — `jax.vmap` over rows; the reference's MPI.Allgather
  type-detection sync (tools/profile_map_rows_steps.jl:86-117) vanishes
  because shapes are static under jit.
"""

from .ell import Ell, ell_from_coo, ell_from_scipy
from .blockdiag import BlockDiagOp
from .elements import LevelBasis, level_basis_from_csr
from .map_rows import map_rows
from .ops import (
    all_isfinite,
    blockdiag,
    clear_caches,
    getcol,
    hcat,
    spdiagm,
    transpose,
    vcat,
    zeros_like_operator,
)

# the reference distinguishes map_rows from map_rows_gpu (GPU-kernel row
# map, src/MultiGridBarrierMPI.jl:165-170); under jit the same vmap code
# path targets whatever backend the operands live on
map_rows_gpu = map_rows

__all__ = [
    "Ell",
    "ell_from_coo",
    "ell_from_scipy",
    "BlockDiagOp",
    "LevelBasis",
    "level_basis_from_csr",
    "map_rows",
    "map_rows_gpu",
    "hcat",
    "vcat",
    "blockdiag",
    "spdiagm",
    "transpose",
    "getcol",
    "all_isfinite",
    "zeros_like_operator",
    "clear_caches",
]
