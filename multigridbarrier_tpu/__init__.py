"""multigridbarrier_tpu — a multigrid interior-point (barrier) framework in JAX.

A from-scratch JAX/XLA re-design of the capability stack of
sloisel/MultiGridBarrierMPI.jl (reference mounted at /root/reference):

    distributed FEM geometry construction -> multigrid hierarchy ->
    barrier/Newton solver -> distributed linear algebra -> linear solve ->
    solution gather/analysis

but built for batched accelerator execution rather than translated:

* Functions are represented by their values at quadrature points of a
  *broken* (element-wise polynomial) space.  Every differential operator
  is therefore block-diagonal over elements and is applied as a batch of
  small dense matmuls — there is no general sparse SpMV in the
  hot path (reference: HPCSparseMatrix SpMV/SpGEMM,
  /root/reference/src/MultiGridBarrierMPI.jl:62-192).
* The multigrid subspace hierarchy (reference `subspaces[:dirichlet]`,
  docs/src/api.md:79-88) is a set of padded-ELL inclusion matrices:
  gather for R v, segment-sum scatter for R' y.
* Barrier functions need only a scalar F0; the per-row gradient (F1) and
  Hessian (F2) of the reference (`map_rows` pipeline,
  tools/profile_barrier.jl) are obtained with jax.vmap(jax.grad/hessian).
* Distribution is GSPMD over a jax.sharding.Mesh on the element axis;
  the reference's MPI Allreduce/Allgather plans become XLA collectives.

Public API mirrors the reference's public surface
(/root/reference/src/MultiGridBarrierMPI.jl:748-752):
fem{1,2,3}d / fem{1,2,3}d_solve, amgb, parabolic_solve,
native_to_device/device_to_native (the native_to_mpi/mpi_to_native
equivalents), plus Backend construction.
"""

import os as _os

import jax as _jax

# Float64 is the correctness contract of the reference (1e-10 agreement,
# /root/reference/test/test_utils.jl:118).  Enable x64 before any array is
# created; the solver also supports f32.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: barrier solves compile one Newton-loop
# kernel per multigrid level, so caching across processes turns each
# compile into a disk hit on every run after the first.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache sits at a fixed
# path in the checkout (the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .backend import Backend, backend_auto, backend_cpu, backend_mesh  # noqa: E402
from .fem import fem1d, fem2d, fem3d, Geometry  # noqa: E402
from .solver import (  # noqa: E402
    amgb,
    AMGBSOL,
    parabolic_solve,
    ParabolicSOL,
    Convex,
    convex_linear,
    convex_Euclidian_power,
)
from .api import (  # noqa: E402
    fem1d_solve,
    fem2d_solve,
    fem3d_solve,
    native_to_device,
    device_to_native,
    NativeGeometry,
)
from .runtime import map_rows  # noqa: E402
from .utils import io0, plot, plot_parabolic, save_solution, load_solution  # noqa: E402

__all__ = [
    "io0",
    "plot",
    "plot_parabolic",
    "save_solution",
    "load_solution",
    "Backend",
    "backend_auto",
    "backend_cpu",
    "backend_mesh",
    "Geometry",
    "fem1d",
    "fem2d",
    "fem3d",
    "fem1d_solve",
    "fem2d_solve",
    "fem3d_solve",
    "amgb",
    "AMGBSOL",
    "parabolic_solve",
    "ParabolicSOL",
    "Convex",
    "convex_linear",
    "convex_Euclidian_power",
    "native_to_device",
    "device_to_native",
    "NativeGeometry",
    "map_rows",
]

__version__ = "0.1.0"
