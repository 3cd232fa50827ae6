"""Backend: device/precision/solver policy object.

The reference parameterizes every distributed object by an
``HPCBackend{T,Ti,Device,Comm,Solver}`` (reference
src/MultiGridBarrierMPI.jl:84-114, test/test_utils.jl:131) with CPU/CUDA/Metal
devices, serial/MPI communicators and MUMPS/cuDSS direct solvers.  The
JAX analogue collapses Device+Comm into a `jax.sharding.Mesh` (XLA
GSPMD emits the collectives) and Solver into a linear-solver policy
(dense Cholesky below a size threshold, multigrid-preconditioned CG above).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Name of the mesh axis over which the element/DOF dimension is sharded.
# The reference's only distribution scheme is 1-D row-block data parallelism
# over MPI ranks (SURVEY.md §2.5); 'dof' is its mesh-axis equivalent.
DOF_AXIS = "dof"


@dataclasses.dataclass(frozen=True)
class Backend:
    """Precision + device-mesh + linear-solver policy.

    Attributes:
      dtype: floating dtype for all geometry/solver arrays (f64 default —
        the reference's tolerance contract is Float64 1e-10).
      itype: integer dtype for ELL column indices (reference uses Int32 by
        default for index arrays, src/MultiGridBarrierMPI.jl:233-234).
      mesh: optional jax Mesh with a DOF_AXIS axis.  None = single device.
      dense_threshold: Newton systems with <= this many unknowns are solved
        with dense Cholesky (the MUMPS replacement, SURVEY.md §2.4);
        larger systems use the iterative path.  Direct solves are not an
        optimization but a CORRECTNESS requirement wherever affordable:
        mid-path barrier Hessians reach cond ~ 1e15 (measured fem2d L=3,
        tools/probe_mult_schwarz.py), where no preconditioned-CG variant
        resolves the physically meaningful soft tail — an exact-solve
        ground truth at fem2d L=5 converges to c=27.360702532 in 145
        Newton iterations while MG-CG paths land 1e-3 off at 2-10x the
        cost.  2048 puts the fem2d L=5 finest level (nf*m = 1922) on the
        direct path.
    """

    dtype: jnp.dtype = jnp.float64
    itype: jnp.dtype = jnp.int32
    mesh: Optional[jax.sharding.Mesh] = None
    dense_threshold: int = 2048

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def replace(self, **kw) -> "Backend":
        return dataclasses.replace(self, **kw)

    def row_sharding(self, ndim: int):
        spec = jax.sharding.PartitionSpec(DOF_AXIS, *([None] * (ndim - 1)))
        return jax.sharding.NamedSharding(self.mesh, spec)

    def shard_rows(self, arr):
        """Place/constrain the leading (element/row) axis of `arr` on the
        mesh (jax.device_put works both outside and under jit).

        Single-device backends return the array unchanged, so all solver code
        is written once and runs identically on 1..N devices (the reference's
        control-flow inversion, SURVEY.md §1)."""
        if self.mesh is None:
            return arr
        if arr.shape[0] % self.mesh.size:
            # Indivisible leading axis: fall back to replication, loudly —
            # geometries built by the fem builders are element-padded
            # (fem.geometry.pad_elements) so this should never fire on the
            # solve path; a silent fallback here would turn into an
            # invisible scaling cliff.
            import warnings

            warnings.warn(
                f"shard_rows: leading dim {arr.shape[0]} not divisible by "
                f"mesh size {self.mesh.size}; replicating instead of "
                "sharding (pad the element axis, see "
                "fem.geometry.pad_elements)",
                stacklevel=2,
            )
            return self.replicate(arr)
        return jax.device_put(arr, self.row_sharding(arr.ndim))

    def replicate(self, arr):
        if self.mesh is None:
            return arr
        spec = jax.sharding.PartitionSpec(*([None] * arr.ndim))
        return jax.device_put(
            arr, jax.sharding.NamedSharding(self.mesh, spec)
        )

    def pad_multiple(self) -> int:
        """Element counts are padded to a multiple of this so the sharded
        axis divides evenly across devices (static shapes; no remainder
        ranks, unlike the reference's uneven row partitions)."""
        return max(1, self.n_devices)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> jax.sharding.Mesh:
    """Create a 1-D ('dof',) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), (DOF_AXIS,))


def backend_cpu(dtype=jnp.float64, itype=jnp.int32, **kw) -> Backend:
    """Single-device backend (reference: backend_cpu_serial, src:95).

    Arrays live on JAX's default device: the GPU when one is visible,
    otherwise the CPU.

    Extra kwargs override Backend fields (e.g. dense_threshold=1<<30 for
    an exact-direct-solve ground-truth run, tools/check_exact.py)."""
    return Backend(dtype=dtype, itype=itype, mesh=None, **kw)


def backend_mesh(
    dtype=jnp.float64,
    itype=jnp.int32,
    n_devices: Optional[int] = None,
) -> Backend:
    """Meshed backend over all (or the first `n_devices`) local devices
    (reference: backend_cpu_mpi / backend_cuda_mpi, src:92-110).  A
    single device gives the unmeshed backend."""
    mesh = make_mesh(n_devices)
    if mesh.size == 1:
        return Backend(dtype=dtype, itype=itype, mesh=None)
    return Backend(dtype=dtype, itype=itype, mesh=mesh)


def backend_auto(dtype=jnp.float64) -> Backend:
    """A 'dof' mesh over EVERY visible device when more than one is
    present, else the single-device backend.  It is the default of the
    fem*_solve entry points, so on a four-GPU host they shard across all
    four cards unless a backend is passed."""
    return backend_mesh(dtype=dtype) if len(jax.devices()) > 1 else backend_cpu(dtype=dtype)
