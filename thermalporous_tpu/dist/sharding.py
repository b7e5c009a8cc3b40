"""Domain decomposition over device meshes.

The reference's only parallelism is MPI domain decomposition of the mesh
with halo exchange at assembly and allreduces in the Krylov solver
(SURVEY.md §2 checklist, §5.8).  The JAX equivalent needs no
communication code at all: every field in this package is a dense array
over the grid axes, so we

  1. build a 2D ``jax.sharding.Mesh`` over ('x', 'y'),
  2. place the state (nc, nx, ny[, nz]) with PartitionSpec(None, 'x', 'y')
     and every problem-data field with ('x', 'y', ...),
  3. jit the step — XLA's SPMD partitioner inserts the halo
     collective-permutes for the stencil shifts and the all-reduces for the
     FGMRES dot products (NCCL over NVLink on GPUs).

z stays local: TPFA columns, gravity and GMG z-coarsening then never
communicate (SURVEY.md §5.7).  Every GPU of a node reaches every other at
the same NVLink rate, so the mesh shape follows the grid alone: four
devices make a 2×2 mesh.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_grid_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A (close-to-square) 2D device mesh over axes ('x', 'y')."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    mx = int(np.floor(np.sqrt(n)))
    while n % mx:
        mx -= 1
    return Mesh(np.array(devices).reshape(mx, n // mx), ("x", "y"))


def state_spec() -> PartitionSpec:
    """PartitionSpec for a (nc, nx, ny[, nz]) state array."""
    return PartitionSpec(None, "x", "y")


def field_spec() -> PartitionSpec:
    """PartitionSpec for an (nx, ny[, nz]) cell field."""
    return PartitionSpec("x", "y")


def shard_state(u: jax.Array, mesh: Mesh) -> jax.Array:
    return jax.device_put(u, NamedSharding(mesh, state_spec()))


def shard_problem_data(data, mesh: Mesh):
    """Place every array-like leaf of ProblemData on the grid decomposition."""

    def place(a):
        a = jnp.asarray(a)
        if a.ndim >= 2:
            return jax.device_put(a, NamedSharding(mesh, field_spec()))
        return a

    return jax.tree.map(place, data)


def replicated(x: jax.Array, mesh: Mesh) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec()))
