"""Explicit halo-exchange residual evaluation (shard_map + ppermute).

The default multi-chip path lets XLA's SPMD partitioner insert the halo
collectives for the stencil shifts (dist/sharding.py).  This module is the
explicit alternative — the direct translation of the reference's
PyOP2/MPI halo exchange (SURVEY.md §5.8): each device owns a grid block,
exchanges one-cell ghost slices with its mesh neighbours via
``lax.ppermute``, and evaluates the SAME local physics on the extended
block.  Boundary fluxes are computed redundantly on both sides of each
block face (standard ghost-cell practice), so no flux exchange is needed.

Uses: validating the GSPMD path against a hand-scheduled reference (tests
assert equality to rounding), and the seed for manually overlapped
communication/compute once multi-chip hardware is available.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from thermalporous_tpu.core.grid import divergence_add, shift_plus
from thermalporous_tpu.models.base import ProblemData, ThermalModelBase


def _edge(x, spatial_axis, lead, first: bool):
    axis = lead + spatial_axis
    n = x.shape[axis]
    sl = (0, 1) if first else (n - 1, n)
    return jax.lax.slice_in_dim(x, *sl, axis=axis)


def _exchange(x, axis_name, spatial_axis, lead, from_right: bool, fill="edge"):
    """Ghost slice from the +axis (from_right) or −axis neighbour.

    Blocks with no neighbour in that direction receive ``fill``:
    - "edge": their own edge slice — correct for STATE ghosts (keeps property
      correlations finite; the zero boundary transmissibility kills the flux);
    - "zero": zeros — required for TRANSMISSIBILITY ghosts, so a phantom
      boundary face can never carry flux even when the ghost state differs
      from the edge state (e.g. gravity ddepth ≠ 0 if a gravity-bearing axis
      is ever decomposed).
    """
    idx = jax.lax.axis_index(axis_name)
    size = jax.lax.axis_size(axis_name)
    if from_right:
        send = _edge(x, spatial_axis, lead, first=True)      # my first slice
        perm = [(i, i - 1) for i in range(1, size)]          # i sends left
        missing = idx == size - 1
        own = _edge(x, spatial_axis, lead, first=False)
    else:
        send = _edge(x, spatial_axis, lead, first=False)     # my last slice
        perm = [(i, i + 1) for i in range(size - 1)]         # i sends right
        missing = idx == 0
        own = _edge(x, spatial_axis, lead, first=True)
    recv = jax.lax.ppermute(send, axis_name, perm)           # zeros if unpaired
    filler = jnp.zeros_like(own) if fill == "zero" else own
    return jnp.where(missing, filler, recv)


def make_halo_residual(
    model: ThermalModelBase,
    mesh: Mesh,
    data_template: ProblemData,
    axis_names: tuple[str, ...] = ("x", "y"),
):
    """Build residual(u, u_old, dt, data) evaluated blockwise under shard_map.

    The grid axes listed in ``axis_names`` are decomposed over the mesh;
    any remaining spatial axes (e.g. z) stay local.  ``data_template`` is
    only used for its pytree structure.
    """
    dim = model.grid.dim
    state_spec = P(None, *axis_names, *([None] * (dim - len(axis_names))))
    field_spec = P(*axis_names, *([None] * (dim - len(axis_names))))
    data_spec = jax.tree.map(lambda _: field_spec, data_template)

    def local_residual(u, u_old, dt, data):
        res = model.cell_terms(u, u_old, dt, data.phi, data.wells)
        for a in range(dim):
            if a < len(axis_names):
                name = axis_names[a]
                # ghosts: right neighbour cell, left neighbour cell + its
                # last face transmissibilities
                u_r = _exchange(u, name, a, 1, from_right=True)
                u_l = _exchange(u, name, a, 1, from_right=False)
                tg_l = _exchange(data.tgeo[a], name, a, 0, from_right=False, fill="zero")
                tc_l = _exchange(data.tcond[a], name, a, 0, from_right=False, fill="zero")

                axis = 1 + a
                u_ext = jnp.concatenate([u_l, u, u_r], axis=axis)
                # faces −1..b−1: left cells are u_ext[:-1], right u_ext[1:]
                ul = jax.lax.slice_in_dim(u_ext, 0, u_ext.shape[axis] - 1, axis=axis)
                ur = jax.lax.slice_in_dim(u_ext, 1, u_ext.shape[axis], axis=axis)
                tg = jnp.concatenate([tg_l, data.tgeo[a]], axis=a)
                tc = jnp.concatenate([tc_l, data.tcond[a]], axis=a)
                f = model.face_terms(a, ul, ur, tg, tc)
                # cell i gains +f[i+1] (its own face) − f[i] (left face)
                n = f.shape[axis]
                f_own = jax.lax.slice_in_dim(f, 1, n, axis=axis)
                f_left = jax.lax.slice_in_dim(f, 0, n - 1, axis=axis)
                res = res + f_own - f_left
            else:
                f = model.face_terms(
                    a,
                    u,
                    _neighbor_plus_local(u, a),
                    data.tgeo[a],
                    data.tcond[a],
                )
                res = divergence_add(res, f, a, lead=1)
        return res

    def _neighbor_plus_local(u, a):
        from thermalporous_tpu.core.grid import neighbor_plus

        return neighbor_plus(u, a, lead=1)

    fn = shard_map(
        local_residual,
        mesh=mesh,
        in_specs=(state_spec, state_spec, P(), data_spec),
        out_specs=state_spec,
    )
    return fn


def model_wells_struct():
    """A WellFields-shaped pytree of placeholders (for spec construction)."""
    from thermalporous_tpu.physics.wells import WellFields

    return WellFields(wi=0, pbh=0, tinj=0, has_tinj=0, qrate=0, qheat=0)
