"""Structured grids and TPFA geometry.

Replacement for the reference's geometry providers
(``thermalporous/rectanglegeo.py`` / ``boxgeo.py``, upstream, unverified —
SURVEY.md §2.5) and for the slice of Firedrake/DMPlex they exercise: here a
"mesh" is just a shape tuple plus spacings, and all fields are dense arrays.

Axis convention
---------------
Arrays are indexed ``[ix, iy]`` in 2D and ``[ix, iy, iz]`` in 3D.  Gravity
acts along the LAST axis of a 3D grid; the depth of a cell centre increases
with the z index (reservoir convention).  2D grids are horizontal (no
gravity) with a uniform ``thickness`` used for cell volumes, face areas and
Peaceman well indices — matching the reference's 2D cases.

State layout
------------
The unknown state is one stacked array ``u`` of shape ``(nc, *grid.shape)``
with component 0 = pressure ``p`` [Pa], component 1 = temperature ``T`` [K]
and (two-phase) component 2 = water saturation ``S`` [-].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a structured grid (hashable; safe as a jit static).

    Attributes:
      shape: cells per axis — ``(nx, ny)`` or ``(nx, ny, nz)``.
      spacing: cell size per axis in metres — ``(dx, dy[, dz])``.
      thickness: out-of-plane thickness for 2D grids [m].
      gravity: gravitational acceleration [m/s²] along the last axis of a 3D
        grid (0 disables gravity; 2D grids ignore it).
      depth_top: depth of the top face of the grid [m] (3D only).
    """

    shape: tuple[int, ...]
    spacing: tuple[float, ...]
    thickness: float = 1.0
    gravity: float = 0.0
    depth_top: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "spacing", tuple(float(s) for s in self.spacing))
        if len(self.shape) not in (2, 3):
            raise ValueError(f"Grid must be 2D or 3D, got shape {self.shape}")
        if len(self.spacing) != len(self.shape):
            raise ValueError("spacing must have one entry per axis")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def ncells(self) -> int:
        return math.prod(self.shape)

    @property
    def cell_volume(self) -> float:
        v = math.prod(self.spacing)
        if self.dim == 2:
            v *= self.thickness
        return v

    def face_area(self, axis: int) -> float:
        """Area of a cell face normal to ``axis``."""
        sizes = list(self.spacing)
        if self.dim == 2:
            sizes.append(self.thickness)
        del sizes[axis]
        return math.prod(sizes)

    @property
    def dz_well(self) -> float:
        """Perforation length of a vertical well through one cell."""
        return self.spacing[2] if self.dim == 3 else self.thickness

    def cell_depths(self, dtype=jnp.float64) -> jax.Array | None:
        """Depth of each cell centre, shape ``grid.shape`` (None in 2D)."""
        if self.dim == 2 or self.gravity == 0.0:
            return None
        nz = self.shape[2]
        dz = self.spacing[2]
        z = self.depth_top + (jnp.arange(nz, dtype=dtype) + 0.5) * dz
        return jnp.broadcast_to(z, self.shape)

    def cell_centers(self, dtype=jnp.float64) -> tuple[jax.Array, ...]:
        """Per-axis cell-centre coordinate arrays (1D each)."""
        return tuple(
            (jnp.arange(n, dtype=dtype) + 0.5) * d
            for n, d in zip(self.shape, self.spacing)
        )


def harmonic_face_transmissibility(
    grid: Grid, coeff_per_axis: Sequence[jax.Array]
) -> tuple[jax.Array, ...]:
    """Geometric TPFA face transmissibilities from a cell coefficient field.

    For a face between cells L,R along ``axis`` with cell coefficient k
    (permeability [m²] or conductivity [W/m/K]) the two-point flux
    transmissibility is the harmonic combination of the half-cell
    transmissibilities ``t = A·k/(Δ/2)``:

        T_f = A · 2·k_L·k_R / ((k_L + k_R) · Δ)

    This is the structured-grid equivalent of the facet terms the reference
    builds in UFL (``thermalporous/singlephase.py`` upstream, unverified;
    SURVEY.md §2.2) — DG0 on quads/hexes ≡ cell-centred TPFA.

    Args:
      coeff_per_axis: one cell-centred array of shape ``grid.shape`` per
        axis (anisotropy supported; pass the same array for isotropy).

    Returns:
      One FULL-shape array per axis: entry i holds T_f of the face between
      cells i and i+1 along that axis, and the last slice is zero — the
      no-flow boundary (the reference's only boundary condition).  Keeping
      face arrays cell-shaped makes every field in the problem uniformly
      shardable over the grid axes (domain decomposition needs no special
      cases for (n−1)-sized arrays).
    """
    out = []
    for axis in range(grid.dim):
        k = coeff_per_axis[axis]
        n = grid.shape[axis]
        kl = jax.lax.slice_in_dim(k, 0, n - 1, axis=axis)
        kr = jax.lax.slice_in_dim(k, 1, n, axis=axis)
        area = grid.face_area(axis)
        delta = grid.spacing[axis]
        denom = (kl + kr) * delta
        # impermeable-impermeable faces: harmonic mean is 0, not 0/0
        tf = jnp.where(denom > 0.0, area * 2.0 * kl * kr / jnp.where(denom > 0.0, denom, 1.0), 0.0)
        pad = [(0, 0)] * k.ndim
        pad[axis] = (0, 1)
        out.append(jnp.pad(tf, pad))
    return tuple(out)


def shift_minus(v: jax.Array, spatial_axis: int, lead: int = 1) -> jax.Array:
    """Value of the +axis neighbour placed at each cell (zero at the last slice).

    ``shift_minus(v)[i] = v[i+1]`` along the spatial axis; used to apply
    upper-diagonal stencil couplings.  ``lead`` is the number of leading
    non-spatial axes (1 for a ``(nc, *shape)`` state, 2 for stencil blocks).
    """
    axis = lead + spatial_axis
    n = v.shape[axis]
    body = jax.lax.slice_in_dim(v, 1, n, axis=axis)
    pad = jax.lax.slice_in_dim(jnp.zeros_like(v), 0, 1, axis=axis)
    return jnp.concatenate([body, pad], axis=axis)


def shift_plus(v: jax.Array, spatial_axis: int, lead: int = 1) -> jax.Array:
    """Value of the −axis neighbour placed at each cell (zero at the first slice).

    ``shift_plus(v)[i] = v[i-1]`` along the spatial axis.
    """
    axis = lead + spatial_axis
    n = v.shape[axis]
    body = jax.lax.slice_in_dim(v, 0, n - 1, axis=axis)
    pad = jax.lax.slice_in_dim(jnp.zeros_like(v), 0, 1, axis=axis)
    return jnp.concatenate([pad, body], axis=axis)


def neighbor_plus(u: jax.Array, spatial_axis: int, lead: int = 1) -> jax.Array:
    """Value of the +axis neighbour at each cell, EDGE-padded at the last slice.

    Used for face evaluations in full-shape layout: the phantom neighbour of
    the last cell is the cell itself, which keeps all property correlations
    finite (the corresponding face transmissibility is zero, so the phantom
    flux and its derivatives vanish exactly).
    """
    axis = lead + spatial_axis
    n = u.shape[axis]
    body = jax.lax.slice_in_dim(u, 1, n, axis=axis)
    edge = jax.lax.slice_in_dim(u, n - 1, n, axis=axis)
    return jnp.concatenate([body, edge], axis=axis)


def divergence_add(
    res: jax.Array, flux: jax.Array, spatial_axis: int, lead: int = 1
) -> jax.Array:
    """Scatter full-shape face fluxes into the cell residual.

    ``flux[i]`` is the flux through the face between cells i and i+1
    (positive in the +axis direction; the last entry is zero by
    construction).  It contributes +flux[i] to cell i and −flux[i] to
    cell i+1.
    """
    return res + flux - shift_plus(flux, spatial_axis, lead=lead)
