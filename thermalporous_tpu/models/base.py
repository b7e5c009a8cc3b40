"""Model base: generic TPFA residual evaluation and block-stencil assembly.

This is the replacement for the whole Firedrake assembly slice
the reference exercises (UFL forms → TSFC-generated C cell/facet kernels →
PyOP2 parloops; SURVEY.md §2.12–2.16 and §3.3).  A model is defined by two
*local* pure functions:

- ``cell_terms(u_cell, u_old_cell, dt, phi_cell, well_cell) -> (nc,)``
  accumulation (backward Euler) and well/heater sources of one cell;
- ``face_terms(axis, u_L, u_R, tgeo, tcond) -> (nc,)``
  TPFA fluxes (with upwinding and gravity) through one interior face.

The SAME local functions are used three ways:

1. broadcast over full arrays → the nonlinear residual (hot path; XLA fuses
   the elementwise chains);
2. under ``jax.jvp`` → exact matrix-free Jacobian-vector products for the
   Krylov operator (upwind ``where`` branches differentiate the selected
   branch, exactly the Newton linearization of an upwind FV scheme);
3. under ``vmap(jacfwd)`` → the exact per-cell block 7-point stencil of the
   Jacobian, consumed only by the CPR/CPTR preconditioner.

By construction (1)–(3) are mutually consistent to machine precision, which
the tests assert against dense ``jax.jacfwd``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from thermalporous_tpu.core.grid import (
    Grid,
    divergence_add,
    harmonic_face_transmissibility,
    neighbor_plus,
    shift_plus,
)
from thermalporous_tpu.core.stencil import BlockStencil
from thermalporous_tpu.physics.props import PhysicalParams
from thermalporous_tpu.physics.wells import (
    Heater,
    Well,
    WellFields,
    build_well_fields,
    empty_well_fields,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ProblemData:
    """All array-valued problem data (a pytree; jit argument).

    Fields:
      tgeo: per-axis geometric face transmissibilities A·k̄/Δ [m³], stored
        FULL-shape (face i→i+1 at index i, zero at the last slice), so every
        array in the problem shards uniformly over the grid axes.
      tcond: per-axis conductive face transmissibilities A·κ̄/Δ [W/K], same
        layout.
      phi: porosity field.
      wells: dense well/heater source fields.
    """

    tgeo: tuple[jax.Array, ...]
    tcond: tuple[jax.Array, ...]
    phi: jax.Array
    wells: WellFields


def make_problem_data(
    grid: Grid,
    pp: PhysicalParams,
    kx: np.ndarray | jax.Array,
    ky: np.ndarray | jax.Array | None = None,
    kz: np.ndarray | jax.Array | None = None,
    phi: np.ndarray | jax.Array | float = 0.2,
    wells: Sequence[Well] = (),
    heaters: Sequence[Heater] = (),
    dtype=jnp.float64,
) -> ProblemData:
    """Precompute transmissibilities and well fields for a case."""
    kx = jnp.asarray(kx, dtype=dtype) * jnp.ones(grid.shape, dtype=dtype)
    ky = kx if ky is None else jnp.asarray(ky, dtype=dtype) * jnp.ones(grid.shape, dtype=dtype)
    kz = kx if kz is None else jnp.asarray(kz, dtype=dtype) * jnp.ones(grid.shape, dtype=dtype)
    k_axes = [kx, ky, kz][: grid.dim]
    tgeo = harmonic_face_transmissibility(grid, k_axes)
    kappa = pp.kappa_eff * jnp.ones(grid.shape, dtype=dtype)
    tcond = harmonic_face_transmissibility(grid, [kappa] * grid.dim)
    phi_arr = jnp.asarray(phi, dtype=dtype) * jnp.ones(grid.shape, dtype=dtype)
    wf = build_well_fields(
        grid, wells, heaters, kx=np.asarray(kx), ky=np.asarray(ky), dtype=dtype
    )
    if not wells and not heaters:
        wf = empty_well_fields(grid, dtype=dtype)
    return ProblemData(tgeo=tgeo, tcond=tcond, phi=phi_arr, wells=wf)


class ThermalModelBase:
    """Shared residual/stencil machinery; subclasses define the local physics.

    Mirrors the role of the reference's ``ThermalModel`` +
    ``init_variational_form`` pair (``thermalporous/thermalmodel.py``,
    ``singlephase.py``/``twophase.py`` upstream, unverified — SURVEY.md
    §2.1–2.3), with UFL replaced by the two local functions.
    """

    nc: int = 0

    def __init__(self, grid: Grid, pp: PhysicalParams):
        self.grid = grid
        self.pp = pp
        # Static depth difference depth_L − depth_R across a face per axis:
        # gravity acts along the last axis of a 3D grid, depth grows with
        # index, so depth_L − depth_R = −dz there and 0 elsewhere.
        dd = [0.0] * grid.dim
        if grid.dim == 3 and grid.gravity != 0.0:
            dd[2] = -grid.spacing[2]
        self._ddepth = tuple(dd)

    # -- subclass contract -------------------------------------------------
    def cell_terms(self, u, u_old, dt, phi, well: WellFields):
        raise NotImplementedError

    def face_terms(self, axis: int, u_l, u_r, tgeo, tcond):
        raise NotImplementedError

    def initial_state(self, data: ProblemData, dtype=jnp.float64) -> jax.Array:
        raise NotImplementedError

    def residual_scales(self, u_old, dt, data: ProblemData) -> jax.Array:
        """Characteristic per-cell accumulation magnitudes, shape (nc, *grid).

        Used to nondimensionalize the Newton convergence test (the
        material-balance-style criterion of production reservoir
        simulators): |R_c| / scale_c is "fraction of a cell's content per
        step", robust across units, Δt and float32 (where rtol-vs-first-
        residual tests stall on the rounding floor of later, settled steps).
        """
        raise NotImplementedError

    # -- balance audit (io/balance.py) -------------------------------------
    def in_place_totals(self, u, data: ProblemData) -> jax.Array:
        """Total conserved content per equation row, shape (nc,).

        Must mirror the accumulation densities of :meth:`cell_terms`
        EXACTLY (same property correlations), so that the material-balance
        audit closes to the Newton tolerance: summing the backward-Euler
        residual over all cells telescopes the interior fluxes (no-flow
        boundaries), leaving ΔM = Δt·Q + Δt·Σ residual.
        """
        raise NotImplementedError

    def source_totals(self, u, data: ProblemData) -> jax.Array:
        """Net well/heater source per equation row at state ``u``, (nc,)."""
        q = self.well_sources(u, data.wells)
        return q.reshape(self.nc, -1).sum(axis=1)

    # -- residual (hot path) -------------------------------------------------
    def residual(self, u: jax.Array, u_old: jax.Array, dt, data: ProblemData) -> jax.Array:
        """Backward-Euler residual, shape (nc, *grid.shape).

        R_i = V·(acc(u_i) − acc(u_old_i))/Δt + Σ_faces F_f − q_i = 0.
        """
        res = self.cell_terms(u, u_old, dt, data.phi, data.wells)
        for axis in range(self.grid.dim):
            f = self.face_terms(
                axis,
                u,
                neighbor_plus(u, axis),
                data.tgeo[axis],
                data.tcond[axis],
            )
            res = divergence_add(res, f, axis, lead=1)
        return res

    # -- Krylov operator -------------------------------------------------
    def jvp(self, u, u_old, dt, data):
        """Returns v ↦ J(u)·v as a closure (exact, matrix-free)."""

        def op(v):
            return jax.jvp(lambda x: self.residual(x, u_old, dt, data), (u,), (v,))[1]

        return op

    # -- stencil assembly (preconditioner only) ---------------------------
    def assemble_stencil(self, u, u_old, dt, data: ProblemData) -> BlockStencil:
        """Exact block 7-point stencil of ∂R/∂u via broadcast-tangent JVPs.

        ``cell_terms`` and ``face_terms`` are pointwise per cell/face, so a
        tangent that is the c-th unit vector broadcast over every cell yields
        the c-th COLUMN of every local Jacobian block in one full-shape JVP
        pass — nc passes per term, all fused elementwise by XLA.  This
        replaces the earlier ``vmap(jacfwd)`` over flattened cells, whose
        (N, nc) transposes/moveaxes were pure layout traffic (measured:
        the dominant cost of assembly at 1024²).
        """
        grid = self.grid
        nc = self.nc
        dtype = u.dtype

        def col_tangent(c):
            e = jnp.zeros((nc,), dtype).at[c].set(1.0)
            return jnp.broadcast_to(e.reshape((nc,) + (1,) * grid.dim), u.shape)

        tangents = [col_tangent(c) for c in range(nc)]
        zero = jnp.zeros_like(u)

        cell_fn = lambda x: self.cell_terms(x, u_old, dt, data.phi, data.wells)
        diag = jnp.stack(
            [jax.jvp(cell_fn, (u,), (tc,))[1] for tc in tangents], axis=1
        )  # (nc_row, nc_col, *shape): [i, c] = ∂R_i/∂u_c of the same cell

        uppers, lowers = [], []
        for axis in range(grid.dim):
            # full-shape face layout: face i→i+1 evaluated at every cell i,
            # with an edge-padded phantom neighbour and zero transmissibility
            # on the last slice (flux and all derivatives vanish there).
            ur = neighbor_plus(u, axis)
            tg, tc_ = data.tgeo[axis], data.tcond[axis]
            face_fn = lambda a, b: self.face_terms(axis, a, b, tg, tc_)
            dfl = jnp.stack(
                [jax.jvp(face_fn, (u, ur), (t, zero))[1] for t in tangents],
                axis=1,
            )  # ∂F_face/∂u_left, (nc, nc, *shape)
            dfr = jnp.stack(
                [jax.jvp(face_fn, (u, ur), (zero, t))[1] for t in tangents],
                axis=1,
            )  # ∂F_face/∂u_right

            # face i adds +F to cell i and −F to cell i+1:
            #   ∂R_i/∂u_{i+1} = +dfr[i]              (upper coupling)
            #   ∂R_{i+1}/∂u_i = −dfl[i]              (lower coupling at i+1)
            #   ∂R_i/∂u_i    += dfl[i] − dfr[i−1]
            uppers.append(dfr)
            lowers.append(-shift_plus(dfl, axis, lead=2))
            diag = diag + dfl - shift_plus(dfr, axis, lead=2)

        return BlockStencil(diag=diag, upper=tuple(uppers), lower=tuple(lowers))
