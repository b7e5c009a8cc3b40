"""Coupled BLOCK geometric multigrid on the full (p,T[,S]) system.

Role (tools/diag_hard.py): on the
full-SPE10 hard systems every DECOUPLED diagonal row is multigrid-easy
(p 6, T 8, S 1-3 FGMRES iterations standalone) while the full system
needs ~97 — the cost is the (p,T,S) COUPLING, whose error components are
smooth and long-range (O(100)-cell mobility/enthalpy propagation).  Flat
point/line smoothers carry them one cell (one line) per application;
what is missing is a COARSE-GRID CORRECTION OF THE COUPLED SYSTEM.

This module provides exactly that: a Galerkin block multigrid hierarchy
on the untouched full-system stencil A (the same summation-restriction /
injection-prolongation pair as the production scalar GMG in
``precond/gmg.py``, lifted entry-wise to the per-cell nc×nc blocks),
smoothed with red-black BLOCK Gauss–Seidel at every level and closed
with a dense coarsest-level solve of the full coupled block system.
Used as the ``stage2="bgmg"`` smoother of the two-stage CPR/CPTR
combination (SURVEY.md §2.8's stage-2 "ILU(0)" role — here upgraded
from a flat smoother to a full cycle, which the reference's PETSc
composite-PC framework could express but thermalporous never did).

System-multigrid caveat, by design: Galerkin coarsening of the
SATURATION transport row is not variationally justified (the row is
hyperbolic), so the cycle is used as a *preconditioner component inside
FGMRES*, never as a standalone solver; the coarse rows still carry the
(p,T)↔S couplings that motivate it.  All lowering follows the
idioms of the scalar path (reshape/pad block-sums, repeat
prolongation, no gathers, no strided views).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from thermalporous_tpu.core.stencil import BlockStencil, invert_blocks
from thermalporous_tpu.precond.gmg import GMGConfig, _replicated, dense_inv


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockGMGState:
    """Coupled-system hierarchy (a pytree; rebuilt per preconditioner setup)."""

    stencils: tuple            # BlockStencil per level
    dinvs: tuple               # per-level (nc, nc, *shape) diagonal inverses
    coarse_inv: jax.Array      # dense inverse of the coarsest block system


def _bsum(x: jax.Array, dim: int, factors: tuple[int, ...]) -> jax.Array:
    """Sum over 2-cell blocks on factor-2 axes; grid axes are the LAST
    ``dim`` axes of ``x`` (works for residuals (nc,*s) and blocks
    (nc,nc,*s) alike; ragged tails zero-padded)."""
    lead = x.ndim - dim
    for axis in range(dim):
        if factors[axis] == 1:
            continue
        ax = axis + lead
        n = x.shape[ax]
        if n % 2 == 1:
            pad = [(0, 0)] * x.ndim
            pad[ax] = (0, 1)
            x = jnp.pad(x, pad)
        m = x.shape[ax] // 2
        new_shape = x.shape[:ax] + (m, 2) + x.shape[ax + 1:]
        x = x.reshape(new_shape).sum(axis=ax + 1)
    return x


def _bprolong(
    e: jax.Array, dim: int, fine_shape: tuple[int, ...],
    factors: tuple[int, ...],
) -> jax.Array:
    """Piecewise-constant injection back to the fine grid (lead-aware)."""
    lead = e.ndim - dim
    for axis in range(dim):
        if factors[axis] == 1:
            continue
        ax = axis + lead
        e = jnp.repeat(e, 2, axis=ax)
        n = fine_shape[axis]
        if e.shape[ax] != n:
            e = jax.lax.slice_in_dim(e, 0, n, axis=ax)
    return e


def block_galerkin_coarsen(
    st: BlockStencil, factors: tuple[int, ...] | None = None
) -> BlockStencil:
    """A_c = R·A·P with summation R / injection P, lifted to block entries.

    Identical cell-centric bookkeeping to the scalar
    ``gmg.galerkin_coarsen`` (a fine face interior to a coarse cell folds
    into the coarse diagonal, the rest into coarse off-diagonals), with
    every scalar coupling replaced by the cell's nc×nc block.  Exactness
    is asserted against the dense R·A·P product in
    ``tests/test_block_gmg.py``.
    """
    shape = st.grid_shape
    dim = len(shape)
    if factors is None:
        factors = tuple(2 if n > 1 else 1 for n in shape)

    def axis_mask(axis: int, even: bool) -> jax.Array:
        idx = jnp.arange(shape[axis])
        m = (idx % 2 == 0) if even else (idx % 2 == 1)
        view = [1] * (dim + 2)
        view[2 + axis] = shape[axis]
        return m.astype(st.diag.dtype).reshape(view)

    d = st.diag
    for a in range(dim):
        if factors[a] == 2:
            d = d + st.upper[a] * axis_mask(a, even=True)
            d = d + st.lower[a] * axis_mask(a, even=False)

    bs = lambda x: _bsum(x, dim, factors)
    coarse_up, coarse_lo = [], []
    for a in range(dim):
        if factors[a] == 2:
            coarse_up.append(bs(st.upper[a] * axis_mask(a, even=False)))
            coarse_lo.append(bs(st.lower[a] * axis_mask(a, even=True)))
        else:
            coarse_up.append(bs(st.upper[a]))
            coarse_lo.append(bs(st.lower[a]))
    return BlockStencil(
        diag=bs(d), upper=tuple(coarse_up), lower=tuple(coarse_lo)
    )


def block_gmg_setup(
    st: BlockStencil,
    gmg_cfg: GMGConfig,
    max_coarse_cells: int = 256,
    max_levels: int = 12,
) -> BlockGMGState:
    """Build the coupled hierarchy (per preconditioner setup).

    Coarsening is full factor-2 on every non-exhausted axis (the coupled
    error modes this cycle exists for are smooth in all directions; the
    scalar hierarchies keep the matrix-dependent schedules).  Levels at or
    below ``gmg_cfg.replicate_below`` cells are constrained fully
    replicated under a device mesh, exactly like the scalar path.
    """
    def maybe_rep(s: BlockStencil) -> BlockStencil:
        if (gmg_cfg.mesh is None
                or math.prod(s.grid_shape) > gmg_cfg.replicate_below):
            return s
        return jax.tree.map(lambda a: _replicated(a, gmg_cfg), s)

    stencils = [maybe_rep(st)]
    while (
        math.prod(stencils[-1].grid_shape) > max_coarse_cells
        and len(stencils) < max_levels
        and any(n > 1 for n in stencils[-1].grid_shape)
    ):
        stencils.append(maybe_rep(block_galerkin_coarsen(stencils[-1])))
    dinvs = tuple(invert_blocks(s.diag) for s in stencils[:-1])
    dense = stencils[-1].to_dense()
    return BlockGMGState(
        stencils=tuple(stencils),
        dinvs=dinvs,
        coarse_inv=dense_inv(dense),
    )


def _cycle(
    state: BlockGMGState, level: int, b: jax.Array, gmg_cfg: GMGConfig,
    sweeps: int,
) -> jax.Array:
    from thermalporous_tpu.precond.chebyshev import (
        block_red_black_gauss_seidel,
    )

    st = state.stencils[level]
    if level == len(state.stencils) - 1:
        nc = st.nc
        n = math.prod(st.grid_shape)
        e = state.coarse_inv @ b.reshape(nc * n)
        return e.reshape((nc,) + st.grid_shape)

    dinv = state.dinvs[level]
    fine = st.grid_shape
    coarse = state.stencils[level + 1].grid_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
    dim = len(fine)

    x = block_red_black_gauss_seidel(st, dinv, b, sweeps=sweeps)
    r = b - st.matvec(x)
    rc = _bsum(r, dim, factors)
    if (gmg_cfg.mesh is not None
            and math.prod(coarse) <= gmg_cfg.replicate_below):
        rc = _replicated(rc, gmg_cfg)
    ec = _cycle(state, level + 1, rc, gmg_cfg, sweeps)
    x = x + _bprolong(ec, dim, fine, factors)
    return block_red_black_gauss_seidel(st, dinv, b, x=x, sweeps=sweeps)


def block_gmg_apply(
    state: BlockGMGState, b: jax.Array, gmg_cfg: GMGConfig,
    sweeps: int = 1, cycles: int = 1,
) -> jax.Array:
    """``cycles`` coupled V-cycles approximating A⁻¹b on the full system."""
    x = _cycle(state, 0, b, gmg_cfg, sweeps)
    for _ in range(cycles - 1):
        r = b - state.stencils[0].matvec(x)
        x = x + _cycle(state, 0, r, gmg_cfg, sweeps)
    return x
