"""thermalporous_tpu — a JAX reservoir-thermal simulator.

A from-scratch rebuild of the capabilities of ``tlroy/thermalporous``
(a Firedrake/PETSc research simulator for non-isothermal flow in porous
media, arXiv:1812.11566 and arXiv:1907.04229), designed for accelerators:

- structured grids as dense arrays (no unstructured mesh machinery);
- DG0 / two-point-flux finite volumes as fused stencil code;
- matrix-free Newton–Krylov (FGMRES) with exact Jacobian-vector products
  via ``jax.jvp``;
- CPR / CPTR two-stage block preconditioning with geometric multigrid
  replacing hypre BoomerAMG and parallel smoothers replacing ILU(0);
- multi-chip scaling via ``jax.sharding`` over the grid axes (XLA inserts
  the halo collectives that MPI performed in the reference).

Reference provenance: the reference mount was empty at build time — see
SURVEY.md §0.  Citations therefore point at the upstream module names
(`thermalporous/<module>.py`, unverified) and the two papers.
"""

__version__ = "0.1.0"

from thermalporous_tpu.core.grid import Grid
from thermalporous_tpu.physics.props import PhysicalParams

__all__ = ["Grid", "PhysicalParams", "__version__"]
