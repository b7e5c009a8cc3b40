"""Ensemble axis: batched parameter studies as data parallelism.

The reference has no batch dimension — every MPI rank works on one
realization (SURVEY.md §2 parallelism checklist marks DP "N/A", with an
optional ensemble axis listed as the cheap accelerator win).  Here it is: vmap the
fully-jitted implicit step over a leading ensemble axis (stacked
permeability fields, well controls, initial states …) and optionally shard
that axis over the device mesh — embarrassingly parallel history matching /
uncertainty quantification on one program.

Semantics: each member runs the SAME Newton/FGMRES/CPTR algorithm it would
run alone; ``vmap`` of the ``lax.while_loop``s masks converged members
until the whole batch is done, so per-member iteration counts in the
returned stats are exactly the single-run counts (tested).

Constraints:
- member-varying quantities must be ARRAY leaves of ``ProblemData`` (all
  members share static shapes: same grid, same number of wells);
- the preconditioner's multigrid uses one shared coarsening schedule —
  ``GMGConfig(coarsen="adaptive")`` would want per-member schedules, so
  ensemble runs use geometric coarsening (or one explicit
  ``level_factors`` planned from a representative member).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from thermalporous_tpu.models.base import ProblemData, ThermalModelBase
from thermalporous_tpu.precond.cpr import CPRConfig
from thermalporous_tpu.solve.newton import NewtonConfig
from thermalporous_tpu.solve.timeloop import make_step_fn


def stack_ensemble(datas: list[ProblemData]) -> ProblemData:
    """Stack per-member problem data along a new leading ensemble axis."""
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *datas)


def make_ensemble_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
):
    """Build ``advance_e(u_e, dt_e, data_e) -> (u_e, stats_e)``: the full
    implicit step vmapped over a leading ensemble axis.

    ``u_e``: (E, nc, *grid); ``dt_e``: (E,) — members may run different Δt;
    ``data_e``: a :func:`stack_ensemble`-stacked ``ProblemData``.
    """
    if pc_cfg is not None and pc_cfg.gmg.coarsen == "adaptive" and (
        pc_cfg.gmg.level_factors is None
    ):
        raise ValueError(
            "ensemble steps need a shared multigrid schedule: plan "
            "level_factors from a representative member (plan_coarsening) "
            "or use geometric coarsening"
        )
    advance = make_step_fn(model, precond, newton_cfg, pc_cfg)
    return jax.vmap(advance, in_axes=(0, 0, 0))


def shard_ensemble(tree, mesh, axis_name: str = "e"):
    """Constrain the leading ensemble axis of every array leaf onto a mesh
    axis (members whole per device — no halos, no collectives inside a
    member's solve; the only cross-device traffic is none)."""
    from jax.sharding import NamedSharding, PartitionSpec

    def put(a):
        spec = PartitionSpec(axis_name, *([None] * (a.ndim - 1)))
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)
