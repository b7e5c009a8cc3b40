"""Benchmark: cell-updates/s per chip on the flagship Newton–FGMRES–CPTR step.

Metric (BASELINE.json): cell-updates per second per chip, where one "cell
update" is one cell advanced through one Newton iteration (each Newton
iteration assembles the exact block-stencil Jacobian, rebuilds the CPTR
multigrid hierarchy, and runs an FGMRES solve over every cell).

Workload: 1024×1024 two-phase thermal flood (3.1M dof, f32), heterogeneous
permeability, BHP injector/producer, Δt doubling per step from the initial
transient up into the hard multi-day regime — the sustained envelope of a
real adaptive run, with the controller's cutback handling steps that
exceed Newton's ball of convergence.

Solver configuration (tools/ab_step.py A/Bs): pc_lag="every" (the
reference's behavior — the frozen per-step preconditioner stalls at 40
FGMRES iterations per Newton) and krylov_op="stencil" (the TPFA Jacobian IS
the assembled block stencil, so matvecs are transcendental-free and share
the assembly with the CPTR setup).  f64 reductions are enabled (x64 on,
state stays f32).

``vs_baseline`` is the ratio against a PETSc-CPU-class reference
throughput of 1.0e6 cell-updates/s: the upstream repo publishes no
benchmark numbers (BASELINE.json — ``published: {}``), so this proxy is the
order of magnitude a multicore PETSc CPR/ILU run achieves on problems of
this size.

Needs a GPU: it raises when JAX's default device is anything else.  The
line before the JSON result is the card's name and power limit
(``nvidia-smi``) and the devices JAX reports.
"""

from __future__ import annotations

import json
import time
import warnings

warnings.filterwarnings("ignore", message=".*truncated to dtype float32.*")

import jax

# f64 accumulation in FGMRES/Newton reductions (state stays f32); must be
# set before the backend is touched
try:
    jax.config.update("jax_enable_x64", True)
except RuntimeError:
    pass

import jax.numpy as jnp
import numpy as np

PETSC_CPU_CLASS_BASELINE = 1.0e6  # cell-updates/s, documented proxy (see above)


def main():
    from thermalporous_tpu.runtime import (
        device_summary,
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.solve import NewtonConfig, make_step_fn

    n = 1024
    dtype = jnp.float32
    pp = PhysicalParams()
    grid = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
    rng = np.random.default_rng(11)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal(grid.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(grid, pp, kx=kx, phi=0.2, wells=wells, dtype=dtype)
    model = TwoPhaseModel(grid, pp, s_init=0.2)
    ncells = grid.ncells

    # ksp_rtol 1e-2: the inexact-Newton forcing term (Newton convergence
    # still gates on the TRUE residual via rtol/atol); bf16 Arnoldi-basis
    # storage is honest at this tolerance (true-residual floor ~4e-3) and
    # halves the CGS2 basis streaming; cap 24 because at this forcing term
    # a typical solve needs ~4-15 directions while CGS2 streams the full
    # static cap every iteration; ksp_orth="cgs2g" (low-synch CGS2, real-
    # dots Gram column — the bf16-safe form) reads the basis 3 times per
    # iteration instead of 4 (tools/ab_step.py).
    cfg = NewtonConfig(rtol=1e-4, atol=2e-5, ksp_rtol=1e-2, ksp_maxiter=24,
                       max_iters=14, pc_lag="every", krylov_op="stencil",
                       ksp_basis="bf16", ksp_orth="cgs2g")
    # degree-4 Chebyshev smoothing: fewer Δt cutbacks at the hard end of
    # the ramp.  Asymmetric cheap-T stage 1: the decoupled temperature
    # hierarchy gets a V-cycle/deg-2 instead of the pressure block's
    # K-cycle/deg-4 at an identical accepted trajectory (tools/ab_step.py
    # g3-deg4-tv).  stage2_cols: the stage-2 residual streams only block
    # columns 0:2 of A — bit-exact (see CPRConfig.stage2_cols).
    pc_cfg = CPRConfig(stage2_cols=True,
                       gmg=GMGConfig(cycle_type="k", max_coarse_cells=1024,
                                     degree=4),
                       gmg_t=GMGConfig(cycle_type="v", max_coarse_cells=1024,
                                       degree=2))
    step = jax.jit(make_step_fn(model, "cptr", cfg, pc_cfg))

    def do_step(u, dt):
        u_new, stats = step(u, jnp.asarray(dt, dtype), data)
        # one bulk stats transfer, which also waits for the step to finish
        return u_new, jax.device_get(stats)

    # compile + consume the sharp initial transient
    u = model.initial_state(data, dtype=dtype)
    dt = 600.0
    u, stats = do_step(u, dt)
    assert bool(stats.converged)

    # sustained adaptive-style workload: Δt doubling into the multi-day
    # regime (with the controller's cutback so a hard step degrades the
    # number instead of killing the artifact)
    nsteps = 10
    total_newton = 0
    t0 = time.perf_counter()
    for _ in range(nsteps):
        dt *= 2.0
        u_new, stats = do_step(u, dt)
        retries = 0
        while not bool(stats.converged) and retries < 6:
            dt *= 0.5
            retries += 1
            u_new, stats = do_step(u, dt)
        assert bool(stats.converged), "benchmark step did not converge after cutbacks"
        u = u_new
        total_newton += int(stats.iters)
    wall = time.perf_counter() - t0

    value = ncells * total_newton / wall
    print(f"# {gpu_name_and_power_limit()}; jax devices {jax.devices()}")
    print(
        json.dumps(
            {
                "metric": "cell-updates/s per chip (Newton-FGMRES-CPTR, 2-phase 1024x1024, f32)",
                "value": round(value, 1),
                "unit": "cell-updates/s",
                "vs_baseline": round(value / PETSC_CPU_CLASS_BASELINE, 3),
                "device": device_summary(),
            }
        )
    )


if __name__ == "__main__":
    main()
