"""A/B whole-step benchmark of solver-path variants on the bench workload.

Whole implicit steps, synced through the step's scalar stats: this runs
the bench.py workload (1024² two-phase CPTR, f32, sustained adaptive Δt
ramp) once per variant and reports cell-updates/s and t_sim/wall.

Usage: python tools/ab_step.py [n] [nsteps] [variant ...] [--cpu]
Variants: the keys of VARIANTS (e.g. r1, stencil, stencil-every, g3-deg4-tv)
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

VARIANTS = {
    # name: (newton overrides, pc overrides)
    "r1":              (dict(krylov_op="jvp"), dict()),
    "stencil":         (dict(krylov_op="stencil"), dict()),
    "stencil-every":   (dict(krylov_op="stencil", pc_lag="every"), dict()),
    "jvp-every":         (dict(krylov_op="jvp", pc_lag="every"), dict()),
    "stencil-every-ksp2":   (dict(krylov_op="stencil", pc_lag="every",
                                  ksp_rtol=1e-2), dict()),
    "stencil-every-v":      (dict(krylov_op="stencil", pc_lag="every"),
                             dict(cycle_type="v")),
    "stencil-every-s2rbgs": (dict(krylov_op="stencil", pc_lag="every"),
                             dict()),
    # coarse-level economics: the dense coarse inverse is rebuilt every
    # Newton iteration with pc_lag="every"; smaller coarsest levels trade
    # inv cost for cycle depth
    "stencil-every-c256":   (dict(krylov_op="stencil", pc_lag="every"),
                             dict(max_coarse_cells=256)),
    "stencil-every-c64":    (dict(krylov_op="stencil", pc_lag="every"),
                             dict(max_coarse_cells=64)),
    "stencil-every-k64":    (dict(krylov_op="stencil", pc_lag="every"),
                             dict(max_coarse_cells=1024,
                                  kcycle_min_cells=64)),
    "stencil-every-k1024":  (dict(krylov_op="stencil", pc_lag="every"),
                             dict(max_coarse_cells=1024,
                                  kcycle_min_cells=1024)),
    "stencil-every-deg4":   (dict(krylov_op="stencil", pc_lag="every"),
                             dict(degree=4)),
    "stencil-every-cyc2":   (dict(krylov_op="stencil", pc_lag="every"),
                             dict(cycles=2)),
    "stencil-every-rbgs-sm": (dict(krylov_op="stencil", pc_lag="every"),
                              dict(smoother="rbgs")),
    "stencil-every-deg6":   (dict(krylov_op="stencil", pc_lag="every"),
                             dict(degree=6)),
    "stencil-every-deg4-ksp2": (dict(krylov_op="stencil", pc_lag="every",
                                     ksp_rtol=1e-2), dict(degree=4)),
    # V-cycle under the production levers: the K-cycle revisits coarse
    # levels ~1.5x per apply — if the 2D bench workload converges equally
    # with V, the apply traffic drops for free
    "stencil-every-deg4v-bf16-ksp2": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4, cycle_type="v")),
    "stencil-every-deg4-cyc2": (dict(krylov_op="stencil", pc_lag="every"),
                                dict(degree=4, cycles=2)),
    # Krylov-space cap: CGS2 sweeps stream the full static basis, so a
    # smaller cap cuts orthogonalization traffic IF convergence still fits
    "stencil-every-deg4-m24": (dict(krylov_op="stencil", pc_lag="every",
                                    ksp_maxiter=24), dict(degree=4)),
    "stencil-every-deg4-m16": (dict(krylov_op="stencil", pc_lag="every",
                                    ksp_maxiter=16), dict(degree=4)),
    # Appleyard saturation chop on the bench workload's hard doubling steps
    "stencil-every-deg4-ds02": (dict(krylov_op="stencil", pc_lag="every",
                                     ds_max=0.2), dict(degree=4)),
    # bf16 basis + chop: the round-3 production candidate
    "stencil-every-deg4-bf16-ds02": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ds_max=0.2), dict(degree=4)),
    # bf16 Arnoldi-basis storage: halves the dominant CGS2 streaming
    # traffic; f32 accumulation, Z/solution stay f32 (round-3 roofline)
    "stencil-every-deg4-bf16": (dict(krylov_op="stencil", pc_lag="every",
                                     ksp_basis="bf16"), dict(degree=4)),
    "stencil-every-bf16":      (dict(krylov_op="stencil", pc_lag="every",
                                     ksp_basis="bf16"), dict()),
    # bf16 basis at a tolerance it can honestly reach (its true-residual
    # floor is ~4e-3): rtol 1e-2 stops where the basis precision allows
    "stencil-every-deg4-bf16-ksp2": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4)),
    # Krylov cap under the v3 levers: at ksp_rtol 1e-2 the typical solve
    # needs ~4-15 iterations, yet CGS2 streams the full static cap's basis
    # slots every iteration — a smaller cap cuts the #1 roofline term
    # proportionally.  (The round-2 "cap 16 craters the doubling workload"
    # verdict was measured at rtol 1e-3, where hard solves need the full
    # 40-space; the forcing term changed that calculus.)
    "stencil-every-deg4-bf16-ksp2-m24": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24), dict(degree=4)),
    "stencil-every-deg4-bf16-ksp2-m16": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=16), dict(degree=4)),
    "stencil-every-deg4-bf16-ksp2-m32": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=32), dict(degree=4)),
    # selective reorthogonalization (Rutishauser criterion): CGS2's second
    # pass only on cancellation-heavy iterations — the principled middle
    # between cgs2 (measured baseline) and cgs1 (measured trajectory
    # collapse); at cap 24 the skipped pass is ~2/4 of the basis traffic
    "stencil-every-deg4-bf16-ksp2-m24-cgs2s": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2s"),
        dict(degree=4)),
    "stencil-every-deg4-ksp2-m24-cgs2s": (
        dict(krylov_op="stencil", pc_lag="every",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2s"),
        dict(degree=4)),
    "stencil-every-deg4-ksp2-m24": (
        dict(krylov_op="stencil", pc_lag="every",
             ksp_rtol=1e-2, ksp_maxiter=24),
        dict(degree=4)),
    # low-synchronization CGS2 via the carried Gram matrix (fgmres
    # orth_gram; round-3 roofline follow-up): the second projection's
    # coefficients are algebraic, so the 4 basis reads per iteration
    # drop to 3 ("cgs2g": real-dots Gram column — the bf16-safe form)
    # or 2 ("cgs2g2": fully algebraic — full-precision basis only,
    # bf16 storage rounding breaks the algebraic column, measured)
    "stencil-every-deg4-bf16-ksp2-m24-g3": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4)),
    "stencil-every-deg4-ksp2-m24-g3": (
        dict(krylov_op="stencil", pc_lag="every",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4)),
    "stencil-every-deg4-ksp2-m24-g2": (
        dict(krylov_op="stencil", pc_lag="every",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g2"),
        dict(degree=4)),
    # cap under the cheaper g3 streaming: hard doubling steps benefit from
    # more directions, and g3 cut the per-slot cost 4->3 passes at bf16
    "stencil-every-deg4-bf16-ksp2-m32-g3": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=32, ksp_orth="cgs2g"),
        dict(degree=4)),
    # smoothing-degree re-scan under the FINAL round-3 config (the round-2
    # deg A/B predates forcing term + bf16 + cap 24 + cgs2g; the cap-24
    # roofline makes the CPTR apply the top bound term, and degree scales
    # it almost linearly)
    "g3-deg4": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4)),
    "g3-deg3": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=3)),
    "g3-deg5": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=5)),
    # stage-1 structure under the production levers: block-diagonal
    # (sequential) and the batched single-traversal form — the CPTR
    # apply is the top roofline bound term at cap 24, and batch_pt
    # halves its op count at whatever iteration cost diagonal carries
    # Eisenstat–Walker forcing (PETSc -snes_ksp_ew v2) on the production
    # levers: per-Newton-iteration η from the true-residual contraction,
    # floored at ksp_rtol (the bf16 basis' honest floor) — loose early
    # solves on the hard doubling steps where maxed-out 24-direction
    # solves at fixed 1e-2 may be over-solving the first iterations
    "g3-deg4-ew": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g", ksp_ew=True),
        dict(degree=4)),
    "g3-deg4-diag": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4)),
    # asymmetric CPTR stage 1 (CPRConfig.gmg_t): cheap V-cycle/deg-2
    # TEMPERATURE hierarchy — the flagship-measured lever (full-SPE10
    # ramp at identical-or-better iteration counts) probed on the 2D
    # bench workload
    "g3-deg4-tv": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4)),
    # + pressure K-recursion floored at 16k cells (2D analog of the
    # flagship's kcycle_min_cells=8192: the 4k/1k-cell deep levels are
    # kernel-launch latency the CG(2) recursion revisits 16-32x)
    "g3-deg4-tvk16": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4, kcycle_min_cells=16384)),
    "g3-deg4-batchpt": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_maxiter=24, ksp_orth="cgs2g"),
        dict(degree=4)),
    # single-pass CGS (PETSc's KSPGMRES default): halves the remaining
    # basis-streaming traffic on top of bf16 storage (roofline follow-up)
    "stencil-every-deg4-bf16-ksp2-cgs1": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2, ksp_orth="cgs1"), dict(degree=4)),
    "stencil-every-deg4-ksp2-cgs1": (
        dict(krylov_op="stencil", pc_lag="every",
             ksp_rtol=1e-2, ksp_orth="cgs1"), dict(degree=4)),
    # restarted FGMRES: small-basis traffic with the full iteration budget
    "stencil-every-deg4-r16": (dict(krylov_op="stencil", pc_lag="every",
                                    ksp_maxiter=48, ksp_restart=16),
                               dict(degree=4)),
    "stencil-every-deg4-r8":  (dict(krylov_op="stencil", pc_lag="every",
                                    ksp_maxiter=48, ksp_restart=8),
                               dict(degree=4)),
    # saturation stage-1 leg (CPTRS) on top of the production levers: the
    # bench workload's hard doubling steps are S-transport-bound too?
    "stencil-every-deg4-bf16-ksp2-sstage": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4)),
    # stage-2 block zebra lines (2D workload: axis 1) — the
    # coupling-propagation smoother from the dt=76.8ks diagnosis
    "stencil-every-deg4-bf16-ksp2-zebra": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4)),
    # bf16 PC-coefficient storage (CPRConfig.pc_dtype): halves the #2
    # roofline traffic term (the CPTR apply); setup stays f32,
    # applies stay f32 vector math.  CPU A/B: +5% iterations.
    "stencil-every-deg4-bf16-ksp2-pcbf16": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4)),
    # selective groups (hard-system bisect at dt=38.4 ks: f32 69 iters,
    # all-bf16 90, gmg-only 77, stage2-only 73 — tools/diag_hard.py)
    "stencil-every-deg4-bf16-ksp2-pcbf16s2": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4)),
    "stencil-every-deg4-bf16-ksp2-pcbf16g": (
        dict(krylov_op="stencil", pc_lag="every", ksp_basis="bf16",
             ksp_rtol=1e-2), dict(degree=4)),
}


def run_variant(name, model, data, u0, nsteps):
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.solve import NewtonConfig, make_step_fn

    newton_over, gmg_over = VARIANTS[name]
    kw = dict(rtol=1e-4, atol=2e-5, ksp_rtol=1e-3, ksp_maxiter=40,
              max_iters=14, pc_lag="step")
    kw.update(newton_over)
    cfg = NewtonConfig(**kw)
    gkw = dict(cycle_type="k", max_coarse_cells=1024)
    gkw.update(gmg_over)
    pc_kw = dict(stage2="rbgs") if name.endswith("s2rbgs") else {}
    if "sstage" in name:
        pc_kw.update(s_stage="rbgs", s_sweeps=2)
    if "zebra" in name:
        pc_kw.update(stage2="zebra", stage2_axis=1)
    if name.endswith("-diag"):
        pc_kw.update(triangular=False)
    if "-tv" in name:  # asymmetric stage 1: cheap T hierarchy
        pc_kw.update(gmg_t=GMGConfig(
            **{**gkw, "cycle_type": "v", "degree": 2,
               "kcycle_min_cells": 256}))
    if name.endswith("-batchpt"):
        pc_kw.update(triangular=False, batch_pt=True)
    if "pcbf16s2" in name:
        pc_kw.update(pc_dtype="bf16_s2")
    elif "pcbf16g" in name:
        pc_kw.update(pc_dtype="bf16_gmg")
    elif "pcbf16" in name:
        pc_kw.update(pc_dtype="bf16")
    pc_cfg = CPRConfig(gmg=GMGConfig(**gkw), **pc_kw)
    step = jax.jit(make_step_fn(model, "cptr", cfg, pc_cfg))

    import os

    growth = float(os.environ.get("AB_GROWTH", "1.5"))
    u = u0
    dt = 600.0
    u, stats = step(u, jnp.asarray(dt, u0.dtype), data)
    stats = jax.device_get(stats)  # one bulk transfer
    assert bool(stats.converged), f"{name}: warmup diverged"

    total_newton = total_ksp = 0
    t_sim = 0.0
    t0 = time.perf_counter()
    for _ in range(nsteps):
        dt *= growth
        u_new, stats = step(u, jnp.asarray(dt, u0.dtype), data)
        stats = jax.device_get(stats)
        retries = 0
        while not bool(stats.converged) and retries < 4:
            dt *= 0.5
            retries += 1
            u_new, stats = step(u, jnp.asarray(dt, u0.dtype), data)
            stats = jax.device_get(stats)
        assert bool(stats.converged)
        u = u_new
        t_sim += dt
        total_newton += int(stats.iters)
        total_ksp += int(stats.ksp_iters)
    wall = time.perf_counter() - t0
    ncells = u0.shape[1] * u0.shape[2]
    cu = ncells * total_newton / wall
    # t_sim/wall is the time-to-solution metric: variants take different
    # Δt-retry trajectories, so wall alone is not comparable across them
    print(f"{name:20s} wall={wall:7.2f}s newton={total_newton:3d} "
          f"ksp={total_ksp:4d} cu/s={cu:,.0f} "
          f"t_sim={t_sim:9.3e}s speedup={t_sim/wall:,.0f}x")
    return cu


def main():
    if "--cpu" in sys.argv:
        # same code on the host backend
        sys.argv.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    nsteps = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    names = sys.argv[3:] or list(VARIANTS)

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
    u0 = model.initial_state(data, dtype=dtype)

    print(f"# backend={jax.default_backend()} grid={n}x{n} f32 steps={nsteps}")
    for name in names:
        run_variant(name, model, data, u0, nsteps)


if __name__ == "__main__":
    main()
