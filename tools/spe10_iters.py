"""FGMRES/Newton iteration table on tp_spe10_full across the Δt ramp.

Target: flat ≤30 FGMRES/Newton across the ramp.
Compares pc_lag step (round-1 config) vs every, and semicoarsen_z.

Usage: python tools/spe10_iters.py [steps] [variant ...]
Variants: step, every, every-semiz, every-in2
"""

from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")


def main():
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.presets import tp_spe10_full
    from thermalporous_tpu.solve import Simulator

    nsteps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    names = sys.argv[2:] or ["step", "every", "every-semiz"]

    case = tp_spe10_full()
    model, data = case.model, case.data
    data32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if hasattr(a, "astype") else a, data
    )
    ncells = model.grid.ncells

    gmg = dict(cycle_type="k", max_coarse_cells=1024)
    variants = {
        "step": (dict(pc_lag="step"), {}),
        "every": (dict(pc_lag="every"), {}),
        "every-semiz": (dict(pc_lag="every"), dict(semicoarsen_z=True)),
        "every-in2": (dict(pc_lag="every"), {}),
        "every-deg4": (dict(pc_lag="every"), dict(degree=4)),
        "every-cyc2": (dict(pc_lag="every"), dict(cycles=2)),
        "every-rbgs": (dict(pc_lag="every"), dict(smoother="rbgs", degree=2)),
        "every-w": (dict(pc_lag="every"), dict(cycle_type="w")),
        "every-s2rbgs": (dict(pc_lag="every"), {}),
        "every-s2rbgs2": (dict(pc_lag="every"), {}),
        "every-adapt": (dict(pc_lag="every"), dict(coarsen="adaptive")),
        "every-adapt-rbgs": (dict(pc_lag="every"), dict(coarsen="adaptive")),
        "every-adapt-rbgs-deg4": (dict(pc_lag="every"),
                                  dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m48": (dict(pc_lag="every", ksp_maxiter=48),
                                      dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m40": (dict(pc_lag="every", ksp_maxiter=40),
                                      dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m32": (dict(pc_lag="every", ksp_maxiter=32),
                                      dict(coarsen="adaptive", degree=4)),
        # standalone-best config (58 iters vs 73 at 1 sweep) — in-step probe
        # of the 2-sweep stage 2 under the new preset
        "every-adapt-rbgs2-deg4-m40": (dict(pc_lag="every", ksp_maxiter=40),
                                       dict(coarsen="adaptive", degree=4)),
        # [P2] inner-GMRES stage 1 in-step under the new preset (anomaly probe)
        "every-adapt-rbgs-deg4-in2": (dict(pc_lag="every", ksp_maxiter=40),
                                      dict(coarsen="adaptive", degree=4)),
        # Richardson inner iterations: nested-Krylov-free inner option
        "every-adapt-rbgs-deg4-rich2": (dict(pc_lag="every", ksp_maxiter=40),
                                        dict(coarsen="adaptive", degree=4)),
        # round-3: Appleyard saturation chop on the production preset —
        # the dt≳21 h wall is Newton divergence (fronts leave the ball of
        # convergence), which the per-cell |dS| clamp targets directly
        "every-adapt-rbgs-deg4-m40-ds02": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m40-ds01": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.1),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m40-ds02-n24": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24),
            dict(coarsen="adaptive", degree=4)),
        # chop + NONMONOTONE acceptance: the ECLIPSE-style combination —
        # the clamped update is not a global descent direction while the
        # front advances, so Armijo rejects it in iteration 1 (measured);
        # nonmonotone accepts the physics-bounded update and polices
        # divergence by blow-up instead
        "every-adapt-rbgs-deg4-m40-ds02-nm": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone"),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m48-ds02-nm": (
            dict(pc_lag="every", ksp_maxiter=48, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone"),
            dict(coarsen="adaptive", degree=4)),
        # looser forcing term (ksp_rtol 1e-2) and bf16 basis on top of the
        # nm-chop production candidate (tools/ab_step.py)
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2-bf16": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        # Krylov cap 24 on the production levers: at ksp_rtol 1e-2 the
        # ramp averages ~12.6 FGMRES/Newton, yet CGS2 streams the full
        # static cap's basis slots every iteration (bench-workload A/B in
        # ab_step.py: same trajectory).
        # Hard steps that genuinely need >24 directions fail FASTER and
        # cheaper (inexact-Newton fallback + failure-memory controller).
        "every-adapt-rbgs-deg4-m24-ds02-nm-ksp2-bf16": (
            dict(pc_lag="every", ksp_maxiter=24, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        # Eisenstat–Walker forcing (PETSc -snes_ksp_ew v2, newton.py
        # ksp_ew) on the production preset: η adapts per Newton iteration
        # from the true-residual contraction, floored at ksp_rtol
        "every-adapt-rbgs-deg4-m24-ds02-nm-ksp2-bf16-ew": (
            dict(pc_lag="every", ksp_maxiter=24, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_ew=True),
            dict(coarsen="adaptive", degree=4)),
        # Krylov-cap rescan UNDER EW (post-adoption): EW solves run 3-6
        # directions typically, so the static cap's CGS2 basis-slot
        # streaming re-opens one more time at 16/12
        "every-adapt-rbgs-deg4-m16-ds02-nm-ksp2-bf16-ew": (
            dict(pc_lag="every", ksp_maxiter=16, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_ew=True),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m12-ds02-nm-ksp2-bf16-ew": (
            dict(pc_lag="every", ksp_maxiter=12, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_ew=True),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m32-ds02-nm-ksp2-bf16-ew": (
            dict(pc_lag="every", ksp_maxiter=32, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_ew=True),
            dict(coarsen="adaptive", degree=4)),
        # Asymmetric CPTR stage 1 (CPRConfig.gmg_t): cheap V-cycle/deg-2
        # TEMPERATURE hierarchy — tools/ab_cycle.py measured IDENTICAL
        # full-system iterations (62@1e-2 / 67@1e-3) at a cheaper apply;
        # "tvk8" adds pressure kcycle_min_cells=8192
        "every-adapt-rbgs-deg4-m16-ds02-nm-ksp2-bf16-ew-tv": (
            dict(pc_lag="every", ksp_maxiter=16, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_ew=True),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m16-ds02-nm-ksp2-bf16-ew-tvk8": (
            dict(pc_lag="every", ksp_maxiter=16, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_ew=True),
            dict(coarsen="adaptive", degree=4, kcycle_min_cells=8192)),
        # low-synch Gram-matrix CGS2 on the production ramp (round-3
        # follow-up, see fgmres.orth_gram): "g2" = 2 basis reads/iter with
        # a FULL-PRECISION basis — same bytes as bf16+cgs2's 4 reads but
        # no 4e-3 basis floor; "bf16-g3" = 3 bf16 reads (cheapest/iter,
        # trajectory-shifted on the 1024² bench workload)
        "every-adapt-rbgs-deg4-m24-ds02-nm-ksp2-g2": (
            dict(pc_lag="every", ksp_maxiter=24, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_orth="cgs2g2"),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m24-ds02-nm-ksp2-bf16-g3": (
            dict(pc_lag="every", ksp_maxiter=24, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16",
                 ksp_orth="cgs2g"),
            dict(coarsen="adaptive", degree=4)),
        # + operator-weighted prolongation (wide coarse stencils)
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2-bf16-wp": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4, transfer="weighted")),
        "every-adapt-rbgs-deg4-m40-ds02-nm-wp": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone"),
            dict(coarsen="adaptive", degree=4, transfer="weighted")),
        # + saturation stage-1 leg (CPTRS).  Post-diagnosis note: the
        # dt=76.8 ks wall turned out to be the (p,T,S) COUPLING (S alone
        # solves in 1-3 iters; s_stage measured neutral, 96 vs 97) — the
        # variant stays for the on-chip regression record.
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2-bf16-sstage": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        # stage-2 BLOCK zebra z-lines (the coupling-targeted smoother:
        # 76 vs 97 iters on the hard standalone system at x2 — does the
        # -22% pay for ~340 scan steps per application on-chip?
        "every-adapt-zebraz-deg4-m40-ds02-nm-ksp2-bf16": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-zebraz2-deg4-m40-ds02-nm-ksp2-bf16": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        # bf16 PC-coefficient storage on the production preset (selective
        # groups: hard-system bisect f32 69 / all 90 / gmg 77 / s2 73)
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2-bf16-pcbf16": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2-bf16-pcbf16s2": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        "every-adapt-rbgs-deg4-m40-ds02-nm-ksp2-bf16-pcbf16g": (
            dict(pc_lag="every", ksp_maxiter=40, ds_max=0.2, max_iters=24,
                 ls_mode="nonmonotone", ksp_rtol=1e-2, ksp_basis="bf16"),
            dict(coarsen="adaptive", degree=4)),
        "every-zebra": (dict(pc_lag="every"),
                        dict(smoother="zebra", degree=1)),
        "every-adapt-zebra": (dict(pc_lag="every"),
                              dict(coarsen="adaptive", smoother="zebra",
                                   degree=1)),
    }

    for name in names:
        n_over, g_over = variants[name]
        # the preset adopted ksp_ew=True (2026-08-19); pin EW explicitly
        # from the variant name so every historical variant keeps its
        # original meaning (only "-ew" variants run the adaptive forcing)
        n_over = {"ksp_ew": False, **n_over}
        ncfg = dataclasses.replace(case.newton_cfg, **n_over)
        pc_kw = dict(inner_iters=2 if "in2" in name else 0)
        if "rich2" in name:
            pc_kw.update(inner_iters=2, inner_method="richardson")
        if name.startswith("every-adapt-rbgs"):
            sweeps = 2 if name.startswith("every-adapt-rbgs2") else 1
            pc_kw.update(stage2="rbgs", stage2_sweeps=sweeps)
        if name == "every-s2rbgs":
            pc_kw.update(stage2="rbgs", stage2_sweeps=1)
        if name == "every-s2rbgs2":
            pc_kw.update(stage2="rbgs", stage2_sweeps=2)
        if name == "every-adapt-rbgs":
            pc_kw.update(stage2="rbgs", stage2_sweeps=1)
        if "sstage" in name:
            pc_kw.update(s_stage="rbgs", s_sweeps=2)
        if "pcbf16s2" in name:
            pc_kw.update(pc_dtype="bf16_s2")
        elif "pcbf16g" in name:
            pc_kw.update(pc_dtype="bf16_gmg")
        elif "pcbf16" in name:
            pc_kw.update(pc_dtype="bf16")
        if "zebraz" in name:
            pc_kw.update(stage2="zebra", stage2_axis=2,
                         stage2_sweeps=2 if "zebraz2" in name else 1)
        if "-tv" in name:  # asymmetric stage 1: cheap T hierarchy
            pc_kw.update(gmg_t=GMGConfig(
                **{**gmg, **g_over, "cycle_type": "v", "degree": 2,
                   "kcycle_min_cells": 256}))
        pc_cfg = CPRConfig(gmg=GMGConfig(**{**gmg, **g_over}), **pc_kw)
        sim = Simulator(model, data32, precond="cptr", newton_cfg=ncfg,
                        pc_cfg=pc_cfg, time_cfg=case.time_cfg)
        u = model.initial_state(data32, dtype=jnp.float32)
        dt = 600.0
        print(f"--- {name}")
        wall_tot = newton_tot = t_sim = 0.0
        for k in range(nsteps):
            t0 = time.perf_counter()
            u_new, stats = sim.step(u, dt)
            stats = jax.device_get(stats)
            w = time.perf_counter() - t0
            conv = bool(stats.converged)
            nit, kit = int(stats.iters), int(stats.ksp_iters)
            print(f"  step {k}: dt={dt:9.0f}s newton={nit:2d} "
                  f"ksp={kit:3d} ({kit/max(nit,1):5.1f}/N) conv={conv} "
                  f"wall={w:6.2f}s")
            if conv:
                u = u_new
                if k > 0:  # skip compile step in throughput
                    wall_tot += w
                    newton_tot += nit
                    t_sim += dt
                dt *= 2.0
            else:
                dt *= 0.5
        if wall_tot > 0:
            print(f"  -> sustained {ncells * newton_tot / wall_tot:,.0f} cu/s, "
                  f"t_sim/wall = {t_sim / wall_tot:,.0f}x realtime")


if __name__ == "__main__":
    main()
