"""Controller-driven full-SPE10 horizon run: time-to-solution A/B.

Unlike tools/spe10_iters.py (harness-driven Δt doubling), this drives
``Simulator.run`` itself — the product path users run — over a fixed
simulated horizon, so the Δt CONTROLLER's policy is what is measured.
Primary A/B: TimeConfig.fail_frac (failure memory) on the wall-bouncing
regime the doubling harness exposed at dt≈76.8 ks.

Usage: python tools/run_horizon.py [days=4] [--cpu] [--mid] [variants...]
Variants: base, fm (fail memory), fm-gentle (growth 1.5), base-gentle

CAVEAT: by default only ONE step program is compile-warmed before the
timed window.  Variants that introduce a SECOND program (fm-blk8's
jitted multi-step block, fm-pred's guess-taking step) pay its compile
INSIDE the window.  Pass ``--warm`` to run each variant's full horizon
once untimed first (steady-state measurement).  An unknown variant name
is an error.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")

MID = "--mid" in sys.argv
if MID:
    sys.argv.remove("--mid")

# --warm: run each variant's full horizon once UNtimed before the timed
# window, so multi-program variants (block_steps>1) are measured
# compile-warm — steady state, not the compile artifact.
WARM = "--warm" in sys.argv
if WARM:
    sys.argv.remove("--warm")

import jax.numpy as jnp


def main():
    from thermalporous_tpu.presets import tp_spe10_3d, tp_spe10_full
    from thermalporous_tpu.solve import Simulator, TimeConfig

    days = float(sys.argv[1]) if len(sys.argv) > 1 else 4.0
    names = sys.argv[2:] or ["base", "fm06vs"]  # fm06vs = the measured
    # production constants; plain "fm" (0.9/1.25) is the documented no-op
    t_end = days * 86400.0

    case = tp_spe10_3d() if MID else tp_spe10_full()
    model, data = case.model, case.data
    data = jax.tree.map(
        lambda a: a.astype(jnp.float32) if hasattr(a, "astype") else a, data)
    ncells = model.grid.ncells

    # the preset carries the production levers itself (EW forcing over a
    # 1e-2 floor, bf16 basis, cap 16, classic cgs2 — the controller-path
    # winner) — use as-is
    ncfg = case.newton_cfg

    tc_common = dict(dt_init=600.0, dt_max=2 * 86400.0,
                     grow_below=8, shrink_above=14)
    variants = {
        "base": dict(growth=2.0),
        # fail_frac=0.9 measured a NO-OP here: cutback 0.5 retries succeed
        # at half the failed dt, and one 1.25x relax releases a 0.9 cap
        # past the failed dt again — the cap must land AT/BELOW the
        # succeeding dt to change any decision
        "fm": dict(growth=2.0, fail_frac=0.9, fail_relax=1.25),
        "fm06": dict(growth=2.0, fail_frac=0.6, fail_relax=1.25),
        "fm06s": dict(growth=2.0, fail_frac=0.6, fail_relax=1.1),
        "fm05s": dict(growth=2.0, fail_frac=0.5, fail_relax=1.1),
        "fm06vs": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        "fm06vvs": dict(growth=2.0, fail_frac=0.6, fail_relax=1.02),
        "fm07vs": dict(growth=2.0, fail_frac=0.7, fail_relax=1.05),
        "fm-pred": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05,
                        predictor="linear"),
        "fm-blk8": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05,
                        block_steps=8),
        "base-gentle": dict(growth=1.5),
        "fm-gentle": dict(growth=1.5, fail_frac=0.9, fail_relax=1.25),
        # Krylov cap 24 on top of the production failure-memory constants:
        # cheaper CGS2 streaming + faster-failing hard steps, but the ramp
        # trajectory settles at dt 19.2 ks instead of 38.4 ks, so the
        # controller-driven horizon must confirm it.
        "fm-m24": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # orthogonalization A/B arm: force the low-synch cgs2g against the
        # preset's cgs2 on the controller-driven path (cgs2g lost here
        # despite winning the harness ramp)
        "fm-cgs2g": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # Eisenstat–Walker forcing A/B (newton.py ksp_ew; left-scaled
        # inner system): 600 vs 1305 total KSP on the 8-day horizon — the
        # fixed 1e-2 term over-solves the hard steps at 16-22 ksp/N where
        # EW runs 3-6/N.  ADOPTED in tp_spe10_full, so the preset arms
        # above all run WITH EW; "fm-noew" is the regression control that
        # reproduces the pre-EW production behavior.
        "fm-ew": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        "fm-noew": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # Krylov-cap rescan under the adopted EW forcing (EW solves
        # typically take 3-6 directions, CGS2 still streams the full
        # static cap's basis slots)
        "fm-m12": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        "fm-m16": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # pc_lag rescan under the adopted EW forcing: the earlier verdict
        # (frozen per-step PC stalls FGMRES at the cap) predates EW — with ~8 Newton/step now, freezing the CPTR hierarchy at step
        # start skips ~7 setups/step if the stale PC doesn't cost
        # iterations/retries.
        "fm-pclag": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # asymmetric CPTR stage 1 (cheap V/deg-2 TEMPERATURE hierarchy;
        # ab_cycle.py: identical full-system iterations; "tvk8" adds
        # pressure kcycle_min_cells=8192)
        "fm-tv": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        "fm-tvk8": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # the preset ADOPTED stage2_cols (bit-exact); "fm-s2off" is the
        # regression control with it disabled
        "fm-s2off": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # sparsified (z-only / yz) smoother operator on the LOOPED rbgs
        # (NOT exact — iteration/trajectory gated)
        "fm-s2z": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        "fm-s2yz": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        # two-step block-Jacobi stage 2 (mask-free; see CPRConfig.stage2
        # "jacobi2") and plain block-Jacobi — iteration/trajectory gated
        "fm-s2j2": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
        "fm-s2bj": dict(growth=2.0, fail_frac=0.6, fail_relax=1.05),
    }

    for name in names:
        model, data = case.model, case.data
        data = jax.tree.map(
            lambda a: a.astype(jnp.float32) if hasattr(a, "astype") else a,
            data)
        if name not in variants:
            raise SystemExit(f"unknown variant {name!r}; one of "
                             f"{sorted(variants)}")
        tc = TimeConfig(**{**tc_common, **variants[name]})
        nc = dataclasses.replace(ncfg, ksp_maxiter=24) if "m24" in name \
            else ncfg
        if "cgs2g" in name:
            nc = dataclasses.replace(nc, ksp_orth="cgs2g")
        if name.endswith("-ew") and not name.endswith("-noew"):
            nc = dataclasses.replace(nc, ksp_ew=True)
        if name.endswith("-noew"):
            nc = dataclasses.replace(nc, ksp_ew=False)
        if "-m12" in name:
            nc = dataclasses.replace(nc, ksp_maxiter=12)
        if "-m16" in name:
            nc = dataclasses.replace(nc, ksp_maxiter=16)
        if "pclag" in name:
            nc = dataclasses.replace(nc, pc_lag="step")
        pc_cfg = case.pc_cfg
        if "s2off" in name:
            pc_cfg = dataclasses.replace(pc_cfg, stage2_cols=False)
        if "s2j2" in name:
            pc_cfg = dataclasses.replace(pc_cfg, stage2="jacobi2")
        if "s2bj" in name:
            pc_cfg = dataclasses.replace(pc_cfg, stage2="block_jacobi")
        if name.endswith("-s2z"):
            pc_cfg = dataclasses.replace(pc_cfg, stage2_axes=(2,))
        if name.endswith("-s2yz"):
            pc_cfg = dataclasses.replace(pc_cfg, stage2_axes=(1, 2))
        if "-tv" in name:
            gmg_p = case.pc_cfg.gmg
            if "tvk8" in name:
                gmg_p = dataclasses.replace(gmg_p, kcycle_min_cells=8192)
            pc_cfg = dataclasses.replace(
                case.pc_cfg, gmg=gmg_p,
                gmg_t=dataclasses.replace(case.pc_cfg.gmg, cycle_type="v",
                                          degree=2))
        sim = Simulator(model, data, precond="cptr", newton_cfg=nc,
                        pc_cfg=pc_cfg, time_cfg=tc)
        u0 = model.initial_state(data, dtype=jnp.float32)
        # compile + initial transient outside the timed window
        u0, st = sim.step(u0, 300.0)
        assert bool(jax.device_get(st).converged)
        if WARM:
            # full untimed pass first: compiles every program the horizon
            # touches (the jitted block for block_steps>1), whose compiles
            # would otherwise land INSIDE the window
            sim.run(t_end=t_end, u0=u0, dt0=600.0, verbose=False)
        t0 = time.perf_counter()
        # verbose prints add a host fetch per step; keep them off for the
        # blocked variants whose whole point is dispatch amortization
        res = sim.run(t_end=t_end, u0=u0, dt0=600.0,
                      verbose="blk" not in name and not WARM)
        wall = time.perf_counter() - t0
        retries = sum(r.retries for r in res.records)
        cu = ncells * res.total_newton / wall
        print(f"=== {name}: steps={res.steps} retries={retries} "
              f"newton={res.total_newton} ksp={res.total_ksp} "
              f"wall={wall:.1f}s  t_sim/wall={t_end / wall:,.0f}x  "
              f"cu/s={cu:,.0f}")


if __name__ == "__main__":
    main()
