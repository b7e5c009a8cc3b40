"""Decompose the dt=76.8 ks full-SPE10 wall: WHICH part needs 90–150
FGMRES iterations — the pressure GMG, the temperature GMG, or the
two-stage coupling (decoupling quality / stage 2)?

Builds the hard system after the usual ramped warmup, then solves
STANDALONE:
  1. the decoupled scalar pressure system  (W·A)_pp e = r  with GMG,
  2. the decoupled scalar temperature system,
  3. the full system under CPTR variants (reference + ablations).
If (1)/(2) are cheap, the wall is the coupling and transfer-class work
is misdirected; if (1) is expensive, GMG quality on pressure binds and
the variational transfer / deflation levers are the right ones.

Usage: python tools/diag_hard.py [dt_seconds=76800] [--cpu] [--mid] [filters...]

--mid swaps the problem to the mid-size tp_spe10_3d preset (60×110×16,
106k cells) — small enough for CPU sweeps,
same channelized physics and production solver stack.
"""

from __future__ import annotations

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")

MID = "--mid" in sys.argv
if MID:
    sys.argv.remove("--mid")

import dataclasses

import jax.numpy as jnp


def main():
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.precond.cpr import (
        _decoupling_weights,
        cpr_apply,
        cpr_setup,
        resolve_adaptive_coarsening,
    )
    from thermalporous_tpu.precond.gmg import gmg_apply, gmg_setup
    from thermalporous_tpu.presets import tp_spe10_3d, tp_spe10_full
    from thermalporous_tpu.solve import Simulator
    from thermalporous_tpu.solve.fgmres import fgmres

    dt_hard = float(sys.argv[1]) if len(sys.argv) > 1 else 76800.0
    only = [s.lower() for s in sys.argv[2:]]

    case = tp_spe10_3d() if MID else tp_spe10_full()
    model, data = case.model, case.data
    dtype = jnp.float32
    data = jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "astype") else a, data)

    sim = Simulator(model, data, precond="cptr", newton_cfg=case.newton_cfg,
                    pc_cfg=case.pc_cfg)
    u = model.initial_state(data, dtype=dtype)
    dt = 600.0
    accepted = 0
    while accepted < 5:
        u_new, stats = sim.step(u, dt)
        if bool(jax.device_get(stats).converged):
            u = u_new
            accepted += 1
            dt *= 2.0
        else:
            dt *= 0.5
            assert dt > 1.0, "warmup cutback spiral"

    dt_j = jnp.asarray(dt_hard, dtype)

    @jax.jit
    def build(u, dt, data):
        f = model.residual(u, u, dt, data)
        st = model.assemble_stencil(u, u, dt, data)
        return f, st

    f, st = build(u, dt_j, data)
    print(f"# tp_spe10_full system at dt={dt_hard:.0f}s after 5-step ramp; "
          f"rtol=1e-3, maxiter=200")

    base = CPRConfig(stage2="rbgs",
                     gmg=GMGConfig(coarsen="adaptive", degree=4,
                                   cycle_type="k", max_coarse_cells=1024))
    base = resolve_adaptive_coarsening(st, base)
    print(f"# adaptive schedule: {base.gmg.level_factors}")

    def want(tag):
        return not only or any(s in tag.lower() for s in only)

    # --- scalar subsystem probes -------------------------------------
    def scalar_probe(tag, field, make_precond):
        """FGMRES on one decoupled scalar row; ``make_precond(app)`` builds
        the jit-traceable r ↦ M⁻¹r closure for it."""
        if not want(tag):
            return
        w = _decoupling_weights(st, base)
        app = st.scale_rows(w).scalar(field, field)

        @jax.jit
        def run(app, w, f):
            from thermalporous_tpu.precond.cpr import apply_blocks
            rhs = apply_blocks(w, -f)[field]
            res = fgmres(app.matvec, rhs, precond=make_precond(app),
                         rtol=1e-3, maxiter=200)
            return res.iters, res.converged

        it, conv = jax.device_get(run(app, w, f))
        print(f"{tag:46s} iters={int(it):4d} conv={bool(conv)}")

    def gmg_pc(gmg_cfg):
        def make(app):
            state = gmg_setup(app, gmg_cfg)
            return lambda r: gmg_apply(state, r, gmg_cfg)
        return make

    def smooth_pc(s_stage, sweeps, axis=0):
        pc = dataclasses.replace(base, s_stage=s_stage, s_sweeps=sweeps,
                                 s_axis=axis)

        def make(app):
            from thermalporous_tpu.precond.cpr import _s_smooth
            return lambda r: _s_smooth(app, r, pc)
        return make

    scalar_probe("PRESSURE system alone, production gmg", 0, gmg_pc(base.gmg))
    scalar_probe("TEMPERATURE system alone, production gmg", 1,
                 gmg_pc(base.gmg))
    if model.nc >= 3:
        scalar_probe("SATURATION alone, rbgs x2 pc", 2, smooth_pc("rbgs", 2))
        scalar_probe("SATURATION alone, rbgs x8 pc", 2, smooth_pc("rbgs", 8))
        scalar_probe("SATURATION alone, zebra y x2 pc", 2,
                     smooth_pc("zebra", 2, axis=1))
        scalar_probe("SATURATION alone, production gmg", 2, gmg_pc(base.gmg))
    g2 = dataclasses.replace(base.gmg, cycles=2)
    scalar_probe("pressure alone, 2 cycles", 0, gmg_pc(g2))
    gv = dataclasses.replace(base.gmg, transfer="weighted")
    scalar_probe("pressure alone, weighted-P", 0, gmg_pc(gv))
    for floor in (0.5, 0.0):
        gva = dataclasses.replace(base.gmg, transfer="variational",
                                  transfer_floor=floor)
        scalar_probe(f"pressure alone, VARIATIONAL floor={floor}", 0,
                     gmg_pc(gva))

    # --- full-system CPTR variants -----------------------------------
    def solve(tag, pc_cfg, maxiter=200, **ksp):
        if not want(tag):
            return
        pc_cfg = resolve_adaptive_coarsening(st, pc_cfg)
        state = jax.jit(lambda s: cpr_setup(s, pc_cfg))(st)

        @jax.jit
        def run(state, f, st):
            res = fgmres(st.matvec, -f,
                         precond=lambda r: cpr_apply(state, r, pc_cfg),
                         rtol=1e-3, maxiter=maxiter, **ksp)
            return res.iters, res.converged

        it, conv = jax.device_get(run(state, f, st))
        print(f"{tag:46s} iters={int(it):4d} conv={bool(conv)}")

    A = dict(coarsen="adaptive", cycle_type="k", max_coarse_cells=1024)
    solve("cptr production (adaptive deg4 s2rbgs)",
          CPRConfig(stage2="rbgs", gmg=GMGConfig(degree=4, **A)))
    # low-synch Gram-matrix CGS2 (fgmres orth_gram): iteration-count parity
    # gate at full scale before any wall A/B on the card — counts must
    # match the production cgs2 row (CPU counts reproduce the card's).  bf16 rows gate the storage-rounding interaction.
    P = CPRConfig(stage2="rbgs", gmg=GMGConfig(degree=4, **A))
    solve("cptr production, ORTH cgs2g f32", P, orth_gram=3)
    solve("cptr production, ORTH cgs2g2 f32", P, orth_gram=2)
    solve("cptr production, ORTH bf16 cgs2 base", P,
          basis_dtype=jnp.bfloat16)
    solve("cptr production, ORTH bf16 cgs2g", P,
          basis_dtype=jnp.bfloat16, orth_gram=3)
    solve("cptr production, ORTH bf16 cgs2g2", P,
          basis_dtype=jnp.bfloat16, orth_gram=2)
    # bf16 PC-coefficient storage bisected: which half loses quality at
    # SPE10 contrast + large dt (measured on the ramp: 27-31/N at 38.4 ks
    # under full bf16 vs ~18/N f32)?
    solve("cptr production, PCBF16 all",
          CPRConfig(stage2="rbgs", pc_dtype="bf16",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr production, PCBF16 gmg-only",
          CPRConfig(stage2="rbgs", pc_dtype="bf16_gmg",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr production, PCBF16 stage2-only",
          CPRConfig(stage2="rbgs", pc_dtype="bf16_s2",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 NONE",
          CPRConfig(stage2="none", gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 rbgs x2",
          CPRConfig(stage2="rbgs", stage2_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 rbgs x4",
          CPRConfig(stage2="rbgs", stage2_sweeps=4,
                    gmg=GMGConfig(degree=4, **A)))
    # coupled block-GMG stage 2 (precond/block_gmg.py): the coarse-grid
    # correction of the FULL system targeting the long-range coupling
    # modes the diagnosis identified
    solve("cptr, stage2 BGMG c256",
          CPRConfig(stage2="bgmg", bgmg_coarse_cells=256,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 BGMG c1024",
          CPRConfig(stage2="bgmg", bgmg_coarse_cells=1024,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 BGMG c256 x2sweeps",
          CPRConfig(stage2="bgmg", bgmg_coarse_cells=256, stage2_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 BGMG c256 cyc2",
          CPRConfig(stage2="bgmg", bgmg_coarse_cells=256, bgmg_cycles=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA y x1",
          CPRConfig(stage2="zebra", stage2_axis=1,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA y x2",
          CPRConfig(stage2="zebra", stage2_axis=1, stage2_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA x x1",
          CPRConfig(stage2="zebra", stage2_axis=0,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA z x1",
          CPRConfig(stage2="zebra", stage2_axis=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA y x1, decoupling timpes",
          CPRConfig(stage2="zebra", stage2_axis=1, decoupling="timpes",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA y om0.5",
          CPRConfig(stage2="zebra", stage2_axis=1, stage2_omega=0.5,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA z om0.7",
          CPRConfig(stage2="zebra", stage2_axis=2, stage2_omega=0.7,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr, stage2 ZEBRA z x2",
          CPRConfig(stage2="zebra", stage2_axis=2, stage2_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cpr (pressure-only stage1) s2rbgs",
          CPRConfig(variant="cpr", stage2="rbgs",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr NON-triangular (block-diag stage1)",
          CPRConfig(stage2="rbgs", triangular=False,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr decoupling=timpes",
          CPRConfig(stage2="rbgs", decoupling="timpes",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr decoupling=abf",
          CPRConfig(stage2="rbgs", decoupling="abf",
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr inner2 (pt-subsystem fgmres)",
          CPRConfig(stage2="rbgs", inner_iters=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr inner3",
          CPRConfig(stage2="rbgs", inner_iters=3,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr cycles=2",
          CPRConfig(stage2="rbgs", gmg=GMGConfig(degree=4, cycles=2, **A)))
    solve("cptr S-STAGE rbgs x2",
          CPRConfig(stage2="rbgs", s_stage="rbgs", s_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE rbgs x4",
          CPRConfig(stage2="rbgs", s_stage="rbgs", s_sweeps=4,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE rbgs x8",
          CPRConfig(stage2="rbgs", s_stage="rbgs", s_sweeps=8,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE jacobi x4",
          CPRConfig(stage2="rbgs", s_stage="jacobi", s_sweeps=4,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE zebra z x2",
          CPRConfig(stage2="rbgs", s_stage="zebra", s_axis=2, s_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE zebra x x2",
          CPRConfig(stage2="rbgs", s_stage="zebra", s_axis=0, s_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE zebra y x2",
          CPRConfig(stage2="rbgs", s_stage="zebra", s_axis=1, s_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE rbgs x2, stage2 bjac",
          CPRConfig(stage2="block_jacobi", s_stage="rbgs", s_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr S-STAGE rbgs x2, stage2 NONE",
          CPRConfig(stage2="none", s_stage="rbgs", s_sweeps=2,
                    gmg=GMGConfig(degree=4, **A)))
    solve("cptr VARIATIONAL floor=0.5",
          CPRConfig(stage2="rbgs",
                    gmg=GMGConfig(degree=4, transfer="variational",
                                  transfer_floor=0.5, **A)))
    solve("cptr VARIATIONAL floor=0.5 inner2",
          CPRConfig(stage2="rbgs", inner_iters=2,
                    gmg=GMGConfig(degree=4, transfer="variational",
                                  transfer_floor=0.5, **A)))


if __name__ == "__main__":
    main()
