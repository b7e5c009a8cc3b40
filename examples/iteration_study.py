#!/usr/bin/env python
"""Preconditioner iteration study — the experiment family of papers
arXiv:1812.11566 / arXiv:1907.04229.

Reproduces the reference's headline tables: FGMRES iterations per Newton
for {ILU-analog (block-Jacobi), CPR, CPTR} across grid refinement and
heterogeneity, where the CPTR property is near-flat counts.

Run: python examples/iteration_study.py [--platform cpu] [--tp]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--tp", action="store_true", help="two-phase instead of single")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.platform is not None:
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.platform])
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.data import SPE10_SPACING_M, synthetic_spe10
    from thermalporous_tpu.models import (
        SinglePhaseModel,
        TwoPhaseModel,
        make_problem_data,
    )
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import NewtonConfig, Simulator

    pp = PhysicalParams()
    model_cls = TwoPhaseModel if args.tp else SinglePhaseModel

    def homo_case(n):
        g = Grid(shape=(n, n), spacing=(400.0 / n, 400.0 / n), thickness=10.0)
        rng = np.random.default_rng(0)
        k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
        wells = [
            Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
            Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
        ]
        data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
        return model_cls(g, pp), data

    def spe10_case(layer=0):
        f = synthetic_spe10(seed=2020).layer(layer)
        nx, ny = f.kx.shape
        dx, dy, dz = SPE10_SPACING_M
        g = Grid(shape=(nx, ny), spacing=(dx, dy), thickness=dz)
        wells = [
            Well(cells=((nx // 2, ny // 2),), control="bhp", p_bh=3.5e7, T_inj=420.0),
            Well(cells=((2, 2),), control="bhp", p_bh=1.0e7),
        ]
        data = make_problem_data(g, pp, kx=f.kx, ky=f.ky, phi=f.phi, wells=wells)
        return model_cls(g, pp), data

    def stiff_case(n=80):
        from thermalporous_tpu.physics import Heater

        g = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
        rng = np.random.default_rng(0)
        k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
        wells = [
            Well(cells=((0, 0),), control="bhp", p_bh=3.5e7, T_inj=450.0),
            Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
        ]
        heaters = [Heater(cells=tuple((n // 2, j) for j in range(10, n - 10)),
                          power=5e6)]
        data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells,
                                 heaters=heaters)
        return model_cls(g, pp), data

    problems = [(f"homog {n}x{n}", *homo_case(n), 2.0e4) for n in (20, 40, 80)]
    problems.append(("SPE10-layer 60x220", *spe10_case(), 2.0e4))
    if not args.tp:
        # the [P2] regime: strong heat source + large dt separates CPTR from
        # pressure-only CPR (measured ~8.6 vs ~14.3 iters/Newton at 80x80)
        problems.append(("heater-stiff 80x80", *stiff_case(), 1.0e5))

    from thermalporous_tpu.precond import CPRConfig

    # one-stage presets (jacobi, rbgs: the ILU-analog ablations), two-stage
    # CPR/CPTR, and [P2]'s inner-GMRES CPTR variant (3 inner iterations)
    preconds = [
        ("jacobi", None),
        ("rbgs", None),
        ("cpr", None),
        ("cptr", None),
        ("cptr-in3", CPRConfig(variant="cptr", inner_iters=3)),
    ]
    if args.tp:
        # CPTRS: the saturation stage-1 leg (two-phase only — the S row is
        # the binding equation at large Δt, tools/diag_hard.py)
        preconds.append(
            ("cptr-s", CPRConfig(variant="cptr", stage2="rbgs",
                                 s_stage="rbgs", s_sweeps=2)))
    print(f"{'problem':20s} " + "  ".join(f"{p:>8s}" for p, _ in preconds)
          + "   (FGMRES iters per Newton, lower+flatter = better)")
    for name, model, data, dt in problems:
        row = []
        for pc, pc_cfg in preconds:
            sim = Simulator(model, data,
                            precond="cptr" if pc.startswith("cptr") else pc,
                            pc_cfg=pc_cfg,
                            newton_cfg=NewtonConfig(ksp_maxiter=300))
            u = model.initial_state(data)
            tot_k = tot_n = 0
            failed = False
            for _ in range(args.steps):
                u2, st = sim.step(u, dt)
                if not bool(st.converged):
                    failed = True
                    break
                u = u2
                tot_k += int(st.ksp_iters)
                tot_n += int(st.iters)
            row.append("   fail " if failed else f"{tot_k/max(tot_n,1):8.1f}")
        print(f"{name:20s} " + "  ".join(row))


if __name__ == "__main__":
    main()
