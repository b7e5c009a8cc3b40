#!/usr/bin/env python
"""Library-API example: build a custom case from scratch and run it.

A five-spot-like pattern on a heterogeneous 2D grid with a rate-controlled
injector, four BHP producers, and a heater; two-phase dead-oil physics.
Shows the pieces a user of the reference's driver scripts would reach for:
geometry, petrophysics, wells, solver choice, telemetry, VTK output.

Run: python examples/custom_case.py [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--days", type=float, default=30.0)
    args = ap.parse_args()

    import jax

    if args.platform is not None:
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.platform])
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from thermalporous_tpu import Grid, PhysicalParams
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import (
        CoreyRelPerm,
        Heater,
        Well,
        per_well_masks,
        well_rates,
    )
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig
    from thermalporous_tpu.utils import convergence_summary

    # --- geometry + petrophysics -----------------------------------------
    n = 48
    grid = Grid(shape=(n, n), spacing=(8.0, 8.0), thickness=6.0)
    rng = np.random.default_rng(5)
    kx = 3e-13 * np.exp(0.8 * rng.standard_normal(grid.shape))

    # --- wells: center injector (rate), corner producers (BHP), one heater
    c = n // 2
    wells = [
        Well(cells=((c, c),), control="rate", rate=4.0, T_inj=430.0, name="INJ"),
        Well(cells=((1, 1),), control="bhp", p_bh=1.2e7, name="P_SW"),
        Well(cells=((1, n - 2),), control="bhp", p_bh=1.2e7, name="P_NW"),
        Well(cells=((n - 2, 1),), control="bhp", p_bh=1.2e7, name="P_SE"),
        Well(cells=((n - 2, n - 2),), control="bhp", p_bh=1.2e7, name="P_NE"),
    ]
    heaters = [Heater(cells=((c, c // 2),), power=2.0e5, name="HEAT")]

    pp = PhysicalParams()
    data = make_problem_data(grid, pp, kx=kx, phi=0.22, wells=wells, heaters=heaters)
    relperm = CoreyRelPerm(s_wr=0.1, s_or=0.15, n_w=2.0, n_o=2.0)
    model = TwoPhaseModel(grid, pp, relperm=relperm, s_init=0.15)

    # --- solve -------------------------------------------------------------
    sim = Simulator(
        model,
        data,
        precond="cptr",
        newton_cfg=NewtonConfig(ksp_maxiter=80),
        time_cfg=TimeConfig(dt_init=900.0, dt_max=3 * 86400.0),
    )
    result = sim.run(t_end=args.days * 86400.0, verbose=True)

    # --- report -------------------------------------------------------------
    print("\nconvergence:", convergence_summary(result.records))
    print("well rates (positive = into reservoir):")
    for name, rec in well_rates(model, result.u, data, per_well_masks(grid, wells, heaters)).items():
        print(f"  {name:6s}", {k: round(v, 4) for k, v in rec.items()})


if __name__ == "__main__":
    main()
