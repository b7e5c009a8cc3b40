"""A/B Eisenstat-Walker adaptive forcing (NewtonConfig.ksp_ew) on a preset.

Rationale: the non-flagship presets run the PETSc-default fixed
ksp_rtol=1e-5, which over-solves the inner systems on steps where Newton
contracts fast (the same effect the flagship measured: the fixed term ran
16-22 FGMRES/Newton where EW's contraction-based eta needed 3-6).  EW is
floored at the preset's ksp_rtol, and Newton always gates on the true
f64-accumulated residual, so the gate for adoption is a bounded final-state
diff (solver-tolerance-level) plus a wall win.

Usage: python tools/ab_ew.py <case> [<case> ...]
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp

from thermalporous_tpu.presets import get_case
from thermalporous_tpu.solve import Simulator


def run_with_ew(case, ew: bool):
    ncfg = dataclasses.replace(case.newton_cfg, ksp_ew=ew)
    sim = Simulator(case.model, case.data, precond=case.precond,
                    pc_cfg=case.pc_cfg, newton_cfg=ncfg,
                    time_cfg=case.time_cfg)
    t0 = time.perf_counter()
    res = sim.run(t_end=case.t_end)
    wall = time.perf_counter() - t0
    return res, wall


def main():
    for name in sys.argv[1:]:
        case = get_case(name)
        res_a, wall_a = run_with_ew(case, False)
        res_b, wall_b = run_with_ew(case, True)
        ua = jax.device_get(res_a.u)
        ub = jax.device_get(res_b.u)
        print(f"{name}: fixed steps={res_a.steps} newton={res_a.total_newton} "
              f"ksp={res_a.total_ksp} wall={wall_a:.1f}s")
        print(f"{name}: ew    steps={res_b.steps} newton={res_b.total_newton} "
              f"ksp={res_b.total_ksp} wall={wall_b:.1f}s")
        comp = ["p", "T", "S"][: ua.shape[0]]
        for c in range(ua.shape[0]):
            d = abs(ua[c] - ub[c])
            scale = max(abs(ua[c]).max(), 1e-30)
            print(f"  {comp[c]}: max|diff|={d.max():.6e}  rel={d.max()/scale:.3e}")


if __name__ == "__main__":
    main()
