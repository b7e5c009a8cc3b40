"""A/B the FGMRES iteration cap on the affected presets.

Rationale: the FGMRES buffers are statically shaped at ksp_maxiter, and
CGS2 streams the FULL basis every iteration (masked), so an oversized cap
is pure memory traffic.  Gate for adopting a smaller cap: identical
Newton/KSP trajectory and final state, or a bounded, component-attributed
diff within solver tolerance when the cap is actually hit.

Usage: python tools/ab_kspcap.py <case> <cap_a> <cap_b>
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp

from thermalporous_tpu.presets import get_case
from thermalporous_tpu.solve import Simulator


def run_with_cap(case, cap):
    ncfg = dataclasses.replace(case.newton_cfg, ksp_maxiter=cap)
    sim = Simulator(case.model, case.data, precond=case.precond,
                    pc_cfg=case.pc_cfg, newton_cfg=ncfg,
                    time_cfg=case.time_cfg)
    t0 = time.perf_counter()
    res = sim.run(t_end=case.t_end)
    wall = time.perf_counter() - t0
    return res, wall


def main():
    name, cap_a, cap_b = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    case = get_case(name)
    res_a, wall_a = run_with_cap(case, cap_a)
    res_b, wall_b = run_with_cap(case, cap_b)
    ua = jax.device_get(res_a.u)
    ub = jax.device_get(res_b.u)
    print(f"{name}: cap{cap_a} steps={res_a.steps} newton={res_a.total_newton} "
          f"ksp={res_a.total_ksp} wall={wall_a:.1f}s")
    print(f"{name}: cap{cap_b} steps={res_b.steps} newton={res_b.total_newton} "
          f"ksp={res_b.total_ksp} wall={wall_b:.1f}s")
    comp = ["p", "T", "S"][: ua.shape[0]]
    for c in range(ua.shape[0]):
        d = abs(ua[c] - ub[c])
        scale = max(abs(ua[c]).max(), 1e-30)
        print(f"  {comp[c]}: max|diff|={d.max():.6e}  rel={d.max()/scale:.3e}")


if __name__ == "__main__":
    main()
