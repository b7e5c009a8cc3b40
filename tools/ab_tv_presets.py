"""A/B the asymmetric cheap-T CPTR stage 1 on the non-flagship presets.

The flagship's measured lever: the
decoupled TEMPERATURE system is diffusion-dominated and easy, so giving
it a V-cycle hierarchy (instead of the pressure block's K-cycle) and
flooring the pressure K-recursion below a latency-bound level size cuts
the CPTR apply cost at identical iteration counts.  This probes the same
two knobs on the other presets.

Methodology: host-loop wall includes a host round trip per step, which
can hide an apply-cost change.  The probe therefore runs the BLOCKED loop
(block_steps=8, the per-config table's production column): host-advance
nsteps adaptive steps once to fix the simulated window, then interleave
compile-warm blocked runs control/variant/control/variant over that same
window.  Gate for adoption: iteration counts unchanged (the lever is
pure apply cost) + reproducible wall win.

Usage: python tools/ab_tv_presets.py \
           [nsteps] <case> [<case> ...]
Env: TV_KMIN (pressure kcycle_min_cells floor for the variant; default
4096, 0 = leave the preset's value).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import jax

try:
    jax.config.update("jax_enable_x64", True)
except RuntimeError:
    pass

import jax.numpy as jnp


def blocked_sim(case, pc_cfg, model, data):
    from thermalporous_tpu.solve import Simulator

    return Simulator(model, data, precond=case.precond, pc_cfg=pc_cfg,
                     newton_cfg=case.newton_cfg,
                     time_cfg=dataclasses.replace(case.time_cfg,
                                                  block_steps=8))


def measure(sim, u0, t_end, max_steps):
    t0 = time.perf_counter()
    res = sim.run(t_end=t_end, u0=u0, max_steps=max_steps)
    wall = time.perf_counter() - t0
    return res, wall


def main():
    from thermalporous_tpu.precond import CPRConfig
    from thermalporous_tpu.solve import Simulator

    from thermalporous_tpu.presets import get_case

    args = sys.argv[1:]
    nsteps = int(args.pop(0)) if args and args[0].isdigit() else 10
    names = args or ["sp_geothermal_3d", "tp_spe10_3d"]
    kmin = int(os.environ.get("TV_KMIN", "4096"))

    for name in names:
        case = get_case(name)
        model, data = case.model, case.data
        data = jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if hasattr(a, "astype") and jnp.issubdtype(a.dtype, jnp.floating)
            else a,
            data,
        )
        pc0 = case.pc_cfg or CPRConfig()
        gmg_t = dataclasses.replace(pc0.gmg, cycle_type="v", degree=2)
        gmg_p = (dataclasses.replace(pc0.gmg, kcycle_min_cells=kmin)
                 if kmin else pc0.gmg)
        pc_tv = dataclasses.replace(pc0, gmg=gmg_p, gmg_t=gmg_t)

        # fix the simulated window with one host-loop pass (control config)
        sim_host = Simulator(model, data, precond=case.precond, pc_cfg=pc0,
                             newton_cfg=case.newton_cfg,
                             time_cfg=case.time_cfg)
        u0 = model.initial_state(data, dtype=jnp.float32)
        u, dt, t_sim = u0, case.time_cfg.dt_init, 0.0
        for _ in range(nsteps):
            u_new, stats = sim_host.step(u, dt)
            stats = jax.device_get(stats)
            if bool(stats.converged):
                u, t_sim = u_new, t_sim + dt
                dt = min(dt * case.time_cfg.growth, case.time_cfg.dt_max)
            else:
                dt = max(dt * case.time_cfg.cutback, case.time_cfg.dt_min)
        print(f"# {name}: window t_end={t_sim:.4e}s ({nsteps} host steps)")

        sims = {"ctl": blocked_sim(case, pc0, model, data),
                "tv": blocked_sim(case, pc_tv, model, data)}
        finals = {}
        for tag, sim in sims.items():  # compile pass (not timed)
            sim.run(t_end=t_sim, u0=u0, max_steps=4 * nsteps)
        ncells = model.grid.ncells
        for rep in range(2):
            for tag, sim in sims.items():
                res, wall = measure(sims[tag], u0, t_sim, 4 * nsteps)
                cu = ncells * res.total_newton / wall if wall else 0.0
                print(f"{name} {tag:3s} rep{rep}: steps={res.steps} "
                      f"newton={res.total_newton} ksp={res.total_ksp} "
                      f"wall={wall:6.2f}s cu/s={cu:,.0f} "
                      f"speedup={t_sim / wall:,.0f}x")
                finals[tag] = jax.device_get(res.u)
        comp = ["p", "T", "S"][: finals["ctl"].shape[0]]
        for c in range(finals["ctl"].shape[0]):
            d = abs(finals["ctl"][c] - finals["tv"][c])
            scale = max(abs(finals["ctl"][c]).max(), 1e-30)
            print(f"  {comp[c]}: max|diff|={d.max():.6e}  "
                  f"rel={d.max() / scale:.3e}")


if __name__ == "__main__":
    main()
