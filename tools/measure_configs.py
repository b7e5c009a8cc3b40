"""Measure the five BASELINE.json configs: a per-config table (cells, dof,
steps, Newton/step, FGMRES/Newton, wall/step, cell-updates/s per chip,
dtype).

Runs each preset through its own Simulator (production solver settings,
f32 + f64 reductions) for a fixed number of adaptive steps and prints a
markdown table.  Whole-step timing with one stats transfer per step; the
first (compile) step is excluded from wall statistics.

Two throughput columns: the host-loop number — which for the small 2D
configs includes a host round trip per step — and the `block_steps=8`
jitted-block number,
where the whole adaptive controller runs in-device and the dispatch cost
amortizes over the block (measured on a second, compile-warm run over the
same simulated window).

Usage: python tools/measure_configs.py [steps] [case ...]
"""

from __future__ import annotations

import sys
import time

import jax

try:
    jax.config.update("jax_enable_x64", True)
except RuntimeError:
    pass

import jax.numpy as jnp


def main():
    from thermalporous_tpu.presets import PRESETS, get_case
    from thermalporous_tpu.solve import Simulator

    nsteps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    names = sys.argv[2:] or sorted(PRESETS)

    rows = []
    for name in names:
        case = get_case(name)
        model, data = case.model, case.data
        data = jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if hasattr(a, "astype") and jnp.issubdtype(a.dtype, jnp.floating)
            else a,
            data,
        )
        sim = Simulator(model, data, precond=case.precond,
                        pc_cfg=case.pc_cfg, newton_cfg=case.newton_cfg,
                        time_cfg=case.time_cfg)
        u = model.initial_state(data, dtype=jnp.float32)
        dt = case.time_cfg.dt_init
        grid = model.grid
        ncells = grid.ncells
        newton_tot = ksp_tot = 0
        wall_tot = 0.0
        steps_done = 0
        t_sim = 0.0
        for k in range(nsteps):
            t0 = time.perf_counter()
            u_new, stats = sim.step(u, dt)
            stats = jax.device_get(stats)
            w = time.perf_counter() - t0
            if bool(stats.converged):
                u = u_new
                t_sim += dt
                if k > 0:  # exclude the compile step
                    newton_tot += int(stats.iters)
                    ksp_tot += int(stats.ksp_iters)
                    wall_tot += w
                    steps_done += 1
                dt = min(dt * case.time_cfg.growth, case.time_cfg.dt_max)
            else:
                dt = max(dt * case.time_cfg.cutback, case.time_cfg.dt_min)
        cu = ncells * newton_tot / wall_tot if wall_tot > 0 else 0.0

        # blocked-loop column: same simulated window through the jitted
        # multi-step block (block_steps=8); second run is compile-warm
        import dataclasses as _dc

        simb = Simulator(model, data, precond=case.precond,
                         pc_cfg=case.pc_cfg, newton_cfg=case.newton_cfg,
                         time_cfg=_dc.replace(case.time_cfg, block_steps=8))
        # u0 must be passed explicitly: run()'s default initial state
        # follows the x64 flag (f64) — this column measures f32 production
        u0 = model.initial_state(data, dtype=jnp.float32)
        simb.run(t_end=t_sim, u0=u0, max_steps=4 * nsteps)          # compile
        resb = simb.run(t_end=t_sim, u0=u0, max_steps=4 * nsteps)   # measured
        cub = ncells * resb.total_newton / resb.wall_s if resb.wall_s else 0.0

        rows.append((
            name,
            "×".join(str(n) for n in grid.shape),
            ncells * model.nc,
            steps_done,
            newton_tot / max(steps_done, 1),
            ksp_tot / max(newton_tot, 1),
            wall_tot / max(steps_done, 1),
            cu,
            cub,
        ))
        print(f"# {name}: done", file=sys.stderr)

    print("| config | grid | dof | steps | Newton/step | FGMRES/Newton "
          "| wall/step [s] | cu/s host-loop | cu/s blocked | chips | dtype |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r[0]} | {r[1]} | {r[2]:,} | {r[3]} | {r[4]:.1f} "
              f"| {r[5]:.1f} | {r[6]:.3f} | {r[7]:,.0f} | {r[8]:,.0f} "
              f"| 1 | f32+f64red |")


if __name__ == "__main__":
    main()
