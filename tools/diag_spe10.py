"""Which CPTR component limits convergence on tp_spe10_full at large Δt?

Builds the hard linear system (after a ramped warmup) STANDALONE and sweeps
preconditioner variants at generous maxiter to see true iteration needs.

Usage: python tools/diag_spe10.py [dt_hours]
"""

from __future__ import annotations

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")

import jax.numpy as jnp
import numpy as np


def main():
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup
    from thermalporous_tpu.presets import tp_spe10_full
    from thermalporous_tpu.solve import Simulator
    from thermalporous_tpu.solve.fgmres import fgmres
    import dataclasses

    dt_hard = float(sys.argv[1]) * 3600.0 if len(sys.argv) > 1 else 38400.0

    case = tp_spe10_full()
    model, data = case.model, case.data
    dtype = jnp.float32
    data = jax.tree.map(lambda a: a.astype(dtype) if hasattr(a, "astype") else a, data)

    # warmup on the production preset PC (adaptive + RBGS + deg4) with
    # retrying Δt control: the diagnostic's state prep must not be
    # brittle to a single hard step
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
    print(f"# system at dt={dt_hard:.0f}s after 5-step ramp; rtol=1e-3")

    from thermalporous_tpu.precond.cpr import resolve_adaptive_coarsening

    only = [s.lower() for s in sys.argv[2:]]

    def solve(tag, pc_cfg, maxiter=150):
        if only and not any(s in tag.lower() for s in only):
            return
        pc_cfg = resolve_adaptive_coarsening(st, pc_cfg)
        if pc_cfg.gmg.level_factors is not None:
            print(f"  [{tag}] schedule: {pc_cfg.gmg.level_factors}")
        state = jax.jit(lambda s: cpr_setup(s, pc_cfg))(st)

        @jax.jit
        def run(state, f, st):
            res = fgmres(st.matvec, -f,
                         precond=lambda r: cpr_apply(state, r, pc_cfg),
                         rtol=1e-3, maxiter=maxiter)
            return res.iters, res.converged

        it, conv = jax.device_get(run(state, f, st))
        print(f"{tag:40s} iters={int(it):4d} conv={bool(conv)}")

    K = dict(cycle_type="k", max_coarse_cells=1024)
    solve("cptr k (production)", CPRConfig(gmg=GMGConfig(**K)))
    solve("cptr k, no stage2", CPRConfig(stage2="none", gmg=GMGConfig(**K)))
    solve("cpr k (pressure only)", CPRConfig(variant="cpr", gmg=GMGConfig(**K)))
    solve("cptr k deg4", CPRConfig(gmg=GMGConfig(degree=4, **K)))
    solve("cptr k cycles=2", CPRConfig(gmg=GMGConfig(cycles=2, **K)))
    solve("cptr k cycles=3", CPRConfig(gmg=GMGConfig(cycles=3, **K)))
    solve("cptr w-cycle", CPRConfig(gmg=GMGConfig(cycle_type="w",
                                                  max_coarse_cells=1024)))
    solve("cptr k semicoarsen_z", CPRConfig(gmg=GMGConfig(semicoarsen_z=True, **K)))
    solve("cptr k inner2 (standalone ok)", CPRConfig(inner_iters=2,
                                                     gmg=GMGConfig(**K)))
    solve("cptr k abf", CPRConfig(decoupling="abf", gmg=GMGConfig(**K)))
    solve("cptr k timpes", CPRConfig(decoupling="timpes", gmg=GMGConfig(**K)))
    solve("cptr k rbgs-smoother deg2",
          CPRConfig(gmg=GMGConfig(smoother="rbgs", **K)))
    solve("cptr k ADAPTIVE coarsening",
          CPRConfig(gmg=GMGConfig(coarsen="adaptive", **K)))
    solve("cptr k adaptive deg4",
          CPRConfig(gmg=GMGConfig(coarsen="adaptive", degree=4, **K)))
    solve("cptr v adaptive",
          CPRConfig(gmg=GMGConfig(coarsen="adaptive", cycle_type="v",
                                  max_coarse_cells=1024)))
    A = dict(coarsen="adaptive", **K)
    solve("adaptive deg4 s2rbgs WEIGHTED-P",
          CPRConfig(stage2="rbgs",
                    gmg=GMGConfig(degree=4, transfer="weighted", **A)))
    solve("geometric deg4 s2rbgs WEIGHTED-P",
          CPRConfig(stage2="rbgs",
                    gmg=GMGConfig(degree=4, transfer="weighted", **K)))
    solve("adaptive + s2 rbgs", CPRConfig(stage2="rbgs", gmg=GMGConfig(**A)))
    solve("adaptive + s2 rbgs x2",
          CPRConfig(stage2="rbgs", stage2_sweeps=2, gmg=GMGConfig(**A)))
    solve("adaptive cycles=2", CPRConfig(gmg=GMGConfig(cycles=2, **A)))
    solve("adaptive cycles=2 + s2 rbgs",
          CPRConfig(stage2="rbgs", gmg=GMGConfig(cycles=2, **A)))
    solve("adaptive deg4 + s2 rbgs",
          CPRConfig(stage2="rbgs", gmg=GMGConfig(degree=4, **A)))
    solve("adaptive rbgs-smoother + s2 rbgs",
          CPRConfig(stage2="rbgs", gmg=GMGConfig(smoother="rbgs", **A)))
    solve("adaptive inner2", CPRConfig(inner_iters=2, gmg=GMGConfig(**A)))
    solve("full + zebra z-lines",
          CPRConfig(gmg=GMGConfig(smoother="zebra", degree=1, **K)))
    solve("full + zebra deg2",
          CPRConfig(gmg=GMGConfig(smoother="zebra", **K)))
    solve("adaptive + zebra",
          CPRConfig(gmg=GMGConfig(smoother="zebra", degree=1, **A)))
    solve("full + line-jacobi deg2",
          CPRConfig(gmg=GMGConfig(smoother="line", **K)))
    solve("full zebra + s2 rbgs",
          CPRConfig(stage2="rbgs", gmg=GMGConfig(smoother="zebra", degree=1,
                                                 **K)))


if __name__ == "__main__":
    main()
