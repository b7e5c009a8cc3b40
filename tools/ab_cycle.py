"""Cycle-depth A/B at the flagship point: what does one CPTR apply cost?

The adaptive hierarchy is 6 levels (1.12M -> 630 cells) and the K-cycle's
2-recursive coarse solves visit level L ~2^(L-1) times (1,2,4,8,16,32),
x2 hierarchies (p and T).  Deep levels are a few thousand cells, where
kernel-launch latency, not bandwidth, sets the cost.

This probe measures, per GMG cycle variant, on the SAME warmed system:
  - marginal wall per CPTR apply (fori_loop slope, one device_get),
  - standalone full-system FGMRES iterations + wall at rtol 1e-2 (the
    production forcing regime) and 1e-3 (quality signal), one jit program
    per variant.

Usage: python tools/ab_cycle.py [dt=38400] [reps=5] [filters...] [--cpu]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")


def main():
    import dataclasses

    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup, \
        resolve_adaptive_coarsening
    from thermalporous_tpu.presets import tp_spe10_full
    from thermalporous_tpu.solve import Simulator
    from thermalporous_tpu.solve.fgmres import fgmres

    args = [a for a in sys.argv[1:]]
    dt_hard = float(args[0]) if args and args[0][0].isdigit() else 38400.0
    reps = int(args[1]) if len(args) > 1 and args[1].isdigit() else 5
    only = [s.lower() for s in args[2:]]

    case = tp_spe10_full()
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
    base = resolve_adaptive_coarsening(st, case.pc_cfg)
    print(f"# full-SPE10 system at dt={dt_hard:.0f}s after 5-step ramp; "
          f"{reps} reps")
    print(f"# adaptive schedule: {base.gmg.level_factors}")

    def timeit(fn, *a):
        out = fn(*a)
        jax.device_get(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.device_get(fn(*a))
        return (time.perf_counter() - t0) / reps

    null = jax.jit(lambda u: jnp.float32(0.0) * u[0, 0, 0, 0])
    floor = timeit(null, u)
    print(f"# dispatch floor {floor*1e3:.3f} ms")
    print(f"{'variant':28s} {'ms/apply':>9s} {'it@1e-2':>8s} {'ms@1e-2':>8s}"
          f" {'it@1e-3':>8s} {'ms@1e-3':>8s}")

    variants = {
        # round-3 variants built gmg_t from the PRESSURE schedule (legacy
        # behavior preserved via _gmg_t); round-4 "keep_t" variants retain
        # the preset's own (separately-planned) production gmg_t instead
        "prod (k, kmin256)": {},
        "kmin2k": dict(kcycle_min_cells=2048),
        "kmin8k": dict(kcycle_min_cells=8192),
        "kmin64k": dict(kcycle_min_cells=65536),
        "kmin600k": dict(kcycle_min_cells=600000),
        "vcycle": dict(cycle_type="v"),
        "wcycle": dict(cycle_type="w"),
        # asymmetric: cheap TEMPERATURE hierarchy (CPRConfig.gmg_t) — the
        # decoupled T system is easy standalone (diag_hard: 8 iters)
        "t-vcycle": dict(_gmg_t=dict(cycle_type="v")),
        "t-vcycle-deg2": dict(_gmg_t=dict(cycle_type="v", degree=2)),
        "t-vcyc-p-kmin8k": dict(kcycle_min_cells=8192,
                                _gmg_t=dict(cycle_type="v", degree=2)),
        # shallower hierarchies — a bigger dense coarse solve trades the
        # deepest (pure-launch-latency) levels for one small matvec;
        # _keep_t retains the production asymmetric gmg_t
        "r4prod": dict(_keep_t=True),
        "mcc2k": dict(max_coarse_cells=2048, _keep_t=True),
        "mcc4k": dict(max_coarse_cells=4096, _keep_t=True),
        "mcc4k-t4k": dict(max_coarse_cells=4096, _keep_t=True,
                          _gmg_t=dict(max_coarse_cells=4096)),
        "mcc4k-kmin32k": dict(max_coarse_cells=4096, kcycle_min_cells=32768,
                              _keep_t=True),
        "kmin32k": dict(kcycle_min_cells=32768, _keep_t=True),
        "bf16pc": dict(_keep_t=True, _pc=dict(pc_dtype="bf16")),
        # EXACT stage-2 traffic levers (cpr.py stage2_cols/stage2_fused —
        # iteration counts must be IDENTICAL to r4prod, only the wall may
        # move)
        "s2cols": dict(_keep_t=True, _pc=dict(stage2_cols=True)),
        "s2fused": dict(_keep_t=True, _pc=dict(stage2_fused=True)),
        "s2both": dict(_keep_t=True, _pc=dict(stage2_cols=True,
                                              stage2_fused=True)),
        # SPARSIFIED smoother operator (looped form; NOT exact —
        # iterations are the gate)
        "s2z": dict(_keep_t=True, _pc=dict(stage2_cols=True,
                                           stage2_axes=(2,))),
        "s2yz": dict(_keep_t=True, _pc=dict(stage2_cols=True,
                                            stage2_axes=(1, 2))),
        # stage-2 BLOCK-JACOBI at the flagship point — no mask,
        # no in-smoother matvec (one dinv stream instead of the rbgs
        # sweep's 2x63-field streams + 2x dinv).  NOT exact (weaker
        # smoother) — iterations are the gate.
        "s2bj": dict(_keep_t=True, _pc=dict(stage2="block_jacobi",
                                            stage2_cols=True)),
        # two-step block-Jacobi Richardson — one RBGS sweep's correction
        # class at 81 coefficient fields (no masks, no A·0 matvec)
        "s2j2": dict(_keep_t=True, _pc=dict(stage2="jacobi2",
                                            stage2_cols=True)),
        "s2j2w08": dict(_keep_t=True, _pc=dict(stage2="jacobi2",
                                               stage2_omega=0.8,
                                               stage2_cols=True)),
        # stage-1 rescan at the cols-adopted baseline — kcycle recursion
        # floor and fine smooth degree
        "s2b-kmin2k": dict(kcycle_min_cells=2048, _keep_t=True,
                           _pc=dict(stage2_cols=True)),
        "s2b-kmin32k": dict(kcycle_min_cells=32768, _keep_t=True,
                            _pc=dict(stage2_cols=True)),
        "s2b-deg3": dict(degree=3, _keep_t=True,
                         _pc=dict(stage2_cols=True)),
        "s2b-deg6": dict(degree=6, _keep_t=True,
                         _pc=dict(stage2_cols=True)),
    }

    for tag, over in variants.items():
        if only and not any(s in tag.lower() for s in only):
            continue
        over = dict(over)
        keep_t = over.pop("_keep_t", False)
        gmg_t_over = over.pop("_gmg_t", None)
        pc_over = over.pop("_pc", {})
        gmg_t = base.gmg_t if keep_t else None
        if gmg_t_over is not None:
            # with _keep_t: tweak the production gmg_t; legacy variants
            # (no _keep_t) build gmg_t from the pressure schedule
            gmg_t = dataclasses.replace(
                base.gmg_t if keep_t else base.gmg, **gmg_t_over)
        pc = dataclasses.replace(
            base, gmg=dataclasses.replace(base.gmg, **over), gmg_t=gmg_t,
            **pc_over)

        # marginal apply cost: slope of k CPTR applies inside one program
        # (st/f passed as traced args, not captured as constants)
        def k_applies(st, f, k, pc=pc):
            pcs = cpr_setup(st, pc)
            def body(i, r):
                return cpr_apply(pcs, r, pc) * (1.0 + 1e-30 * i)
            return jax.lax.fori_loop(0, k, body, f).ravel()[7]

        w2 = timeit(jax.jit(lambda st, f: k_applies(st, f, 2)), st, f)
        w10 = timeit(jax.jit(lambda st, f: k_applies(st, f, 10)), st, f)
        per_apply = (w10 - w2) / 8.0

        # standalone full-system solves; SAME static cap for every variant
        # so the (cap-proportional) CGS2 basis streaming cancels in the
        # cross-variant comparison and the deltas isolate the PC apply
        def make_run(rtol, pc=pc):
            @jax.jit
            def run(st, f):
                pcs = cpr_setup(st, pc)
                res = fgmres(st.matvec, -f,
                             precond=lambda r: cpr_apply(pcs, r, pc),
                             rtol=rtol, maxiter=96)
                return res.iters, res.converged
            return run

        run2, run3 = make_run(1e-2), make_run(1e-3)
        it2, c2 = jax.device_get(run2(st, f))
        it3, c3 = jax.device_get(run3(st, f))
        wall2 = timeit(run2, st, f)
        wall3 = timeit(run3, st, f)
        flag2 = "" if bool(c2) else "*DNF"
        flag3 = "" if bool(c3) else "*DNF"
        print(f"{tag:28s} {per_apply*1e3:9.2f} {int(it2):8d}{flag2}"
              f" {wall2*1e3:8.1f} {int(it3):8d}{flag3} {wall3*1e3:8.1f}",
              flush=True)


if __name__ == "__main__":
    main()
