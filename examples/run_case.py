#!/usr/bin/env python
"""Run a named simulation case — the reference's driver-script ergonomics as a CLI.

Examples:
  python examples/run_case.py --case sp_hot_injection_2d --t-end-days 30
  python examples/run_case.py --case tp_thermal_2d --precond cpr --vtk out/
  python examples/run_case.py --case sp_spe10_layer_2d --platform cpu --metrics run.jsonl
  python examples/run_case.py --case tp_spe10_3d --platform gpu --f32
  python examples/run_case.py --case tp_thermal_2d --resume out/ckpt_0000010.npz

Prints per-step telemetry and an end-of-run summary (total Newton/FGMRES
iterations and cell-updates/s), the quantities the companion papers report.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


#: --platform choice -> jax_platforms value
PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--case", default="sp_hot_injection_2d")
    p.add_argument("--list", action="store_true", help="list available cases")
    p.add_argument("--t-end-days", type=float, default=None)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--precond", default=None,
                   choices=[None, "none", "jacobi", "rbgs", "lu", "cpr", "cptr"])
    p.add_argument("--dt0", type=float, default=None, help="initial dt [s]")
    p.add_argument("--predictor", default=None, choices=[None, "none", "linear"],
                   help="Newton initial guess: linear = extrapolate from the "
                        "previous step (same converged answer, fewer iterations)")
    p.add_argument("--ds-max", type=float, default=None,
                   help="Appleyard saturation chop: per-Newton-iteration "
                        "|dS| clamp (two-phase models; 0 disables)")
    p.add_argument("--ls-mode", default=None,
                   choices=[None, "armijo", "nonmonotone"],
                   help="line-search acceptance (nonmonotone pairs with "
                        "--ds-max on hard saturation fronts)")
    p.add_argument("--block-steps", type=int, default=None,
                   help="advance this many adaptive steps per device dispatch "
                        "as one XLA program (amortizes host round trips; "
                        "callbacks then fire per block)")
    p.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"],
                   help="run on this platform (default: JAX's default); "
                        "gpu fails when there is no card")
    p.add_argument("--x64", action="store_true", default=True)
    p.add_argument("--f32", dest="x64", action="store_false")
    p.add_argument("--vtk", default=None, metavar="DIR", help="write .pvd/.vti series")
    p.add_argument("--vtk-every", type=int, default=5)
    p.add_argument("--metrics", default=None, metavar="FILE", help="JSONL telemetry")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--resume", default=None, metavar="NPZ")
    p.add_argument("--decoupling", default=None,
                   choices=[None, "qimpes", "timpes", "abf"],
                   help="CPR/CPTR decoupling variant (ablations)")
    p.add_argument("--cycle", default=None, choices=[None, "v", "w", "k"],
                   help="multigrid cycle type")
    p.add_argument("--balance", action="store_true",
                   help="end-of-run material/energy balance audit "
                        "(host-loop runs; measures solver-tolerance drift)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--qualify", action="store_true",
                   help="run a short warmed Newton ramp on the "
                        "accelerator AND a CPU reference subprocess and "
                        "compare Newton/FGMRES counts (exits 1 on mismatch)")
    args = p.parse_args(argv)

    import jax

    from thermalporous_tpu.runtime import enable_compile_cache, require_gpu

    if args.platform is not None:
        jax.config.update("jax_platforms", PLATFORMS[args.platform])
    if args.platform == "gpu":
        require_gpu()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    from thermalporous_tpu.io import CheckpointManager, MetricsLogger, PVDWriter, load_checkpoint, state_fields
    from thermalporous_tpu.presets import CASE_DESCRIPTIONS, get_case
    from thermalporous_tpu.solve import Simulator

    if args.list:
        for name, desc in sorted(CASE_DESCRIPTIONS.items()):
            print(f"{name:24s} {desc}")
        return

    if args.qualify:
        from thermalporous_tpu.qualify import qualify_case

        ok = qualify_case(args.case, dt0=args.dt0)
        raise SystemExit(0 if ok else 1)

    case = get_case(args.case)
    print(f"# {case.name}: {case.description}")
    print(f"# grid {case.model.grid.shape} = {case.model.grid.ncells} cells, "
          f"{case.model.nc} unknowns/cell, precond={args.precond or case.precond}")

    pc_cfg = case.pc_cfg
    if args.decoupling or args.cycle:
        import dataclasses as _dc

        from thermalporous_tpu.precond import CPRConfig

        base = pc_cfg if pc_cfg is not None else CPRConfig()
        gmg = _dc.replace(base.gmg,
                          cycle_type=args.cycle or base.gmg.cycle_type)
        pc_cfg = _dc.replace(
            base,
            decoupling=args.decoupling or base.decoupling,
            gmg=gmg,
        )
    newton_cfg = case.newton_cfg
    if args.ds_max is not None or args.ls_mode:
        import dataclasses as _dc3

        over = {}
        if args.ds_max is not None:
            over["ds_max"] = args.ds_max if args.ds_max > 0 else None
        if args.ls_mode:
            over["ls_mode"] = args.ls_mode
        newton_cfg = _dc3.replace(newton_cfg, **over)
    time_cfg = case.time_cfg
    if args.predictor or args.block_steps:
        import dataclasses as _dc2

        over = {}
        if args.predictor:
            over["predictor"] = args.predictor
        if args.block_steps:
            over["block_steps"] = args.block_steps
        time_cfg = _dc2.replace(time_cfg, **over)
    sim = Simulator(
        case.model,
        case.data,
        precond=args.precond or case.precond,
        pc_cfg=pc_cfg,
        newton_cfg=newton_cfg,
        time_cfg=time_cfg,
    )

    callbacks = []
    if args.vtk:
        writer = PVDWriter(args.vtk, case.name, case.model.grid)
        u0 = case.model.initial_state(case.data)
        writer.write(0.0, state_fields(case.model, u0))
        # rec.state_consistent: block-mode intermediate records carry a
        # later state than their clock — write only consistent pairs.
        # Cadence is "vtk_every steps elapsed since the last frame", not
        # step % vtk_every: block-final step numbers shift with retries,
        # so a modulus test could skip every consistent record.
        vtk_last = [0]

        def vtk_cb(step, t, u, rec):
            if not getattr(rec, "state_consistent", True):
                return
            if step - vtk_last[0] < args.vtk_every:
                return
            vtk_last[0] = step
            writer.write(t, state_fields(case.model, u))

        callbacks.append(vtk_cb)
    if args.metrics:
        callbacks.append(MetricsLogger(args.metrics, ncells=case.model.grid.ncells,
                                       extra={"case": case.name}))
    if args.ckpt_dir:
        callbacks.append(CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                                           name="ckpt"))

    u0, dt0, t0, step0, dt_cap0 = None, args.dt0, 0.0, 0, None
    if args.resume:
        u0, t0, dt_saved, step0, meta = load_checkpoint(args.resume)
        dt0 = dt0 or dt_saved
        dt_cap0 = meta.get("dt_cap")  # failure-memory cap, when active
        print(f"# resuming from {args.resume}: t={t0:.4e}s step={step0}")

    auditor = None
    if args.balance:
        from thermalporous_tpu.io import BalanceAuditor

        if u0 is None:
            u0 = case.model.initial_state(case.data)
        # on --resume the audit window starts at the checkpoint state
        auditor = BalanceAuditor(case.model, case.data, u0)
        callbacks.append(auditor)

    def callback(step, t, u, rec):
        for cb in callbacks:
            cb(step, t, u, rec)

    t_end = (args.t_end_days * 86400.0) if args.t_end_days else case.t_end
    result = sim.run(
        t_end=t_end,
        u0=u0,
        dt0=dt0,
        t0=t0,
        step0=step0,
        max_steps=args.max_steps,
        callback=callback if callbacks else None,
        verbose=not args.quiet,
        dt_cap0=dt_cap0,
    )

    n = max(result.total_newton, 1)
    print(f"# done: t={result.t:.4e}s in {result.steps} steps, wall {result.wall_s:.1f}s")
    print(f"# newton total {result.total_newton} ({result.total_newton/max(result.steps,1):.1f}/step), "
          f"fgmres total {result.total_ksp} ({result.total_ksp/n:.1f}/newton)")
    print(f"# throughput {case.model.grid.ncells * result.total_newton / result.wall_s:.3e} cell-updates/s")

    if auditor is not None:
        from thermalporous_tpu.io import format_balance

        print(format_balance(auditor.report()))

    if case.well_masks:
        from thermalporous_tpu.physics import well_rates

        print("# final well rates (positive = into reservoir):")
        for name, rec in well_rates(case.model, result.u, case.data,
                                    case.well_masks).items():
            vals = "  ".join(f"{k}={v:+.4g}" for k, v in rec.items())
            print(f"#   {name:10s} {vals}")


if __name__ == "__main__":
    main()
