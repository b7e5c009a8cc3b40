#!/usr/bin/env python
"""Chip smoke test: the simulator's main path, end to end, on NVIDIA GPUs.

    python chip_smoke.py               # phases (c), (a), (b) on one GPU
    python chip_smoke.py --devices 4   # phase (d) only, on four GPUs

Phases (each raises on a failed check, so the script exits non-zero):

(a) flagship ``tp_spe10_full`` (60x220x85 = 1.122M cells, 3.37M unknowns,
    f32 state with f64 reductions) through ``Simulator.run`` for a few
    controller-driven steps: counts, compile and run seconds, peak device
    memory, the balance audit's reading; every accepted step converged and
    the state is finite and in its physical bounds.  Then the same steps in
    f64 state at a tight Newton tolerance, where the material/energy
    balance audit must close to 1e-6 relative.
(b) ``qualify_case("tp_spe10_3d")``: Newton/FGMRES counts on the GPU
    against a CPU reference in a subprocess pinned to the CPU.
(c) one production Newton–FGMRES–CPTR step of ``tp_thermal_2d`` (n=20)
    in f64 against the dense-LU oracle, at the CPU tests' tolerance.
(d) the sharded production configuration of ``__graft_entry__`` on a
    2x2 mesh of four GPUs at 64x128x16 cells against the same run on one.

All numbers go on lines before the last; the first of them is the card's
name and power limit from ``nvidia-smi``.  The last line is one JSON
object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.  Without
a GPU the script raises before it prints anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: phases run for each --devices value, in order
PHASES = {1: ("oracle", "flagship", "qualify"), 4: ("sharded",)}

FLAGSHIP_STEPS = 4
QUALIFY_CASE, QUALIFY_STEPS = "tp_spe10_3d", 4
ORACLE_N = 20
SHARDED_SHAPE = (64, 128, 16)
#: relative closure the flagship's material/energy balance audit must reach
BALANCE_RTOL = 1e-6
#: Newton tolerance of that check.  The audit's error is Δt·Σ R(u) over the
#: converged residuals, ≈ 4000× the final scaled RMS norm on the flagship:
#: the preset's atol (3e-5, near the f32 state's floor) leaves a few percent,
#: in f32 and f64 state alike, and 1e-6 needs the norm near 1e-11, in f64.
BALANCE_NEWTON = dict(rtol=1e-14, atol=1e-11, max_iters=30)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1, choices=sorted(PHASES),
                   help="1: phases (c), (a), (b) on one GPU; "
                        "4: the sharded phase (d) on four GPUs, alone")
    return p.parse_args(argv)


def result_line(summary: dict) -> str:
    """The last line of the output."""
    return json.dumps({"ok": True, "device": summary})


def _f32_data(data):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if hasattr(a, "astype") else a, data)


def _controller_run(case, dtype, newton_cfg, steps: int):
    """``steps`` controller-driven steps of ``case`` in ``dtype`` state, with
    the balance audit (in f64) as callback; returns the run, the audit's
    report and the seconds of the first call (compile and one step)."""
    import jax
    import jax.numpy as jnp

    from thermalporous_tpu.io import BalanceAuditor
    from thermalporous_tpu.solve import Simulator

    model = case.model
    data = _f32_data(case.data) if dtype == jnp.float32 else case.data
    u0 = model.initial_state(data, dtype=dtype)
    sim = Simulator(model, data, precond=case.precond, pc_cfg=case.pc_cfg,
                    newton_cfg=newton_cfg, time_cfg=case.time_cfg)
    # the first call compiles the step (or fetches it from the compile
    # cache) and runs it once
    t0 = time.perf_counter()
    u1, _ = sim.step(u0, case.time_cfg.dt_init)
    jax.block_until_ready(u1)
    first_call_s = time.perf_counter() - t0

    auditor = BalanceAuditor(model, case.data, u0.astype(jnp.float64))
    res = sim.run(t_end=case.t_end, u0=u0, max_steps=steps,
                  callback=lambda step, t, u, rec: auditor(
                      step, t, u.astype(jnp.float64), rec))
    jax.block_until_ready(res.u)
    # Simulator.run accepts a step only when Newton converged (a failed
    # or unconverged solve is retried at a smaller Δt or raises)
    assert res.steps == steps, f"{res.steps} accepted steps, expected {steps}"
    report = auditor.report()
    assert report["complete"], report
    return res, report, first_call_s


def phase_flagship(case_name: str = "tp_spe10_full",
                   steps: int = FLAGSHIP_STEPS) -> dict:
    """(a) controller-driven steps of a preset in f32 state, then the
    balance check in f64 state at a tight Newton tolerance."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from thermalporous_tpu.presets import get_case

    case = get_case(case_name)
    model = case.model
    res, report, first_call_s = _controller_run(
        case, jnp.float32, case.newton_cfg, steps)
    u = np.asarray(res.u, dtype=np.float64)
    assert np.isfinite(u).all(), "non-finite state"
    t_lo, t_hi = _temperature_bounds(model, case.data)
    assert t_lo <= u[1].min() and u[1].max() <= t_hi, (
        f"T outside [{t_lo}, {t_hi}] K: [{u[1].min()}, {u[1].max()}]")
    if model.nc >= 3:
        assert 0.0 <= u[2].min() and u[2].max() <= 1.0, (
            f"S_w outside [0, 1]: [{u[2].min()}, {u[2].max()}]")
    stats = jax.devices()[0].memory_stats() or {}
    out = dict(
        case=case.name, grid=model.grid.shape, cells=model.grid.ncells,
        steps=res.steps, newton=res.total_newton, fgmres=res.total_ksp,
        retries=sum(r.retries for r in res.records),
        first_call_s=first_call_s,
        # solver time of the accepted steps and their retries (the balance
        # audit's own compiles run in callbacks outside these)
        run_s=sum(r.wall_s for r in res.records),
        t_sim_s=res.t,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        # at the preset's Newton tolerance: a reading, not a check
        balance_rel_error={k: r["rel_error"]
                           for k, r in report["rows"].items()},
        T_range=(float(u[1].min()), float(u[1].max())),
    )
    del res

    tight = dataclasses.replace(case.newton_cfg, **BALANCE_NEWTON)
    res, report, _ = _controller_run(case, jnp.float64, tight, steps)
    rel = {k: r["rel_error"] for k, r in report["rows"].items()}
    assert max(rel.values()) <= BALANCE_RTOL, rel
    out["balance_check"] = dict(
        state="f64", newton_cfg=BALANCE_NEWTON, steps=res.steps,
        newton=res.total_newton, fgmres=res.total_ksp, t_sim_s=res.t,
        max_norm=max(r.residual_norm for r in res.records), rel_error=rel)
    return out


def _temperature_bounds(model, data) -> tuple[float, float]:
    """[T_init − 1, T_inj + 1] K: the range an injection run stays in."""
    import numpy as np

    w = data.wells
    tinj = np.asarray(w.tinj)[np.asarray(w.has_tinj) > 0]
    t_init = model.pp.T_init
    t_hi = max([t_init, *tinj.tolist()])
    return t_init - 1.0, float(t_hi) + 1.0


def phase_qualify(case_name: str = QUALIFY_CASE,
                  steps: int = QUALIFY_STEPS) -> dict:
    """(b) GPU vs CPU Newton/FGMRES counts (thermalporous_tpu.qualify)."""
    from thermalporous_tpu.qualify import qualify_case

    t0 = time.perf_counter()
    ok = qualify_case(case_name, steps=steps)
    assert ok, f"qualify {case_name}: counts diverge from the CPU reference"
    return dict(case=case_name, steps=steps, passed=ok,
                wall_s=time.perf_counter() - t0)


def phase_oracle(n: int = ORACLE_N) -> dict:
    """(c) one f64 production step against the dense-LU oracle."""
    import jax
    import numpy as np

    from thermalporous_tpu.presets import get_case
    from thermalporous_tpu.solve import Simulator, oracle_run
    from thermalporous_tpu.solve.oracle import (
        ORACLE_ATOL,
        ORACLE_NEWTON,
        state_errors,
    )

    if not jax.config.x64_enabled:
        raise RuntimeError("the oracle phase needs jax_enable_x64")
    case = get_case("tp_thermal_2d", n=n)
    model, data = case.model, case.data
    dt = case.time_cfg.dt_init
    u_ref = oracle_run(model, data, [dt])[0]
    sim = Simulator(model, data, precond=case.precond, pc_cfg=case.pc_cfg,
                    newton_cfg=ORACLE_NEWTON)
    u, st = sim.step(model.initial_state(data), dt)
    st = jax.device_get(st)
    assert bool(st.converged), "production step did not converge"
    err = state_errors(u, u_ref)
    for c, (e, tol) in enumerate(zip(err, ORACLE_ATOL)):
        assert e <= tol, f"component {c}: |u - oracle| = {e} > {tol}"
    assert np.asarray(u).dtype == np.float64
    return dict(case=case.name, grid=model.grid.shape, dt=dt,
                newton=int(st.iters), fgmres=int(st.ksp_iters),
                max_abs_error=err, atol=ORACLE_ATOL)


def phase_sharded(n_devices: int = 4, shape=SHARDED_SHAPE) -> dict:
    """(d) the sharded production run against the same run on one device."""
    import jax

    import __graft_entry__ as graft

    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"the sharded phase needs {n_devices} devices, JAX has "
            f"{len(jax.devices())}")
    r = graft.sharded_vs_single(n_devices, shape=shape)
    keep = ("mesh", "shape", "steps", "newton", "ksp", "wall_single_s",
            "wall_sharded_s", "max_abs_diff")
    return {k: r[k] for k in keep}


def main(argv=None) -> int:
    args = parse_args(argv)

    import jax

    # f64 reductions (the flagship keeps its state in f32) and the f64
    # oracle phase
    jax.config.update("jax_enable_x64", True)

    from thermalporous_tpu.runtime import (
        device_summary,
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    if len(jax.devices()) < args.devices:
        raise RuntimeError(f"--devices {args.devices}: JAX has only "
                           f"{len(jax.devices())} device(s)")
    cache = enable_compile_cache()
    print(gpu_name_and_power_limit(), flush=True)
    print(f"# jax devices: {jax.devices()}; compile cache {cache}",
          flush=True)

    for name in PHASES[args.devices]:
        t0 = time.perf_counter()
        if name == "oracle":
            out = phase_oracle()
        elif name == "flagship":
            out = phase_flagship()
        elif name == "qualify":
            out = phase_qualify()
        else:
            out = phase_sharded(args.devices)
        out["phase_s"] = time.perf_counter() - t0
        print(f"# phase {name}: {json.dumps(out, default=str)}", flush=True)
    print(result_line(device_summary()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
