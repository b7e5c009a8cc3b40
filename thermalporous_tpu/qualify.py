"""Accelerator-vs-CPU count parity: qualify a case on the card.

Newton and FGMRES counts do not depend on the platform for a correctly
compiled program: the CPU reproduces an accelerator's counts (97 == 97 at
full-SPE10 scale), while a miscompiled program shows gross departures
(a stall at the iteration cap).  So a short warmed run compared against a
CPU reference is a cheap check of a new grid shape, configuration or
backend before trusting it at scale:

- :func:`qualify_steps` runs a short deterministic Δt ramp (doubling on
  success, halving on failure) through ``Simulator.step`` and records
  per-step Newton/FGMRES counts, convergence, and scaled norms — one
  ``jax.device_get`` per step.
- :func:`compare_runs` compares an accelerator run against the CPU
  reference.  Reductions are summed in another order on each backend, so
  the thresholds are loose: convergence flags must match, Newton within
  ±2, FGMRES within max(5, 50%).
- :func:`qualify_case` orchestrates both: the current default backend
  in-process (it must be an accelerator), the CPU reference in a
  subprocess pinned to the CPU (one process per card), and the verdict.

CLI (also ``run_case.py --qualify``):

    python -m thermalporous_tpu.qualify --case tp_spe10_full
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def qualify_steps(case, steps: int = 4, dt0: float | None = None,
                  dtype=None) -> list[dict]:
    """Run ``steps`` warmed Newton steps on the current default backend.

    Δt policy is deterministic (double on success, halve on failure) so
    two backends produce comparable per-step records unless the numerics
    themselves diverge — which is exactly what is being detected.
    """
    import jax
    import jax.numpy as jnp

    from thermalporous_tpu.solve import Simulator

    dtype = dtype or jnp.float32
    model, data = case.model, case.data
    data = jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "astype") else a, data)
    sim = Simulator(model, data, precond=case.precond,
                    newton_cfg=case.newton_cfg, pc_cfg=case.pc_cfg)
    u = model.initial_state(data, dtype=dtype)
    # start BELOW dt_init so the ramp includes the easiest (smallest-Δt)
    # step as well as harder ones
    dt = dt0 if dt0 is not None else case.time_cfg.dt_init / 2.0
    records = []
    for _ in range(steps):
        u_new, st = sim.step(u, dt)
        s = jax.device_get(st)          # ONE fetch per step
        rec = dict(dt=float(dt), newton=int(s.iters), ksp=int(s.ksp_iters),
                   converged=bool(s.converged), norm0=float(s.norm0),
                   norm=float(s.norm))
        records.append(rec)
        if rec["converged"]:
            u, dt = u_new, dt * 2.0
        else:
            dt = dt * 0.5
    return records


def compare_runs(acc: list[dict], ref: list[dict]) -> tuple[bool, list[str]]:
    """Loose count-parity verdict (see module docstring for thresholds)."""
    msgs = []
    ok = len(acc) == len(ref)
    if not ok:
        msgs.append(f"record counts differ: {len(acc)} vs CPU {len(ref)}")
    for i, (a, r) in enumerate(zip(acc, ref)):
        tag = f"step {i} (dt={r['dt']:.0f}s)"
        if a["dt"] != r["dt"]:
            ok = False
            msgs.append(f"{tag}: Δt trajectories diverged "
                        f"(acc {a['dt']:.0f} vs cpu {r['dt']:.0f})")
            break
        if a["converged"] != r["converged"]:
            ok = False
            msgs.append(
                f"{tag}: convergence mismatch — accelerator "
                f"{'converged' if a['converged'] else 'STALLED'} "
                f"(N={a['newton']}, ksp={a['ksp']}, norm {a['norm']:.2e}) "
                f"vs CPU {'converged' if r['converged'] else 'stalled'} "
                f"(N={r['newton']}, ksp={r['ksp']})")
            continue
        if abs(a["newton"] - r["newton"]) > 2:
            ok = False
            msgs.append(f"{tag}: Newton counts {a['newton']} vs CPU "
                        f"{r['newton']} (>±2)")
        if abs(a["ksp"] - r["ksp"]) > max(5, 0.5 * r["ksp"]):
            ok = False
            msgs.append(f"{tag}: FGMRES counts {a['ksp']} vs CPU "
                        f"{r['ksp']} (>max(5, 50%))")
    return ok, msgs


def cpu_reference_cmd(case_name: str, steps: int = 4,
                      dt0: float | None = None, x64: bool = False) -> list:
    """Command line of the CPU reference run (one JSON line of records)."""
    cmd = [sys.executable, "-m", "thermalporous_tpu.qualify",
           "--case", case_name, "--platform", "cpu", "--json",
           "--steps", str(steps)]
    if dt0 is not None:
        cmd += ["--dt0", str(dt0)]
    if x64:
        cmd += ["--x64"]
    return cmd


def start_cpu_reference(case_name: str, steps: int = 4,
                        dt0: float | None = None,
                        x64: bool = False) -> subprocess.Popen:
    """Start the CPU reference in a subprocess that never opens the card.

    ``x64`` must match the accelerator run's ``jax_enable_x64`` (the
    reductions' precision is part of the program).
    """
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        cpu_reference_cmd(case_name, steps, dt0, x64),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def collect_cpu_reference(proc: subprocess.Popen,
                          timeout: float = 7200) -> list[dict]:
    """Wait for :func:`start_cpu_reference` and return its records."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"CPU reference run failed (rc={proc.returncode}):\n{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])["records"]


def _print_records(tag: str, records: list[dict]) -> None:
    for r in records:
        print(f"#   [{tag}] dt={r['dt']:8.0f}s newton={r['newton']:3d} "
              f"ksp={r['ksp']:4d} converged={r['converged']} "
              f"norm={r['norm']:.2e}", flush=True)


def qualify_case(case_name: str, steps: int = 4, dt0: float | None = None,
                 verbose: bool = True) -> bool:
    """Run the check: current backend in-process vs a CPU subprocess.

    Returns True iff the counts agree.  The default backend must be an
    accelerator: comparing the CPU with itself proves nothing, so that
    raises.
    """
    import jax

    from thermalporous_tpu.presets import get_case

    backend = jax.default_backend()
    if backend == "cpu":
        raise RuntimeError(
            "qualify compares an accelerator run with the CPU reference, "
            "but the default backend is the CPU")
    # the CPU reference runs in its own process meanwhile
    ref_proc = start_cpu_reference(case_name, steps, dt0,
                                   x64=jax.config.x64_enabled)
    case = get_case(case_name)
    if verbose:
        print(f"# qualify {case.name}: grid {case.model.grid.shape} on "
              f"'{backend}' vs CPU reference ({steps} steps)", flush=True)
    acc = qualify_steps(case, steps=steps, dt0=dt0)
    if verbose:
        _print_records(backend, acc)
    ref = collect_cpu_reference(ref_proc)
    if verbose:
        _print_records("cpu", ref)
    ok, msgs = compare_runs(acc, ref)
    if verbose:
        for m in msgs:
            print(f"# MISMATCH {m}")
        print(f"# verdict: {'PASS' if ok else 'FAIL'} — "
              + ("counts match the CPU reference" if ok else
                 "counts diverge from the CPU reference: suspect a "
                 "backend miscompile or a precision difference"))
    return ok


def _main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--case", default="tp_spe10_full")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--dt0", type=float, default=None)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--x64", action="store_true",
                   help="enable x64 (f64 reductions; the state stays f32)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line of records (no comparison)")
    args = p.parse_args(argv)

    import jax

    from thermalporous_tpu.runtime import enable_compile_cache, require_gpu

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif args.platform == "gpu":
        jax.config.update("jax_platforms", "cuda")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    if args.json:
        from thermalporous_tpu.presets import get_case

        case = get_case(args.case)
        recs = qualify_steps(case, steps=args.steps, dt0=args.dt0)
        print(json.dumps({"case": case.name,
                          "platform": jax.default_backend(),
                          "records": recs}))
        return 0
    if args.platform == "gpu":
        require_gpu()
    ok = qualify_case(args.case, steps=args.steps, dt0=args.dt0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
