"""Layer times, compile times and the matmul-precision check on one GPU.

    python tools/gpu_profile.py [--out DIR] [--steps N] [--skip SECTION ...]

1. Flagship (``tp_spe10_full``, f32 state, f64 reductions): the first call
   of the step (compile, or compile-cache retrieval when the cache already
   holds it), ``memory_analysis()`` of the compiled step, the steady step
   time (``block_until_ready``), and a device trace of ``--steps`` steps
   reduced to per-layer kernel time by the ``jax.named_scope`` labels of the
   step (``residual``, ``assemble``, ``pc_setup``, ``fgmres``, ``matvec``,
   ``precond/stage1_p|stage1_t/gmg_L<k>/smooth|matvec|coarse_solve``,
   ``stage2``, ``line_search``).
2. The plain paths at flagship size, each jitted alone: the residual, its
   JVP, the Krylov block-stencil matvec, one level-0 Chebyshev smooth and
   matvec of the pressure hierarchy, the pressure K-cycle below the first
   level of at most 40,000 cells, the full pressure GMG apply, and the
   stage-2 block RBGS.  For each: the median wall time of a call (dispatch
   and sync included; the floor of an empty call is reported) and, from a
   device trace, the kernel-busy time and kernel count per call.
3. Precision: ``tp_spe10_3d`` Newton/FGMRES counts on the GPU under the
   default matmul precision and under ``"highest"`` against one CPU
   reference, and the f64 oracle check (``chip_smoke.phase_oracle``) under
   both.

Prints one JSON line per section and writes them to ``DIR/profile.json``;
the raw trace stays under ``out/gpu_profile_trace`` (not returned).
Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

#: level size below which the coarse K-cycle subtree is timed as one unit
#: (the candidate for a one-launch deep-cycle kernel)
COARSE_SUBTREE_CELLS = 40_000


def _time(fn, *args, reps: int = 10, trace_dir: str | None = None) -> dict:
    """Median wall seconds of ``fn(*args)`` over ``reps`` warm calls and,
    with ``trace_dir``, its device-busy seconds and kernels per call from a
    trace of ``reps`` more calls."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    out = {"wall_s": statistics.median(ts)}
    if trace_dir is not None:
        with jax.profiler.trace(trace_dir):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        tr = reduce_trace(trace_dir, {})
        out["device_s"] = tr["busy_s"] / reps
        out["kernels"] = tr["kernels"] / reps
    return out


def _levels(shape, cfg) -> list[tuple[int, ...]]:
    """Grid shapes of the GMG hierarchy ``gmg_setup`` builds for ``cfg``."""
    from roofline_full import level_shapes

    return level_shapes(shape, cfg.level_factors, cfg.max_coarse_cells,
                        cfg.max_levels)


def _kernel_key(name: str) -> str:
    """HLO instruction names and GPU kernel names agree up to separators
    (``loop_add_fusion.113`` runs as kernel ``loop_add_fusion_113``)."""
    return re.sub(r"[.\-]", "_", name)


def op_names_from_hlo(hlo_text: str) -> dict[str, str]:
    """Kernel key -> ``op_name`` metadata of an optimized HLO module."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*'
                     r'op_name="([^"]*)"', re.M)
    return {_kernel_key(m.group(1)): m.group(2)
            for m in pat.finditer(hlo_text)}


def layer_of(op_name: str) -> str:
    """Layer label of one kernel from its op_name scope path."""
    parts = op_name.split("/")
    has = set(parts)
    if "pc_setup" in has:
        return "pc_setup"
    if "precond" in has:
        if "stage2" in has:
            return "precond/stage2"
        for field in ("stage1_p", "stage1_t"):
            if field in has:
                levels = [p for p in parts if re.fullmatch(r"gmg_L\d+", p)]
                lvl = levels[-1] if levels else "gmg_L?"
                i = parts.index(lvl) if levels else -1
                sub = next((p for p in parts[i + 1:] if p in
                            ("smooth", "matvec", "coarse_solve")), "other")
                return f"precond/{field}/{lvl}/{sub}"
        return "precond/other"
    for name in ("line_search", "matvec", "fgmres", "residual", "assemble",
                 "jvp"):
        if name in has:
            return name
    return "other"


def reduce_trace(trace_dir: str, op_names: dict[str, str],
                 plane_prefix: str = "/device:GPU") -> dict:
    """Kernel time per layer over the traced window (device planes only)."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = ProfileData.from_file(sorted(paths)[-1])
    layers: dict[str, float] = {}
    intervals = []
    n_kernels = unattributed = 0
    sample = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if len(sample) < 40:
                    sample.append((plane.name, line.name, ev.name,
                                   ev.duration_ns, stats))
                hlo_op = stats.get("hlo_op")
                if hlo_op is None:
                    continue
                n_kernels += 1
                dur = ev.duration_ns * 1e-9
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                # kernels inside a CUDA graph report hlo_op
                # "command_buffer"; their own name identifies the fusion
                name = (op_names.get(_kernel_key(ev.name))
                        or op_names.get(_kernel_key(str(hlo_op))))
                if name is None:
                    unattributed += 1
                    label = "unattributed"
                else:
                    label = layer_of(name)
                layers[label] = layers.get(label, 0.0) + dur
    busy = 0.0
    if intervals:
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = intervals[-1][1] - intervals[0][0]
    else:
        window = 0
    return dict(
        kernels=n_kernels, unattributed_kernels=unattributed,
        kernel_s=sum(layers.values()), busy_s=busy * 1e-9,
        window_s=window * 1e-9,
        idle_share=(1.0 - busy / window) if window else None,
        layers_s=dict(sorted(layers.items(), key=lambda kv: -kv[1])),
        sample=[(p, ln, n, d, {k: str(v) for k, v in s.items()})
                for p, ln, n, d, s in sample],
    )


def flagship_profile(steps: int, trace_dir: str,
                     case_name: str = "tp_spe10_full",
                     plane_prefix: str = "/device:GPU") -> dict:
    import jax
    import jax.numpy as jnp

    from chip_smoke import _f32_data
    from thermalporous_tpu.presets import get_case
    from thermalporous_tpu.solve import Simulator

    case = get_case(case_name)
    model, data = case.model, _f32_data(case.data)
    u0 = model.initial_state(data, dtype=jnp.float32)
    sim = Simulator(model, data, precond=case.precond, pc_cfg=case.pc_cfg,
                    newton_cfg=case.newton_cfg, time_cfg=case.time_cfg)
    dt = case.time_cfg.dt_init
    t0 = time.perf_counter()
    u1, st = sim.step(u0, dt)
    jax.block_until_ready(u1)
    first_call_s = time.perf_counter() - t0

    dt_arr = jnp.asarray(dt, jnp.float32)
    compiled = sim._advance.lower(u0, dt_arr, data).compile()
    mem = compiled.memory_analysis()
    op_names = op_names_from_hlo(compiled.as_text())

    # steady window: the same step from the same state, repeated
    walls, newton, ksp = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        u1, st = sim.step(u0, dt)
        st = jax.device_get(st)
        walls.append(time.perf_counter() - t0)
        newton.append(int(st.iters))
        ksp.append(int(st.ksp_iters))
    with jax.profiler.trace(trace_dir):
        for _ in range(steps):
            u1, st = sim.step(u0, dt)
            jax.block_until_ready((u1, st))
    trace = reduce_trace(trace_dir, op_names, plane_prefix)
    stats = jax.devices()[0].memory_stats() or {}
    return dict(
        case=case.name, dt=dt, first_call_s=first_call_s,
        step_s=statistics.median(walls), step_walls_s=walls,
        newton_per_step=newton, fgmres_per_step=ksp,
        memory_analysis=str(mem),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        traced_steps=steps, trace=trace,
        gmg_p_levels=_levels(model.grid.shape, sim.pc_cfg.gmg),
        gmg_t_levels=_levels(model.grid.shape, sim.pc_cfg.gmg_t),
    )


def plain_path_times(trace_root: str, case_name: str = "tp_spe10_full",
                     subtree_cells: int = COARSE_SUBTREE_CELLS) -> dict:
    """Standalone times of the plain paths a hand-written kernel would
    replace: residual, JVP, matvecs, smoother, coarse subtree, stage 2."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import _f32_data
    from thermalporous_tpu.precond.chebyshev import (
        block_red_black_gauss_seidel,
        chebyshev,
    )
    from thermalporous_tpu.precond.cpr import cpr_setup
    from thermalporous_tpu.precond.gmg import _coarse_correction, gmg_apply
    from thermalporous_tpu.presets import get_case
    from thermalporous_tpu.solve import Simulator

    case = get_case(case_name)
    model, data = case.model, _f32_data(case.data)
    # the adaptive schedule is baked host-side by the Simulator
    cfg = Simulator(model, data, precond=case.precond, pc_cfg=case.pc_cfg,
                    newton_cfg=case.newton_cfg,
                    time_cfg=case.time_cfg).pc_cfg
    u0 = model.initial_state(data, dtype=jnp.float32)
    dt = jnp.asarray(case.time_cfg.dt_init, jnp.float32)
    u = u0 + 1e-3 * u0          # a state off the initial equilibrium
    key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, u.shape, jnp.float32)

    st = jax.jit(lambda u: model.assemble_stencil(u, u0, dt, data))(u)
    state = jax.jit(lambda st: cpr_setup(st, cfg))(st)
    gp = state.gmg_p
    l0 = gp.stencils[0]
    b0 = v[0]
    sub = next(i for i, s in enumerate(gp.stencils)
               if math.prod(s.grid_shape) <= subtree_cells)
    b_sub = jnp.ones(gp.stencils[sub].grid_shape, jnp.float32)
    g = cfg.gmg
    paths = {
        # one jitted call that does no work: the dispatch + sync floor
        # every wall time below includes
        "dispatch_floor": (jax.jit(lambda u: u[0, 0, 0, 0] * 0.0), u),
        "residual": (jax.jit(lambda u: model.residual(u, u0, dt, data)), u),
        "jvp": (jax.jit(lambda u, v: model.jvp(u, u0, dt, data)(v)), u, v),
        "block_matvec": (jax.jit(lambda s, v: s.matvec(v)), st, v),
        "gmg_l0_smooth": (jax.jit(
            lambda s, lam, b: chebyshev(s, b, None, degree=g.degree,
                                        lam_max=lam,
                                        lam_min_frac=g.lam_min_frac)),
            l0, gp.lam_max[0], b0),
        "gmg_l0_matvec": (jax.jit(lambda s, x: s.matvec(x)), l0, b0),
        "coarse_subtree": (jax.jit(
            lambda gs, r: _coarse_correction(gs, sub, r, g)), gp, b_sub),
        "gmg_p_apply": (jax.jit(lambda gs, b: gmg_apply(gs, b, g)), gp, b0),
        "stage2_rbgs": (jax.jit(
            lambda s, d, r: block_red_black_gauss_seidel(
                s, d, r, sweeps=cfg.stage2_sweeps)),
            state.stencil, state.dinv, v),
    }
    out = {name: _time(fn, *args, trace_dir=os.path.join(trace_root, name))
           for name, (fn, *args) in paths.items()}
    out["coarse_subtree"].update(level=sub,
                                 shape=gp.stencils[sub].grid_shape)
    return out


def precision_check(name: str = "tp_spe10_3d", oracle_n: int = 20) -> dict:
    import jax

    from chip_smoke import phase_oracle
    from thermalporous_tpu.presets import get_case
    from thermalporous_tpu.qualify import (
        collect_cpu_reference,
        compare_runs,
        qualify_steps,
        start_cpu_reference,
    )

    steps = 4
    proc = start_cpu_reference(name, steps, x64=True)
    acc = {}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(
                None if prec == "default" else prec):
            acc[prec] = qualify_steps(get_case(name), steps=steps)
    ref = collect_cpu_reference(proc)
    out = {"case": name, "cpu": ref}
    for prec, recs in acc.items():
        ok, msgs = compare_runs(recs, ref)
        out[prec] = dict(records=recs, passed=ok, mismatches=msgs)
        with jax.default_matmul_precision(
                None if prec == "default" else prec):
            out[prec]["oracle"] = phase_oracle(oracle_n)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "out", "gpu_profile"))
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--skip", nargs="*", default=[],
                   choices=("flagship", "plain_paths", "precision"),
                   help="sections not to run")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)

    from thermalporous_tpu.runtime import (
        device_summary,
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    result = {"gpu": gpu_name_and_power_limit(), "device": device_summary()}
    print(result["gpu"], flush=True)
    trace_dir = os.path.join(ROOT, "out", "gpu_profile_trace")
    for name, fn in (("flagship", lambda: flagship_profile(args.steps,
                                                           trace_dir)),
                     ("plain_paths", lambda: plain_path_times(
                         os.path.join(trace_dir, "plain"))),
                     ("precision", precision_check)):
        if name in args.skip:
            continue
        t0 = time.perf_counter()
        result[name] = fn()
        result[name]["section_s"] = time.perf_counter() - t0
        shown = {k: v for k, v in result[name].items() if k != "trace"}
        if name == "flagship":
            shown["trace"] = {k: v for k, v in result[name]["trace"].items()
                              if k != "sample"}
        print(f"# {name}: {json.dumps(shown, default=str)}", flush=True)
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
