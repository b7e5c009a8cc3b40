"""Flagship roofline: achieved vs memory-bound per component at 60×220×85.

The 1024² bench point has its achieved-vs-bound table in tools/roofline.py;
this tool computes the mandatory-traffic bounds for the PRODUCTION tp_spe10_full
configuration (adaptive hierarchy with its ACTUAL level sizes, asymmetric
cheap-T stage 1, RBGS stage 2, cap-16 bf16 basis) and measures each
component as a whole jitted program synced through one device_get, so
progress is tracked against a bound, not a wall.  Bounds divide by the
device's published peak memory bandwidth
(``thermalporous_tpu.runtime.PEAK_MEMORY_BW``; an unknown device is an
error).

Per-component byte model (f32 = 4 B/elem unless noted):
  residual      read ~14 field/state arrays + write nc·N
  assembly      write 45N block coef + read ~14 arrays
  matvec        read 45N coef + read/write state vectors
  CPTR apply    Σ_levels (visits × (deg+1) × (7-coef scalar matvec bytes))
                over BOTH hierarchies with the adaptive level sizes and
                the cycle-type visit pattern (K: 2^(L−1) capped by
                kcycle_min_cells; V: 1), + dense coarse inv streaming ×
                visits, + stage-2 RBGS (2 half-sweeps over 45N + vectors)
  CGS2(m=16)    4 passes × 17 slots × nc·N × basis bytes (bf16 = 2)

Usage: python tools/roofline_full.py [reps]
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import jax
import jax.numpy as jnp

def level_shapes(shape, factors_schedule, max_coarse, max_levels=16):
    """Replicate gmg_setup's level-shape walk (constant transfer)."""
    shapes = [tuple(shape)]
    lev = 0
    while (math.prod(shapes[-1]) > max_coarse and len(shapes) < max_levels
           and any(n > 1 for n in shapes[-1])):
        cur = shapes[-1]
        if factors_schedule is not None and lev < len(factors_schedule):
            fac = tuple(f if n > 1 else 1
                        for f, n in zip(factors_schedule[lev], cur))
        else:
            fac = tuple(2 if n > 1 else 1 for n in cur)
        shapes.append(tuple(-(-n // 2) if f == 2 else n
                            for n, f in zip(cur, fac)))
        lev += 1
    return shapes


def hierarchy_bytes(shapes, degree, cycle_type, kmin, itemsize=4):
    """Mandatory HBM traffic of ONE stage-1 GMG correction pass.

    Visit counts follow _coarse_correction: level L is visited v(L) times
    where v doubles below every K-eligible level (cells ≥ kmin) and the
    coarsest is a dense matvec (n² bytes of inverse per visit).
    """
    visits = [1]
    for lev in range(1, len(shapes)):
        parent_k = (cycle_type == "k"
                    and math.prod(shapes[lev - 1]) >= kmin
                    and lev - 1 > 0)
        visits.append(visits[-1] * (2 if parent_k else 1))
    total = 0.0
    for lev, (sh, v) in enumerate(zip(shapes, visits)):
        n = math.prod(sh)
        dim = len(sh)
        if lev == len(shapes) - 1:
            total += v * (n * n * itemsize)  # dense inverse stream
            continue
        # per visit: 2 smooths of (degree) matvecs each + 1 residual matvec
        # + K-glue matvecs (2 at K levels); each scalar matvec reads
        # (2·dim+1)·n coef + r/w vectors (~3n)
        mv = (2 * dim + 1 + 3) * n * itemsize
        per_visit = (2 * degree + 1 + (2 if (cycle_type == "k"
                                             and n >= kmin and lev > 0)
                                       else 0)) * mv
        total += v * per_visit
    return total, visits


def main():
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup
    from thermalporous_tpu.presets import tp_spe10_full
    from thermalporous_tpu.runtime import peak_memory_bandwidth
    from thermalporous_tpu.solve import Simulator, make_step_fn

    HBM_BW = peak_memory_bandwidth()

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    case = tp_spe10_full()
    model, data = case.model, case.data
    dtype = jnp.float32
    data = jax.tree.map(
        lambda a: a.astype(dtype) if hasattr(a, "astype") else a, data)

    sim = Simulator(model, data, precond="cptr", newton_cfg=case.newton_cfg,
                    pc_cfg=case.pc_cfg, time_cfg=case.time_cfg)
    u = model.initial_state(data, dtype=dtype)
    res = sim.run(t_end=2 * 3600.0, u0=u, dt0=600.0)
    u = res.u
    dt_w = res.records[-1].next_dt or res.records[-1].dt
    pc = sim.pc_cfg
    dt = jnp.asarray(dt_w, dtype)
    ncfg = case.newton_cfg

    shape = model.grid.shape
    N = math.prod(shape)
    nc = model.nc
    dim = len(shape)

    # ---- bounds
    p_shapes = level_shapes(shape, pc.gmg.level_factors,
                            pc.gmg.max_coarse_cells)
    t_cfg = pc.gmg_t or pc.gmg
    t_shapes = level_shapes(shape, t_cfg.level_factors,
                            t_cfg.max_coarse_cells)
    gmg_p_b, vis_p = hierarchy_bytes(p_shapes, pc.gmg.degree,
                                     pc.gmg.cycle_type,
                                     pc.gmg.kcycle_min_cells)
    gmg_t_b, vis_t = hierarchy_bytes(t_shapes, t_cfg.degree,
                                     t_cfg.cycle_type,
                                     t_cfg.kcycle_min_cells)
    coef_b = (2 * dim + 1) * nc * nc * N * 4
    sb = nc * N * 4
    # stage-2 RBGS: 2 colored half-sweeps, each streaming the full block
    # coef + dinv + vectors
    stage2_b = 2 * (coef_b / 2 + nc * nc * N * 4 / 2) + 4 * sb
    apply_b = gmg_p_b + gmg_t_b + stage2_b + 6 * sb  # + W scale, residuals
    matvec_b = coef_b + 2 * sb
    m = ncfg.ksp_maxiter
    basis_bytes = 2 if ncfg.ksp_basis == "bf16" else 4
    cgs2_b = 4 * (m + 1) * nc * N * basis_bytes + 6 * sb
    assembly_b = coef_b + 14 * N * 4
    residual_b = (14 * N + 2 * nc * N) * 4

    per_iter_b = (matvec_b + cgs2_b + apply_b) / HBM_BW

    print(f"# flagship {shape} two-phase f32, production preset, "
          f"dt={float(dt):.0f}s, {reps} reps")
    print(f"# p-hierarchy {[math.prod(s) for s in p_shapes]} visits {vis_p}")
    print(f"# t-hierarchy {[math.prod(s) for s in t_shapes]} visits {vis_t}")
    print(f"# bounds: residual {residual_b/HBM_BW*1e3:.3f} ms | assembly "
          f"{assembly_b/HBM_BW*1e3:.3f} | matvec {matvec_b/HBM_BW*1e3:.3f}"
          f" | CPTR apply {apply_b/HBM_BW*1e3:.3f} (gmg_p "
          f"{gmg_p_b/HBM_BW*1e3:.3f} + gmg_t {gmg_t_b/HBM_BW*1e3:.3f} + "
          f"stage2 {stage2_b/HBM_BW*1e3:.3f}) | CGS2 cap{m} "
          f"{cgs2_b/HBM_BW*1e3:.3f} | per-iter {per_iter_b*1e3:.3f}")

    # ---- measurements
    def timeit(fn, *args):
        out = fn(*args)
        jax.device_get(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.device_get(fn(*args))
        return (time.perf_counter() - t0) / reps

    null = jax.jit(lambda u: jnp.float32(0.0) * u[0, 0, 0, 0])
    floor = timeit(null, u)
    print(f"  null (dispatch floor) {floor*1e3:7.3f} ms")

    rfn = jax.jit(lambda u: model.residual(u, u, dt, data).ravel()[7])
    w = timeit(rfn, u)
    print(f"  residual             {w*1e3:8.2f} ms  bound "
          f"{residual_b/HBM_BW*1e3:6.3f}  (incl. floor)")

    afn = jax.jit(
        lambda u: model.assemble_stencil(u, u, dt, data).diag.ravel()[7])
    w = timeit(afn, u)
    print(f"  assemble             {w*1e3:8.2f} ms  bound "
          f"{assembly_b/HBM_BW*1e3:6.3f}  (incl. floor)")

    @jax.jit
    def build(u):
        st = model.assemble_stencil(u, u, dt, data)
        f = model.residual(u, u, dt, data)
        return st, f
    st, f = build(u)

    def k_applies(st, f, k):
        pcs = cpr_setup(st, pc)
        def body(i, r):
            return cpr_apply(pcs, r, pc) * (1.0 + 1e-30 * i)
        return jax.lax.fori_loop(0, k, body, f).ravel()[7]
    w2 = timeit(jax.jit(lambda st, f: k_applies(st, f, 2)), st, f)
    w10 = timeit(jax.jit(lambda st, f: k_applies(st, f, 10)), st, f)
    per_apply = (w10 - w2) / 8.0
    print(f"  CPTR apply (slope)   {per_apply*1e3:8.2f} ms  bound "
          f"{apply_b/HBM_BW*1e3:6.3f}  -> "
          f"{apply_b/HBM_BW/per_apply*100:4.0f}% of roofline")

    def k_matvecs(st, f, k):
        def body(i, r):
            return st.matvec(r) * (1.0 + 1e-30 * i)
        return jax.lax.fori_loop(0, k, body, f).ravel()[7]
    w2 = timeit(jax.jit(lambda st, f: k_matvecs(st, f, 2)), st, f)
    w10 = timeit(jax.jit(lambda st, f: k_matvecs(st, f, 10)), st, f)
    per_mv = (w10 - w2) / 8.0
    print(f"  block matvec (slope) {per_mv*1e3:8.2f} ms  bound "
          f"{matvec_b/HBM_BW*1e3:6.3f}  -> "
          f"{matvec_b/HBM_BW/per_mv*100:4.0f}% of roofline")

    # full production Newton at forced ksp budgets -> per-iteration slope
    walls = {}
    for k in (1, 6):
        cfg = dataclasses.replace(
            ncfg, rtol=1e-30, atol=0.0, ksp_rtol=1e-30, ksp_ew=False,
            ksp_maxiter=k, max_iters=1, max_backtracks=1)
        step = jax.jit(make_step_fn(model, "cptr", cfg, pc))
        def one(u, step=step):
            _, s = step(u, dt, data)
            return s.ksp_iters
        walls[k] = timeit(one, u)
    per_iter = (walls[6] - walls[1]) / 5.0
    print(f"  per FGMRES iter      {per_iter*1e3:8.2f} ms  bound "
          f"{per_iter_b*1e3:6.3f}  -> "
          f"{per_iter_b/per_iter*100:4.0f}% of roofline")
    print(f"  (1-Newton wall at ksp=1: {walls[1]*1e3:.1f} ms, ksp=6: "
          f"{walls[6]*1e3:.1f} ms)")
    print(f"# headroom: per-iter achieved/bound = "
          f"{per_iter/per_iter_b:.2f}x; CPTR apply "
          f"{per_apply/(apply_b/HBM_BW):.2f}x")


if __name__ == "__main__":
    main()
