"""Roofline: achieved vs memory-bandwidth-bound time per solver component.

Achieved-vs-achievable bandwidth per component at the bench configuration
(1024² two-phase f32, deg-4 K-cycle CPTR, cap 40).

Method: every number is a WHOLE Newton step synced through one device_get, with the FGMRES iteration count
forced exactly (unreachable rtol + fixed cap), so
  wall(k; m) = intercept + k · per_iter(m)
separates the per-Newton fixed cost (assembly + 2× GMG setup + line
search + dispatch) from the per-iteration cost (block matvec + CPTR apply
+ CGS2 streaming of the full static m+1-slot basis).  Running the same
split with bf16 basis storage isolates the CGS2 term because ONLY the
basis bytes change.

Bounds divide by the device's published peak memory bandwidth
(``thermalporous_tpu.runtime.PEAK_MEMORY_BW``, keyed by ``device_kind``; an
unknown device is an error) and count mandatory memory traffic:
  matvec      read 45N coef + read v + write y
  CGS2(m)     4 passes × (m+1) slots × state bytes  (2 projections + 2
              reconstructions per CGS2; V storage dtype sets the bytes)
  CPTR apply  stage-1 GMG: (deg+1) scalar matvecs × levels (~4/3 geometric
              sum, ~×1.5 K-cycle revisits) on p AND T + stage-2 RBGS block
              sweep (2 half-sweeps over the 45N block coef) + vectors
  assembly    write 45N coef + read state/fields

Usage: python tools/roofline.py [n] [reps] [m] [basis ...]

``m`` is the static Krylov cap (default 40; bench.py runs 24, where the
basis term shrinks by ~(25/41)).

``basis`` tokens may carry an orthogonalization suffix: ``same-g2``
(f32 basis + fully-algebraic low-synch CGS2, 2 basis passes/iter),
``bf16-g3`` (bf16 basis + real-dots Gram column, 3 passes) — see
fgmres.orth_gram.  Plain ``same``/``bf16`` = classic CGS2 (4 passes).
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

def main():
    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.solve import NewtonConfig, make_step_fn

    from thermalporous_tpu.runtime import peak_memory_bandwidth

    HBM_BW = peak_memory_bandwidth()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    m_arg = int(sys.argv[3]) if len(sys.argv) > 3 else 40
    bases = sys.argv[4:] or ["same", "bf16"]

    dtype = jnp.float32
    pp = PhysicalParams()
    grid = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
    rng = np.random.default_rng(11)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal(grid.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(grid, pp, kx=kx, phi=0.2, wells=wells, dtype=dtype)
    model = TwoPhaseModel(grid, pp, s_init=0.2)
    pc = CPRConfig(gmg=GMGConfig(cycle_type="k", max_coarse_cells=1024,
                                 degree=4))

    # warm the state into the adaptive regime
    warm = jax.jit(make_step_fn(model, "cptr", NewtonConfig(
        rtol=1e-4, atol=2e-5, ksp_rtol=1e-3, ksp_maxiter=40, max_iters=14,
        pc_lag="every"), pc))
    u = model.initial_state(data, dtype=dtype)
    dt = 600.0
    for _ in range(6):
        u_new, stats = warm(u, jnp.asarray(dt, dtype), data)
        stats = jax.device_get(stats)
        assert bool(stats.converged)
        u = u_new
        dt *= 2.0
    dt_j = jnp.asarray(dt, dtype)

    N = grid.ncells
    nc = model.nc
    sb = nc * N * 4                      # one f32 state, bytes
    m = m_arg

    def timed(cfg, k_expect):
        step = jax.jit(make_step_fn(model, "cptr", cfg, pc))
        _, st = step(u, dt_j, data)
        st = jax.device_get(st)
        k_got = int(st.ksp_iters)
        # the unreachable rtol usually pins the count at the cap, but a
        # breakdown guard may exit a couple of iterations early — use the
        # MEASURED count in the slope rather than asserting the cap
        assert k_got >= max(1, k_expect - 4), (k_expect, k_got)
        t0 = time.perf_counter()
        for _ in range(reps):
            _, st = step(u, dt_j, data)
            st = jax.device_get(st)
        return (time.perf_counter() - t0) / reps, k_got

    print(f"# {n}x{n} f32 two-phase, dt={dt:.0f}s, deg-4 K-cycle CPTR, "
          f"cap {m}, {reps} reps")
    # token = "<basis>[-g2|-g3]": storage dtype + orthogonalization variant
    ORTH = {"g2": "cgs2g2", "g3": "cgs2g"}
    PASSES = {"cgs2": 4, "cgs2g2": 2, "cgs2g": 3}
    meas = {}
    for token in bases:
        basis, _, osfx = token.partition("-")
        orth = ORTH.get(osfx, "cgs2")
        walls = {}
        for k in (1, m):
            cfg = NewtonConfig(rtol=1e-30, atol=0.0, ksp_rtol=1e-30,
                               ksp_maxiter=m, max_iters=1, pc_lag="every",
                               max_backtracks=1, ksp_basis=basis,
                               ksp_orth=orth,
                               # force exactly k iterations via the cap
                               ) if k == m else NewtonConfig(
                rtol=1e-30, atol=0.0, ksp_rtol=1e-30, ksp_maxiter=1,
                max_iters=1, pc_lag="every", max_backtracks=1,
                ksp_basis=basis, ksp_orth=orth)
            walls[k] = timed(cfg, k)
        # k=1 ran at cap 1 (1 basis slot), k=m at cap m: per-iteration cost
        # AT CAP M comes from the m-run alone minus the fixed intercept;
        # the k=1 run approximates intercept + 1 cheap iteration
        (w1, k1), (wm, km) = walls[1], walls[m]
        per_iter_m = (wm - w1) / (km - k1)
        meas[token] = (w1, wm, per_iter_m)
        print(f"basis={token:8s}: wall(k={k1},cap1)={w1*1e3:7.2f} ms  "
              f"wall(k={km},cap{m})={wm*1e3:7.2f} ms  "
              f"-> per-iter at cap {m} ≈ {per_iter_m*1e3:6.3f} ms")

    # ---- bounds
    coef_b = (2 * grid.dim + 1) * nc * nc * N * 4
    matvec_b = coef_b + 2 * sb
    # p = basis passes/iteration (4 classic CGS2, 3 Gram/real-dots, 2 algebraic)
    cgs2 = lambda vb, p=4: p * (m + 1) * nc * N * vb + 6 * sb  # + w traffic
    # stage-1 GMG per apply: two scalar hierarchies (p, T), (deg+1) stencil
    # matvecs per level visit, 5-coef scalar stencils, 2D coarsening ratio
    # ~1/4 per level (geometric series 4/3), K-cycle revisit factor ~1.5
    deg = 4
    scalar_lvl0 = (deg + 1) * ((2 * grid.dim + 1) * N * 4 + 2 * N * 4)
    gmg_one = scalar_lvl0 * (4.0 / 3.0) * 1.5
    stage1_b = 2 * gmg_one + 4 * N * 4 * 6   # + residual/restrict vectors
    stage2_b = 2 * (coef_b / 2 + sb)         # RB half-sweeps... bJacobi: inv blocks
    # default stage2 is block-Jacobi: read nc² diag inverse + r, write x
    stage2_b = nc * nc * N * 4 + 2 * sb
    cptr_b = stage1_b + stage2_b
    per_iter_bound = lambda vb, p=4: (matvec_b + cgs2(vb, p) + cptr_b) / HBM_BW

    assembly_b = coef_b + 10 * N * 4
    fixed_bound = (assembly_b + 2 * gmg_one + 4 * sb) / HBM_BW

    print("\n# bounds at peak memory bandwidth", HBM_BW / 1e9, "GB/s")
    print(f"  matvec       {matvec_b/2**20:7.1f} MiB  {matvec_b/HBM_BW*1e3:6.3f} ms")
    print(f"  CGS2 f32     {cgs2(4)/2**20:7.1f} MiB  {cgs2(4)/HBM_BW*1e3:6.3f} ms")
    print(f"  CGS2 bf16    {cgs2(2)/2**20:7.1f} MiB  {cgs2(2)/HBM_BW*1e3:6.3f} ms")
    print(f"  g2 f32 (2p)  {cgs2(4,2)/2**20:7.1f} MiB  {cgs2(4,2)/HBM_BW*1e3:6.3f} ms")
    print(f"  g3 bf16 (3p) {cgs2(2,3)/2**20:7.1f} MiB  {cgs2(2,3)/HBM_BW*1e3:6.3f} ms")
    print(f"  CPTR apply   {cptr_b/2**20:7.1f} MiB  {cptr_b/HBM_BW*1e3:6.3f} ms")
    print(f"  per-iter bound: f32 {per_iter_bound(4)*1e3:.3f} ms, "
          f"bf16 {per_iter_bound(2)*1e3:.3f} ms, "
          f"f32-g2 {per_iter_bound(4,2)*1e3:.3f} ms, "
          f"bf16-g3 {per_iter_bound(2,3)*1e3:.3f} ms")
    print(f"  per-Newton fixed bound ≈ {fixed_bound*1e3:.3f} ms "
          f"(assembly + 2 GMG setups + vectors)")
    for token, (w1, wm, pi) in meas.items():
        basis, _, osfx = token.partition("-")
        vb = 2 if basis == "bf16" else 4
        p = PASSES[ORTH.get(osfx, "cgs2")]
        print(f"  basis={token:8s}: achieved per-iter {pi*1e3:.3f} ms vs "
              f"bound {per_iter_bound(vb,p)*1e3:.3f} ms "
              f"-> {per_iter_bound(vb,p)/pi*100:.0f}% of roofline")


if __name__ == "__main__":
    main()
