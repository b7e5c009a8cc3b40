"""Does Krylov recycling (solve/deflate.py) pay on the hard SPE10 system?

The dt-ramp wall is a handful of slow coupled (p,T,S) modes that EVERY
Newton iteration's FGMRES must rediscover.
This probe builds the post-ramp hard system like tools/diag_hard.py and
runs the Newton-sequence experiment explicitly:

  1. solve J(u)·dx = −F(u) plain vs deflated-cold (must match),
  2. re-solve the SAME system with the harvested recycle space
     (second-Newton-iteration upper bound on the win),
  3. take the Newton update (chopped), rebuild J at u+dx, solve plain
     vs recycled-from-step-1 (the REAL Newton-drift case),
  4. capped production regime (maxiter 40, rtol 1e-2): sequence of 3
     Newton-style solves, total iterations plain vs recycled.

Usage: python tools/diag_recycle.py [dt_seconds=76800] [--cpu] [--mid] [k=8]

NOTE on units: printed iters are ARNOLDI iterations; every recycled
solve additionally pays k prepare_recycle matvecs + the QR/eigh harvest
(deflate.py docstring), so "recycled iters < plain iters" understates
recycled cost by ~k matvecs.  Wall A/Bs are the decisive metric.
"""

from __future__ import annotations

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")

MID = "--mid" in sys.argv
if MID:
    sys.argv.remove("--mid")

import jax.numpy as jnp


def main():
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.precond.cpr import (
        cpr_apply,
        cpr_setup,
        resolve_adaptive_coarsening,
    )
    from thermalporous_tpu.presets import tp_spe10_3d, tp_spe10_full
    from thermalporous_tpu.solve import Simulator
    from thermalporous_tpu.solve.deflate import empty_recycle, fgmres_dr
    from thermalporous_tpu.solve.fgmres import fgmres

    dt_hard = float(sys.argv[1]) if len(sys.argv) > 1 else 76800.0
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    case = tp_spe10_3d() if MID else tp_spe10_full()
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
    pc_cfg = CPRConfig(stage2="rbgs",
                       gmg=GMGConfig(coarsen="adaptive", degree=4,
                                     cycle_type="k", max_coarse_cells=1024))
    pc_cfg = resolve_adaptive_coarsening(st, pc_cfg)
    print(f"# hard system dt={dt_hard:.0f}s, recycle k={k}, "
          f"{'mid' if MID else 'full'} case")

    def pc_of(st):
        state = jax.jit(lambda s: cpr_setup(s, pc_cfg))(st)
        return lambda r: cpr_apply(state, r, pc_cfg)

    # ---- 1+2: plain vs deflated-cold vs recycled on the SAME system ----
    from functools import partial

    @partial(jax.jit, static_argnums=(2, 3))
    def solve_plain(st, f, rtol, maxiter):
        res = fgmres(st.matvec, -f, precond=pc_of(st),
                     rtol=rtol, maxiter=maxiter)
        return res.iters, res.converged, res.x

    @partial(jax.jit, static_argnums=(4, 5))
    def solve_dr(st, f, U, mask, rtol, maxiter):
        res, U2, m2 = fgmres_dr(st.matvec, -f, precond=pc_of(st),
                                U=U, u_mask=mask, rtol=rtol, maxiter=maxiter)
        return res.iters, res.converged, res.x, U2, m2

    it_p, conv_p, dx = jax.device_get(solve_plain(st, f, 1e-3, 200))
    print(f"plain, rtol 1e-3, cap 200:            iters={int(it_p):4d} "
          f"conv={bool(conv_p)}")

    U0, m0 = empty_recycle(f.shape, k, dtype)
    it_c, conv_c, dx_c, U1, m1 = jax.device_get(
        solve_dr(st, f, U0, m0, 1e-3, 200))
    print(f"deflated-cold (must match plain):     iters={int(it_c):4d} "
          f"conv={bool(conv_c)}")

    U1 = jnp.asarray(U1)
    m1 = jnp.asarray(m1)
    it_r, conv_r, _, U2, m2 = jax.device_get(
        solve_dr(st, f, U1, m1, 1e-3, 200))
    print(f"recycled, SAME system:                iters={int(it_r):4d} "
          f"conv={bool(conv_r)}")

    # third pass with the twice-harvested space
    it_r2, conv_r2, _, _, _ = jax.device_get(
        solve_dr(st, f, jnp.asarray(U2), jnp.asarray(m2), 1e-3, 200))
    print(f"recycled x2, SAME system:             iters={int(it_r2):4d} "
          f"conv={bool(conv_r2)}")

    # ---- 3: Newton drift — rebuild at the chopped updated state -------
    dx = jnp.asarray(dx)
    ds = jnp.clip(dx[2], -0.2, 0.2) if model.nc >= 3 else None
    if ds is not None:
        dx = jnp.concatenate([dx[:2], ds[None]], axis=0)
    u2 = u + dx
    if model.nc >= 3:
        s = jnp.clip(u2[2], 0.0, 1.0)
        u2 = jnp.concatenate([u2[:2], s[None]], axis=0)
    f2, st2 = build(u2, dt_j, data)

    it_p2, conv_p2, _ = jax.device_get(solve_plain(st2, f2, 1e-3, 200))
    print(f"NEXT Newton system, plain:            iters={int(it_p2):4d} "
          f"conv={bool(conv_p2)}")
    it_n, conv_n, _, _, _ = jax.device_get(
        solve_dr(st2, f2, U1, m1, 1e-3, 200))
    print(f"NEXT Newton system, recycled:         iters={int(it_n):4d} "
          f"conv={bool(conv_n)}")

    # ---- 4: capped production regime (rtol 1e-2, cap 40) ---------------
    for tag, use_recycle in (("plain", False), ("recycled", True)):
        tot = 0
        U, mask = empty_recycle(f.shape, k, dtype)
        su, sf = u, f
        sst = st
        for i in range(3):
            if use_recycle:
                it, conv, dxx, U, mask = jax.device_get(
                    solve_dr(sst, sf, jnp.asarray(U), jnp.asarray(mask),
                             1e-2, 40))
                U, mask = jnp.asarray(U), jnp.asarray(mask)
            else:
                it, conv, dxx = jax.device_get(solve_plain(sst, sf, 1e-2, 40))
            tot += int(it)
            dxx = jnp.asarray(dxx)
            if model.nc >= 3:
                ds = jnp.clip(dxx[2], -0.2, 0.2)
                dxx = jnp.concatenate([dxx[:2], ds[None]], axis=0)
            su = su + dxx
            if model.nc >= 3:
                s = jnp.clip(su[2], 0.0, 1.0)
                su = jnp.concatenate([su[:2], s[None]], axis=0)
            sf, sst = build(su, dt_j, data)
            print(f"  cap-40 seq [{tag}] solve {i}: iters={int(it):3d} "
                  f"conv={bool(conv)}")
        print(f"cap-40 rtol 1e-2 Newton-seq {tag}:   total={tot}")


if __name__ == "__main__":
    main()
