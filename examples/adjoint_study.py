#!/usr/bin/env python
"""Adjoint sensitivity study: exact gradients of a production objective
with respect to the permeability (transmissibility) field, porosity and
well controls, through the full implicit simulation.

This is the history-matching / well-control-optimization workflow the
reference stack has no counterpart for (SURVEY.md §2): one backward sweep
costs a handful of linear solves with the TRANSPOSED Newton Jacobian —
preconditioned by the same CPTR+GMG stack — and yields dJ/dθ for EVERY
cell simultaneously, where finite differences would need one full
simulation per parameter.

The demo maximizes heat delivered to the producer region: it reports the
gradient structure, validates one finite-difference probe, and takes a
few steepest-ascent steps on log-transmissibility to show the loop
closing (J increasing).

Run: python examples/adjoint_study.py [--platform cpu] [--tp] [--ascent N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--tp", action="store_true", help="two-phase model")
    ap.add_argument("--ascent", type=int, default=3,
                    help="steepest-ascent iterations on log-T (0 = skip)")
    args = ap.parse_args()

    import jax

    if args.platform is not None:
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.platform])
    jax.config.update("jax_enable_x64", True)

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import (
        SinglePhaseModel,
        TwoPhaseModel,
        make_problem_data,
    )
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import (
        NewtonConfig,
        Simulator,
        adjoint_gradients,
        record_trajectory,
    )

    pp = PhysicalParams()
    shape = (24, 20)
    g = Grid(shape=shape, spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(11)
    k = 1e-13 * np.exp(1.0 * rng.standard_normal(shape))
    wells = [
        Well(cells=((2, 2),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((21, 17),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    model = (TwoPhaseModel if args.tp else SinglePhaseModel)(g, pp)
    # day-scale schedule: the thermal front needs days to sweep mid-field
    # on 10 m cells (hour-scale runs leave J numerically flat and make
    # every gradient probe vanish)
    dts = [21600.0, 43200.0, 86400.0, 172800.0, 345600.0]

    def terminal(u, d):
        # heat swept into the mid-field block on the injector→producer path
        return jnp.mean(u[1, 4:12, 3:10])

    ncfg = NewtonConfig(rtol=1e-11, ksp_rtol=1e-9, ksp_maxiter=120)

    def evaluate(d):
        sim = Simulator(model, d, precond="cptr", newton_cfg=ncfg)
        states = record_trajectory(sim, model.initial_state(d), dts)
        return adjoint_gradients(model, d, states, dts, terminal=terminal,
                                 rtol=1e-10, maxiter=240)

    res = evaluate(data)
    gt = res.grad_data.tgeo[0]
    print(f"# {model.__class__.__name__} {shape}, {len(dts)} steps, "
          f"J = mean T over the mid-field sweep region")
    print(f"J           = {float(res.value):.6f} K")
    print(f"adjoint KSP = {res.ksp_iters} iterations total "
          f"(converged={res.converged})")
    print(f"|dJ/dT_geo| max {float(jnp.abs(gt).max()):.3e}, "
          f"|dJ/dphi| max {float(jnp.abs(res.grad_data.phi).max()):.3e}")
    iy, ix = np.unravel_index(int(jnp.argmax(jnp.abs(gt))), shape)
    print(f"most sensitive x-face: cell ({iy},{ix}) — on the "
          f"injector→producer path" )

    # one finite-difference probe as a live correctness check
    xi = jnp.asarray(rng.standard_normal(shape))
    d_tg = data.tgeo[0] * xi
    eps = 1e-4

    def j_of(dd):
        sim = Simulator(model, dd, precond="cptr", newton_cfg=ncfg)
        states = record_trajectory(sim, model.initial_state(dd), dts)
        return float(terminal(states[-1], dd))

    def bump(s):
        return dataclasses.replace(
            data, tgeo=(data.tgeo[0] + s * eps * d_tg,) + tuple(data.tgeo[1:]))

    fd = (j_of(bump(+1)) - j_of(bump(-1))) / (2 * eps)
    ad = float(jnp.vdot(gt, d_tg))
    print(f"FD probe: adjoint {ad:.6e} vs central-difference {fd:.6e} "
          f"(rel err {abs(ad - fd) / max(abs(fd), 1e-300):.2e})")
    # NOTE: u0 is recomputed per evaluation; initial_state here does not
    # depend on tgeo, so the probe is consistent with the adjoint.

    # close the loop: steepest ascent on log-transmissibility
    for it in range(args.ascent):
        g_log = res.grad_data.tgeo[0] * data.tgeo[0]   # chain rule to log-T
        step = 0.5 / float(jnp.abs(g_log).max())
        new_t0 = data.tgeo[0] * jnp.exp(step * g_log)
        data = dataclasses.replace(
            data, tgeo=(new_t0,) + tuple(data.tgeo[1:]))
        res = evaluate(data)
        print(f"ascent {it + 1}: J = {float(res.value):.6f} K")


if __name__ == "__main__":
    main()
