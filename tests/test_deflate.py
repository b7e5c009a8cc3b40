"""Krylov recycling (solve/deflate.py): degrade-exactness, recycling
wins, residual-estimate honesty, and Newton oracle parity."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from thermalporous_tpu.solve import NewtonConfig, Simulator, oracle_run
from thermalporous_tpu.solve.deflate import (
    empty_recycle,
    fgmres_dr,
    prepare_recycle,
)
from thermalporous_tpu.solve.fgmres import fgmres

from tests.test_newton_cptr import TIGHT, _compare_states, _tp_case


def _slow_mode_system(rng, n=100, n_slow=6):
    """Nonsymmetric system with a few tiny singular values — the shape of
    the SPE10 coupling wall (a handful of slow modes)."""
    a = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    d = np.ones(n)
    d[:n_slow] = 1e-3 * (1.0 + np.arange(n_slow))
    a = a @ np.diag(d)
    x = rng.standard_normal(n)
    return jnp.asarray(a), jnp.asarray(x), jnp.asarray(a @ x)


def test_deflated_cold_matches_plain(rng):
    """All-invalid recycle space degrades EXACTLY to plain FGMRES."""
    a, x_true, b = _slow_mode_system(rng)
    mv = lambda v: a @ v
    ref = fgmres(mv, b, rtol=1e-9, maxiter=60)
    U, mask = empty_recycle(b.shape, 5, b.dtype)
    res, U1, m1 = fgmres_dr(mv, b, U=U, u_mask=mask, rtol=1e-9, maxiter=60)
    assert int(res.iters) == int(ref.iters)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    # the harvest is populated from the solve
    assert bool(jnp.any(m1))


def test_recycling_reduces_iterations_same_system(rng):
    a, x_true, b = _slow_mode_system(rng)
    mv = lambda v: a @ v
    U, mask = empty_recycle(b.shape, 6, b.dtype)
    r1, U1, m1 = fgmres_dr(mv, b, U=U, u_mask=mask, rtol=1e-8, maxiter=110)
    r2, _, _ = fgmres_dr(mv, b, U=U1, u_mask=m1, rtol=1e-8, maxiter=110)
    assert bool(r1.converged)
    assert int(r2.iters) < int(r1.iters)
    assert bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(x_true),
                               rtol=1e-5, atol=1e-7)


def test_residual_estimate_is_true_residual(rng):
    """The C-component of the residual is annihilated exactly by
    alpha = -B y, so the Givens estimate equals the true residual."""
    a, x_true, b = _slow_mode_system(rng)
    mv = lambda v: a @ v
    U, mask = empty_recycle(b.shape, 6, b.dtype)
    _, U1, m1 = fgmres_dr(mv, b, U=U, u_mask=mask, rtol=1e-8, maxiter=80)
    res, _, _ = fgmres_dr(mv, b, U=U1, u_mask=m1, rtol=1e-4, maxiter=80)
    true = float(jnp.linalg.norm(b - a @ res.x))
    est = float(res.res_norm)
    assert abs(true - est) <= 1e-6 * float(jnp.linalg.norm(b)) + 1e-12


def test_prepare_recycle_image_orthonormal(rng):
    a, _, b = _slow_mode_system(rng)
    mv = lambda v: a @ v
    U = jnp.asarray(rng.standard_normal((4, b.shape[0])))
    mask = jnp.asarray([True, True, True, True])
    Uo, C, m = prepare_recycle(mv, U, mask)
    assert bool(jnp.all(m))
    # A Uo = C and C^T C = I
    np.testing.assert_allclose(np.asarray(jnp.stack([mv(Uo[i]) for i in range(4)])),
                               np.asarray(C), rtol=1e-10, atol=1e-10)
    G = np.asarray(C) @ np.asarray(C).T
    np.testing.assert_allclose(G, np.eye(4), atol=1e-10)


def test_prepare_recycle_masks_dependent_columns(rng):
    a, _, b = _slow_mode_system(rng)
    mv = lambda v: a @ v
    u0 = rng.standard_normal(b.shape[0])
    U = jnp.asarray(np.stack([u0, 2.0 * u0, rng.standard_normal(b.shape[0])]))
    mask = jnp.asarray([True, True, True])
    Uo, C, m = prepare_recycle(mv, U, mask)
    assert bool(m[0]) and not bool(m[1]) and bool(m[2])
    np.testing.assert_array_equal(np.asarray(C[1]), 0.0)


@pytest.mark.slow
def test_newton_recycle_matches_oracle():
    """Recycling is a Krylov accelerator only — converged states match
    the f64 dense oracle.  NOTE: ksp_iters counts Arnoldi iterations
    only; each recycled solve also pays k prepare_recycle matvecs, so
    counts are not comparable units with the plain solver (deflate.py
    docstring) — no iteration assertion here."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    rec = Simulator(model, data, precond="cptr",
                    newton_cfg=dataclasses.replace(TIGHT, ksp_recycle=4))
    u0 = model.initial_state(data)
    u_r, st_r = rec.step(u0, dts[0])
    assert bool(st_r.converged)
    _compare_states(u_r, oracle_states[0])


@pytest.mark.slow
def test_adjoint_recycle_matches_plain():
    """The adjoint sweep's recycle option changes iteration counts only —
    gradients match the plain sweep to solve tolerance."""
    from thermalporous_tpu.solve import adjoint_gradients, record_trajectory

    model, data = _tp_case(n=6)
    u0 = model.initial_state(data)
    dts = [1800.0, 2700.0, 4050.0]
    sim = Simulator(model, data, precond="cptr", newton_cfg=TIGHT)
    states = record_trajectory(sim, u0, dts)

    def terminal(u, d):
        return jnp.mean(u[1, :3, :3])

    plain = adjoint_gradients(model, data, states, dts, terminal=terminal,
                              rtol=1e-11, maxiter=200)
    rec = adjoint_gradients(model, data, states, dts, terminal=terminal,
                            rtol=1e-11, maxiter=200, recycle=4)
    assert rec.converged
    np.testing.assert_allclose(np.asarray(rec.grad_u0),
                               np.asarray(plain.grad_u0),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rec.grad_data.phi),
                               np.asarray(plain.grad_data.phi),
                               rtol=1e-6, atol=1e-12)


def test_recycle_restart_incompatible():
    model, data = _tp_case(n=6)
    sim = Simulator(model, data, precond="cptr",
                    newton_cfg=dataclasses.replace(
                        TIGHT, ksp_recycle=4, ksp_restart=16))
    with pytest.raises(ValueError, match="ksp_recycle"):
        sim.step(model.initial_state(data), 3600.0)
