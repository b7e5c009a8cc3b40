"""Preconditioner decoupling variants, lagged PC, and utils."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from thermalporous_tpu.precond import CPRConfig
from thermalporous_tpu.solve import NewtonConfig, Simulator, oracle_run
from thermalporous_tpu.utils import (
    all_finite,
    assert_all_finite,
    convergence_summary,
    power_iteration,
)

from tests.test_newton_cptr import TIGHT, _compare_states, _sp_case, _tp_case


@pytest.mark.parametrize("decoupling", ["abf", "qimpes", "timpes"])
def test_decoupling_variants_match_oracle(decoupling):
    """All decoupling variants are preconditioning only — same answers."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(decoupling=decoupling), newton_cfg=TIGHT)
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged), decoupling
    _compare_states(u, oracle_states[0])


def test_asymmetric_t_hierarchy_matches_oracle():
    """Independent (cheaper) GMG config on the temperature block is
    preconditioning only — same converged answers (cpr.py::CPRConfig.gmg_t).

    This is the flagship-adopted asymmetric CPTR stage 1: the decoupled
    temperature system is near-Laplacian (8 standalone iterations vs the
    pressure block's contrast-limited hierarchy), so a V-cycle/deg-2
    hierarchy preconditions it as well as the pressure-grade K-cycle at
    ~¾ the apply cost (tools/ab_cycle.py).
    """
    from thermalporous_tpu.precond import GMGConfig

    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    pc = CPRConfig(
        gmg=GMGConfig(coarsen="adaptive", degree=4, max_coarse_cells=8),
        gmg_t=GMGConfig(cycle_type="v", degree=2, max_coarse_cells=8),
    )
    sim = Simulator(model, data, precond="cptr", pc_cfg=pc, newton_cfg=TIGHT)
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])


@pytest.mark.parametrize("pc_dtype", ["bf16", "bf16_gmg", "bf16_s2"])
def test_pc_dtype_bf16_matches_oracle(pc_dtype):
    """bf16 PC-coefficient storage is preconditioning only — same answers.

    Newton gates on the true (full-precision) residual, so rounding the
    stored PC coefficients to bf16 may shift iteration counts but must not
    move the converged states (cpr.py::CPRConfig.pc_dtype).
    """
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(pc_dtype=pc_dtype), newton_cfg=TIGHT)
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged), pc_dtype
    _compare_states(u, oracle_states[0])


def test_pc_lag_step_matches_and_converges():
    model, data = _sp_case(n=12)
    dts = [3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)
    import dataclasses

    cfg = dataclasses.replace(TIGHT, pc_lag="step")
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u = model.initial_state(data)
    for dt, ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, ref)


def test_utils_finite_and_summary():
    assert all_finite({"a": jnp.ones(3), "b": [jnp.zeros((2, 2))]})
    assert not all_finite(jnp.array([1.0, np.nan]))
    with pytest.raises(FloatingPointError):
        assert_all_finite(jnp.array([np.inf]))

    from thermalporous_tpu.solve import StepRecord

    recs = [
        StepRecord(step=i + 1, t=float(i), dt=1.0, newton_iters=3, ksp_iters=12,
                   retries=0, residual_norm0=1.0, residual_norm=1e-9, wall_s=0.1)
        for i in range(4)
    ]
    s = convergence_summary(recs)
    assert s["steps"] == 4
    assert s["ksp_per_newton_mean"] == pytest.approx(4.0)
    assert s["total_newton"] == 12


def test_power_iteration():
    a = jnp.diag(jnp.asarray([1.0, -5.0, 2.0]))
    lam = power_iteration(lambda v: a @ v, (3,), iters=50)
    assert float(lam) == pytest.approx(5.0, rel=1e-3)


def test_cptr_inner_gmres_matches_oracle():
    """[P2]'s inner-GMRES stage-1 CPTR variant is preconditioning only."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(inner_iters=3), newton_cfg=TIGHT)
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])


def test_one_stage_rbgs_preset_matches_oracle():
    """The one-stage red-black block-GS preset (ILU-analog) solves correctly
    and needs more Krylov iterations than CPTR (the ablation premise)."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)

    import dataclasses
    cfg = dataclasses.replace(TIGHT, ksp_maxiter=300)
    sim = Simulator(model, data, precond="rbgs", newton_cfg=cfg)
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])

    sim2 = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u2, stats2 = sim2.step(model.initial_state(data), dts[0])
    assert int(stats2.ksp_iters) <= int(stats.ksp_iters)


def test_krylov_op_variants_match():
    """jvp / stencil Krylov operators give the same step."""
    import dataclasses
    model, data = _sp_case(n=12)
    u0 = model.initial_state(data)
    results = []
    for op in ("jvp", "stencil"):
        cfg = dataclasses.replace(TIGHT, krylov_op=op)
        sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
        u, stats = sim.step(u0, 3600.0)
        assert bool(stats.converged), op
        results.append((op, np.asarray(u), int(stats.iters)))
    for op, u, iters in results[1:]:
        assert iters == results[0][2], op
        np.testing.assert_allclose(u[0], results[0][1][0], atol=1.0)
        np.testing.assert_allclose(u[1], results[0][1][1], atol=1e-7)


def test_cptr_stage2_rbgs_matches_oracle():
    """Stage-2 block-RBGS (the closer ILU analog) is preconditioning only."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(stage2="rbgs", stage2_sweeps=2),
                    newton_cfg=TIGHT)
    u, stats = sim.step(model.initial_state(data), dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])


def test_cptr_stage2_zebra_matches_oracle():
    """Stage-2 block zebra line GS (batched block-Thomas lines, the
    coupling-propagation smoother) is preconditioning only."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(stage2="zebra", stage2_axis=1),
                    newton_cfg=TIGHT)
    u, stats = sim.step(model.initial_state(data), dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])


def test_block_tridiag_solve_matches_dense(rng):
    """The block-Thomas primitive solves the exact block-tridiagonal part
    (dense comparison per line)."""
    from thermalporous_tpu.precond.chebyshev import block_tridiag_solve_along

    model, data = _tp_case(n=6)
    u0 = model.initial_state(data)
    st = model.assemble_stencil(u0, u0, 3600.0, data)
    axis, nc = 1, 3
    nx, ny = st.grid_shape
    b = jnp.asarray(rng.standard_normal((nc,) + st.grid_shape))
    x = block_tridiag_solve_along(axis, st.lower[axis], st.diag,
                                  st.upper[axis], b)
    for i in range(nx):
        a = np.zeros((nc * ny, nc * ny))
        for j in range(ny):
            a[j*nc:(j+1)*nc, j*nc:(j+1)*nc] = np.asarray(st.diag[:, :, i, j])
            if j + 1 < ny:
                a[j*nc:(j+1)*nc, (j+1)*nc:(j+2)*nc] = np.asarray(
                    st.upper[axis][:, :, i, j])
                a[(j+1)*nc:(j+2)*nc, j*nc:(j+1)*nc] = np.asarray(
                    st.lower[axis][:, :, i, j + 1])
        rhs = np.asarray(b[:, i, :]).T.reshape(-1)
        sol = np.linalg.solve(a, rhs).reshape(ny, nc).T
        np.testing.assert_allclose(np.asarray(x[:, i, :]), sol,
                                   rtol=1e-10, atol=1e-10 * np.abs(sol).max())


@pytest.mark.parametrize("s_stage,kw", [
    ("rbgs", {}),
    ("zebra", {"s_axis": 1}),
    ("jacobi", {"s_sweeps": 4}),
])
def test_cptr_saturation_stage_matches_oracle(s_stage, kw):
    """The saturation leg of stage 1 (CPTRS) is preconditioning only:
    the Newton answers reproduce the f64 dense oracle.  (On its
    motivation: the dt=76.8 ks full-SPE10 wall turned out to be
    the (p,T,S) COUPLING — every decoupled row solves in ≤8 iterations
    standalone, S itself in 1–3 — so the S leg is measured
    iteration-neutral there (96 vs 97) and stays an off-default option;
    tools/diag_hard.py.)"""
    model, data = _tp_case(n=6)
    dts = [3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(stage2="rbgs", s_stage=s_stage, **kw),
                    newton_cfg=TIGHT)
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, u_ref)


def test_lu_preconditioner_exact(rng):
    """The reference's direct-LU preset: FGMRES converges in 1 iteration and
    the guard rejects production-size grids."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.precond import make_preconditioner
    from thermalporous_tpu.solve.fgmres import fgmres

    pp = PhysicalParams()
    g = Grid(shape=(6, 6), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=400.0),
        Well(cells=((5, 5),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)
    u = model.initial_state(data)
    dt = jnp.asarray(600.0, u.dtype)
    st = model.assemble_stencil(u, u, dt, data)
    f = model.residual(u, u, dt, data)

    setup, apply = make_preconditioner("lu")
    state = setup(st)
    res = fgmres(st.matvec, -f, precond=lambda r: apply(state, r),
                 rtol=1e-10, maxiter=5)
    assert int(res.iters) == 1 and bool(res.converged)

    big = Grid(shape=(100, 100), spacing=(1.0, 1.0))
    data_b = make_problem_data(big, pp, kx=1e-13, phi=0.2, wells=[
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=400.0)])
    model_b = TwoPhaseModel(big, pp)
    u_b = model_b.initial_state(data_b)
    st_b = model_b.assemble_stencil(u_b, u_b, dt, data_b)
    with pytest.raises(ValueError, match="tiny grids"):
        setup(st_b)


def test_linear_predictor_same_trajectory():
    """The linear-extrapolation Newton initial guess changes the start
    point, not the rootfind: trajectories match the default to solver
    tolerance, and the predictor does not cost iterations."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

    pp = PhysicalParams()
    n = 12
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.2)
    ncfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7)

    results = {}
    for pred in ("none", "linear"):
        sim = Simulator(
            model, data, precond="cptr", newton_cfg=ncfg,
            # pin the controller (grow every step) so both runs take the
            # SAME dt sequence: the predictor legitimately changes Newton
            # counts (it converges sooner), which would otherwise steer
            # the iteration-count-based controller onto a different — and
            # incomparable — trajectory
            time_cfg=TimeConfig(dt_init=1800.0, predictor=pred,
                                grow_below=999),
        )
        results[pred] = sim.run(t_end=12 * 3600.0)

    a, b = results["none"], results["linear"]
    assert a.steps == b.steps
    np.testing.assert_allclose(
        np.asarray(a.u[0]), np.asarray(b.u[0]), atol=50.0)       # p [Pa]
    np.testing.assert_allclose(
        np.asarray(a.u[1]), np.asarray(b.u[1]), atol=1e-4)       # T [K]
    np.testing.assert_allclose(
        np.asarray(a.u[2]), np.asarray(b.u[2]), atol=1e-6)       # S_w
    assert b.total_newton <= a.total_newton + 2, (
        b.total_newton, a.total_newton)


def test_inner_richardson_preconditioner():
    """The Richardson inner-iteration CPTR variant (nested-Krylov-free form
    of [P2]'s inner option) converges FGMRES to the same solution."""
    import jax.numpy as jnp
    import numpy as np

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.precond import CPRConfig, cpr_apply, cpr_setup
    from thermalporous_tpu.solve.fgmres import fgmres

    pp = PhysicalParams()
    n = 10
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.2)
    u = model.initial_state(data)
    dt = jnp.asarray(3600.0, u.dtype)
    st = model.assemble_stencil(u, u, dt, data)
    f = model.residual(u, u, dt, data)
    bnorm = float(jnp.linalg.norm(f))

    iters = {}
    for name, cfg in [
        ("single", CPRConfig()),
        ("richardson2", CPRConfig(inner_iters=2, inner_method="richardson")),
        ("fgmres2", CPRConfig(inner_iters=2)),
    ]:
        state = cpr_setup(st, cfg)
        res = fgmres(st.matvec, -f,
                     precond=lambda r, s=state, c=cfg: cpr_apply(s, r, c),
                     rtol=1e-9, maxiter=80)
        assert bool(res.converged), name
        rnorm = float(jnp.linalg.norm(st.matvec(res.x) + f))
        assert rnorm <= 1e-8 * bnorm, (name, rnorm)
        iters[name] = int(res.iters)
    # inner iterations must not be worse than the single pass
    assert iters["richardson2"] <= iters["single"], iters


def test_appleyard_chop_same_answer_and_bounds():
    """The Appleyard saturation chop (NewtonConfig.ds_max) is
    globalization only: the converged answer matches the unchopped run to
    solver tolerance, saturations stay in [0, 1], and on an aggressively
    large step the chopped Newton still converges."""
    model, data = _tp_case(n=8)
    dts = [3600.0, 4.0 * 3600.0]
    oracle_states = oracle_run(model, data, dts)

    sim = Simulator(model, data, precond="cptr",
                    newton_cfg=dataclasses.replace(TIGHT, ds_max=0.05))
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, u_ref)
    s = np.asarray(u[2])
    assert s.min() >= -1e-9 and s.max() <= 1.0 + 1e-9

    # hard step: strong drive + multi-day dt — the chop must not break
    # convergence (and should help the front cells stay physical)
    sim_hard = Simulator(
        model, data, precond="cptr",
        newton_cfg=NewtonConfig(max_iters=25, ksp_maxiter=60, ds_max=0.2),
    )
    u2, st2 = sim_hard.step(model.initial_state(data), 2.0e5)
    assert bool(st2.converged)
    s2 = np.asarray(u2[2])
    assert s2.min() >= -1e-9 and s2.max() <= 1.0 + 1e-9


def test_predictor_tolerance_anchored_at_step_start():
    """A predictor guess must not move the rtol anchor: with a
    guess, reported norm0 (and hence the convergence target) equals the
    step-start residual norm, not the typically-much-smaller guess
    residual."""
    model, data = _tp_case(n=8)
    sim = Simulator(model, data, precond="cptr",
                    newton_cfg=NewtonConfig(rtol=1e-8, ksp_rtol=1e-6))
    u0 = model.initial_state(data)
    dt = 1800.0
    u1, st_plain = sim.step(u0, dt)
    # a near-solution guess (the converged u1 nudged back toward u0)
    guess = u1 + 0.05 * (u0 - u1)
    _, st_guess = sim.step(u0, dt, guess)
    # anchor equality: both runs report the SAME step-start norm0 ...
    np.testing.assert_allclose(float(st_guess.norm0),
                               float(st_plain.norm0), rtol=1e-12)
    # ... so the good guess converges in fewer iterations (a guess-anchored
    # rtol would have tightened tol ~20x here and cost iterations instead)
    assert int(st_guess.iters) <= int(st_plain.iters)
    assert bool(st_guess.converged)


def test_nonmonotone_chop_matches_oracle():
    """ls_mode='nonmonotone' + Appleyard chop (the production hard-step
    combination): acceptance policy changes, the rootfind does not — the
    converged state matches the f64 dense oracle, and a blow-up still
    reports failure (divergence guard)."""
    model, data = _tp_case(n=8)
    dts = [3600.0, 4 * 3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(
        model, data, precond="cptr",
        newton_cfg=dataclasses.replace(TIGHT, ds_max=0.2,
                                       ls_mode="nonmonotone"),
    )
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, u_ref)

    # divergence guard: an absurd dt must still report failure, not hang
    # or claim convergence
    u2, st2 = sim.step(model.initial_state(data), 1.0e9)
    assert not bool(st2.converged) or bool(jnp.isfinite(st2.norm))


@pytest.mark.parametrize("ksp_orth", ["cgs2g", "cgs2g2"])
def test_ksp_orth_gram_matches_oracle(ksp_orth):
    """Low-synch Gram-matrix CGS2 (fgmres.orth_gram) is orthogonalization
    arithmetic only — the converged states must match the f64 dense oracle
    exactly like the cgs2 default does (solve/fgmres.py)."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    newton_cfg=dataclasses.replace(TIGHT, ksp_orth=ksp_orth))
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged), ksp_orth
    _compare_states(u, oracle_states[0])


def test_batch_pt_matches_sequential_diagonal():
    """batch_pt stacks the p/T hierarchies into ONE vmapped traversal.

    The batched block-diagonal stage 1 computes the same two K-cycles as
    the sequential triangular=False form, so a single preconditioner
    application must agree to roundoff (cpr.py::CPRConfig.batch_pt).
    """
    import jax

    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup

    model, data = _tp_case(n=6)
    u = model.initial_state(data)
    st = model.assemble_stencil(u, u, 3600.0, data)
    r = model.residual(u, u, 3600.0, data)
    seq = cpr_setup(st, CPRConfig(triangular=False))
    bat = cpr_setup(st, CPRConfig(triangular=False, batch_pt=True))
    assert bat.gmg_t is None
    x_seq = np.asarray(cpr_apply(seq, r, CPRConfig(triangular=False)))
    x_bat = np.asarray(
        cpr_apply(bat, r, CPRConfig(triangular=False, batch_pt=True)))
    np.testing.assert_allclose(x_bat, x_seq, rtol=1e-12, atol=0.0)

    with pytest.raises(ValueError, match="batch_pt"):
        cpr_setup(st, CPRConfig(triangular=True, batch_pt=True))


def test_batch_pt_matches_oracle():
    """Batched diagonal stage 1 is preconditioning only — same answers."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(model, data, precond="cptr",
                    pc_cfg=CPRConfig(triangular=False, batch_pt=True),
                    newton_cfg=TIGHT)
    u, stats = sim.step(model.initial_state(data), dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])


def test_eisenstat_walker_matches_oracle():
    """EW forcing adapts only the INNER tolerance — same converged states.

    Newton gates on the true residual (newton.py::NewtonConfig.ksp_ew), so
    ksp_ew may shift the per-iteration FGMRES counts but must converge to
    the same answer as the fixed-tolerance solve; ksp_rtol is the floor η
    is clipped to, so the final solves are as tight as the plain config's.
    """
    model, data = _tp_case(n=6)
    dts = [3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)
    cfg = dataclasses.replace(TIGHT, ksp_ew=True)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u = model.initial_state(data)
    for dt, ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, ref)


def test_eisenstat_walker_saves_inner_iterations():
    """The loose early-forcing must reduce total FGMRES work vs solving
    every inner system to the tight fixed tolerance (the point of EW)."""
    model, data = _tp_case(n=8)
    u0 = model.initial_state(data)
    sim_fix = Simulator(model, data, precond="cptr", newton_cfg=TIGHT)
    sim_ew = Simulator(model, data, precond="cptr",
                       newton_cfg=dataclasses.replace(TIGHT, ksp_ew=True))
    _, st_fix = sim_fix.step(u0, 43200.0)
    _, st_ew = sim_ew.step(u0, 43200.0)
    assert bool(st_fix.converged) and bool(st_ew.converged)
    assert int(st_ew.ksp_iters) < int(st_fix.ksp_iters)


def test_gmg_t_asymmetric_matches_oracle():
    """A cheap (V-cycle, deg-2, geometric) TEMPERATURE hierarchy is
    preconditioning only — same converged states as the oracle, and the
    adaptive pressure schedule still resolves when gmg_t plans its own.

    Motivation: the flagship CPTR apply is latency-bound in the K-cycle's
    deep-level visits ×2 hierarchies;
    the decoupled T system is easy standalone, so it gets a V-cycle.
    """
    from thermalporous_tpu.precond import GMGConfig

    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    pc = CPRConfig(
        gmg=GMGConfig(coarsen="adaptive", cycle_type="k", degree=4),
        gmg_t=GMGConfig(cycle_type="v", degree=2),
    )
    sim = Simulator(model, data, precond="cptr", pc_cfg=pc, newton_cfg=TIGHT)
    assert sim.pc_cfg.gmg.level_factors is not None  # adaptive resolved
    u = model.initial_state(data)
    u, stats = sim.step(u, dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])
    # adaptive gmg_t plans from the T operator
    pc2 = CPRConfig(
        gmg=GMGConfig(cycle_type="k"),
        gmg_t=GMGConfig(coarsen="adaptive", cycle_type="v"),
    )
    sim2 = Simulator(model, data, precond="cptr", pc_cfg=pc2,
                     newton_cfg=TIGHT)
    assert sim2.pc_cfg.gmg_t.level_factors is not None
    u2, stats2 = sim2.step(model.initial_state(data), dts[0])
    assert bool(stats2.converged)
    _compare_states(u2, oracle_states[0])


def test_gmg_t_rejects_batch_pt():
    from thermalporous_tpu.precond import GMGConfig
    from thermalporous_tpu.precond.cpr import cpr_setup

    model, data = _tp_case(n=4)
    u = model.initial_state(data)
    st = model.assemble_stencil(u, u, jnp.asarray(600.0, u.dtype), data)
    pc = CPRConfig(batch_pt=True, triangular=False,
                   gmg_t=GMGConfig(cycle_type="v"))
    with pytest.raises(ValueError, match="batch_pt requires gmg_t"):
        cpr_setup(st, pc)


# ---------------------------------------------- round-5 stage-2 exact levers
#
# The stage-2 traffic reformulations must be EXACT —
# column-restricted r − A·x₁ (stencil.matvec_cols) and the fused zero-start
# RBGS sweep (chebyshev.block_rbgs_fused_zero).  These tests pin the
# bit-level algebra on random operators and the full solver on the oracle.


def _random_block_stencil(rng, shape, nc=3, dtype=jnp.float64):
    """Diagonally-dominant random block stencil with the zero-boundary
    face convention."""
    import numpy as _np

    def face(a):
        f = rng.standard_normal((nc, nc) + shape)
        idx = _np.arange(shape[a]).reshape(
            tuple(shape[a] if i == a else 1 for i in range(len(shape))))
        return f * (idx < shape[a] - 1)

    uppers = [face(a) for a in range(len(shape))]
    lowers = [_np.roll(u, 1, axis=2 + a) * 0.7 for a, u in enumerate(uppers)]
    diag = rng.standard_normal((nc, nc) + shape)
    for i in range(nc):
        diag[i, i] += 4.0 * (2 * len(shape) + nc)
    from thermalporous_tpu.core.stencil import BlockStencil

    return BlockStencil(
        diag=jnp.asarray(diag, dtype),
        upper=tuple(jnp.asarray(u, dtype) for u in uppers),
        lower=tuple(jnp.asarray(l, dtype) for l in lowers),
    )


@pytest.mark.parametrize("shape", [(7, 6), (5, 6, 4)])
def test_matvec_cols_bit_exact(rng, shape):
    """matvec_cols(v, k) ≡ matvec([v; 0]) bitwise (the elided columns
    multiply exact zeros in the same summation order)."""
    st = _random_block_stencil(rng, shape)
    for k in (1, 2):
        v = jnp.asarray(rng.standard_normal((k,) + shape))
        full = jnp.zeros((3,) + shape, v.dtype).at[0:k].set(v)
        got = np.asarray(st.matvec_cols(v, k))
        want = np.asarray(st.matvec(full))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(7, 6), (5, 6, 4)])
def test_matvec_offdiag_matches(rng, shape):
    """matvec_offdiag ≡ matvec − D·v (tight float tolerance: the two sides
    accumulate the same terms, minus the diagonal, in the same order)."""
    from thermalporous_tpu.core.stencil import apply_blocks

    st = _random_block_stencil(rng, shape)
    v = jnp.asarray(rng.standard_normal((3,) + shape))
    got = np.asarray(st.matvec_offdiag(v))
    want = np.asarray(st.matvec(v) - apply_blocks(st.diag, v))
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(7, 6), (5, 6, 4)])
def test_block_rbgs_fused_zero_bit_exact(rng, shape):
    """The fused zero-start sweep ≡ the looped one-sweep form (proof in the
    block_rbgs_fused_zero docstring: both elisions remove exact zeros)."""
    from thermalporous_tpu.core.stencil import invert_blocks
    from thermalporous_tpu.precond.chebyshev import (
        _checkerboard,
        block_red_black_gauss_seidel,
        block_rbgs_fused_zero,
    )

    st = _random_block_stencil(rng, shape)
    dinv = invert_blocks(st.diag)
    b = jnp.asarray(rng.standard_normal((3,) + shape))
    red = _checkerboard(shape, b.dtype)
    want = np.asarray(block_red_black_gauss_seidel(st, dinv, b, sweeps=1))
    got = np.asarray(block_rbgs_fused_zero(
        st, red * dinv, (1.0 - red) * dinv, b))
    np.testing.assert_allclose(got, want, rtol=1e-14,
                               atol=1e-14 * np.abs(want).max())


def test_stage2_levers_apply_identical(rng):
    """cpr_apply with stage2_cols + stage2_fused reproduces the baseline
    apply on a real two-phase Jacobian stencil, for CPTR (k=2) and CPR
    (k=1), including the sweeps=2 looped continuation."""
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup

    model, data = _tp_case(n=6)
    u = model.initial_state(data)
    st = model.assemble_stencil(u, u, jnp.asarray(3600.0, u.dtype), data)
    r = jnp.asarray(rng.standard_normal((3,) + st.grid_shape))
    for variant in ("cptr", "cpr"):
        for sweeps in (1, 2):
            base = CPRConfig(variant=variant, stage2="rbgs",
                             stage2_sweeps=sweeps, stage2_cols=False)
            fast = dataclasses.replace(base, stage2_cols=True,
                                       stage2_fused=True)
            want = np.asarray(cpr_apply(cpr_setup(st, base), r, base))
            got = np.asarray(cpr_apply(cpr_setup(st, fast), r, fast))
            np.testing.assert_allclose(
                got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max()), (
                variant, sweeps)


def test_stage2_cols_block_jacobi_and_zebra(rng):
    """stage2_cols also serves the block_jacobi and zebra stage-2 forms
    (the residual path is shared)."""
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup

    model, data = _tp_case(n=6)
    u = model.initial_state(data)
    st = model.assemble_stencil(u, u, jnp.asarray(3600.0, u.dtype), data)
    r = jnp.asarray(rng.standard_normal((3,) + st.grid_shape))
    for stage2 in ("block_jacobi", "zebra"):
        base = CPRConfig(stage2=stage2, stage2_cols=False)
        fast = dataclasses.replace(base, stage2_cols=True)
        want = np.asarray(cpr_apply(cpr_setup(st, base), r, base))
        got = np.asarray(cpr_apply(cpr_setup(st, fast), r, fast))
        np.testing.assert_allclose(
            got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max()), stage2


def test_stage2_cols_disabled_with_s_stage(rng):
    """With a saturation stage x₁ has full support — the apply must fall
    back to the full matvec and still match the baseline."""
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup

    model, data = _tp_case(n=6)
    u = model.initial_state(data)
    st = model.assemble_stencil(u, u, jnp.asarray(3600.0, u.dtype), data)
    r = jnp.asarray(rng.standard_normal((3,) + st.grid_shape))
    base = CPRConfig(stage2="rbgs", s_stage="rbgs", stage2_cols=False)
    fast = dataclasses.replace(base, stage2_cols=True, stage2_fused=True)
    want = np.asarray(cpr_apply(cpr_setup(st, base), r, base))
    got = np.asarray(cpr_apply(cpr_setup(st, fast), r, fast))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_cptr_stage2_levers_match_oracle():
    """Full Newton solve with both stage-2 levers reproduces the f64 dense
    oracle (they are exact reformulations, so identical trajectories)."""
    model, data = _tp_case(n=6)
    dts = [3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(
        model, data, precond="cptr",
        pc_cfg=CPRConfig(stage2="rbgs", stage2_cols=True, stage2_fused=True),
        newton_cfg=TIGHT)
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, u_ref)


@pytest.mark.parametrize("axes", [(0,), (1,), (0, 1)])
def test_matvec_offdiag_axes_subset(rng, axes):
    """matvec_offdiag(axes=...) sums exactly the requested axes' terms."""
    from thermalporous_tpu.core.stencil import apply_blocks
    from thermalporous_tpu.core.grid import shift_minus, shift_plus

    shape = (5, 6, 4)
    st = _random_block_stencil(rng, shape)
    v = jnp.asarray(rng.standard_normal((3,) + shape))
    got = np.asarray(st.matvec_offdiag(v, axes=axes))
    want = np.zeros_like(got)
    for a in axes:
        want = want + np.asarray(
            apply_blocks(st.upper[a], shift_minus(v, a, lead=1))
            + apply_blocks(st.lower[a], shift_plus(v, a, lead=1)))
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


def test_stage2_axes_sparsified_matches_oracle():
    """The sparsified stage-2 smoother operator (stage2_axes) is
    preconditioning-only: full Newton answers still reproduce the f64
    dense oracle (iteration counts MAY change — that is the A/B's
    business, not correctness's)."""
    model, data = _tp_case(n=6)
    dts = [3600.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(
        model, data, precond="cptr",
        pc_cfg=CPRConfig(stage2="rbgs", stage2_fused=True,
                         stage2_cols=True, stage2_axes=(1,)),
        newton_cfg=TIGHT)
    u, stats = sim.step(model.initial_state(data), dts[0])
    assert bool(stats.converged)
    _compare_states(u, oracle_states[0])


def test_cptr_stage2_jacobi2_matches_oracle():
    """The mask-free two-step block-Jacobi stage 2 (round-5 'jacobi2') is
    preconditioning only: Newton answers reproduce the f64 dense oracle."""
    model, data = _tp_case(n=6)
    dts = [3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)
    sim = Simulator(
        model, data, precond="cptr",
        pc_cfg=CPRConfig(stage2="jacobi2", stage2_cols=True),
        newton_cfg=TIGHT)
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, u_ref)


def test_stage2_jacobi2_formula(rng):
    """jacobi2 ≡ x₁ + D⁻¹r₂ + ω·D⁻¹(r₂ − A·D⁻¹r₂) by hand."""
    from thermalporous_tpu.core.stencil import apply_blocks
    from thermalporous_tpu.precond.cpr import cpr_apply, cpr_setup

    model, data = _tp_case(n=6)
    u = model.initial_state(data)
    st = model.assemble_stencil(u, u, jnp.asarray(3600.0, u.dtype), data)
    r = jnp.asarray(rng.standard_normal((3,) + st.grid_shape))
    cfg = CPRConfig(stage2="jacobi2", stage2_omega=0.8)
    state = cpr_setup(st, cfg)
    got = np.asarray(cpr_apply(state, r, cfg))
    base = CPRConfig(stage2="none")
    x1 = cpr_apply(cpr_setup(st, base), r, base)
    r2 = r - st.matvec(x1)
    x2 = apply_blocks(state.dinv, r2)
    want = np.asarray(
        x1 + x2 + 0.8 * apply_blocks(state.dinv, r2 - st.matvec(x2)))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
