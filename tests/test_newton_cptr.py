"""End-to-end solver tests: Newton–FGMRES–CPTR vs the f64 dense oracle.

This is the rebuild's numerical acceptance gate (SURVEY.md §4): the
production matrix-free stack must reproduce dense-LU Newton per-timestep to
tight tolerance, and the CPTR preconditioner must deliver small, flat
FGMRES iteration counts (the [P2] property and BASELINE.json's parity
metric).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from thermalporous_tpu.core import Grid
from thermalporous_tpu.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
from thermalporous_tpu.physics import PhysicalParams, Well
from thermalporous_tpu.solve import NewtonConfig, Simulator, oracle_run
from thermalporous_tpu.solve.oracle import ORACLE_ATOL, ORACLE_NEWTON


def _sp_case(n=12, seed=0, lx=120.0):
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(lx / n, lx / n), thickness=5.0)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    return SinglePhaseModel(g, pp), data


def _tp_case(n=8, seed=1, lx=80.0):
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(lx / n, lx / n), thickness=5.0)
    rng = np.random.default_rng(seed)
    k = 5e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    return TwoPhaseModel(g, pp, s_init=0.2), data


TIGHT = ORACLE_NEWTON


def _compare_states(u, u_ref, atol_p=ORACLE_ATOL[0], atol_t=ORACLE_ATOL[1],
                    atol_s=ORACLE_ATOL[2]):
    np.testing.assert_allclose(np.asarray(u[0]), u_ref[0], atol=atol_p, rtol=0)
    np.testing.assert_allclose(np.asarray(u[1]), u_ref[1], atol=atol_t, rtol=0)
    if u.shape[0] > 2:
        np.testing.assert_allclose(np.asarray(u[2]), u_ref[2], atol=atol_s, rtol=0)


@pytest.mark.parametrize("precond", ["cptr", "cpr", "jacobi"])
def test_sp_matches_oracle(precond):
    model, data = _sp_case()
    dts = [1800.0, 3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)

    sim = Simulator(model, data, precond=precond, newton_cfg=TIGHT)
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged), f"{precond}: newton failed"
        _compare_states(u, u_ref)


@pytest.mark.slow
def test_tp_matches_oracle():
    model, data = _tp_case()
    dts = [3600.0, 7200.0]
    oracle_states = oracle_run(model, data, dts)

    sim = Simulator(model, data, precond="cptr", newton_cfg=TIGHT)
    u = model.initial_state(data)
    for dt, u_ref in zip(dts, oracle_states):
        u, stats = sim.step(u, dt)
        assert bool(stats.converged)
        _compare_states(u, u_ref)


def test_cptr_iteration_counts_small_and_flat():
    """The CPTR property: FGMRES counts small and ~flat under refinement."""
    counts = {}
    for n in (16, 32):
        model, data = _sp_case(n=n)
        sim = Simulator(model, data, precond="cptr")
        u = model.initial_state(data)
        tot_ksp = tot_newton = 0
        for dt in (3600.0, 7200.0):
            u, stats = sim.step(u, dt)
            assert bool(stats.converged)
            tot_ksp += int(stats.ksp_iters)
            tot_newton += int(stats.iters)
        counts[n] = tot_ksp / tot_newton
    assert counts[16] < 25.0, f"CPTR iters too high: {counts}"
    assert counts[32] < 1.8 * counts[16] + 2.0, f"CPTR not flat: {counts}"


def test_adaptive_run_completes():
    from thermalporous_tpu.solve import TimeConfig

    model, data = _sp_case(n=10)
    sim = Simulator(
        model,
        data,
        precond="cptr",
        time_cfg=TimeConfig(dt_init=600.0, growth=2.0),
    )
    result = sim.run(t_end=86400.0)
    assert result.t == pytest.approx(86400.0)
    assert result.steps < 40
    # Δt controller grew the step
    assert result.records[-1].dt > result.records[0].dt
    # telemetry is populated
    assert all(r.newton_iters >= 1 for r in result.records)
    assert all(r.residual_norm <= 1e-6 * r.residual_norm0 + 1e-12 for r in result.records)


def test_dt_retry_on_divergence():
    """An absurd initial dt must be cut back by the controller, not crash."""
    from thermalporous_tpu.solve import TimeConfig

    model, data = _tp_case(n=8)
    sim = Simulator(
        model, data, precond="cptr",
        newton_cfg=NewtonConfig(max_iters=8, ksp_maxiter=40),
        time_cfg=TimeConfig(dt_init=1.0e9, dt_min=1.0, cutback=0.25),
    )
    res = sim.run(t_end=2.0e5, max_steps=50)
    assert res.t == pytest.approx(2.0e5)
    assert sum(r.retries for r in res.records) >= 1, "expected at least one cutback"
    s = np.asarray(res.u[2])
    assert s.min() >= -1e-6 and s.max() <= 1.0 + 1e-6


@pytest.mark.slow
def test_cptr_beats_cpr_thermally_stiff():
    """[P2]'s motivation: with a strong heat source and large dt the
    temperature block is parabolic/advective and needs its own multigrid —
    pressure-only CPR degrades, CPTR does not."""
    from thermalporous_tpu.physics import Heater

    pp = PhysicalParams()
    n = 48
    g = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
    rng = np.random.default_rng(0)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.5e7, T_inj=450.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    heaters = [Heater(cells=tuple((n // 2, j) for j in range(6, n - 6)), power=3e6)]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells, heaters=heaters)
    model = SinglePhaseModel(g, pp)

    counts = {}
    for pc in ("cpr", "cptr"):
        sim = Simulator(model, data, precond=pc,
                        newton_cfg=NewtonConfig(ksp_maxiter=300))
        u = model.initial_state(data)
        tk = tn = 0
        for _ in range(3):
            u, st = sim.step(u, 1.0e5)
            assert bool(st.converged), pc
            tk += int(st.ksp_iters)
            tn += int(st.iters)
        counts[pc] = tk / tn
    assert counts["cptr"] < 0.8 * counts["cpr"], counts


@pytest.mark.slow
def test_blocked_time_loop_bit_exact():
    """TimeConfig.block_steps>1 runs the adaptive controller in-device
    (one XLA program per block); trajectory, iteration counts and final
    state are bit-exact vs the host loop."""
    import numpy as np

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

    pp = PhysicalParams()
    n = 10
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.2)
    ncfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7)

    res = {}
    for bs in (1, 4):
        sim = Simulator(
            model, data, precond="cptr", newton_cfg=ncfg,
            time_cfg=TimeConfig(dt_init=1800.0, block_steps=bs),
        )
        res[bs] = sim.run(t_end=8 * 3600.0)

    a, b = res[1], res[4]
    assert a.steps == b.steps
    assert abs(a.t - b.t) < 1e-9 * a.t
    assert a.total_newton == b.total_newton
    assert a.total_ksp == b.total_ksp
    assert [r.dt for r in a.records] == [r.dt for r in b.records]
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_blocked_partial_final_step_no_overshoot():
    """A final partial step smaller than dt_min must land exactly on t_end
    in block mode (the host loop's min(dt, t_end - t) clip, no dt_min
    floor) — previously the block overshot by up to dt_min."""
    from thermalporous_tpu.solve import TimeConfig

    model, data = _sp_case(n=8)
    # dt grows 1800 -> ... ; dt_min large enough that the last partial
    # step (t_end not on the trajectory) is below it
    t_end = 5 * 3600.0 + 737.0
    res = {}
    for bs in (1, 4):
        sim = Simulator(
            model, data, precond="cptr",
            time_cfg=TimeConfig(dt_init=1800.0, dt_min=1500.0,
                                block_steps=bs),
        )
        res[bs] = sim.run(t_end=t_end)
    assert res[4].t == pytest.approx(t_end, rel=1e-12)
    assert res[1].t == pytest.approx(t_end, rel=1e-12)
    assert [r.dt for r in res[1].records] == [r.dt for r in res[4].records]
    np.testing.assert_array_equal(np.asarray(res[1].u), np.asarray(res[4].u))


@pytest.mark.slow
def test_fail_memory_reduces_retries_host_and_blocked():
    """TimeConfig.fail_frac: a failed attempt caps Δt regrowth below the
    failure, so the controller stops bouncing against a Δt wall (fewer
    retries, no lost simulated time); host and blocked loops implement
    the identical policy (bit-exact trajectories)."""
    from thermalporous_tpu.solve import TimeConfig

    model, data = _tp_case(n=8)
    ncfg = NewtonConfig(max_iters=5, ksp_maxiter=30, rtol=1e-8,
                        ksp_rtol=1e-6)
    t_end = 6.0e5
    runs = {}
    for tag, kw, bs in (("off", {}, 1),
                        ("on", dict(fail_frac=0.9, fail_relax=1.3), 1),
                        ("on-blk", dict(fail_frac=0.9, fail_relax=1.3), 4)):
        tc = TimeConfig(dt_init=1800.0, growth=3.0, block_steps=bs, **kw)
        sim = Simulator(model, data, precond="cptr", newton_cfg=ncfg,
                        time_cfg=tc)
        runs[tag] = sim.run(t_end=t_end)

    off, on, blk = runs["off"], runs["on"], runs["on-blk"]
    assert all(abs(r.t - t_end) < 1e-6 * t_end for r in runs.values())
    r_off = sum(r.retries for r in off.records)
    r_on = sum(r.retries for r in on.records)
    assert r_on < r_off          # the wall is remembered, not re-hit
    assert on.total_newton <= off.total_newton
    # host ≡ blocked under the feature: identical Δt policy decisions
    # (exact), states to f64 roundoff (the cap ops change the blocked
    # program's fusion, so bitwise equality is not guaranteed here — the
    # default-config bit-exact contract is test_blocked_time_loop_bit_exact)
    assert [r.dt for r in on.records] == [r.dt for r in blk.records]
    assert on.total_newton == blk.total_newton
    assert on.total_ksp == blk.total_ksp
    np.testing.assert_allclose(np.asarray(on.u), np.asarray(blk.u),
                               rtol=1e-12, atol=1e-7)


@pytest.mark.slow
def test_blocked_gives_up_at_dt_min_like_host():
    """When cutbacks bottom out at dt_min and still fail, the block must
    raise just as the host loop does (same give-up condition), instead of
    burning all max_retries at the floor."""
    from thermalporous_tpu.solve import TimeConfig

    model, data = _tp_case(n=8)
    tc = dict(dt_init=1.0e9, dt_min=2.0e8, cutback=0.5, max_retries=12)
    ncfg = NewtonConfig(max_iters=6, ksp_maxiter=30)
    for bs in (1, 4):
        sim = Simulator(
            model, data, precond="cptr", newton_cfg=ncfg,
            time_cfg=TimeConfig(block_steps=bs, **tc),
        )
        with pytest.raises(RuntimeError):
            sim.run(t_end=2.0e9, max_steps=10)


def test_newton_config_rejects_unknown_string_options():
    """Typo'd string options must fail loudly at construction, not silently
    degrade to the default code path (e.g. ksp_basis="bfloat16" silently
    measuring the full-precision basis)."""
    for field, bad in [("ksp_basis", "bfloat16"), ("ksp_orth", "mgs"),
                       ("ls_mode", "wolfe"), ("pc_lag", "never"),
                       ("krylov_op", "dense")]:
        with pytest.raises(ValueError, match=field):
            NewtonConfig(**{field: bad})
