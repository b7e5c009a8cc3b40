"""Multi-chip-without-a-cluster tests (SURVEY.md §4 item 5).

Runs on the forced 8-device CPU mesh: residuals, stencil matvecs and full
Newton steps computed under grid domain decomposition must match the
single-device results to the last ulp-scale tolerance (the collectives XLA
inserts are reductions over identical partial sums, so differences are at
rounding level only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from thermalporous_tpu.dist import (
    make_grid_mesh,
    shard_problem_data,
    shard_state,
)
from thermalporous_tpu.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
from thermalporous_tpu.core import Grid
from thermalporous_tpu.physics import PhysicalParams, Well
from thermalporous_tpu.solve import NewtonConfig, Simulator


def _case(model_cls, n=16, seed=0):
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(seed)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    model = model_cls(g, pp)
    return model, data


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("model_cls", [SinglePhaseModel, TwoPhaseModel])
def test_sharded_residual_matches(model_cls, rng):
    model, data = _case(model_cls)
    mesh = make_grid_mesh(8)
    u_old = model.initial_state(data)
    u = u_old + 1e5 * jnp.asarray(rng.standard_normal(u_old.shape))

    ref = jax.jit(lambda u: model.residual(u, u_old, 500.0, data))(u)

    u_s = shard_state(u, mesh)
    uo_s = shard_state(u_old, mesh)
    data_s = shard_problem_data(data, mesh)
    out = jax.jit(lambda u, uo, d: model.residual(u, uo, 500.0, d))(u_s, uo_s, data_s)

    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), atol=1e-12 * scale, rtol=1e-12
    )


def test_sharded_newton_step_matches():
    model, data = _case(SinglePhaseModel)
    sim = Simulator(model, data, precond="cptr",
                    newton_cfg=NewtonConfig(rtol=1e-9, ksp_rtol=1e-7))
    u0 = model.initial_state(data)

    u_ref, stats_ref = sim.step(u0, 3600.0)

    mesh = make_grid_mesh(8)
    u_s = shard_state(u0, mesh)
    data_s = shard_problem_data(data, mesh)
    sim_s = Simulator(model, data_s, precond="cptr",
                      newton_cfg=NewtonConfig(rtol=1e-9, ksp_rtol=1e-7))
    u_out, stats = sim_s.step(u_s, 3600.0)

    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    # FGMRES totals too: a sharding-induced preconditioner regression that
    # costs Krylov iterations must fail here, not just Newton parity
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    # identical algorithm, reductions re-associated only → rounding-level diff
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]), atol=5.0)
    np.testing.assert_allclose(np.asarray(u_out[1]), np.asarray(u_ref[1]), atol=1e-6)
    # result is actually distributed
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
@pytest.mark.parametrize("ksp_orth", ["cgs2g", "cgs2g2"])
def test_sharded_ksp_orth_gram_match(ksp_orth):
    """Low-synch Gram-matrix CGS2 (fgmres.orth_gram — adopted by the
    production preset) under domain decomposition: the carried G = VᵀV is
    built from global dots that GSPMD lowers to all-reduces, so sharded
    Newton/FGMRES counts and states must match single-device exactly."""
    import dataclasses

    model, data = _case(TwoPhaseModel)
    cfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7, ksp_orth=ksp_orth)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]), atol=5.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]), atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_3d_two_phase_step():
    """3D domain decomposition (z local): full CPTR step on a 2x4 mesh."""
    import dataclasses

    pp = PhysicalParams()
    g = Grid(shape=(8, 16, 6), spacing=(10.0, 10.0, 4.0), gravity=9.81)
    rng = np.random.default_rng(4)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(6)), control="bhp",
             p_bh=4.0e7, T_inj=420.0),
        Well(cells=tuple((7, 15, iz) for iz in range(6)), control="bhp",
             p_bh=1.5e7),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)

    cfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]), atol=10.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]), atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_s_stage_match():
    """The CPTRS saturation stage-1 leg (s_stage) is pure stencil algebra
    on full-shape arrays — a sharded 3D run must match single-device with
    identical Newton AND FGMRES counts."""
    from thermalporous_tpu.precond import CPRConfig

    pp = PhysicalParams()
    g = Grid(shape=(8, 16, 6), spacing=(10.0, 10.0, 4.0), gravity=9.81)
    rng = np.random.default_rng(11)
    k = 1e-13 * np.exp(1.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(6)), control="bhp",
             p_bh=4.0e7, T_inj=420.0),
        Well(cells=tuple((7, 15, iz) for iz in range(6)), control="bhp",
             p_bh=1.5e7),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)

    cfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
    pc = CPRConfig(stage2="rbgs", s_stage="rbgs", s_sweeps=2)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg, pc_cfg=pc)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg, pc_cfg=pc)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]),
                               atol=10.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]),
                               atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_stage2_zebra_z_match():
    """stage2='zebra' along z: the block-Thomas lax.scan runs over the
    LOCAL z axis under the production (x,y) domain decomposition, so the
    sharded run must match single-device with identical counts and stay
    collective-free inside the scan."""
    from thermalporous_tpu.precond import CPRConfig

    pp = PhysicalParams()
    g = Grid(shape=(8, 16, 6), spacing=(10.0, 10.0, 4.0), gravity=9.81)
    rng = np.random.default_rng(13)
    k = 1e-13 * np.exp(1.0 * rng.standard_normal(g.shape))
    # full z-column wells as in test_sharded_3d_two_phase_step: single-cell
    # corner wells at this Δt trip the line-search blow-up guard for EVERY
    # stage-2 smoother (verified bjac/rbgs/zebra identical), which would
    # test the controller, not the sharding
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(6)), control="bhp",
             p_bh=4.0e7, T_inj=420.0),
        Well(cells=tuple((7, 15, iz) for iz in range(6)), control="bhp",
             p_bh=1.5e7),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)

    cfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
    # 1 sweep: undamped ×2 line sweeps can destabilize Newton on small
    # stiff systems;
    # the sharding-equality property is sweep-count-independent
    pc = CPRConfig(stage2="zebra", stage2_axis=2, stage2_sweeps=1)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg, pc_cfg=pc)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg, pc_cfg=pc)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]),
                               atol=10.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]),
                               atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_stage2_bgmg_match():
    """stage2='bgmg': the coupled block hierarchy (Galerkin block
    coarsening, block-RBGS levels, dense coupled coarse solve) must give
    identical counts and matching states under the device mesh."""
    from thermalporous_tpu.precond import CPRConfig

    pp = PhysicalParams()
    g = Grid(shape=(8, 16, 6), spacing=(10.0, 10.0, 4.0), gravity=9.81)
    rng = np.random.default_rng(13)
    k = 1e-13 * np.exp(1.0 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(6)), control="bhp",
             p_bh=4.0e7, T_inj=420.0),
        Well(cells=tuple((7, 15, iz) for iz in range(6)), control="bhp",
             p_bh=1.5e7),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)

    cfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
    pc = CPRConfig(stage2="bgmg", bgmg_coarse_cells=96)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg, pc_cfg=pc)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg, pc_cfg=pc)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]),
                               atol=10.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]),
                               atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_ksp_recycle_match():
    """Krylov recycling (solve/deflate.py): the recycle space rides the
    Newton carry as state-shaped columns, its projections are grid-wide
    reductions (psum under GSPMD) and the harvest eigh runs on a
    replicated small matrix — a sharded run must match single-device
    with identical Newton AND total FGMRES counts."""
    model, data = _case(TwoPhaseModel, n=16, seed=3)
    cfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80,
                       ksp_recycle=4)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]),
                               atol=10.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]),
                               atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_adjoint_matches_single_device():
    """The adjoint backward sweep (transposed stencil + vjp operator) is
    the same shift/elementwise algebra as the forward pass — sharded
    gradients must match single-device to rounding."""
    from thermalporous_tpu.solve import adjoint_gradients, record_trajectory

    pp = PhysicalParams()
    g = Grid(shape=(8, 16), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(21)
    k = 1e-13 * np.exp(0.8 * rng.standard_normal(g.shape))
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=[
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((7, 15),), control="bhp", p_bh=1.0e7),
    ])
    model = TwoPhaseModel(g, pp)
    dts = [43200.0, 86400.0]

    def terminal(u, d):
        return jnp.mean(u[1, :5, :6])

    cfg = NewtonConfig(rtol=1e-11, ksp_rtol=1e-9, ksp_maxiter=120)
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    states = record_trajectory(sim, model.initial_state(data), dts)
    ref = adjoint_gradients(model, data, states, dts, terminal=terminal,
                            rtol=1e-10, maxiter=240)

    mesh = make_grid_mesh(8)
    data_s = shard_problem_data(data, mesh)
    states_s = [shard_state(u, mesh) for u in states]
    got = adjoint_gradients(model, data_s, states_s, dts, terminal=terminal,
                            rtol=1e-10, maxiter=240)
    assert got.converged
    scale = float(jnp.abs(ref.grad_data.phi).max())
    np.testing.assert_allclose(np.asarray(got.grad_data.phi),
                               np.asarray(ref.grad_data.phi),
                               atol=1e-8 * scale, rtol=1e-8)
    st_scale = float(jnp.abs(ref.grad_data.tgeo[0]).max())
    np.testing.assert_allclose(np.asarray(got.grad_data.tgeo[0]),
                               np.asarray(ref.grad_data.tgeo[0]),
                               atol=1e-8 * st_scale, rtol=1e-8)


@pytest.mark.slow
def test_sharded_variational_transfer_match():
    """transfer='variational' (R=Pᵀ, box Galerkin levels): shifts, masks
    and pairwise block-sums only, so a sharded run must match
    single-device with identical counts.  2D on purpose — the 3D box
    conjugation compiles for minutes and the
    sharding-sensitive lowerings are the same per axis."""
    from thermalporous_tpu.precond import CPRConfig, GMGConfig

    pp = PhysicalParams()
    g = Grid(shape=(16, 32), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(11)
    k = 1e-13 * np.exp(1.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((15, 31),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)

    cfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=80)
    pc = CPRConfig(stage2="rbgs",
                   gmg=GMGConfig(transfer="variational", transfer_floor=0.5,
                                 max_coarse_cells=64))
    sim = Simulator(model, data, precond="cptr", newton_cfg=cfg, pc_cfg=pc)
    u0 = model.initial_state(data)
    u_ref, stats_ref = sim.step(u0, 3600.0)
    assert bool(stats_ref.converged)

    mesh = make_grid_mesh(8)
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      newton_cfg=cfg, pc_cfg=pc)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)
    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]),
                               atol=10.0)
    np.testing.assert_allclose(np.asarray(u_out[2]), np.asarray(u_ref[2]),
                               atol=1e-8)
    assert len(u_out.sharding.device_set) == 8


def test_halo_residual_matches_global():
    """Explicit shard_map+ppermute halo exchange ≡ the global residual."""
    from thermalporous_tpu.dist.halo import make_halo_residual

    for model_cls, shape in [(SinglePhaseModel, (16, 24)),
                             (TwoPhaseModel, (16, 24)),
                             (TwoPhaseModel, (8, 16, 4))]:
        pp = PhysicalParams()
        g = Grid(shape=shape, spacing=tuple(10.0 for _ in shape),
                 thickness=5.0, gravity=9.81 if len(shape) == 3 else 0.0)
        rng = np.random.default_rng(1)
        k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
        wells = [
            Well(cells=(tuple(0 for _ in shape),), control="bhp",
                 p_bh=3.0e7, T_inj=420.0),
            Well(cells=(tuple(n - 1 for n in shape),), control="bhp", p_bh=1.0e7),
        ]
        data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
        model = model_cls(g, pp)
        u_old = model.initial_state(data)
        u = u_old + 1e5 * jnp.asarray(rng.standard_normal(u_old.shape))

        ref = model.residual(u, u_old, 700.0, data)

        mesh = make_grid_mesh(8)
        halo_res = make_halo_residual(model, mesh, data)
        out = jax.jit(halo_res)(
            shard_state(u, mesh), shard_state(u_old, mesh),
            jnp.asarray(700.0), shard_problem_data(data, mesh),
        )
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-12 * scale, rtol=1e-12)


def test_gmg_replicated_coarse_levels_match():
    """Mesh-threaded GMG with replicated coarse levels (SURVEY.md §5.8):
    identical Newton/FGMRES counts and state as the unconstrained run, and
    the coarse stencils actually come out replicated."""
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.precond.cpr import cpr_setup

    model, data = _case(SinglePhaseModel, n=32)
    cfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7)
    u0 = model.initial_state(data)

    sim_ref = Simulator(model, data, precond="cptr", newton_cfg=cfg)
    u_ref, stats_ref = sim_ref.step(u0, 3600.0)

    mesh = make_grid_mesh(8)
    pc_cfg = CPRConfig(gmg=GMGConfig(mesh=mesh, replicate_below=256))
    sim_s = Simulator(model, shard_problem_data(data, mesh), precond="cptr",
                      pc_cfg=pc_cfg, newton_cfg=cfg)
    u_out, stats = sim_s.step(shard_state(u0, mesh), 3600.0)

    assert bool(stats.converged)
    assert int(stats.iters) == int(stats_ref.iters)
    assert int(stats.ksp_iters) == int(stats_ref.ksp_iters)
    np.testing.assert_allclose(np.asarray(u_out[0]), np.asarray(u_ref[0]),
                               atol=5.0)
    np.testing.assert_allclose(np.asarray(u_out[1]), np.asarray(u_ref[1]),
                               atol=1e-6)

    # the threshold actually replicates: build the hierarchy under jit with
    # sharded inputs and inspect the coarsest level's sharding
    @jax.jit
    def setup(u, data):
        st = model.assemble_stencil(u, u, 3600.0, data)
        state = cpr_setup(st, pc_cfg)
        return state.gmg_p.stencils[-1].diag

    coarse_diag = setup(shard_state(u0, mesh), shard_problem_data(data, mesh))
    assert coarse_diag.sharding.is_fully_replicated


def test_ensemble_axis_matches_single_runs():
    """The ensemble (parameter-study) axis: vmapped steps over stacked
    members reproduce each member's solo run exactly — per-member states
    AND per-member iteration counts — and the ensemble axis shards over
    the device mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.dist import (
        make_ensemble_step_fn,
        shard_ensemble,
        stack_ensemble,
    )
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import NewtonConfig, make_step_fn

    pp = PhysicalParams()
    n = 8
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    model = TwoPhaseModel(g, pp, s_init=0.2)
    cfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7)

    rng = np.random.default_rng(3)
    members = []
    for e in range(4):
        wells = [
            Well(cells=((0, 0),), control="bhp", p_bh=(3.0 + 0.3 * e) * 1e7,
                 T_inj=400.0 + 10.0 * e),
            Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
        ]
        kx = 1e-13 * np.exp(0.4 * rng.standard_normal(g.shape))
        members.append(make_problem_data(g, pp, kx=kx, phi=0.2, wells=wells))

    dts = [600.0, 900.0, 1200.0, 1500.0]
    # solo runs
    solo_step = jax.jit(make_step_fn(model, "cptr", cfg))
    solo = []
    for data, dt in zip(members, dts):
        u0 = model.initial_state(data)
        u1, st = solo_step(u0, jnp.asarray(dt, u0.dtype), data)
        solo.append((np.asarray(u1), int(st.iters), int(st.ksp_iters)))

    # ensemble run, sharded over the 8 virtual devices
    data_e = stack_ensemble(members)
    u0_e = jnp.stack([model.initial_state(d) for d in members])
    dt_e = jnp.asarray(dts, u0_e.dtype)
    mesh = Mesh(np.array(jax.devices()[:4]), ("e",))
    data_e = shard_ensemble(data_e, mesh)
    u0_e = shard_ensemble(u0_e, mesh)
    step_e = jax.jit(make_ensemble_step_fn(model, "cptr", cfg))
    u1_e, st_e = step_e(u0_e, dt_e, data_e)

    for e in range(4):
        u_ref, iters_ref, ksp_ref = solo[e]
        np.testing.assert_allclose(np.asarray(u1_e[e]), u_ref,
                                   rtol=1e-12, atol=1e-9)
        assert int(st_e.iters[e]) == iters_ref
        assert int(st_e.ksp_iters[e]) == ksp_ref


@pytest.mark.slow
def test_blocked_loop_and_adaptive_coarsening_sharded():
    """The jitted block time loop and the strength-adaptive coarsening
    schedule both work under GSPMD: a sharded blocked run reproduces the
    single-device blocked run's trajectory and iteration counts."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.dist import (
        make_grid_mesh,
        shard_problem_data,
        shard_state,
    )
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.precond import CPRConfig, GMGConfig
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

    pp = PhysicalParams()
    nx, ny, nz = 8, 16, 6
    g = Grid(shape=(nx, ny, nz), spacing=(10.0, 10.0, 1.0), gravity=9.81)
    rng = np.random.default_rng(11)
    k = 1e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=tuple((0, 0, iz) for iz in range(nz)), control="bhp",
             p_bh=3.5e7, T_inj=420.0),
        Well(cells=tuple((nx - 1, ny - 1, iz) for iz in range(nz)),
             control="bhp", p_bh=1.2e7),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp)
    ncfg = NewtonConfig(rtol=1e-8, ksp_rtol=1e-6, ksp_maxiter=60)
    pc = CPRConfig(gmg=GMGConfig(coarsen="adaptive", max_coarse_cells=32))
    tc = TimeConfig(dt_init=900.0, block_steps=3)

    def run(data, u0):
        sim = Simulator(model, data, precond="cptr", newton_cfg=ncfg,
                        pc_cfg=pc, time_cfg=tc)
        # the adaptive schedule must have been baked host-side
        assert sim.pc_cfg.gmg.level_factors is not None
        return sim.run(t_end=3 * 3600.0, u0=u0)

    u0 = model.initial_state(data)
    ref = run(data, u0)

    mesh = make_grid_mesh(8)
    out = run(shard_problem_data(data, mesh), shard_state(u0, mesh))

    assert out.steps == ref.steps
    assert out.total_newton == ref.total_newton
    assert out.total_ksp == ref.total_ksp
    assert [r.dt for r in out.records] == [r.dt for r in ref.records]
    ref_u, out_u = np.asarray(ref.u), np.asarray(out.u)
    np.testing.assert_allclose(out_u[0], ref_u[0], atol=10.0)    # p [Pa]
    np.testing.assert_allclose(out_u[1], ref_u[1], atol=1e-6)    # T [K]
    np.testing.assert_allclose(out_u[2], ref_u[2], atol=1e-8)    # S_w
