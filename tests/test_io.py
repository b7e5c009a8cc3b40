"""IO subsystem tests: VTI/PVD output, checkpoint resume, JSONL metrics, CLI."""

import json
import pytest
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from thermalporous_tpu.core import Grid
from thermalporous_tpu.io import (
    CheckpointManager,
    MetricsLogger,
    PVDWriter,
    load_checkpoint,
    save_checkpoint,
    write_vti,
)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _read_vti_payload(path, n_arrays):
    """Parse the raw-appended section back into float64 arrays."""
    blob = open(path, "rb").read()
    start = blob.index(b'<AppendedData encoding="raw">')
    cursor = blob.index(b"_", start) + 1
    arrays = []
    for _ in range(n_arrays):
        (nbytes,) = struct.unpack_from("<Q", blob, cursor)
        cursor += 8
        arrays.append(np.frombuffer(blob[cursor : cursor + nbytes], dtype=np.float64))
        cursor += nbytes
    return arrays


def test_vti_roundtrip(tmp_path, rng):
    g = Grid(shape=(4, 3), spacing=(1.0, 2.0), thickness=0.5)
    p = rng.standard_normal(g.shape)
    t = rng.standard_normal(g.shape)
    path = str(tmp_path / "out.vti")
    write_vti(path, g, {"pressure": p, "temperature": t})

    header = open(path, "rb").read(600).decode(errors="ignore")
    assert 'WholeExtent="0 4 0 3 0 1"' in header
    assert 'Name="pressure"' in header and 'Name="temperature"' in header

    pay_p, pay_t = _read_vti_payload(path, 2)
    # VTK order: x fastest
    np.testing.assert_array_equal(pay_p, p.T.ravel())
    np.testing.assert_array_equal(pay_t, t.T.ravel())


def test_vti_3d_and_pvd(tmp_path, rng):
    g = Grid(shape=(3, 4, 5), spacing=(1.0, 1.0, 2.0))
    w = PVDWriter(str(tmp_path), "case", g)
    for i in range(3):
        w.write(float(i) * 10.0, {"pressure": rng.standard_normal(g.shape)})
    pvd = (tmp_path / "case.pvd").read_text()
    assert pvd.count("<DataSet") == 3
    assert 'timestep="20.0"' in pvd
    assert (tmp_path / "case_00002.vti").exists()


def test_checkpoint_roundtrip(tmp_path):
    u = jnp.asarray(np.random.default_rng(0).standard_normal((2, 5, 5)))
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, u, t=123.5, dt=7.25, step=42, meta={"case": "x"})
    u2, t, dt, step, meta = load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(u2), np.asarray(u))  # bit-exact
    assert (t, dt, step, meta) == (123.5, 7.25, 42, {"case": "x"})


def test_checkpoint_manager_retention(tmp_path):
    import dataclasses

    from thermalporous_tpu.solve import StepRecord

    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    u = jnp.zeros((2, 3, 3))
    for step in range(1, 9):
        rec = StepRecord(step=step, t=step * 1.0, dt=1.0, newton_iters=1,
                         ksp_iters=1, retries=0, residual_norm0=1.0,
                         residual_norm=0.0, wall_s=0.1)
        mgr(step, step * 1.0, u, rec)
    files = sorted(os.listdir(tmp_path))
    assert files == ["ckpt_0000006.npz", "ckpt_0000008.npz"]


def test_metrics_logger(tmp_path):
    from thermalporous_tpu.solve import StepRecord

    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path, ncells=100, extra={"case": "t"}) as log:
        rec = StepRecord(step=1, t=10.0, dt=10.0, newton_iters=4, ksp_iters=20,
                         retries=0, residual_norm0=1.0, residual_norm=1e-8,
                         wall_s=0.5)
        log(1, 10.0, None, rec)
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["newton_iters"] == 4
    assert lines[0]["case"] == "t"
    assert lines[0]["cell_updates_per_s"] == 100 * 4 / 0.5


def test_cli_list():
    out = subprocess.run(
        [sys.executable, "examples/run_case.py", "--list"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "sp_hot_injection_2d" in out.stdout
    assert "tp_spe10_3d" in out.stdout


def test_cli_end_to_end(tmp_path):
    """The CLI is the user surface: run a short case with all outputs on."""
    out = subprocess.run(
        [
            sys.executable, "examples/run_case.py",
            "--case", "sp_hot_injection_2d",
            "--t-end-days", "0.2",
            "--platform", "cpu",
            "--quiet",
            "--vtk", str(tmp_path / "vtk"),
            "--vtk-every", "2",
            "--metrics", str(tmp_path / "m.jsonl"),
            "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "3",
        ],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "# done:" in out.stdout
    assert "fgmres total" in out.stdout
    assert (tmp_path / "vtk" / "sp_hot_injection_2d.pvd").exists()
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert recs and all(r["residual_norm"] < r["residual_norm0"] for r in recs)
    cks = os.listdir(tmp_path / "ck")
    assert cks, "no checkpoints written"


def test_resume_continues_trajectory_exactly(tmp_path):
    """A run interrupted at a checkpoint and resumed reproduces the
    uninterrupted run bit-exactly (state, clock, and Δt controller)."""
    import numpy as np
    import pytest

    from tests.test_newton_cptr import _sp_case
    from thermalporous_tpu.io import load_checkpoint
    from thermalporous_tpu.solve import Simulator, TimeConfig

    model, data = _sp_case(n=10)
    tc = TimeConfig(dt_init=600.0, growth=1.7)
    t_end = 40000.0

    sim = Simulator(model, data, precond="cptr", time_cfg=tc)
    full = sim.run(t_end=t_end)

    # interrupted run: stop after 3 steps, checkpoint, resume to t_end
    mgr = CheckpointManager(str(tmp_path), every=3, keep=1)
    part = sim.run(t_end=t_end, max_steps=3, callback=mgr)
    u0, t0, dt0, step0, _ = load_checkpoint(mgr.latest())
    resumed = sim.run(t_end=t_end, u0=u0, t0=t0, dt0=dt0, step0=step0)

    assert resumed.t == full.t
    np.testing.assert_array_equal(np.asarray(resumed.u), np.asarray(full.u))
    full_dts = [r.dt for r in full.records]
    resumed_dts = [r.dt for r in part.records] + [r.dt for r in resumed.records]
    np.testing.assert_allclose(resumed_dts, full_dts)


@pytest.mark.slow
def test_block_mode_checkpoints_are_state_consistent(tmp_path):
    """block_steps>1 materializes only the block-final state; checkpoints
    must pair state and clock consistently: a resume
    from a block-mode checkpoint reproduces the uninterrupted run."""
    import numpy as np
    import pytest

    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

    pp = PhysicalParams()
    n = 8
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.2)
    ncfg = NewtonConfig(rtol=1e-9, ksp_rtol=1e-7)
    tc = TimeConfig(dt_init=1800.0, block_steps=3)
    t_end = 8 * 3600.0

    def mk_sim():
        return Simulator(model, data, precond="cptr", newton_cfg=ncfg,
                         time_cfg=tc)

    # full run for reference
    ref = mk_sim().run(t_end=t_end)

    # run with every-step checkpointing: only block-final records (whose u
    # matches their t) may be written
    mgr = CheckpointManager(str(tmp_path), every=1, keep=100)
    res = mk_sim().run(t_end=t_end, callback=mgr)
    n_final_records = sum(1 for r in res.records if r.state_consistent)
    import glob as _glob
    written = sorted(_glob.glob(str(tmp_path / "ckpt_*.npz")))
    assert len(written) == n_final_records
    assert 0 < len(written) < res.steps  # intermediate records skipped

    # resume from a mid-run checkpoint: trajectory must rejoin the
    # uninterrupted run exactly (state AND clock were consistent)
    u0, t0, dt0, step0, _ = load_checkpoint(written[-2])
    cont = mk_sim().run(t_end=t_end, u0=u0, dt0=dt0, t0=t0, step0=step0)
    assert cont.t == pytest.approx(ref.t, rel=1e-12)
    np.testing.assert_allclose(np.asarray(cont.u), np.asarray(ref.u),
                               rtol=0, atol=1e-9)


def test_checkpoint_cadence_survives_block_final_step_drift(tmp_path):
    """Block mode exposes only block-final records (state_consistent), and
    retries shift their step numbers off any fixed modulus — e.g. finals at
    3, 7, 11 with every=4 match step % 4 == 0 NEVER.  The manager's cadence
    is 'every steps elapsed since the last snapshot', so it must still
    write (advisor r3)."""
    import dataclasses

    from thermalporous_tpu.solve import StepRecord

    mgr = CheckpointManager(str(tmp_path), every=4, keep=100)
    u = jnp.zeros((2, 3, 3))
    for step in range(1, 13):
        rec = StepRecord(step=step, t=step * 1.0, dt=1.0, newton_iters=1,
                         ksp_iters=1, retries=0, residual_norm0=1.0,
                         residual_norm=0.0, wall_s=0.1)
        rec.state_consistent = step in (3, 7, 11)
        mgr(step, step * 1.0, u, rec)
    files = sorted(os.listdir(tmp_path))
    # first consistent record past each 4-step cadence point: 7 (>=4), 11 (>=7+4)
    assert files == ["ckpt_0000007.npz", "ckpt_0000011.npz"]


@pytest.mark.slow
def test_resume_preserves_failure_memory_cap(tmp_path):
    """With TimeConfig.fail_frac active, a resumed run must continue the
    failure-memory Δt cap: the checkpoint stores record.dt_cap and
    Simulator.run(dt_cap0=...) seeds it, reproducing the uninterrupted
    trajectory exactly.  Without the cap the resumed controller would
    immediately re-attempt the known-failing Δt (growth× jump)."""
    import numpy as np

    from thermalporous_tpu.models import TwoPhaseModel, make_problem_data
    from thermalporous_tpu.physics import PhysicalParams, Well
    from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig

    pp = PhysicalParams()
    n = 12
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    rng = np.random.default_rng(3)
    kx = 2e-13 * np.exp(1.0 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.8e7, T_inj=430.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=8.0e6),
    ]
    data = make_problem_data(g, pp, kx=kx, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.25)
    # max_iters=4 + aggressive 4x growth force a Newton failure mid-run,
    # after which the 0.6 cap BINDS every subsequent step (dt == cap): a
    # resume that drops it takes a visibly different trajectory.
    ncfg = NewtonConfig(max_iters=4, rtol=1e-8)
    tc = TimeConfig(dt_init=600.0, growth=4.0, dt_max=1e7, grow_below=5,
                    fail_frac=0.6, fail_relax=1.1)
    t_end = 1.2e6

    sim = Simulator(model, data, precond="cptr", newton_cfg=ncfg, time_cfg=tc)
    u_init = model.initial_state(data)
    full = sim.run(t_end=t_end, u0=u_init)
    assert any(r.retries > 0 for r in full.records), "scenario lost its failure"

    # interrupt AFTER the failure established the cap, checkpoint, resume
    mgr = CheckpointManager(str(tmp_path), every=1, keep=1)
    part = sim.run(t_end=t_end, u0=u_init, max_steps=7, callback=mgr)
    assert part.records[-1].dt_cap is not None, "cap not active at checkpoint"
    u0, t0, dt0, step0, meta = load_checkpoint(mgr.latest())
    assert meta["dt_cap"] == part.records[-1].dt_cap
    resumed = sim.run(t_end=t_end, u0=u0, t0=t0, dt0=dt0, step0=step0,
                      dt_cap0=meta["dt_cap"])

    assert resumed.t == full.t
    np.testing.assert_array_equal(np.asarray(resumed.u), np.asarray(full.u))
    full_dts = [r.dt for r in full.records]
    stitched = [r.dt for r in part.records] + [r.dt for r in resumed.records]
    np.testing.assert_allclose(stitched, full_dts)

    # negative control: dropping the cap (the old behavior) diverges —
    # pins that this test actually exercises the threading
    resumed_nocap = sim.run(t_end=t_end, u0=u0, t0=t0, dt0=dt0, step0=step0)
    # the first step's dt comes from the checkpoint either way; without the
    # cap the CONTROLLER then grows 4x past the wall instead of tracking it
    assert resumed_nocap.records[0].next_dt != resumed.records[0].next_dt
