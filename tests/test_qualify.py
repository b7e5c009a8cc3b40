"""Accelerator-vs-CPU count parity (thermalporous_tpu/qualify.py).

These tests pin the protocol on CPU (deterministic records), the refusal
to qualify the CPU against itself, and the comparison verdict on synthetic
records shaped like a miscompiled program's stall.
"""

import numpy as np

from thermalporous_tpu.qualify import compare_runs, qualify_steps


def _rec(dt, newton, ksp, converged=True, norm=1e-9):
    return dict(dt=dt, newton=newton, ksp=ksp, converged=converged,
                norm0=1.0, norm=norm)


def test_compare_runs_pass_on_identical():
    ref = [_rec(300.0, 4, 8), _rec(600.0, 5, 12)]
    ok, msgs = compare_runs([dict(r) for r in ref], ref)
    assert ok and not msgs


def test_compare_runs_tolerates_small_drift():
    ref = [_rec(300.0, 4, 8)]
    acc = [_rec(300.0, 5, 11)]   # +1 Newton, +3 ksp: within band
    ok, _ = compare_runs(acc, ref)
    assert ok


def test_compare_runs_flags_the_ledgered_stall():
    # a miscompile's signature: the accelerator stalls at the KSP cap
    # (16 N, norm stuck ~1e-3) where CPU converges in 4 N / 5 ksp
    ref = [_rec(300.0, 4, 5)]
    acc = [_rec(300.0, 16, 256, converged=False, norm=1e-3)]
    ok, msgs = compare_runs(acc, ref)
    assert not ok
    assert any("STALLED" in m for m in msgs)


def test_compare_runs_flags_count_divergence():
    ref = [_rec(300.0, 4, 5)]
    acc = [_rec(300.0, 9, 40)]   # converged but way off: still suspect
    ok, msgs = compare_runs(acc, ref)
    assert not ok and msgs


def test_compare_runs_flags_dt_trajectory_divergence():
    ref = [_rec(300.0, 4, 5), _rec(600.0, 4, 5)]
    acc = [_rec(300.0, 4, 5, converged=True), _rec(150.0, 4, 5)]
    ok, msgs = compare_runs(acc, ref)
    assert not ok
    assert any("diverged" in m for m in msgs)


def test_qualify_steps_protocol_on_cpu():
    """The ramp protocol is deterministic and fetches once per step."""
    from thermalporous_tpu.presets import get_case

    case = get_case("tp_thermal_2d")
    recs = qualify_steps(case, steps=3)
    assert len(recs) == 3
    assert recs[0]["dt"] == case.time_cfg.dt_init / 2.0
    for r in recs:
        assert r["converged"] and r["newton"] >= 1 and r["ksp"] >= 1
        assert np.isfinite(r["norm"])
    # doubling on success
    assert recs[1]["dt"] == 2 * recs[0]["dt"]
    # repeatable (same records on a rerun — the comparison's premise)
    recs2 = qualify_steps(case, steps=3)
    assert [r["newton"] for r in recs2] == [r["newton"] for r in recs]
    assert [r["ksp"] for r in recs2] == [r["ksp"] for r in recs]
