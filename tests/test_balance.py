"""Material/energy balance audit (io/balance.py).

The closure identity is exact for the backward-Euler TPFA scheme up to
the Newton tolerance: interior fluxes telescope under no-flow boundaries,
so Δ(in place) − ∫ sources dt = Δt·Σ_cells R(u_new) per step.  These
tests pin (a) closure at tight Newton tolerance over a multi-step
adaptive run (wells, heaters, rate controls, gravity), and (b) blocked
mode closing via the in-device source integrals (BlockStats.src_dt) and
agreeing with the host-loop audit.
"""

from __future__ import annotations

import numpy as np

from thermalporous_tpu.core import Grid
from thermalporous_tpu.io import BalanceAuditor, format_balance
from thermalporous_tpu.models import (
    SinglePhaseModel,
    TwoPhaseModel,
    make_problem_data,
)
from thermalporous_tpu.physics import Heater, PhysicalParams, Well
from thermalporous_tpu.solve import NewtonConfig, Simulator, TimeConfig
import pytest

TIGHT = NewtonConfig(rtol=1e-11, max_iters=20)


@pytest.mark.slow
def test_balance_two_phase_bhp_wells():
    pp = PhysicalParams()
    n = 10
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.5e7, T_inj=420.0, name="INJ"),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7, name="PROD"),
    ]
    data = make_problem_data(g, pp, kx=2e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.3)
    sim = Simulator(model, data, precond="cptr", newton_cfg=TIGHT,
                    time_cfg=TimeConfig(dt_init=1800.0))
    u0 = model.initial_state(data)
    aud = BalanceAuditor(model, data, u0)
    res = sim.run(t_end=6 * 3600.0, u0=u0, callback=aud)

    rep = aud.report()
    assert rep["complete"]
    assert rep["steps"] == res.steps
    # real through-flow happened (the test isn't vacuous)
    assert rep["rows"]["water_kg"]["cum_source"] > 0.0
    for lab in ("water_kg", "oil_kg", "energy_J"):
        assert rep["rows"][lab]["rel_error"] < 1e-9, (lab, rep["rows"][lab])
    # the formatter runs and mentions every row
    txt = format_balance(rep)
    for lab in ("water_kg", "oil_kg", "energy_J"):
        assert lab in txt


def test_balance_single_phase_heater_and_rate_well():
    """Rate-controlled injection + heater + gravity (3D): energy closure
    includes the heater power; mass closure includes the fixed rate."""
    pp = PhysicalParams()
    g = Grid(shape=(6, 6, 4), spacing=(10.0, 10.0, 2.0))
    wells = [
        Well(cells=((0, 0, 0),), control="rate", rate=0.5, T_inj=400.0,
             name="INJ"),
        Well(cells=((5, 5, 3),), control="bhp", p_bh=1.2e7, name="PROD"),
    ]
    heaters = [Heater(cells=((2, 2, 1),), power=5.0e4)]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.25, wells=wells,
                             heaters=heaters)
    model = SinglePhaseModel(g, pp)
    sim = Simulator(model, data, precond="cptr", newton_cfg=TIGHT,
                    time_cfg=TimeConfig(dt_init=900.0))
    u0 = model.initial_state(data)
    aud = BalanceAuditor(model, data, u0)
    sim.run(t_end=2 * 3600.0, u0=u0, callback=aud)

    rep = aud.report()
    assert rep["complete"]
    for lab in ("mass_kg", "energy_J"):
        assert rep["rows"][lab]["rel_error"] < 1e-9, (lab, rep["rows"][lab])
    # the heater's energy actually entered the cumulative source integral:
    # it contributes power × elapsed time on top of the well enthalpy flows
    assert rep["rows"]["energy_J"]["cum_source"] != 0.0


def _blocked_case():
    pp = PhysicalParams()
    n = 8
    g = Grid(shape=(n, n), spacing=(10.0, 10.0), thickness=5.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7),
    ]
    data = make_problem_data(g, pp, kx=2e-13, phi=0.2, wells=wells)
    model = TwoPhaseModel(g, pp, s_init=0.3)
    return model, data


def test_balance_blocked_mode_closes():
    """block_steps>1 never materializes intermediate states, but the block
    body integrates Δtₙ·Q(uₙ) in-device (BlockStats.src_dt), so the audit
    closes to the same tolerance as the host loop."""
    model, data = _blocked_case()
    sim = Simulator(model, data, precond="cptr", newton_cfg=TIGHT,
                    time_cfg=TimeConfig(dt_init=1800.0, block_steps=3))
    u0 = model.initial_state(data)
    aud = BalanceAuditor(model, data, u0)
    res = sim.run(t_end=4 * 3600.0, u0=u0, callback=aud)

    rep = aud.report()
    assert rep["complete"]
    assert rep["skipped_records"] == 0
    assert rep["steps"] == res.steps
    assert rep["rows"]["water_kg"]["cum_source"] > 0.0
    for lab in ("water_kg", "oil_kg", "energy_J"):
        assert rep["rows"][lab]["rel_error"] < 1e-9, (lab, rep["rows"][lab])
    assert "INCOMPLETE" not in format_balance(rep)


def test_balance_blocked_matches_host_loop():
    """Blocked and host loops take the same trajectory (block semantics are
    host-exact), so the two audits must agree on the source integrals."""
    model, data = _blocked_case()
    u0 = model.initial_state(data)

    sim_h = Simulator(model, data, precond="cptr", newton_cfg=TIGHT,
                      time_cfg=TimeConfig(dt_init=1800.0))
    aud_h = BalanceAuditor(model, data, u0)
    sim_h.run(t_end=4 * 3600.0, u0=u0, callback=aud_h)

    sim_b = Simulator(model, data, precond="cptr", newton_cfg=TIGHT,
                      time_cfg=TimeConfig(dt_init=1800.0, block_steps=3))
    aud_b = BalanceAuditor(model, data, u0)
    sim_b.run(t_end=4 * 3600.0, u0=u0, callback=aud_b)

    assert aud_b.steps == aud_h.steps
    np.testing.assert_allclose(aud_b.cum, aud_h.cum, rtol=1e-12)
    np.testing.assert_allclose(aud_b.cum_abs, aud_h.cum_abs, rtol=1e-12)
    np.testing.assert_allclose(aud_b.m_last, aud_h.m_last, rtol=1e-12)
