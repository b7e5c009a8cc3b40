"""Single-phase non-isothermal flow model (pressure, temperature).

Equivalent of the reference's ``SPModel``
(``thermalporous/singlephase.py`` upstream, unverified — SURVEY.md §2.2),
implementing the equations of arXiv:1812.11566 [P1]:

  mass:   ∂(φρ)/∂t + ∇·(ρu) = q,       u = −(K/μ(T))(∇p − ρ g ∇z)
  energy: ∂((1−φ)ρ_r c_r T + φ ρ c_v T)/∂t + ∇·(ρ c_p T u) − ∇·(κ ∇T) = q_h

discretized cell-centred TPFA (≡ DG0 on quads/hexes), fully implicit
backward Euler, upwinded mobility/enthalpy, no-flow boundaries, Peaceman
wells and heaters as cell sources.

Unknowns (component axis): 0 = p [Pa], 1 = T [K].
Equations (rows):          0 = mass [kg/s], 1 = energy [W].
"""

from __future__ import annotations

import jax.numpy as jnp

from thermalporous_tpu.models.base import ProblemData, ThermalModelBase
from thermalporous_tpu.physics.wells import WellFields


class SinglePhaseModel(ThermalModelBase):
    nc = 2
    # equation rows for telemetry/balance reporting (io/balance.py)
    eq_labels = ("mass_kg", "energy_J")

    def well_sources(self, u, well: WellFields):
        """Per-cell source terms (nc, *shape), positive INTO the reservoir."""
        pp = self.pp
        p, T = u[0], u[1]

        # Peaceman BHP wells: q = WI·(ρ/μ)·(p_bh − p), upwinded by flow sign —
        # inflow carries injected-fluid properties at T_inj, outflow local T.
        dp = well.pbh - p
        inflow = dp >= 0.0
        t_up = jnp.where(jnp.logical_and(inflow, well.has_tinj > 0.5), well.tinj, T)
        lam = pp.rho_w(p, t_up) / pp.mu_w(t_up)
        q_m = well.wi * lam * dp
        q_e = q_m * pp.cp_w * t_up

        # Rate-controlled wells: fixed mass rate; injection carries T_inj.
        t_rate = jnp.where(well.has_tinj > 0.5, well.tinj, T)
        q_m = q_m + well.qrate
        q_e = q_e + well.qrate * pp.cp_w * jnp.where(well.qrate >= 0.0, t_rate, T)

        # Heaters: pure energy sources.
        q_e = q_e + well.qheat

        return jnp.stack([q_m, q_e])

    def cell_terms(self, u, u_old, dt, phi, well: WellFields):
        pp = self.pp
        vol = self.grid.cell_volume
        p, T = u[0], u[1]
        p0, T0 = u_old[0], u_old[1]

        rho = pp.rho_w(p, T)
        rho0 = pp.rho_w(p0, T0)
        acc_m = vol * phi * (rho - rho0) / dt
        acc_e = vol * (pp.energy_density_sp(p, T, phi) - pp.energy_density_sp(p0, T0, phi)) / dt

        return jnp.stack([acc_m, acc_e]) - self.well_sources(u, well)

    def in_place_totals(self, u, data: ProblemData):
        """(total fluid mass [kg], total thermal energy [J]) — the exact
        integrals of the ``cell_terms`` accumulation densities."""
        pp = self.pp
        vol = self.grid.cell_volume
        p, T = u[0], u[1]
        m = vol * data.phi * pp.rho_w(p, T)
        e = vol * pp.energy_density_sp(p, T, data.phi)
        return jnp.stack([m.sum(), e.sum()])

    def face_terms(self, axis, u_l, u_r, tgeo, tcond):
        pp = self.pp
        g = self.grid.gravity
        ddepth = self._ddepth[axis]
        p_l, t_l = u_l[0], u_l[1]
        p_r, t_r = u_r[0], u_r[1]

        rho_l = pp.rho_w(p_l, t_l)
        rho_r = pp.rho_w(p_r, t_r)
        dphi = p_l - p_r - 0.5 * (rho_l + rho_r) * g * ddepth
        up = dphi >= 0.0
        rho_up = jnp.where(up, rho_l, rho_r)
        t_up = jnp.where(up, t_l, t_r)
        f_m = tgeo * rho_up / pp.mu_w(t_up) * dphi
        f_e = pp.cp_w * t_up * f_m + tcond * (t_l - t_r)
        return jnp.stack([f_m, f_e])

    def residual_scales(self, u_old, dt, data: ProblemData):
        pp = self.pp
        vol = self.grid.cell_volume
        w = data.wells
        p0, t0 = u_old[0], u_old[1]
        rho = pp.rho_w(p0, t0)
        mass = vol * data.phi * rho / dt
        energy = vol * ((1.0 - data.phi) * pp.rho_c_rock
                        + data.phi * rho * pp.cp_w) * t0 / dt
        # well cells: the through-flow can dwarf the cell content per step
        # (fine grids / strong wells); normalize their residual by the well's
        # own throughput so the convergence test stays achievable in f32.
        q_char = (
            w.wi * (rho / pp.mu_w(t0)) * (jnp.abs(w.pbh - p0) + 0.01 * jnp.abs(p0))
            + jnp.abs(w.qrate)
        )
        mass = mass + q_char
        energy = energy + q_char * pp.cp_w * t0 + jnp.abs(w.qheat)
        return jnp.stack([mass, energy])

    def initial_state(self, data: ProblemData, dtype=jnp.float64):
        pp = self.pp
        grid = self.grid
        p = pp.p_init * jnp.ones(grid.shape, dtype=dtype)
        depths = grid.cell_depths(dtype=dtype)
        if depths is not None:
            # hydrostatic equilibrium around the initial temperature
            rho0 = pp.rho_w(pp.p_init, pp.T_init)
            p = p + rho0 * grid.gravity * (depths - depths.reshape(-1)[0])
        t = pp.T_init * jnp.ones(grid.shape, dtype=dtype)
        return jnp.stack([p, t])
