"""Fluid and rock property correlations.

Equivalent of the reference's ``PhysicalParameters``
(``thermalporous/params.py`` upstream, unverified — SURVEY.md §2.4): a frozen
dataclass of scalars plus jax-traceable property closures shared by the
single-phase and two-phase models.

IMPORTANT PROVENANCE NOTE: the reference mount was empty at build time, so
every coefficient below is a standard-literature placeholder chosen to
reproduce the *physics regimes* of the companion papers (arXiv:1812.11566,
arXiv:1907.04229) — hot-water injection lowering heavy-oil viscosity by
orders of magnitude — not a verified copy of the upstream constants.  All of
them are config fields precisely so that re-verification against the real
reference is a constants patch, not a refactor (SURVEY.md §7 hard part #6).

Units: SI throughout (Pa, K, kg, m, s, W).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PhysicalParams:
    """Constants + correlations for water, dead oil and rock.

    Used as a *static* argument (plain Python floats participate in tracing
    as compile-time constants), mirroring how the reference bakes parameter
    values into its UFL forms.
    """

    # --- reference conditions -------------------------------------------
    p_ref: float = 1.0e5          # [Pa] reference pressure for densities
    T_ref: float = 288.15         # [K] reference temperature (15 °C)
    T_inj: float = 420.0          # [K] default injection temperature
    T_init: float = 300.0         # [K] default initial reservoir temperature
    p_init: float = 2.0e7         # [Pa] default initial reservoir pressure

    # --- water -----------------------------------------------------------
    rho_w_ref: float = 1000.0     # [kg/m³] at (p_ref, T_ref)
    c_w: float = 4.5e-10          # [1/Pa] water compressibility
    beta_w: float = 4.0e-4        # [1/K] water thermal expansion
    cp_w: float = 4184.0          # [J/kg/K] water specific heat (c_p ≈ c_v)

    # --- dead oil (heavy) --------------------------------------------------
    rho_o_ref: float = 900.0      # [kg/m³] at (p_ref, T_ref)
    c_o: float = 1.0e-9           # [1/Pa] oil compressibility
    beta_o: float = 9.0e-4        # [1/K] oil thermal expansion
    cp_o: float = 2093.0          # [J/kg/K] oil specific heat
    mu_o_ref: float = 1.0         # [Pa·s] oil viscosity at T_mu_ref (heavy oil)
    T_mu_ref: float = 293.15      # [K] reference for the Andrade law
    b_o: float = 6360.0           # [K] Andrade activation temperature

    # --- rock --------------------------------------------------------------
    rho_r: float = 2650.0         # [kg/m³] rock grain density
    c_r: float = 920.0            # [J/kg/K] rock specific heat
    kappa_eff: float = 2.5        # [W/m/K] effective thermal conductivity

    # ------------------------------------------------------------------ water
    def rho_w(self, p, T):
        """Water density: linearized compressibility + thermal expansion."""
        return self.rho_w_ref * (
            1.0 + self.c_w * (p - self.p_ref) - self.beta_w * (T - self.T_ref)
        )

    def mu_w(self, T):
        """Water viscosity [Pa·s], Vogel correlation (T in Kelvin).

        μ_w(T) = 2.414e-5 · 10^(247.8 / (T − 140)) — standard liquid-water
        fit, valid ~273–500 K; strongly decreasing with temperature.
        """
        return 2.414e-5 * 10.0 ** (247.8 / (T - 140.0))

    # ------------------------------------------------------------------ oil
    def rho_o(self, p, T):
        """Dead-oil density: linearized compressibility + thermal expansion."""
        return self.rho_o_ref * (
            1.0 + self.c_o * (p - self.p_ref) - self.beta_o * (T - self.T_ref)
        )

    def mu_o(self, T):
        """Heavy-oil viscosity [Pa·s], Andrade law.

        μ_o(T) = μ_ref · exp(b·(1/T − 1/T_ref)).  With the defaults this
        spans ~1 Pa·s at 293 K down to ~5 mPa·s at 400 K — the orders-of-
        magnitude thinning that motivates thermal recovery ([P2] §2).
        """
        return self.mu_o_ref * jnp.exp(self.b_o * (1.0 / T - 1.0 / self.T_mu_ref))

    # ------------------------------------------------------------------ rock
    @property
    def rho_c_rock(self) -> float:
        """Volumetric rock heat capacity ρ_r·c_r [J/m³/K]."""
        return self.rho_r * self.c_r

    # --------------------------------------------------------------- energy
    def energy_density_sp(self, p, T, phi):
        """Single-phase volumetric internal energy (1−φ)ρ_r c_r T + φ ρ c_v T."""
        return (1.0 - phi) * self.rho_c_rock * T + phi * self.rho_w(p, T) * self.cp_w * T

    def energy_density_tp(self, p, T, S, phi):
        """Two-phase volumetric internal energy, water saturation S."""
        fluid = (
            S * self.rho_w(p, T) * self.cp_w
            + (1.0 - S) * self.rho_o(p, T) * self.cp_o
        )
        return (1.0 - phi) * self.rho_c_rock * T + phi * fluid * T
