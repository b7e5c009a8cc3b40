"""Wells and heaters: Peaceman model, source-term fields.

Equivalent of the reference's well/heater case machinery
(``thermalporous/cases.py``-like module upstream, unverified — SURVEY.md
§2.7).  The reference localizes wells via DG0 indicator functions; here each
well writes its Peaceman well index into dense per-cell fields which the
residual consumes directly — the same discrete-delta algebra, laid out
as dense elementwise fields.

Conventions: source terms are positive INTO the reservoir.  BHP-controlled
wells contribute ``q = WI·λ·(p_bh − p)``; rate-controlled wells a fixed mass
rate; heaters a fixed power.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from thermalporous_tpu.core.grid import Grid


@dataclasses.dataclass(frozen=True)
class Well:
    """One vertical well, perforating one or more cells.

    Attributes:
      cells: perforated cell indices, each a full-dimension index tuple.
      control: "bhp" (bottom-hole pressure) or "rate" (fixed mass rate).
      p_bh: bottom-hole pressure [Pa] (BHP control).
      rate: total mass rate [kg/s], positive = injection (rate control).
      T_inj: injection temperature [K]; None marks a pure producer (inflow,
        if it ever happens through crossflow, carries the local temperature).
      radius: wellbore radius r_w [m].
    """

    cells: tuple[tuple[int, ...], ...]
    control: str = "bhp"
    p_bh: float = 0.0
    rate: float = 0.0
    T_inj: float | None = None
    radius: float = 0.1
    name: str = "well"


@dataclasses.dataclass(frozen=True)
class Heater:
    """A pure energy source over a set of cells (geothermal scenarios, [P1])."""

    cells: tuple[tuple[int, ...], ...]
    power: float = 0.0  # total [W], split evenly over cells
    name: str = "heater"


def peaceman_well_index(
    kx: float, ky: float, dx: float, dy: float, dz: float, r_w: float
) -> float:
    """Anisotropic Peaceman well index for a vertical well through one cell.

    WI = 2π·√(kx·ky)·Δz / ln(r_e / r_w), with the Peaceman equivalent radius

        r_e = 0.28·√(√(ky/kx)·Δx² + √(kx/ky)·Δy²) / ((ky/kx)^¼ + (kx/ky)^¼)

    which reduces to r_e ≈ 0.198·Δx on an isotropic square grid.  Matches the
    well model described for the reference cases (SURVEY.md §2.7; exact
    variant LOW-confidence pending the real source).
    """
    a = math.sqrt(ky / kx)
    b = math.sqrt(kx / ky)
    r_e = 0.28 * math.sqrt(a * dx * dx + b * dy * dy) / (a**0.5 + b**0.5)
    if r_e <= r_w:
        raise ValueError(
            f"Peaceman equivalent radius r_e={r_e:.4g} m <= wellbore radius "
            f"r_w={r_w:.4g} m (cell {dx}x{dy} m too fine for this r_w); "
            "WI would be negative/singular"
        )
    return 2.0 * math.pi * math.sqrt(kx * ky) * dz / math.log(r_e / r_w)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WellFields:
    """Dense per-cell source-term fields consumed by the residual kernels."""

    wi: jax.Array        # (*shape) Peaceman well index [m³]; 0 = no well
    pbh: jax.Array       # (*shape) bottom-hole pressure [Pa]
    tinj: jax.Array      # (*shape) injection temperature [K]
    has_tinj: jax.Array  # (*shape) 1.0 where T_inj specified, else 0.0
    qrate: jax.Array     # (*shape) fixed mass rate density [kg/s per cell]
    qheat: jax.Array     # (*shape) heater power density [W per cell]


def build_well_fields(
    grid: Grid,
    wells: Sequence[Well] = (),
    heaters: Sequence[Heater] = (),
    kx: np.ndarray | None = None,
    ky: np.ndarray | None = None,
    dtype=jnp.float64,
) -> WellFields:
    """Assemble dense source fields from well/heater specs.

    ``kx``/``ky`` are cell permeability arrays [m²] used for the Peaceman
    index (required if any BHP well is present).
    """
    shape = grid.shape
    wi = np.zeros(shape)
    wipbh = np.zeros(shape)  # Σ WI_i·p_bh,i, folded to a WI-weighted BHP below
    tinj = np.zeros(shape)
    has_tinj = np.zeros(shape)
    qrate = np.zeros(shape)
    qheat = np.zeros(shape)

    dx, dy = grid.spacing[0], grid.spacing[1]
    dz = grid.dz_well

    for w in wells:
        for cell in w.cells:
            idx = tuple(int(i) for i in cell)
            if w.control == "bhp":
                if kx is None:
                    raise ValueError("BHP wells need permeability fields for WI")
                kx_c = float(np.asarray(kx)[idx])
                ky_c = float(np.asarray(ky)[idx]) if ky is not None else kx_c
                wi_c = peaceman_well_index(kx_c, ky_c, dx, dy, dz, w.radius)
                wi[idx] += wi_c
                # WI-weighted BHP: Σ WI_i·(p_bh,i − p) ≡ (Σ WI_i)·(p̄_bh − p)
                # with p̄_bh = Σ WI_i·p_bh,i / Σ WI_i — exact for co-located wells
                wipbh[idx] += wi_c * w.p_bh
            elif w.control == "rate":
                qrate[idx] += w.rate / len(w.cells)
            else:
                raise ValueError(f"unknown well control {w.control!r}")
            if w.T_inj is not None:
                tinj[idx] = w.T_inj
                has_tinj[idx] = 1.0

    for h in heaters:
        for cell in h.cells:
            idx = tuple(int(i) for i in cell)
            qheat[idx] += h.power / len(h.cells)

    pbh = np.divide(wipbh, wi, out=np.zeros_like(wipbh), where=wi > 0)

    as_j = lambda a: jnp.asarray(a, dtype=dtype)
    return WellFields(
        wi=as_j(wi),
        pbh=as_j(pbh),
        tinj=as_j(tinj),
        has_tinj=as_j(has_tinj),
        qrate=as_j(qrate),
        qheat=as_j(qheat),
    )


def per_well_masks(
    grid: Grid, wells: Sequence[Well] = (), heaters: Sequence[Heater] = ()
) -> dict[str, np.ndarray]:
    """Boolean cell masks per named well/heater (diagnostics only)."""
    masks: dict[str, np.ndarray] = {}
    for w in list(wells) + list(heaters):
        m = masks.setdefault(w.name, np.zeros(grid.shape, dtype=bool))
        for cell in w.cells:
            m[tuple(int(i) for i in cell)] = True
    return masks


def well_rates(model, u, data, masks: dict[str, np.ndarray]) -> dict[str, dict]:
    """Per-well surface report: mass [kg/s] and energy [W] rates, positive
    into the reservoir (injectors +, producers −).

    The reference's cases report these through its well models (SURVEY.md
    §2.7); here they are a pure diagnostic over the model's source fields.
    """
    q = np.asarray(model.well_sources(u, data.wells))
    out: dict[str, dict] = {}
    for name, mask in masks.items():
        rec = {}
        if model.nc == 2:
            rec["mass_kg_s"] = float(q[0][mask].sum())
            rec["energy_W"] = float(q[1][mask].sum())
        else:
            rec["water_kg_s"] = float(q[0][mask].sum())
            rec["oil_kg_s"] = float(q[2][mask].sum())
            rec["energy_W"] = float(q[1][mask].sum())
        out[name] = rec
    return out


def empty_well_fields(grid: Grid, dtype=jnp.float64) -> WellFields:
    z = jnp.zeros(grid.shape, dtype=dtype)
    return WellFields(wi=z, pbh=z, tinj=z, has_tinj=z, qrate=z, qheat=z)
