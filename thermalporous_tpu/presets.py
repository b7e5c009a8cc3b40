"""Named case presets mirroring the reference's driver scripts.

The reference configures experiments with per-case Python driver scripts at
the repo root (SURVEY.md §2.10); here each of the five BASELINE.json
measurement configs is a named preset returning a ready-to-run bundle.
Use ``examples/run_case.py --case <name>`` or :func:`get_case` directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from thermalporous_tpu.core.grid import Grid
from thermalporous_tpu.data.spe10 import SPE10_SPACING_M, synthetic_spe10
from thermalporous_tpu.models import (
    ProblemData,
    SinglePhaseModel,
    ThermalModelBase,
    TwoPhaseModel,
    make_problem_data,
)
from thermalporous_tpu.physics import Heater, PhysicalParams, Well, per_well_masks
from thermalporous_tpu.precond import CPRConfig, GMGConfig
from thermalporous_tpu.solve import NewtonConfig, TimeConfig


@dataclasses.dataclass
class Case:
    name: str
    description: str
    model: ThermalModelBase
    data: ProblemData
    time_cfg: TimeConfig
    newton_cfg: NewtonConfig
    t_end: float
    precond: str = "cptr"
    well_masks: dict | None = None
    # per-case preconditioner tuning (None = CPRConfig defaults); the
    # reference keys per-case PETSc solver_parameters the same way
    # (SURVEY.md §2.1)
    pc_cfg: object | None = None


def sp_hot_injection_2d(n: int = 40) -> Case:
    """BASELINE config #1: 2D homogeneous single-phase hot-water injection."""
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(400.0 / n, 400.0 / n), thickness=10.0)
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=3.0e7, T_inj=420.0, name="INJ"),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7, name="PROD"),
    ]
    data = make_problem_data(g, pp, kx=1e-13, phi=0.2, wells=wells)
    return Case(
        well_masks=per_well_masks(g, wells),
        name="sp_hot_injection_2d",
        description="2D homogeneous single-phase hot-water injection (40x40)",
        model=SinglePhaseModel(g, pp),
        data=data,
        time_cfg=TimeConfig(dt_init=3600.0, dt_max=30 * 86400.0),
        # Eisenstat-Walker forcing (tools/ab_ew.py): EW trades ~2x FGMRES
        # savings for cheap extra Newton iterations on every preset.  Final
        # states differ at trajectory level only (the controller keys
        # growth on Newton counts, so the accepted dt sequence shifts).
        newton_cfg=NewtonConfig(ksp_ew=True),
        # asymmetric cheap-T stage 1 (tools/ab_tv_presets.py): identical
        # iteration counts (32 N / 62 ksp both) with a cheaper T cycle.
        # The other 2D presets tied and stay on the shared symmetric
        # hierarchy.
        pc_cfg=CPRConfig(gmg_t=GMGConfig(cycle_type="v")),
        t_end=180 * 86400.0,
    )


def sp_spe10_layer_2d(layer: int = 0, seed: int = 2020) -> Case:
    """BASELINE config #2: SPE10 top-layer permeability + two Peaceman wells."""
    pp = PhysicalParams()
    fields = synthetic_spe10(seed=seed).layer(layer)
    nx, ny = fields.kx.shape
    dx, dy, dz = SPE10_SPACING_M
    g = Grid(shape=(nx, ny), spacing=(dx, dy), thickness=dz)
    wells = [
        Well(cells=((nx // 2, ny // 2),), control="bhp", p_bh=3.5e7, T_inj=420.0,
             name="INJ"),
        Well(cells=((2, 2),), control="bhp", p_bh=1.0e7, name="PROD"),
    ]
    data = make_problem_data(
        g, pp, kx=fields.kx, ky=fields.ky, phi=fields.phi, wells=wells
    )
    return Case(
        well_masks=per_well_masks(g, wells),
        name="sp_spe10_layer_2d",
        description="2D single-phase, SPE10-style heterogeneous layer (60x220)",
        model=SinglePhaseModel(g, pp),
        data=data,
        time_cfg=TimeConfig(dt_init=600.0, dt_max=10 * 86400.0),
        # cap 32: the layer case solves in 6-12 FGMRES/Newton at the
        # PETSc-default ksp_rtol; CGS2 streams the full STATIC cap's basis
        # slots every iteration, so unused slots are pure memory traffic
        newton_cfg=NewtonConfig(ksp_maxiter=32, ksp_ew=True),
        t_end=60 * 86400.0,
    )


def sp_geothermal_3d(nx: int = 64, ny: int = 64, nz: int = 32) -> Case:
    """BASELINE config #3: 3D single-phase geothermal box with gravity + heaters."""
    pp = dataclasses.replace(PhysicalParams(), T_init=350.0, p_init=3.0e7)
    g = Grid(
        shape=(nx, ny, nz),
        spacing=(640.0 / nx, 640.0 / ny, 160.0 / nz),
        gravity=9.81,
        depth_top=1500.0,
    )
    rng = np.random.default_rng(7)
    k = 5e-14 * np.exp(0.7 * rng.standard_normal(g.shape))
    heaters = [
        Heater(cells=tuple((nx // 2 + i, ny // 2, nz - 2) for i in range(-2, 3)),
               power=5.0e5, name="HEAT"),
    ]
    wells = [
        Well(cells=tuple((nx // 4, ny // 4, iz) for iz in range(nz // 2, nz)),
             control="bhp", p_bh=4.0e7, T_inj=430.0, name="INJ"),
        Well(cells=tuple((3 * nx // 4, 3 * ny // 4, iz) for iz in range(0, nz // 2)),
             control="bhp", p_bh=2.0e7, name="PROD"),
    ]
    data = make_problem_data(g, pp, kx=k, kz=0.3 * k, phi=0.15, wells=wells,
                             heaters=heaters)
    return Case(
        well_masks=per_well_masks(g, wells, heaters),
        name="sp_geothermal_3d",
        description="3D single-phase geothermal box (64x64x32), gravity + heaters",
        model=SinglePhaseModel(g, pp),
        data=data,
        time_cfg=TimeConfig(dt_init=3600.0, dt_max=30 * 86400.0),
        # cap 32 (was 80): measured 7.3 FGMRES/Newton — see the cap note
        # in sp_spe10_layer_2d
        newton_cfg=NewtonConfig(ksp_maxiter=32, ksp_ew=True),
        # asymmetric cheap-T stage 1 + pressure K-recursion floor
        # (tools/ab_tv_presets.py): identical iteration counts
        # (28 N / 58 ksp both)
        pc_cfg=CPRConfig(gmg=GMGConfig(kcycle_min_cells=4096),
                         gmg_t=GMGConfig(cycle_type="v")),
        t_end=365 * 86400.0,
    )


def tp_thermal_2d(n: int = 60) -> Case:
    """BASELINE config #4: 2D two-phase dead-oil thermal displacement, full CPTR."""
    pp = PhysicalParams()
    g = Grid(shape=(n, n), spacing=(300.0 / n, 300.0 / n), thickness=10.0)
    rng = np.random.default_rng(11)
    k = 2e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    wells = [
        Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0, name="INJ"),
        Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7, name="PROD"),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    return Case(
        well_masks=per_well_masks(g, wells),
        name="tp_thermal_2d",
        description="2D two-phase dead-oil thermal displacement (60x60)",
        model=TwoPhaseModel(g, pp, s_init=0.2),
        data=data,
        time_cfg=TimeConfig(dt_init=600.0, dt_max=5 * 86400.0),
        # cap 32 (was 80): measured 5.9 FGMRES/Newton — see the cap note
        # in sp_spe10_layer_2d
        newton_cfg=NewtonConfig(ksp_maxiter=32, ksp_ew=True),
        t_end=90 * 86400.0,
    )


def tp_spe10_3d(nx: int = 60, ny: int = 110, nz: int = 16, seed: int = 2020) -> Case:
    """BASELINE config #5: 3D two-phase SPE10-subset thermal flood (multi-chip)."""
    pp = PhysicalParams()
    fields = synthetic_spe10(shape=(nx, ny, nz), seed=seed, tarbert_frac=0.5)
    dx, dy, dz = SPE10_SPACING_M
    g = Grid(shape=(nx, ny, nz), spacing=(dx, dy, dz), gravity=9.81,
             depth_top=3600.0 * 0.3048)
    wells = [
        Well(cells=tuple((nx // 2, ny // 2, iz) for iz in range(nz)),
             control="bhp", p_bh=4.0e7, T_inj=420.0, name="INJ"),
        Well(cells=tuple((2, 2, iz) for iz in range(nz)),
             control="bhp", p_bh=1.0e7, name="P1"),
        Well(cells=tuple((nx - 3, ny - 3, iz) for iz in range(nz)),
             control="bhp", p_bh=1.0e7, name="P2"),
    ]
    data = make_problem_data(
        g, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz, phi=fields.phi,
        wells=wells,
    )
    return Case(
        well_masks=per_well_masks(g, wells),
        name="tp_spe10_3d",
        description=f"3D two-phase SPE10-subset thermal flood ({nx}x{ny}x{nz})",
        model=TwoPhaseModel(g, pp, s_init=0.15),
        data=data,
        time_cfg=TimeConfig(dt_init=300.0, dt_max=2 * 86400.0),
        # cap 32 (was 100): measured 14.0 FGMRES/Newton average; at cap
        # 100 the unused basis slots were ~40% of the whole step's memory
        # traffic (tools/roofline.py byte model)
        newton_cfg=NewtonConfig(ksp_maxiter=32, max_iters=20,
                                ksp_ew=True),
        # asymmetric cheap-T stage 1 + pressure K-recursion floor
        # (tools/ab_tv_presets.py): identical iteration counts
        # (31 N / 79 ksp both)
        pc_cfg=CPRConfig(gmg=GMGConfig(kcycle_min_cells=4096),
                         gmg_t=GMGConfig(cycle_type="v")),
        t_end=30 * 86400.0,
    )


def tp_spe10_full(seed: int = 2020) -> Case:
    """Full SPE10-size problem: 60×220×85 = 1.122M cells (3.37M dof),
    two-phase thermal — the reference papers' largest demonstrated problem
    ([P2], run there on O(10–100) MPI cores).  One card holds it in f32
    state with x64 reductions.

    Solver preset (round-2 measured, tools/spe10_iters.py): rebuild the
    preconditioner every Newton iteration (the reference's behavior; the
    frozen per-step PC thrashes at the iteration cap on ramped Δt), CPTR
    with matrix-dependent (strength-adaptive) coarsening — SPE10's thin
    cells make vertical transmissibility ~30× horizontal, so the first GMG
    levels aggregate along z — and red-black block Gauss–Seidel stage 2.
    vs the geometric+block-Jacobi default this cuts FGMRES/Newton ~35%
    across the ramp (6.0→38.5 vs 11.8→59.5 at ksp_rtol 1e-5, with deg-4
    Chebyshev smoothing) and keeps converging at day-scale Δt where the
    default hits the cap.
    """
    nx, ny, nz = 60, 220, 85
    pp = PhysicalParams()
    fields = synthetic_spe10(seed=seed)
    g = Grid(shape=(nx, ny, nz), spacing=SPE10_SPACING_M, gravity=9.81,
             depth_top=3600.0 * 0.3048)
    wells = [
        Well(cells=tuple((nx // 2, ny // 2, iz) for iz in range(nz)),
             control="bhp", p_bh=4.0e7, T_inj=420.0, name="INJ"),
    ] + [
        Well(cells=tuple((i, j, iz) for iz in range(nz)),
             control="bhp", p_bh=1.0e7, name=f"P_{i}_{j}")
        for i, j in [(2, 2), (nx - 3, 2), (2, ny - 3), (nx - 3, ny - 3)]
    ]
    data = make_problem_data(
        g, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz, phi=fields.phi,
        wells=wells,
    )
    return Case(
        well_masks=per_well_masks(g, wells),
        name="tp_spe10_full",
        description="FULL SPE10-size two-phase thermal (60x220x85, 3.37M dof)",
        model=TwoPhaseModel(g, pp, s_init=0.15),
        data=data,
        # Controller constants are the tools/run_horizon.py measured set
        # (8-day controller-driven horizon).  Iteration bands 8/14:
        # production hard steps run 8–14 Newton (chop+nonmonotone), so the
        # generic 6/10 band would cut Δt right after the first wall
        # acceptance.  Failure memory: without it the controller bounces
        # against the dt≈76.8 ks wall every other step (11 retries);
        # capping regrowth at 0.6x a failed dt with a slow 1.05x/step
        # release gives 1 retry.
        time_cfg=TimeConfig(dt_init=600.0, dt_max=2 * 86400.0,
                            growth=2.0, grow_below=8, shrink_above=14,
                            fail_frac=0.6, fail_relax=1.05),
        # ksp_maxiter=16: CGS2 streams the full STATIC cap's basis slots
        # every iteration, so the cap is a first-order traffic knob.  Under
        # EW forcing typical solves take 3-6 directions; cap 16 keeps
        # headroom for the rare hard solve (tools/ab_kspcap.py).
        # ds_max + nonmonotone: Appleyard chop with nonmonotone acceptance
        # converges repeatedly at dt=38400s where Armijo+chop always fails,
        # and hard-step failures detect cheaply (docs/parity.md).
        # ksp_rtol 1e-2 + bf16 Arnoldi basis (tools/spe10_iters.py): the
        # inexact-Newton forcing term (Newton still gates on the TRUE
        # residual via rtol/atol) and halved CGS2 basis streaming.  The
        # bf16 basis is honest ONLY at this loose forcing term (its
        # true-residual floor is ~4e-3 — fgmres.py docstring); revert BOTH
        # if tightening ksp_rtol.
        # ksp_orth stays the default cgs2 (NOT the low-synch "cgs2g"): on
        # the CONTROLLER-driven horizon cgs2g lands on a worse trajectory
        # (more FGMRES/Newton).  bench.py's fixed-dt step uses cgs2g.
        # ksp_ew=True: Eisenstat–Walker adaptive forcing (PETSc
        # -snes_ksp_ew v2) on top of the 1e-2 floor.  The fixed term
        # over-solves the HARD steps (16-22 FGMRES/Newton at dt≥38.4ks)
        # where EW runs them at 3-6/N and still converges; Newton counts
        # rise (absorbed by chop+nonmonotone) but each iteration is
        # cheaper (600 vs 1305 total KSP on the 8-day horizon).
        newton_cfg=NewtonConfig(atol=3e-5, ksp_rtol=1e-2, ksp_maxiter=16,
                                max_iters=16, pc_lag="every", ds_max=0.2,
                                ls_mode="nonmonotone", ksp_basis="bf16",
                                ksp_ew=True),
        pc_cfg=CPRConfig(
            stage2="rbgs",
            # stage2_cols: the stage-2 residual streams only block
            # columns 0:2 of A — bit-exact (s_stage="none" leaves x₁'s
            # saturation component at zero).
            stage2_cols=True,
            gmg=GMGConfig(cycle_type="k", max_coarse_cells=1024,
                          coarsen="adaptive", degree=4,
                          kcycle_min_cells=8192),
            # Asymmetric stage 1: the decoupled TEMPERATURE system is
            # diffusion-dominated and easy (8 standalone FGMRES iterations
            # vs the full system's ~97, tools/diag_hard.py), so it gets a
            # V-cycle/deg-2 hierarchy instead of the pressure block's
            # K-cycle/deg-4 — the K-cycle visits level L 2^(L-1) times,
            # and the deep levels are latency-bound.  Identical
            # full-system iteration counts (tools/ab_cycle.py).  The
            # pressure K-cycle additionally stops its CG(2) recursion
            # below 8192 cells (kcycle_min_cells — plain V-descent there).
            gmg_t=GMGConfig(cycle_type="v", max_coarse_cells=1024,
                            coarsen="adaptive", degree=2),
        ),
        t_end=30 * 86400.0,
    )


def tp_spe10_inner(seed: int = 2020) -> Case:
    """The literal [P2] §5 configuration: CPTR with INNER iterations on the
    decoupled (p,T) subsystem (2 inner FGMRES iterations per outer
    preconditioner application), on the full SPE10-size problem.

    Kept as a named preset so the paper-faithful configuration stays warm:
    it cuts outer FGMRES counts ~10–35%, at twice the stage-1 cost per
    application (docs/parity.md; `tools/spe10_iters.py
    every-adapt-rbgs-deg4-in2` reruns it).
    """
    case = tp_spe10_full(seed=seed)
    return dataclasses.replace(
        case,
        name="tp_spe10_inner",
        description="FULL SPE10-size, [P2]-faithful inner-iteration CPTR",
        # gmg_t=None, stage2_cols=False: keep the historical configuration
        # this preset's per-round regression numbers were measured at
        pc_cfg=dataclasses.replace(case.pc_cfg, inner_iters=2, gmg_t=None,
                                   stage2_cols=False),
    )


PRESETS = {
    "sp_hot_injection_2d": sp_hot_injection_2d,
    "sp_spe10_layer_2d": sp_spe10_layer_2d,
    "sp_geothermal_3d": sp_geothermal_3d,
    "tp_thermal_2d": tp_thermal_2d,
    "tp_spe10_3d": tp_spe10_3d,
    "tp_spe10_full": tp_spe10_full,
    "tp_spe10_inner": tp_spe10_inner,
}

# static descriptions (listing cases must not construct their fields)
CASE_DESCRIPTIONS = {
    "sp_hot_injection_2d": "2D homogeneous single-phase hot-water injection (40x40)",
    "sp_spe10_layer_2d": "2D single-phase, SPE10-style heterogeneous layer (60x220)",
    "sp_geothermal_3d": "3D single-phase geothermal box (64x64x32), gravity + heaters",
    "tp_thermal_2d": "2D two-phase dead-oil thermal displacement (60x60)",
    "tp_spe10_3d": "3D two-phase SPE10-subset thermal flood (60x110x16)",
    "tp_spe10_full": "FULL SPE10-size two-phase thermal (60x220x85, 3.37M dof)",
    "tp_spe10_inner": "FULL SPE10-size, [P2]-faithful inner-iteration CPTR",
}


def get_case(name: str, **kwargs) -> Case:
    if name not in PRESETS:
        raise KeyError(f"unknown case {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](**kwargs)
