"""CPR / CPTR two-stage preconditioners — the scientific core.

Rebuild of the reference's ``thermalporous/preconditioners.py``
(upstream, unverified — SURVEY.md §2.8), the custom PCBase classes behind
papers arXiv:1812.11566 (CPR) and arXiv:1907.04229 (CPTR):

  M⁻¹ r = x₁ + M₂⁻¹ (r − A x₁),   x₁ = P · stage1(R · W · r)

- **decoupling** W: per-cell block scaling of the equations.  Default is
  the full diagonal-block inverse (alternate-block-factorization form; the
  reference's Quasi-IMPES/True-IMPES row weightings are cheaper specials of
  the same idea — variants kept as config for iteration-count ablations).
- **stage 1 (CPR)**: one geometric-multigrid V-cycle on the decoupled
  pressure stencil (the BoomerAMG role).
- **stage 1 (CPTR)**: block-triangular solve of the (p,T) 2×2 subsystem —
  V-cycle on p, correct the T residual through the T←p coupling, V-cycle on
  T.  This is the [P2] contribution: temperature is parabolic/advective and
  needs its own multigrid treatment.
- **stage 2**: per-cell block-Jacobi with exact nc×nc inverses (the
  parallel stand-in for ILU(0), which is inherently sequential).

Everything here is stencil algebra on dense per-cell blocks: setup is a few
elementwise passes per Newton iteration, apply is a handful of stencil
matvecs.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from thermalporous_tpu.core.stencil import BlockStencil, ScalarStencil, apply_blocks
from thermalporous_tpu.precond.gmg import (
    GMGConfig,
    GMGState,
    gmg_apply,
    gmg_setup,
    plan_coarsening,
)


@dataclasses.dataclass(frozen=True)
class CPRConfig:
    """Static configuration of the two-stage preconditioner."""

    variant: str = "cptr"            # "cpr" | "cptr"
    # stage-2 smoother on the full system (the reference's ILU(0)/bjacobi
    # role): "block_jacobi" (per-cell exact block solve), "jacobi2"
    # (TWO-step block-Jacobi Richardson: x = D⁻¹r₂; x += ω·D⁻¹(r₂ − A·x)
    # — matches one RBGS sweep's correction quality class at 81
    # coefficient fields instead of 189+: no masks, no zero-start
    # matvec), "rbgs"
    # (red-black block Gauss-Seidel — propagates transport corrections a
    # cell per color pass, the closer ILU analog), "zebra" (red-black
    # BLOCK line solves along stage2_axis — the dt=76.8 ks full-SPE10
    # wall is the (p,T,S) COUPLING needing O(100)-cell propagation along
    # channels, which point smoothers carry one cell per sweep and exact
    # line solves carry across the whole line; tools/diag_hard.py),
    # "bgmg" (coupled block geometric
    # multigrid on the FULL system — Galerkin block coarsening + block
    # RBGS smoothing + dense coupled coarse solve, precond/block_gmg.py:
    # the coarse-grid correction that carries the long-range coupling
    # modes point/line smoothers cannot), "none"
    stage2: str = "block_jacobi"
    stage2_sweeps: int = 1           # rbgs/zebra sweeps
    # Exact stage-2 traffic levers.  Both are BIT-exact reformulations (proofs in core/stencil.py matvec_cols /
    # precond/chebyshev.py block_rbgs_fused_zero):
    # stage2_cols — the stage-2 residual r − A·x₁ streams only the block
    #   COLUMNS x₁ is supported on (0:2 for CPTR, 0:1 for CPR) when
    #   s_stage == "none" leaves the trailing components of x₁ at zero;
    #   cuts 1/3 of that matvec's coefficient bytes.  Default on: bit-exact
    #   by construction.  tp_spe10_inner disables it to keep its original
    #   trajectory.
    stage2_cols: bool = True
    # stage2_fused — stage2="rbgs", first sweep only: zero-start sweep via
    #   setup-premasked D⁻¹ halves (the looped body's A·0 matvec and the
    #   black half's diag stream are elided; extra sweeps continue in the
    #   looped form).  Qualify it against CPU counts (qualify.py) before
    #   adopting it at a new scale.
    stage2_fused: bool = False
    # stage2_axes — SPARSIFIED smoother operator (NOT exact): restrict the rbgs sweep's neighbour coupling to these
    #   grid axes (e.g. (2,) = z only, the SPE10 strong axis at ~30x
    #   horizontal transmissibility).  Works with the looped form (both
    #   half-sweeps' matvecs reduced) and the fused form (black half).
    #   Each omitted axis drops two 9-field coefficient streams per
    #   matvec; gate adoption on unchanged iteration counts (hard-system
    #   probe AND horizon).  None = full coupling.
    stage2_axes: tuple[int, ...] | None = None
    stage2_axis: int = 1             # zebra line axis (1 = SPE10 channel y)
    stage2_omega: float = 1.0        # zebra under-relaxation (stability at
                                     # extreme contrast)
    bgmg_coarse_cells: int = 256     # stage2="bgmg": coarsest-level size
    bgmg_cycles: int = 1             # stage2="bgmg": V-cycles per apply
    triangular: bool = True          # CPTR stage-1: triangular vs block-diagonal
    # Batch the p and T hierarchies through ONE vmapped GMG traversal
    # (requires triangular=False: the triangular form's T residual
    # correction depends on e_p, so the two K-cycles are inherently
    # sequential).  The adaptive schedule is planned once from the
    # pressure block, so both hierarchies are pytree-congruent and stack
    # leaf-wise; a batched traversal halves stage-1's op COUNT — the
    # fine-level ops are bandwidth-bound (no byte savings) but the
    # K-cycle's many coarse-level ops are latency-bound, where op count
    # is the cost.  When set, ``CPRState.gmg_p`` holds the stacked (2,·)
    # hierarchy and ``gmg_t`` is None.
    # Off in every preset; qualify it against CPU counts (qualify.py)
    # before using it at scale.
    batch_pt: bool = False
    # decoupling operator W ([P1] §4, [P2] §3):
    #   "qimpes" — Quasi-IMPES: eliminate only the last-unknown coupling of
    #              the other rows using the cell's diagonal block (DEFAULT,
    #              as in the reference; measured ~2x fewer FGMRES iterations
    #              than ABF on SPE10-class problems — full-block scaling
    #              spoils the pressure block's near-ellipticity)
    #   "timpes" — True-IMPES: same elimination with column sums over the
    #              whole stencil row (the reference's other variant)
    #   "abf"    — full diagonal-block inverse (alternate block factorization)
    decoupling: str = "qimpes"
    # [P2] §5 option: run a few inner iterations on the decoupled (p,T)
    # subsystem in stage 1 (preconditioned by the block-triangular GMG
    # combination) instead of a single application.  0 = single pass (the
    # default two-stage CPTR); k>0 = k inner iterations.
    inner_iters: int = 0
    inner_rtol: float = 1e-2
    # "fgmres" is [P2]'s literal variant; "richardson" iterates
    # z ← z + M(r − A·z) — same subspace idea without a nested Krylov
    # solver inside the outer FGMRES's while_loop.
    inner_method: str = "fgmres"
    # SATURATION stage (round-3 extension, "CPTRS"): a third leg of the
    # block-triangular stage 1 — after the (p,T) solves, the S residual
    # is corrected through the S←(p,T) couplings and the decoupled scalar
    # S-S operator is smoothed directly.  Measured on the dt=76.8
    # ks full-SPE10 wall it was built for (tools/diag_hard.py): every
    # DECOUPLED row is easy standalone (p 6, T 8, S 1–3 FGMRES
    # iterations) while the full system needs ~97 — the wall is the
    # (p,T,S) COUPLING, so this leg is measured iteration-neutral there
    # (96 vs 97) and stays off by default.  The
    # coupling-targeted lever is stage2="zebra" above.  "rbgs" | "jacobi"
    # | "zebra"/"line" (batched-Thomas line solves along s_axis) | "none".
    s_stage: str = "none"
    s_sweeps: int = 2
    s_axis: int = 0
    # Storage dtype of the PC-internal coefficient arrays ("f32" | "bf16").
    # Almost all of the CPTR apply's traffic is streaming stencil
    # coefficients (GMG level stencils under Chebyshev, the stage-2 block
    # stencil, W, D⁻¹).  "bf16" computes the SETUP in full precision and then casts only the
    # stored coefficients; every apply still runs f32 vector arithmetic
    # (bf16 coef × f32 vec promotes to f32), so this halves the PC's memory
    # traffic at a ~0.4% coefficient rounding that FGMRES absorbs (the PC
    # is flexible-preconditioning territory; the Krylov operator and true
    # residual stay full-precision in solve/newton.py).  Exceptions kept
    # full precision: the coarsest-level dense inverse (latency- not
    # bandwidth-bound), Chebyshev λ estimates (scalars), the zebra
    # block-Thomas factorization (a sequential recurrence that compounds
    # rounding), and weighted-transfer weights.
    pc_dtype: str = "f32"
    gmg: GMGConfig = GMGConfig()
    # Separate GMG configuration for the TEMPERATURE hierarchy (CPTR
    # stage 1 only; None = use ``gmg`` for both).  Motivation: at
    # full-SPE10 scale the K-cycle's 2-recursive coarse solves visit deep
    # (latency-bound) levels 2^(L−1) times, for BOTH hierarchies.  But the decoupled T system
    # is diffusion-dominated and measured EASY standalone (8 FGMRES
    # iterations where the full system needs ~97 — tools/diag_hard.py),
    # so it does not need the pressure hierarchy's K-cycle robustness: a
    # V-cycle / lower degree here removes about half the deep-level
    # kernel storm.  Incompatible with ``batch_pt`` (stacked traversal
    # requires congruent hierarchies).
    gmg_t: GMGConfig | None = None


def _cast_floats(dtype):
    """Tree-cast every floating leaf of a (possibly None) pytree."""

    def go(tree):
        if tree is None:
            return None
        return jax.tree.map(
            lambda a: a.astype(dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a,
            tree,
        )

    return go


def _impes_weights(d: jax.Array) -> jax.Array:
    """W eliminating the last-unknown column from all other equations.

    d: per-cell (nc, nc, *shape) blocks (the diagonal for Quasi-IMPES, the
    stencil column sums for True-IMPES).  For nc=2 the "last unknown" is T
    (single-phase CPR decoupling); for nc=3 it is S_w.
    """
    nc = d.shape[0]
    last = nc - 1
    dtype = d.dtype
    shape = d.shape[2:]
    eye = jnp.eye(nc, dtype=dtype).reshape((nc, nc) + (1,) * len(shape))
    w = jnp.broadcast_to(eye, d.shape)
    denom = d[last, last]
    safe = jnp.where(jnp.abs(denom) > 0, denom, 1.0)
    rows = []
    for i in range(nc):
        row = w[i]
        if i != last:
            row = row.at[last].set(-d[i, last] / safe)
        rows.append(row)
    return jnp.stack(rows)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CPRState:
    """Per-Newton-iteration preconditioner state (a pytree)."""

    stencil: BlockStencil            # original Jacobian stencil A
    dinv: jax.Array                  # per-cell inverse diagonal blocks (stage 2)
    w: jax.Array                     # per-cell decoupling blocks W (stage 1)
    gmg_p: GMGState                  # hierarchy on decoupled pressure block
    gmg_t: GMGState | None           # hierarchy on decoupled temperature block
    a_tp: ScalarStencil | None       # decoupled T-equation ← p-unknown coupling
    pt: BlockStencil | None          # decoupled (p,T) 2×2 stencil (inner GMRES)
    a_sp: ScalarStencil | None = None  # S-equation ← p coupling (s_stage)
    a_st: ScalarStencil | None = None  # S-equation ← T coupling (s_stage)
    a_ss: ScalarStencil | None = None  # S-S transport operator (s_stage)
    # block-Thomas factorization for stage2="zebra" (computed once per
    # setup; each apply reuses it for every color half-sweep)
    zebra_fac: tuple | None = None
    # coupled block hierarchy for stage2="bgmg" (precond/block_gmg.py)
    bgmg: object | None = None
    # setup-premasked D⁻¹ color halves for stage2_fused (red·D⁻¹, black·D⁻¹)
    dinv_red: jax.Array | None = None
    dinv_black: jax.Array | None = None


def _decoupling_weights(
    stencil: BlockStencil, cfg: CPRConfig, dinv: jax.Array | None = None
) -> jax.Array:
    if cfg.decoupling == "abf":
        return stencil.diag_inverse() if dinv is None else dinv
    if cfg.decoupling == "qimpes":
        return _impes_weights(stencil.diag)
    if cfg.decoupling == "timpes":
        colsum = stencil.diag
        for up, lo in zip(stencil.upper, stencil.lower):
            colsum = colsum + up + lo
        return _impes_weights(colsum)
    raise ValueError(f"unknown decoupling {cfg.decoupling!r}")


def resolve_adaptive_coarsening(
    stencil: BlockStencil, cfg: CPRConfig, theta: float = 0.25
) -> CPRConfig:
    """Bake the matrix-dependent coarsening schedule into ``cfg`` (host-side).

    When ``cfg.gmg.coarsen == "adaptive"`` and no ``level_factors`` schedule
    is set yet, decouple a CONCRETE Jacobian stencil (any representative
    state/Δt — the coupling ratios are geometry/permeability-driven), run
    :func:`plan_coarsening` on its pressure block, and return a config with
    the static schedule baked in.  Call once before jitting; no-op otherwise.
    """
    gmg_todo = (cfg.gmg.coarsen == "adaptive"
                and cfg.gmg.level_factors is None)
    gmg_t_todo = (cfg.gmg_t is not None
                  and cfg.gmg_t.coarsen == "adaptive"
                  and cfg.gmg_t.level_factors is None)
    if not (gmg_todo or gmg_t_todo):
        return cfg
    dec = stencil.scale_rows(_decoupling_weights(stencil, cfg))
    if gmg_todo:
        schedule = plan_coarsening(dec.scalar(0, 0), cfg.gmg, theta=theta)
        cfg = dataclasses.replace(
            cfg, gmg=dataclasses.replace(cfg.gmg, level_factors=schedule))
    if gmg_t_todo:
        # the T hierarchy plans from ITS OWN decoupled operator (conduction
        # anisotropy need not match the pressure block's)
        schedule_t = plan_coarsening(dec.scalar(1, 1), cfg.gmg_t, theta=theta)
        cfg = dataclasses.replace(
            cfg,
            gmg_t=dataclasses.replace(cfg.gmg_t, level_factors=schedule_t))
    return cfg


def cpr_setup(stencil: BlockStencil, cfg: CPRConfig = CPRConfig()) -> CPRState:
    dinv = stencil.diag_inverse()
    w = _decoupling_weights(stencil, cfg, dinv=dinv)
    dec = stencil.scale_rows(w)         # W·A
    app = dec.scalar(0, 0)
    gmg_p = gmg_setup(app, cfg.gmg)
    pt = None
    a_sp = a_st = a_ss = None
    if cfg.variant == "cptr":
        att = dec.scalar(1, 1)
        gmg_t = gmg_setup(att, cfg.gmg_t or cfg.gmg)
        a_tp = dec.scalar(1, 0)
        if cfg.batch_pt:
            if cfg.triangular:
                raise ValueError(
                    "batch_pt requires triangular=False: the triangular "
                    "T-residual correction depends on e_p, so the two "
                    "hierarchies cannot be traversed together")
            if cfg.gmg_t is not None:
                raise ValueError(
                    "batch_pt requires gmg_t=None: the stacked traversal "
                    "needs pytree-congruent p/T hierarchies")
            gmg_p = jax.tree.map(lambda *xs: jnp.stack(xs), gmg_p, gmg_t)
            gmg_t = None
        if cfg.inner_iters > 0:
            pt = dec.block(slice(0, 2), slice(0, 2))
        if cfg.s_stage != "none" and stencil.nc >= 3:
            a_sp = dec.scalar(2, 0)
            a_st = dec.scalar(2, 1)
            a_ss = dec.scalar(2, 2)
    else:
        gmg_t = None
        a_tp = None
    zebra_fac = None
    if cfg.stage2 == "zebra":
        from thermalporous_tpu.precond.chebyshev import block_tridiag_factor

        a = cfg.stage2_axis % len(stencil.grid_shape)
        zebra_fac = block_tridiag_factor(
            a, stencil.lower[a], stencil.diag, stencil.upper[a])
    bgmg = None
    if cfg.stage2 == "bgmg":
        from thermalporous_tpu.precond.block_gmg import block_gmg_setup

        bgmg = block_gmg_setup(
            stencil, cfg.gmg, max_coarse_cells=cfg.bgmg_coarse_cells)
    dinv_red = dinv_black = None
    if cfg.stage2 == "rbgs" and cfg.stage2_fused:
        from thermalporous_tpu.precond.chebyshev import _checkerboard

        red = _checkerboard(stencil.grid_shape, dinv.dtype)
        dinv_red, dinv_black = red * dinv, (1.0 - red) * dinv
    if cfg.pc_dtype != "f32":
        # Cast ONLY the stored coefficients (see CPRConfig.pc_dtype): setup
        # ran in full precision above, applies still do f32 vector math.
        # The selective groups exist to bisect quality loss: "bf16_gmg"
        # casts the stage-1 hierarchies only, "bf16_s2" the full-system
        # stage-2 stencil/D⁻¹ only, "bf16" everything.
        if cfg.pc_dtype not in ("bf16", "bf16_gmg", "bf16_s2"):
            raise ValueError(f"unknown pc_dtype {cfg.pc_dtype!r}")
        cast = _cast_floats(jnp.bfloat16)
        if cfg.pc_dtype in ("bf16", "bf16_s2"):
            stencil, dinv = cast(stencil), cast(dinv)
            dinv_red, dinv_black = cast(dinv_red), cast(dinv_black)
            if bgmg is not None:
                bgmg = dataclasses.replace(
                    bgmg, stencils=cast(bgmg.stencils),
                    dinvs=cast(bgmg.dinvs))
        if cfg.pc_dtype in ("bf16", "bf16_gmg"):
            a_tp = cast(a_tp)
            gmg_p = dataclasses.replace(gmg_p, stencils=cast(gmg_p.stencils))
            if gmg_t is not None:
                gmg_t = dataclasses.replace(
                    gmg_t, stencils=cast(gmg_t.stencils))
        if cfg.pc_dtype == "bf16":
            w, pt = cast(w), cast(pt)
            a_sp, a_st, a_ss = cast(a_sp), cast(a_st), cast(a_ss)
    return CPRState(
        stencil=stencil, dinv=dinv, w=w, gmg_p=gmg_p, gmg_t=gmg_t, a_tp=a_tp,
        pt=pt, a_sp=a_sp, a_st=a_st, a_ss=a_ss, zebra_fac=zebra_fac,
        bgmg=bgmg, dinv_red=dinv_red, dinv_black=dinv_black,
    )


def _s_smooth(a_ss: ScalarStencil, r_s: jax.Array, cfg: CPRConfig) -> jax.Array:
    """Approximate A_ss⁻¹ r_s with cfg.s_sweeps scalar smoother sweeps."""
    from thermalporous_tpu.precond.chebyshev import (
        line_jacobi,
        red_black_gauss_seidel,
        weighted_jacobi,
        zebra_line_gs,
    )

    if cfg.s_stage == "rbgs":
        return red_black_gauss_seidel(a_ss, r_s, None, sweeps=cfg.s_sweeps)
    if cfg.s_stage == "zebra":
        return zebra_line_gs(a_ss, r_s, None, axis=cfg.s_axis,
                             sweeps=cfg.s_sweeps)
    if cfg.s_stage == "line":
        return line_jacobi(a_ss, r_s, None, axis=cfg.s_axis,
                           sweeps=cfg.s_sweeps)
    if cfg.s_stage == "jacobi":
        return weighted_jacobi(a_ss, r_s, None, sweeps=cfg.s_sweeps)
    raise ValueError(f"unknown s_stage {cfg.s_stage!r}")


def _stage1_pt(state: CPRState, r_pt: jax.Array, cfg: CPRConfig) -> jax.Array:
    """Block-triangular (or -diagonal) GMG application on the (p,T) system."""
    if cfg.batch_pt:
        # gmg_p holds the stacked (2,·) hierarchy (see CPRConfig.batch_pt);
        # one vmapped traversal runs both block-diagonal K-cycles at once
        return jax.vmap(lambda s, b: gmg_apply(s, b, cfg.gmg))(
            state.gmg_p, r_pt)
    with jax.named_scope("stage1_p"):
        e_p = gmg_apply(state.gmg_p, r_pt[0], cfg.gmg)
    r_t = r_pt[1]
    if cfg.triangular:
        r_t = r_t - state.a_tp.matvec(e_p)
    with jax.named_scope("stage1_t"):
        e_t = gmg_apply(state.gmg_t, r_t, cfg.gmg_t or cfg.gmg)
    return jnp.stack([e_p, e_t])


def cpr_apply(state: CPRState, r: jax.Array, cfg: CPRConfig = CPRConfig()) -> jax.Array:
    """Apply M⁻¹ to a state-shaped residual r (nc, *grid)."""
    w = apply_blocks(state.w, r)        # decoupled residual W·r

    # stage 1 on the elliptic block(s)
    if cfg.variant == "cptr":
        r_pt = w[0:2]
        if cfg.inner_iters > 0 and cfg.inner_method == "richardson":
            # preconditioned Richardson on the (p,T) subsystem: one block
            # application + (k−1) defect corrections
            e_pt = _stage1_pt(state, r_pt, cfg)
            for _ in range(cfg.inner_iters - 1):
                d = r_pt - state.pt.matvec(e_pt)
                e_pt = e_pt + _stage1_pt(state, d, cfg)
        elif cfg.inner_iters > 0:
            # [P2]'s inner-iteration option: a few FGMRES steps on the
            # decoupled (p,T) subsystem, preconditioned by the single-pass
            # block combination (lazy import: solve ← precond at call time)
            from thermalporous_tpu.solve.fgmres import fgmres

            e_pt = fgmres(
                state.pt.matvec,
                r_pt,
                precond=lambda q: _stage1_pt(state, q, cfg),
                rtol=cfg.inner_rtol,
                maxiter=cfg.inner_iters,
            ).x
        else:
            e_pt = _stage1_pt(state, r_pt, cfg)
        x1 = jnp.zeros_like(r).at[0:2].set(e_pt)
        x1_active, k_active = e_pt, 2
        if state.a_ss is not None:
            # saturation leg of the triangular stage 1 (CPTRS): correct
            # the S residual through the S←(p,T) couplings, then smooth
            # the decoupled scalar transport operator directly
            r_s = (w[2] - state.a_sp.matvec(e_pt[0])
                   - state.a_st.matvec(e_pt[1]))
            e_s = _s_smooth(state.a_ss, r_s, cfg)
            x1 = x1.at[2].set(e_s)
            x1_active, k_active = None, None   # x₁ now has full support
    else:
        with jax.named_scope("stage1_p"):
            e_p = gmg_apply(state.gmg_p, w[0], cfg.gmg)
        x1 = jnp.zeros_like(r).at[0].set(e_p)
        x1_active, k_active = e_p[None], 1

    # stage 2: multiplicative smoother correction on the full system
    if cfg.stage2 == "none":
        return x1
    with jax.named_scope("stage2"):
        return x1 + _stage2(state, r, x1, x1_active, k_active, cfg)


def _stage2(state: CPRState, r: jax.Array, x1: jax.Array, x1_active,
            k_active, cfg: CPRConfig) -> jax.Array:
    """Stage-2 correction x₂ ≈ M₂⁻¹(r − A·x₁) on the full system."""
    if cfg.stage2 not in ("block_jacobi", "jacobi2", "rbgs", "zebra",
                          "bgmg"):
        raise ValueError(f"unknown stage2 {cfg.stage2!r}")
    # stage-2 residual r − A·x₁: when x₁'s trailing components are zero
    # (s_stage == "none"), stream only the block columns it is supported
    # on — bit-exact (stencil.matvec_cols docstring)
    if (cfg.stage2_cols and k_active is not None
            and k_active < state.stencil.nc):
        r2 = r - state.stencil.matvec_cols(x1_active, k_active)
    else:
        r2 = r - state.stencil.matvec(x1)
    if cfg.stage2 == "block_jacobi":
        return apply_blocks(state.dinv, r2)
    if cfg.stage2 == "jacobi2":
        x2 = apply_blocks(state.dinv, r2)
        return x2 + cfg.stage2_omega * apply_blocks(
            state.dinv, r2 - state.stencil.matvec(x2))
    if cfg.stage2 == "rbgs":
        from thermalporous_tpu.precond.chebyshev import (
            block_red_black_gauss_seidel,
            block_rbgs_fused_zero,
        )

        if cfg.stage2_fused:
            x2 = block_rbgs_fused_zero(
                state.stencil, state.dinv_red, state.dinv_black, r2,
                axes=cfg.stage2_axes)
            if cfg.stage2_sweeps > 1:
                x2 = block_red_black_gauss_seidel(
                    state.stencil, state.dinv, r2, x=x2,
                    sweeps=cfg.stage2_sweeps - 1)
            return x2
        return block_red_black_gauss_seidel(
            state.stencil, state.dinv, r2, sweeps=cfg.stage2_sweeps,
            axes=cfg.stage2_axes,
        )
    if cfg.stage2 == "zebra":
        from thermalporous_tpu.precond.chebyshev import block_zebra_line_gs

        return block_zebra_line_gs(
            state.stencil, r2, axis=cfg.stage2_axis,
            sweeps=cfg.stage2_sweeps, omega=cfg.stage2_omega,
            factor=state.zebra_fac,
        )
    from thermalporous_tpu.precond.block_gmg import block_gmg_apply

    return block_gmg_apply(
        state.bgmg, r2, cfg.gmg,
        sweeps=cfg.stage2_sweeps, cycles=cfg.bgmg_cycles,
    )


# ---------------------------------------------------------------- registry

def make_preconditioner(name: str, cfg: CPRConfig | None = None):
    """Return (setup, apply) closures for a named preconditioner.

    Names mirror the reference's solver-parameter presets (SURVEY.md §2.1):
    "none", "jacobi" (per-cell block-Jacobi), "rbgs" (one-stage red-black
    block Gauss–Seidel, the parallel ILU-analog), "lu" (exact dense
    inverse — the reference's direct-LU preset; tiny grids only), "cpr",
    "cptr".
    """
    name = name.lower()
    if name == "none":
        return (lambda st: None, lambda state, r: r)
    if name == "lu":
        # the reference's `pc_type: lu` debugging preset: exact solve as the
        # preconditioner (FGMRES converges in 1 iteration).  Dense inverse,
        # not LU factors: triangular solves are sequential, inv·r is one
        # matvec.  O((nc·N)²) memory — guard against production misuse.
        def lu_setup(st):
            import math as _math

            n = st.nc * _math.prod(st.grid_shape)
            if n > 20000:
                raise ValueError(
                    f"'lu' preconditioner is dense ({n}² entries); use it "
                    "only on tiny grids (debugging/ablation, SURVEY.md §2.1)"
                )
            from thermalporous_tpu.precond.gmg import dense_inv

            return dense_inv(st.to_dense())

        def lu_apply(inv, r):
            return (inv @ r.reshape(-1)).reshape(r.shape)

        return (lu_setup, lu_apply)
    if name == "jacobi":
        return (
            lambda st: st.diag_inverse(),
            lambda dinv, r: apply_blocks(dinv, r),
        )
    if name == "rbgs":
        from thermalporous_tpu.precond.chebyshev import (
            block_red_black_gauss_seidel,
        )

        return (
            lambda st: (st, st.diag_inverse()),
            lambda state, r: block_red_black_gauss_seidel(
                state[0], state[1], r, sweeps=2
            ),
        )
    if name in ("cpr", "cptr"):
        cfg = cfg or CPRConfig()
        cfg = dataclasses.replace(cfg, variant=name)
        return (
            lambda st: cpr_setup(st, cfg),
            lambda state, r: cpr_apply(state, r, cfg),
        )
    raise ValueError(f"unknown preconditioner {name!r}")
