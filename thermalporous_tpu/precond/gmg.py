"""Geometric multigrid on scalar 7-point stencils.

Structured-grid replacement for hypre BoomerAMG, which the reference invokes for
the stage-1 pressure/temperature solves of CPR/CPTR (SURVEY.md §2.8,
§2.12–2.16).  On structured grids algebraic multigrid is dead weight: the
grid hierarchy is known, so we use cell-centred geometric multigrid with

- piecewise-constant interpolation P (injection) and its adjoint summation
  restriction R — the natural DG0/finite-volume pair;
- Galerkin coarse operators A_c = R·A·P, which for a 7-point stencil stay
  7-point and reduce to masked block sums of the fine coefficients (a few
  elementwise reductions; no sparse products);
- Chebyshev (or damped-Jacobi) smoothing — fully parallel, replacing ILU;
- a dense inverse on the coarsest level (≤ ~max_coarse_cells cells).

Heterogeneity (SPE10-class contrast) is carried by the Galerkin coarsening
of the transmissibility-weighted fine stencil; SURVEY.md §7 hard part #1
tracks its limits — the FGMRES wrapper absorbs a mediocre cycle.

Odd grid sizes coarsen raggedly (last coarse cell holds one fine cell), so
any shape — e.g. SPE10's 60×220×85 — has a full hierarchy.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from thermalporous_tpu.core.stencil import ScalarStencil
from thermalporous_tpu.precond.chebyshev import (
    chebyshev,
    gershgorin_lambda_max,
    line_jacobi,
    red_black_gauss_seidel,
    weighted_jacobi,
    zebra_line_gs,
)


@dataclasses.dataclass(frozen=True)
class GMGConfig:
    """Static multigrid configuration."""

    smoother: str = "chebyshev"       # "chebyshev" | "jacobi" | "rbgs" |
                                      # "line" (line-Jacobi) | "zebra"
    line_axis: int = -1               # strong axis for line smoothers (z)
    degree: int = 2                   # smoothing steps pre and post
    lam_min_frac: float = 0.3         # Chebyshev smoothing interval lower end
    jacobi_omega: float = 0.8
    max_coarse_cells: int = 64        # stop coarsening at/below this size
    max_levels: int = 16
    cycles: int = 1                   # cycles per apply
    # K-cycle default: on SPE10-class contrast it cuts FGMRES counts ~3x vs
    # plain V-cycles (41 -> 14 per Newton measured on the channelized layer)
    # at lower wall time; "v" remains the cheap option for easy problems.
    cycle_type: str = "k"             # "v" | "w" | "k" (Krylov-accelerated)
    # levels smaller than this fall back to a single recursive cycle: tiny
    # grids are launch-latency-bound; 256 keeps most of the K-cycle's
    # iteration benefit (13.7 -> 15.8 on the SPE10 layer vs 23.4 at 1024)
    kcycle_min_cells: int = 256
    # semicoarsening: never coarsen the LAST grid axis (3D z) while other
    # axes remain coarsenable — the classic fix for strong vertical coupling
    # from thin, high-transmissibility layers (SPE10: dz ≈ dx/10)
    semicoarsen_z: bool = False
    # matrix-dependent coarsening (the AGMG/strength-of-connection idea on a
    # structured grid): an explicit per-level schedule of coarsening factors,
    # e.g. ((1, 1, 2), (1, 1, 2), (2, 2, 2), ...) — aggregate only along
    # strongly-coupled axes.  Produced by :func:`plan_coarsening` from the
    # actual operator (host-side, once per problem — coupling ratios are set
    # by geometry/permeability, not by Δt, so the schedule is static under
    # jit).  None = geometric full coarsening (+ semicoarsen_z if set).
    # Levels beyond the schedule fall back to the geometric rule.
    level_factors: tuple[tuple[int, ...], ...] | None = None
    # "geometric" = fixed full coarsening (+ semicoarsen_z); "adaptive" asks
    # the host-side caller (Simulator / cpr.resolve_adaptive_coarsening) to
    # bake a matrix-dependent ``level_factors`` schedule before jitting.
    coarsen: str = "geometric"
    # grid transfer: "constant" = injection P / summation R (baseline);
    # "weighted" = Kwak/BoxMG-style operator-weighted prolongation with the
    # same summation R — coarse operators leave the 5/7-point class and
    # become wide (9/27-point) stencils via 3^dim-colour Galerkin probing
    # (precond/transfer.py; SURVEY.md §7 hard part 1).  "variational" = the
    # same weighted P with R = Pᵀ and EXACT A_c = PᵀAP on the per-axis-width
    # box class (±2 support along coarsened axes) — the Galerkin-safe pair
    # that tolerates aggressive (low-floor) weights; see transfer_floor.
    # On wide/box levels only chebyshev/jacobi smoothing is available
    # (rbgs/line colourings assume axis-aligned couplings); other smoothers
    # fall back to chebyshev there.
    transfer: str = "constant"
    # parent-weight floor for weighted/variational P: ¾ is mandatory for the
    # Petrov–Galerkin "weighted" pair (divergent below — dense analysis in
    # tests/test_transfer.py); "variational" is stable at any floor and
    # tracks heterogeneity harder at lower values (0.5 measured best).
    transfer_floor: float = 0.75
    # multi-chip coarse-level strategy (SURVEY.md §5.8): levels at/below
    # this many cells are constrained FULLY REPLICATED (one all-gather at
    # the restriction that crosses the threshold), so deep-cycle smoothing
    # runs collective-free instead of on degenerate one-cell-per-device
    # shards.  Requires ``mesh``; inert when mesh is None (single chip).
    replicate_below: int = 4096
    mesh: object | None = None  # jax.sharding.Mesh threaded from the caller


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GMGState:
    """Per-Newton-iteration multigrid hierarchy (a pytree)."""

    stencils: tuple  # ScalarStencil level 0; WideStencil below if weighted
    lam_max: tuple[jax.Array, ...]
    coarse_inv: jax.Array  # dense inverse of the coarsest operator
    # per fine-level tuple of AxisWeights|None when transfer="weighted",
    # else an empty tuple (static pytree structure per config)
    transfers: tuple = ()


def _blocksum(
    x: jax.Array, fine_shape: tuple[int, ...], factors: tuple[int, ...] | None = None
) -> jax.Array:
    """Sum over 2-cell blocks on factor-2 axes (ragged tail zero-padded)."""
    for axis in range(len(fine_shape)):
        if factors is not None and factors[axis] == 1:
            continue
        n = x.shape[axis]
        if n % 2 == 1:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (0, 1)
            x = jnp.pad(x, pad)
        m = x.shape[axis] // 2
        new_shape = x.shape[:axis] + (m, 2) + x.shape[axis + 1 :]
        x = x.reshape(new_shape).sum(axis=axis + 1)
    return x


def _prolong(
    e: jax.Array, fine_shape: tuple[int, ...], factors: tuple[int, ...] | None = None
) -> jax.Array:
    """Piecewise-constant injection back to the fine grid."""
    for axis in range(len(fine_shape)):
        if factors is not None and factors[axis] == 1:
            continue
        e = jnp.repeat(e, 2, axis=axis)
        n = fine_shape[axis]
        if e.shape[axis] != n:
            e = jax.lax.slice_in_dim(e, 0, n, axis=axis)
    return e


def galerkin_coarsen(
    st: ScalarStencil, factors: tuple[int, ...] | None = None
) -> ScalarStencil:
    """A_c = R·A·P with summation restriction / injection prolongation.

    ``factors[a] ∈ {1, 2}`` selects per-axis coarsening (semicoarsening
    skips the strongly-coupled axis — SPE10's thin-cell vertical direction).
    Cell-centric form: a fine face along a factor-2 axis is interior to a
    coarse cell iff its lower cell has an even a-index; such couplings fold
    into the coarse diagonal, the rest into the coarse off-diagonals.
    Factor-1 axes keep all their couplings as off-diagonals.
    """
    shape = st.grid_shape
    dim = len(shape)
    if factors is None:
        factors = (2,) * dim

    def axis_mask(axis: int, even: bool) -> jax.Array:
        idx = jnp.arange(shape[axis])
        m = (idx % 2 == 0) if even else (idx % 2 == 1)
        view = [1] * dim
        view[axis] = shape[axis]
        return m.astype(st.diag.dtype).reshape(view)

    d = st.diag
    for a in range(dim):
        if factors[a] == 2:
            d = d + st.upper[a] * axis_mask(a, even=True)
            d = d + st.lower[a] * axis_mask(a, even=False)

    bs = lambda x: _blocksum(x, shape, factors)
    coarse_d = bs(d)
    coarse_up, coarse_lo = [], []
    for a in range(dim):
        if factors[a] == 2:
            coarse_up.append(bs(st.upper[a] * axis_mask(a, even=False)))
            coarse_lo.append(bs(st.lower[a] * axis_mask(a, even=True)))
        else:
            coarse_up.append(bs(st.upper[a]))
            coarse_lo.append(bs(st.lower[a]))
    return ScalarStencil(diag=coarse_d, upper=tuple(coarse_up), lower=tuple(coarse_lo))


def _level_factors(
    shape: tuple[int, ...], cfg: GMGConfig, level: int | None = None
) -> tuple[int, ...]:
    if (
        cfg.level_factors is not None
        and level is not None
        and level < len(cfg.level_factors)
    ):
        # matrix-dependent schedule; clamp factor 2 -> 1 on exhausted axes
        return tuple(
            f if n > 1 else 1 for f, n in zip(cfg.level_factors[level], shape)
        )
    factors = [2 if n > 1 else 1 for n in shape]
    if cfg.semicoarsen_z and len(shape) == 3 and any(
        n > 1 for n in shape[:2]
    ):
        factors[2] = 1
    return tuple(factors)


def axis_strengths(st: ScalarStencil) -> tuple[float, ...]:
    """Mean |coupling| per axis of a CONCRETE scalar stencil (host-side).

    The strength-of-connection measure behind :func:`plan_coarsening`:
    smoothing leaves error smooth along strongly-coupled axes, so those are
    the axes worth aggregating (classical anisotropic-multigrid rule; the
    structured-grid form of AGMG's strength-guided pairwise aggregation).
    """
    # reduce on device, fetch the per-axis scalars in one transfer
    vals = [
        jnp.mean(jnp.abs(up)) + jnp.mean(jnp.abs(lo))
        for up, lo in zip(st.upper, st.lower)
    ]
    return tuple(float(v) for v in jax.device_get(vals))


def plan_coarsening(
    st: ScalarStencil,
    cfg: GMGConfig = GMGConfig(),
    theta: float = 0.25,
) -> tuple[tuple[int, ...], ...]:
    """Matrix-dependent per-level coarsening schedule from a concrete stencil.

    Walks the actual Galerkin hierarchy of ``st`` (host-side, once per
    problem): at each level, coarsen only the axes whose mean coupling
    strength is ≥ ``theta`` × the strongest axis — e.g. on SPE10 geometry
    (Δz ≈ Δx/10 ⇒ vertical transmissibility ~30× horizontal) the first
    levels aggregate along z only, until the coarse operator's anisotropy
    equilibrates, then coarsen all axes.  This is the structured-grid
    counterpart of BoomerAMG's operator-dependent coarsening — the role the
    reference delegates to hypre (SURVEY.md §7 hard part #1).

    The coupling RATIOS are set by grid geometry and permeability, not by
    the Newton state or Δt (those move the diagonal), so the schedule is
    computed once and baked into :class:`GMGConfig` as a static — shapes
    under ``jit`` stay static while the hierarchy remains operator-adapted.

    Returns the factor schedule; bake it in with
    ``dataclasses.replace(cfg, level_factors=plan_coarsening(st, cfg))``.
    """
    schedule: list[tuple[int, ...]] = []
    level = st
    while (
        math.prod(level.grid_shape) > cfg.max_coarse_cells
        and len(schedule) < cfg.max_levels - 1
        and any(n > 1 for n in level.grid_shape)
    ):
        s = axis_strengths(level)
        smax = max(
            (v for v, n in zip(s, level.grid_shape) if n > 1), default=0.0
        )
        factors = tuple(
            2 if (n > 1 and (smax <= 0.0 or v >= theta * smax)) else 1
            for v, n in zip(s, level.grid_shape)
        )
        if all(f == 1 for f in factors):  # degenerate: coarsen strongest axis
            a = max(range(len(s)), key=lambda i: (level.grid_shape[i] > 1, s[i]))
            factors = tuple(2 if i == a else 1 for i in range(len(s)))
        schedule.append(factors)
        level = galerkin_coarsen(level, factors)
    return tuple(schedule)


def _replicated(x: jax.Array, cfg: GMGConfig) -> jax.Array:
    """Constrain ``x`` fully replicated over cfg.mesh (no-op without mesh)."""
    if cfg.mesh is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.lax.with_sharding_constraint(
        x, NamedSharding(cfg.mesh, PartitionSpec())
    )


def _maybe_replicate_level(st: ScalarStencil, cfg: GMGConfig) -> ScalarStencil:
    if cfg.mesh is None or math.prod(st.grid_shape) > cfg.replicate_below:
        return st
    return jax.tree.map(lambda a: _replicated(a, cfg), st)


def dense_inv(a: jax.Array) -> jax.Array:
    """Dense inverse of a small operator, in the operand's dtype."""
    return jnp.linalg.inv(a)


def gmg_setup(st: ScalarStencil, cfg: GMGConfig = GMGConfig()) -> GMGState:
    """Build the multigrid hierarchy for one stencil (per Newton iteration)."""
    stencils = [_maybe_replicate_level(st, cfg)]
    transfers = []
    while (
        math.prod(stencils[-1].grid_shape) > cfg.max_coarse_cells
        and len(stencils) < cfg.max_levels
        and any(n > 1 for n in stencils[-1].grid_shape)
    ):
        level = stencils[-1]
        factors = _level_factors(level.grid_shape, cfg, level=len(stencils) - 1)
        if cfg.transfer in ("weighted", "variational"):
            from thermalporous_tpu.precond.transfer import (
                galerkin_variational,
                galerkin_wide,
                transfer_weights,
            )

            w = transfer_weights(level, factors, floor=cfg.transfer_floor)
            coarse_shape = tuple(
                -(-n // 2) if f == 2 else n
                for n, f in zip(level.grid_shape, factors)
            )
            transfers.append(w)
            if cfg.transfer == "variational":
                nxt = galerkin_variational(level, w, coarse_shape)
            else:
                nxt = galerkin_wide(level, w, coarse_shape)
        else:
            nxt = galerkin_coarsen(level, factors)
        stencils.append(_maybe_replicate_level(nxt, cfg))

    def _lam(s):
        # Gershgorin is tight on the M-matrix-like scalar/summation levels
        # but overestimates the VARIATIONAL box levels ~10–15× (PᵀAP rows
        # carry heavy sign cancellation; measured true |λ|max ≈ 2.7 vs
        # Gershgorin 37 on a channelized crop), which parks the Chebyshev
        # interval far above the spectrum and disables smoothing there.
        # Power-iterate D⁻¹A on those levels instead (a few matvecs per
        # setup, deterministic start, 15% safety margin).
        if cfg.transfer == "variational" and not isinstance(s, ScalarStencil):
            from thermalporous_tpu.utils import power_iteration

            dinv = 1.0 / s.diag
            lam = power_iteration(
                lambda v: dinv * s.matvec(v), s.grid_shape,
                dtype=s.diag.dtype, iters=12,
            )
            return 1.15 * lam
        return gershgorin_lambda_max(s)

    lam_max = tuple(_lam(s) for s in stencils[:-1])
    # Dense inverse, not an LU: the K-cycle visits the coarsest level many
    # times per application, and triangular solves are sequential while
    # inv·b is one small matvec.  Inversion happens once per preconditioner
    # setup on a tiny, diagonally-shifted operator.
    dense = stencils[-1].to_dense()
    return GMGState(
        stencils=tuple(stencils),
        lam_max=lam_max,
        coarse_inv=dense_inv(dense),
        transfers=tuple(transfers),
    )


def _is_wide(st) -> bool:
    return not isinstance(st, ScalarStencil)


def _smooth(st, lam, b, x, cfg: GMGConfig):
    if _is_wide(st) and cfg.smoother not in ("chebyshev", "jacobi"):
        # rbgs/line/zebra colourings assume axis-aligned couplings; wide
        # (box-support) levels smooth with Chebyshev instead
        return chebyshev(
            st, b, x, degree=cfg.degree, lam_max=lam,
            lam_min_frac=cfg.lam_min_frac,
        )
    if cfg.smoother == "chebyshev":
        return chebyshev(
            st, b, x, degree=cfg.degree, lam_max=lam, lam_min_frac=cfg.lam_min_frac
        )
    if cfg.smoother == "rbgs":
        return red_black_gauss_seidel(st, b, x, sweeps=cfg.degree)
    if cfg.smoother == "line":
        return line_jacobi(st, b, x, axis=cfg.line_axis, sweeps=cfg.degree)
    if cfg.smoother == "zebra":
        return zebra_line_gs(st, b, x, axis=cfg.line_axis, sweeps=cfg.degree)
    return weighted_jacobi(st, b, x, sweeps=cfg.degree, omega=cfg.jacobi_omega)


def _coarse_correction(state: GMGState, level: int, rc: jax.Array, cfg: GMGConfig):
    """Approximate A_{level}⁻¹ rc according to the cycle type.

    - "v": one recursive cycle;
    - "w": two recursive cycles (multiplicative);
    - "k": Notay-style K-cycle — two recursive cycles combined by a 2-step
      flexible-CG update, which keeps multigrid robust when the cycle is a
      weak contraction (the SPE10-contrast regime; SURVEY.md §7 hard part #1).
    """
    e1 = _v_cycle(state, level, rc, cfg)
    if (
        cfg.cycle_type == "v"
        or level == len(state.stencils) - 1
        or math.prod(state.stencils[level].grid_shape) < cfg.kcycle_min_cells
    ):
        return e1
    a_mat = state.stencils[level].matvec
    if cfg.cycle_type == "w":
        r1 = rc - a_mat(e1)
        return e1 + _v_cycle(state, level, r1, cfg)
    # K-cycle: flexible CG(2) on A_level preconditioned by one cycle
    v1 = a_mat(e1)
    rho1 = jnp.vdot(v1, e1)
    alpha1 = jnp.vdot(rc, e1)
    safe = jnp.where(jnp.abs(rho1) > 0, rho1, 1.0)
    x = (alpha1 / safe) * e1
    r1 = rc - (alpha1 / safe) * v1
    e2 = _v_cycle(state, level, r1, cfg)
    v2 = a_mat(e2)
    gamma = jnp.vdot(v1, e2)
    beta = jnp.vdot(v2, e2)
    alpha2 = jnp.vdot(r1, e2)
    rho2 = beta - gamma * gamma / safe
    safe2 = jnp.where(jnp.abs(rho2) > 0, rho2, 1.0)
    x = x + (alpha2 / safe2) * (e2 - (gamma / safe) * e1)
    return x


def _v_cycle(state: GMGState, level: int, b: jax.Array, cfg: GMGConfig) -> jax.Array:
    # one scope per level: device traces attribute each kernel to the
    # innermost gmg_L<k> (tools/gpu_profile.py)
    with jax.named_scope(f"gmg_L{level}"):
        return _v_cycle_level(state, level, b, cfg)


def _v_cycle_level(state: GMGState, level: int, b: jax.Array,
                   cfg: GMGConfig) -> jax.Array:
    if level == len(state.stencils) - 1:
        shape = state.stencils[level].grid_shape
        n = math.prod(shape)
        with jax.named_scope("coarse_solve"):
            e = state.coarse_inv @ b.reshape(n)
        return e.reshape(shape)

    st = state.stencils[level]
    lam = state.lam_max[level]
    # per-axis coarsening factors are implied by the (static) level shapes
    fine = st.grid_shape
    coarse = state.stencils[level + 1].grid_shape
    factors = tuple(2 if c < f else 1 for f, c in zip(fine, coarse))
    with jax.named_scope("smooth"):
        x = _smooth(st, lam, b, None, cfg)
    with jax.named_scope("matvec"):
        r = b - st.matvec(x)
    if state.transfers and cfg.transfer == "variational":
        from thermalporous_tpu.precond.transfer import restrict_weighted

        rc = restrict_weighted(r, state.transfers[level])
    else:
        rc = _blocksum(r, fine, factors)
    if cfg.mesh is not None and math.prod(coarse) <= cfg.replicate_below:
        # the all-gather that moves the cycle onto replicated coarse levels
        rc = _replicated(rc, cfg)
    ec = _coarse_correction(state, level + 1, rc, cfg)
    if state.transfers:
        from thermalporous_tpu.precond.transfer import prolong_weighted

        x = x + prolong_weighted(ec, fine, state.transfers[level])
    else:
        x = x + _prolong(ec, fine, factors)
    with jax.named_scope("smooth"):
        return _smooth(st, lam, b, x, cfg)


def gmg_apply(state: GMGState, b: jax.Array, cfg: GMGConfig = GMGConfig()) -> jax.Array:
    """Approximate A⁻¹b with ``cfg.cycles`` V-cycles (the BoomerAMG stand-in)."""
    x = _v_cycle(state, 0, b, cfg)
    for _ in range(cfg.cycles - 1):
        r = b - state.stencils[0].matvec(x)
        x = x + _v_cycle(state, 0, r, cfg)
    return x
