"""Newton's method with backtracking line search, jit-native.

Replacement for PETSc SNES ``newtonls`` as the reference drives
it (SURVEY.md §2.12–2.16, §3.1): a ``lax.while_loop`` over Newton
iterations, each of which

  1. assembles the block stencil and builds the preconditioner state,
  2. solves J·dx = −F with right-preconditioned FGMRES (matrix-free J),
  3. backtracks α ∈ {1, ½, ¼, …} until sufficient decrease of ‖F‖.

The whole solve is one XLA program: no host round-trips per iteration, so
per-step dispatch overhead is one launch regardless of iteration counts.
Divergence (line search exhausted / non-finite residual) sets a ``failed``
flag consumed by the adaptive-Δt controller — the reference's behavior of
signalling SNES divergence up to the time loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from thermalporous_tpu.solve.fgmres import fgmres, reduce_dtype


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    max_iters: int = 15
    rtol: float = 1e-6            # ‖F‖ ≤ max(rtol·‖F₀‖, atol)
    atol: float = 0.0
    ksp_rtol: float = 1e-5        # PETSc KSP default
    ksp_atol: float = 0.0
    ksp_maxiter: int = 60
    # Eisenstat–Walker adaptive forcing (PETSc SNES ``-snes_ksp_ew``,
    # version 2 — the reference can flip this on any SNES-driven solve,
    # SURVEY.md §2.13): the k-th linear solve's relative tolerance is
    #   η_k = γ·(‖F_k‖/‖F_{k−1}‖)^α,   η_0 = ew_rtol0,
    # safeguarded by η_k ← max(η_k, γ·η_{k−1}^α) whenever the previous
    # forcing still "matters" (γ·η_{k−1}^α > ew_threshold), so the
    # tolerance cannot collapse after one lucky iteration.  η is clipped
    # to [ksp_rtol, ew_rtolmax]: ``ksp_rtol`` acts as the FLOOR — with
    # ksp_basis="bf16" the basis' honest true-residual floor is ~4e-3
    # (fgmres.py docstring), and EW must not request tolerances the storage
    # cannot certify.  Newton still gates on the true residual norm, so
    # the accepted answer is unchanged; only the inner work adapts.
    # When material-balance scales are active the inner system is
    # left-scaled by them so η, the contraction ratio, and the
    # line-search norm all live in the same (scaled) norm — without
    # this the loose early solves are not descent directions for the
    # scaled norm and Newton line-search-fails (see body comment).
    ksp_ew: bool = False
    ew_rtol0: float = 0.3         # PETSc snes_ksp_ew_rtol0
    ew_rtolmax: float = 0.9       # PETSc snes_ksp_ew_rtolmax
    ew_gamma: float = 1.0         # PETSc snes_ksp_ew_gamma (version 2)
    ew_alpha: float = 1.618033988749895   # (1+√5)/2, PETSc default
    ew_threshold: float = 0.1     # PETSc snes_ksp_ew_threshold
    # FGMRES(r) restart cycles (None = one cycle of ksp_maxiter).  PETSc's
    # KSP default is restart 30; here it is also a bandwidth lever — the
    # CGS2 orthogonalization streams the full static basis every iteration,
    # so Krylov traffic scales with the cycle size, not the total budget.
    ksp_restart: int | None = None
    # Arnoldi-basis storage dtype: "same" (compute dtype) or "bf16".  The
    # CGS2 sweeps stream the full static basis 4× per FGMRES iteration —
    # the solve's dominant memory traffic (tools/roofline.py) — and bf16
    # storage halves it; projections accumulate in f32 and
    # the second CGS pass absorbs the coarser basis rounding.  The
    # flexible basis Z and the solution stay full precision.
    ksp_basis: str = "same"
    # Gram–Schmidt passes: "cgs2" (default — one reorthogonalization,
    # MGS-grade stability), "cgs1" (PETSc's KSPGMRES default: single
    # classical pass, no refinement — measured LOSER end-to-end, it
    # collapses trajectories exactly on the hard steps), or
    # "cgs2s" (selective: the second pass runs only when Rutishauser's
    # cancellation criterion fires — CGS2 stability where it matters,
    # CGS1 traffic where it doesn't; see fgmres.orth_selective), or the
    # low-synchronization Gram-matrix CGS2 variants (fgmres.orth_gram):
    # "cgs2g" (3 basis reads/iteration instead of CGS2's 4; the new Gram
    # column from real dots — exact-of-stored even with ksp_basis="bf16")
    # and "cgs2g2" (2 reads; fully algebraic Gram update).
    ksp_orth: str = "cgs2"
    # Krylov-subspace recycling dimension (0 = off).  k > 0 carries a
    # k-column recycle space across the Newton iterations of a solve
    # (FGCRO-DR-style deflation, solve/deflate.py): each linear solve is
    # deflated by the k slowest modes harvested from the previous one.
    # The dt-ramp wall on full SPE10 is a handful of slow coupled
    # (p,T,S) modes that every Newton iteration otherwise rediscovers
    # — exactly the recycling use case.
    # Incompatible with ksp_restart.
    ksp_recycle: int = 0
    max_backtracks: int = 6
    ls_decrease: float = 1e-4     # accept if ‖F(u+αdx)‖ ≤ (1 − c·α)·‖F(u)‖
    # Line-search acceptance: "armijo" (default — sufficient decrease) or
    # "nonmonotone" (accept any finite residual up to (1+ls_growth)·‖F‖,
    # with divergence policed by ls_div_ratio against the step-start norm).
    # The nonmonotone mode is the standard companion of the Appleyard chop:
    # a locally-clamped update is not a descent direction for the GLOBAL
    # norm while the front advances cell-by-cell (measured: chopped hard
    # SPE10 steps fail Armijo in iteration 1, tools/spe10_iters.py r3), so
    # production simulators accept the physics-bounded update and judge
    # failure by blow-up, not by per-iteration monotonicity.
    ls_mode: str = "armijo"
    ls_growth: float = 0.25       # nonmonotone: allowed fractional increase
    ls_div_ratio: float = 4.0     # fail when ‖F‖ exceeds this × ‖F₀‖
    # Appleyard-style saturation chop (None = off): per-cell clamp of the
    # saturation component of each Newton update to |ΔS| ≤ ds_max, and of
    # the target saturation to [0, 1].  Line search alone globalizes badly
    # on day-scale reservoir steps — a uniform α must shrink the WHOLE
    # update to tame a handful of front cells — while the chop is local, so
    # the rest of the domain keeps its full Newton step.  Standard
    # production-simulator practice (Appleyard/ECLIPSE heuristic; the
    # reference delegates globalization to PETSc SNES line search only —
    # SURVEY.md §2.13 — which is exactly what fails past dt≈21 h on full
    # SPE10, docs/parity.md).  Applied via the ``chop`` hook that
    # make_step_fn wires for models with a saturation component.
    ds_max: float | None = None
    # "every": rebuild the preconditioner each Newton iteration (the
    # reference's behavior); "step": build once from the step's initial
    # state and reuse — the common "frozen CPR" production trade: the Krylov
    # operator stays the exact current Jacobian, only the preconditioner
    # lags, costing a few extra FGMRES iterations but saving the
    # per-iteration multigrid setup.
    pc_lag: str = "every"
    # Krylov operator realization — BOTH are the exact Jacobian (the TPFA
    # residual couples each cell only to its face neighbours, so ∂R/∂u IS
    # the block 7-point stencil; tests assert jvp/stencil/dense agreement):
    #   "stencil": assemble the block stencil once per Newton iteration and
    #     matvec with it — transcendental-free, bandwidth-bound; measured
    #     ~2x faster per FGMRES iteration than re-evaluating the property
    #     correlations inside jvp at 1024² f32, and the same assembly feeds
    #     the preconditioner when pc_lag="every".
    #   "jvp": matrix-free jax.jvp closure (no stencil materialization).
    krylov_op: str = "stencil"

    def __post_init__(self):
        # typo'd string options must fail loudly, not silently degrade to
        # the default code path (e.g. ksp_basis="bfloat16" measuring the
        # full-precision basis); mirrors CPRConfig.pc_dtype's ValueError
        _check = {
            "ksp_basis": ("same", "bf16"),
            "ksp_orth": ("cgs2", "cgs1", "cgs2s", "cgs2g", "cgs2g2"),
            "ls_mode": ("armijo", "nonmonotone"),
            "pc_lag": ("every", "step"),
            "krylov_op": ("stencil", "jvp"),
        }
        for field, allowed in _check.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"unknown {field} {v!r}; one of {allowed}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NewtonStats:
    iters: jax.Array          # Newton iterations performed
    ksp_iters: jax.Array      # total FGMRES iterations
    norm0: jax.Array          # initial residual norm
    norm: jax.Array           # final residual norm
    converged: jax.Array      # bool
    failed: jax.Array         # bool: line search exhausted / non-finite


def _scoped(name: str, fn: Callable) -> Callable:
    """``fn`` traced under ``jax.named_scope(name)`` (trace labels)."""
    def scoped(*args, **kwargs):
        with jax.named_scope(name):
            return fn(*args, **kwargs)
    return scoped


def newton_solve(
    residual: Callable[[jax.Array], jax.Array],
    jvp_at: Callable[[jax.Array], Callable[[jax.Array], jax.Array]],
    assemble: Callable[[jax.Array], object],
    pc_setup: Callable[[object], object],
    pc_apply: Callable[[object, jax.Array], jax.Array],
    u0: jax.Array,
    cfg: NewtonConfig = NewtonConfig(),
    scale: jax.Array | None = None,
    norm_from: jax.Array | None = None,
    chop: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
) -> tuple[jax.Array, NewtonStats]:
    """Solve residual(u) = 0 starting from ``u0``.

    Args:
      residual: u ↦ F(u), state-shaped.
      jvp_at: u ↦ (v ↦ J(u)·v).
      assemble: u ↦ BlockStencil of J(u) (preconditioner input only).
      pc_setup/pc_apply: preconditioner factory and application.
      scale: optional per-cell residual scales (``model.residual_scales``);
        when given, convergence and line-search norms are the RMS of F/scale
        (dimensionless "fraction of cell content per step"), and a
        dtype-aware absolute floor is applied so float32 runs terminate at
        their rounding floor instead of stalling.
      norm_from: optional state whose residual anchors the rtol-based
        tolerance (and reported ``norm0``) instead of ``u0``'s.  The
        predictor path passes the PHYSICAL step start here so an
        extrapolated initial guess — whose residual is typically much
        smaller — does not silently tighten the convergence target.
      chop: optional per-iteration update limiter ``(u, dx) -> dx`` applied
        to the Newton direction BEFORE the line search (PETSc's
        SNESLineSearchPostCheck slot; used for the Appleyard saturation
        chop, see ``NewtonConfig.ds_max``).  Must leave dx a descent
        direction in the active region — clamps qualify.
    """

    # convergence/line-search norms accumulate in f64 under f32 state when
    # x64 is live (SURVEY.md §5.8; see fgmres.reduce_dtype)
    rd = reduce_dtype(u0.dtype)
    if scale is None:
        def norm(f):
            q = f.astype(rd)
            return jnp.sqrt(jnp.sum(q * q)).astype(f.dtype)
        atol = cfg.atol
    else:
        def norm(f):
            q = (f / scale).astype(rd)
            return jnp.sqrt(jnp.sum(q * q) / q.size).astype(f.dtype)
        eps = float(jnp.finfo(u0.dtype).eps)
        atol = max(cfg.atol, 50.0 * eps)

    f0 = residual(u0)
    nrm_start = norm(f0)
    if norm_from is not None:
        # rtol anchors on the step-start residual, not the (possibly
        # extrapolated) guess.  SAFEGUARD: an extrapolation across an
        # advancing front under aggressive Δt growth can land OUTSIDE the
        # step-start residual ball — measured: +3 Newton over a 12 h ramp
        # (tests/test_variants.py) — so when the guess's residual is worse
        # than the physical step start's, discard it and start there; the
        # predictor then costs at most the one residual evaluation this
        # comparison reuses.
        f_ref = residual(norm_from)
        nrm0 = norm(f_ref)
        use_guess = nrm_start <= nrm0
        u0 = jnp.where(use_guess, u0, norm_from)
        f0 = jnp.where(use_guess, f0, f_ref)
        nrm_start = jnp.where(use_guess, nrm_start, nrm0)
    else:
        nrm0 = nrm_start
    tol = jnp.maximum(cfg.rtol * nrm0, atol)

    frozen_pcs = pc_setup(assemble(u0)) if cfg.pc_lag == "step" else None

    recycle = int(cfg.ksp_recycle)
    if recycle > 0 and cfg.ksp_restart is not None:
        raise ValueError("ksp_recycle is incompatible with ksp_restart")

    ew = bool(cfg.ksp_ew)
    # carry layout: (u, f, nrm, k, ksp, failed) [+ (U, umask)] [+ eta]
    eta_idx = 6 + (2 if recycle > 0 else 0)

    def cond(carry):
        u, f, nrm, k, ksp, failed = carry[:6]
        go = jnp.logical_and(nrm > tol, k < cfg.max_iters)
        return jnp.logical_and(go, jnp.logical_not(failed))

    def body(carry):
        u, f, nrm, k, ksp, failed = carry[:6]
        if recycle > 0:
            U, umask = carry[6], carry[7]
        rtol_k = carry[eta_idx] if ew else cfg.ksp_rtol

        if cfg.krylov_op == "stencil":
            st = assemble(u)            # exact J; one assembly serves both
            matvec = st.matvec
            pcs = (frozen_pcs if cfg.pc_lag == "step"
                   else _scoped("pc_setup", pc_setup)(st))
        else:
            matvec = jvp_at(u)
            pcs = (frozen_pcs if cfg.pc_lag == "step"
                   else _scoped("pc_setup", pc_setup)(assemble(u)))
        if ew and scale is not None:
            # EW requires the inner tolerance to live in the SAME norm
            # Newton gates (and line-searches) on.  FGMRES controls the
            # UNSCALED L2 residual, but the material-balance scales vary
            # over orders of magnitude, so an η-accurate-in-L2 step can
            # concentrate its error on the small-scale rows and fail to be
            # a descent direction for the scaled RMS norm (measured:
            # 1-ksp-iteration solves Armijo-failing at 8.6e-3 scaled on
            # the 8² two-phase case).  Fix: left-scale the linear system
            # by the scales — FGMRES then enforces η on ‖(F+J·dx)/s‖₂ /
            # ‖F/s‖₂, exactly the scaled-norm contraction the forcing
            # theory assumes (the RMS 1/√N cancels in the ratio).  Right
            # preconditioning is untouched: the PC still sees the
            # unscaled residual.
            mv_u = matvec
            matvec = lambda v: mv_u(v) / scale
            rhs = -(f / scale)
            krylov_pc = lambda r: pc_apply(pcs, r * scale)
        else:
            rhs = -f
            krylov_pc = lambda r: pc_apply(pcs, r)
        matvec = _scoped("matvec", matvec)
        krylov_pc = _scoped("precond", krylov_pc)
        if recycle > 0:
            from thermalporous_tpu.solve.deflate import fgmres_dr

            result, U, umask = fgmres_dr(
                matvec,
                rhs,
                precond=krylov_pc,
                U=U,
                u_mask=umask,
                rtol=rtol_k,
                atol=cfg.ksp_atol,
                maxiter=cfg.ksp_maxiter,
                basis_dtype=jnp.bfloat16 if cfg.ksp_basis == "bf16" else None,
                # the deflated solver implements neither the selective
                # second pass nor the Gram-matrix variants; "cgs2s"/
                # "cgs2g"/"cgs2g2" safely degrade to plain CGS2 here
                orth_passes=1 if cfg.ksp_orth == "cgs1" else 2,
            )
        else:
            result = _scoped("fgmres", fgmres)(
                matvec,
                rhs,
                precond=krylov_pc,
                rtol=rtol_k,
                atol=cfg.ksp_atol,
                maxiter=cfg.ksp_maxiter,
                restart=cfg.ksp_restart,
                basis_dtype=jnp.bfloat16 if cfg.ksp_basis == "bf16" else None,
                orth_passes=1 if cfg.ksp_orth == "cgs1" else 2,
                orth_selective=cfg.ksp_orth == "cgs2s",
                orth_gram={"cgs2g": 3, "cgs2g2": 2}.get(cfg.ksp_orth, 0),
            )
        dx = result.x
        if chop is not None:
            dx = chop(u, dx)

        def ls_cond(c):
            alpha, tries, accepted, u_t, f_t, n_t = c
            return jnp.logical_and(
                jnp.logical_not(accepted), tries < cfg.max_backtracks
            )

        if cfg.ls_mode == "nonmonotone":
            accept_cap = (1.0 + cfg.ls_growth) * nrm
        else:
            accept_cap = None

        def ls_body(c):
            alpha, tries, accepted, u_t, f_t, n_t = c
            u_try = u + alpha * dx
            f_try = residual(u_try)
            n_try = norm(f_try)
            if accept_cap is None:
                bound = (1.0 - cfg.ls_decrease * alpha) * nrm
            else:
                bound = accept_cap
            ok = jnp.logical_and(jnp.isfinite(n_try), n_try <= bound)
            return (alpha * 0.5, tries + 1, ok, u_try, f_try, n_try)

        init = (jnp.asarray(1.0, dtype=u.dtype), jnp.asarray(0), jnp.asarray(False),
                u, f, nrm)
        with jax.named_scope("line_search"):
            _, _, accepted, u_new, f_new, n_new = jax.lax.while_loop(
                ls_cond, ls_body, init)

        failed_now = jnp.logical_not(accepted)
        if accept_cap is not None:
            # nonmonotone divergence guard: blow-up past the step-start
            # residual is the failure signal the Armijo test no longer gives
            failed_now = jnp.logical_or(
                failed_now, n_new > cfg.ls_div_ratio * nrm0
            )
        # on failure keep the old iterate; the Δt controller will retry
        u_new = jnp.where(failed_now, u, u_new)
        f_new = jnp.where(failed_now, f, f_new)
        n_new = jnp.where(failed_now, nrm, n_new)
        out = (u_new, f_new, n_new, k + 1, ksp + result.iters, failed_now)
        if recycle > 0:
            out = out + (U, umask)
        if ew:
            # Eisenstat–Walker version-2 update.  The contraction ratio is
            # measured in the scaled RMS norm — the SAME norm the (now
            # left-scaled) inner solve enforces η in and the line search
            # gates on; norm consistency is what makes the forcing theory
            # hold (see the left-scaling comment above).
            # A failed step keeps η — the Δt controller aborts anyway.
            eta = rtol_k
            ratio = n_new / jnp.maximum(nrm, jnp.finfo(u.dtype).tiny)
            eta_a = cfg.ew_gamma * ratio ** cfg.ew_alpha
            eta_safe = cfg.ew_gamma * eta ** cfg.ew_alpha
            eta_next = jnp.where(
                eta_safe > cfg.ew_threshold, jnp.maximum(eta_a, eta_safe), eta_a
            )
            eta_next = jnp.clip(eta_next, cfg.ksp_rtol, cfg.ew_rtolmax)
            out = out + (jnp.where(failed_now, eta, eta_next).astype(u.dtype),)
        return out

    carry = (u0, f0, nrm_start, jnp.asarray(0), jnp.asarray(0),
             jnp.asarray(False))
    if recycle > 0:
        from thermalporous_tpu.solve.deflate import empty_recycle

        carry = carry + empty_recycle(u0.shape, recycle, u0.dtype)
    if ew:
        eta0 = min(max(cfg.ew_rtol0, cfg.ksp_rtol), cfg.ew_rtolmax)
        carry = carry + (jnp.asarray(eta0, dtype=u0.dtype),)
    final = jax.lax.while_loop(cond, body, carry)
    u, f, nrm, k, ksp, failed = final[:6]

    converged = nrm <= tol
    stats = NewtonStats(
        iters=k, ksp_iters=ksp, norm0=nrm0, norm=nrm,
        converged=converged,
        failed=jnp.logical_or(failed, jnp.logical_not(converged)),
    )
    return u, stats
