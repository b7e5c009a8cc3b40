"""Discrete adjoint of the implicit time stepper: exact gradients of
trajectory functionals with respect to every array in the problem.

This is a capability the reference stack does not ship (SURVEY.md §2
lists no adjoint/optimization layer; Firedrake's adjoint would require
the separate dolfin-adjoint machinery): history matching and well-control
optimization need dJ/dθ for θ = {permeability/transmissibility fields,
porosity, well controls}, and a JAX-native simulator gets the building
blocks for free — ``jax.vjp`` of the SAME residual function that defines
the forward physics is the exact transposed linearization, including the
upwind ``where`` branch selections (the adjoint of an upwind FV scheme).

Method (adjoint of implicit Euler; j = terminal(u_N, data) +
Σ_k running(u_k, dt_k, data)):

    F_k(u_k, u_{k-1}, dt_k, θ) = 0,             k = 1..N
    (∂F_N/∂u_N)ᵀ μ_N = (∂j/∂u_N)ᵀ
    λ_{k-1} = (∂j/∂u_{k-1})ᵀ − (∂F_k/∂u_{k-1})ᵀ μ_k
    (∂F_k/∂u_k)ᵀ μ_k = λ_k
    dJ/dθ  = ∂j/∂θ − Σ_k (∂F_k/∂θ)ᵀ μ_k
    dJ/du₀ = λ₀

Each backward step is one linear solve with the TRANSPOSED Newton
Jacobian.  The Krylov operator is matrix-free and exact —
``jax.vjp(residual)`` in the ``u_new`` slot — and the preconditioner is
the production CPR/CPTR + GMG stack applied to
``BlockStencil.transpose()`` (TPFA ⇒ the assembled stencil IS the
Jacobian, so its transpose is the exact adjoint operator too; the
matrix-free form is kept as the operator for parity with the forward
``krylov_op="jvp"`` default).  One jitted backward-step function is
compiled once and reused for every step (static shapes).

Memory: the backward pass streams the recorded states newest-first;
for long trajectories, pair with checkpoint/resume segments (io/
checkpoint.py) and re-run the forward slice per segment — the classical
revolve trade handled at the driver level, mirroring jax.checkpoint's
FLOPs-for-memory trade inside a step.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from thermalporous_tpu.precond.cpr import CPRConfig, make_preconditioner
from thermalporous_tpu.solve.fgmres import fgmres


@dataclasses.dataclass
class AdjointResult:
    value: jax.Array            # J evaluated on the trajectory
    grad_data: object           # ProblemData-shaped cotangent pytree
    grad_u0: jax.Array          # dJ/du₀ (state-shaped)
    ksp_iters: int              # total FGMRES iterations over the sweep
    converged: bool             # every adjoint solve met its tolerance


def _zeros_like_tree(tree):
    return jax.tree.map(jnp.zeros_like, tree)


# Compiled backward-step functions, cached per model so an optimization
# loop (N calls to adjoint_gradients with the same model/config/shapes)
# traces once instead of once per call — compiles of the CPTR+GMG
# backward program take minutes each.  Weak keys: dropping the
# model drops its cache.  The objective callables are part of the key by
# identity (define them once outside the loop to benefit).
_STEP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached(model, key, build):
    per_model = _STEP_CACHE.setdefault(model, {})
    if key not in per_model:
        per_model[key] = build()
    return per_model[key]


def adjoint_gradients(
    model,
    data,
    states: Sequence[jax.Array],
    dts: Sequence[float],
    terminal: Callable | None = None,
    running: Callable | None = None,
    precond: str = "cptr",
    pc_cfg: CPRConfig | None = None,
    rtol: float = 1e-10,
    maxiter: int = 200,
    recycle: int = 0,
    orth: str = "cgs2",
) -> AdjointResult:
    """Backward sweep over a recorded trajectory.

    Args:
      states: [u_0, u_1, ..., u_N] — the accepted states of a forward run
        (``Simulator.step`` outputs; u_0 the initial state).
      dts: the N accepted step sizes.
      terminal: ``j(u_N, data) -> scalar`` (optional).
      running: ``j(u_k, dt_k, data) -> scalar`` summed over k = 1..N
        (optional; e.g. produced energy: rate(u_k) · dt_k).
      precond/pc_cfg: preconditioner family and tuning; the
        preconditioner is built on the transposed stencil.  (The forward
        NewtonConfig is deliberately NOT taken: the backward sweep is a
        sequence of LINEAR solves with their own tolerance economics —
        e.g. the forward bf16 basis floor (~4e-3) is far above the
        gradient-accuracy rtol below.)
      rtol/maxiter: adjoint linear-solve tolerance (tighter than forward
        ksp_rtol — gradient accuracy is limited by it directly).
      recycle: Krylov-recycling dimension k (0 = off).  The backward
        sweep is a sequence of tightly-toleranced transposed solves whose
        operators drift by ONE accepted step each — the textbook
        GCRO-DR regime (solve/deflate.py) — so a k-column recycle space
        harvested from each solve deflates the next.  (The forward
        Newton sequence is the opposite regime: the slow coupled modes
        are front-localized and move with every Newton update — measured
        LOSS — hence recycling defaults off
        there and on here only by explicit request.)
      orth: Gram–Schmidt variant for the adjoint FGMRES ("cgs2" default;
        "cgs2g"/"cgs2g2" = the low-synch Gram-matrix forms, see
        fgmres.orth_gram — the backward sweep stores a FULL-PRECISION
        basis, exactly the regime where "cgs2g2" halves the dominant
        basis-streaming traffic at tight tolerance).  Ignored when
        ``recycle > 0`` (the deflated solver runs classic CGS2).

    Returns AdjointResult with J, dJ/d(data) as a ProblemData-shaped
    pytree (tgeo/tcond/phi/wells cotangents), and dJ/du₀.
    """
    if terminal is None and running is None:
        raise ValueError("need at least one of terminal/running objective")
    n = len(dts)
    if len(states) != n + 1:
        raise ValueError(f"states ({len(states)}) must be dts+1 ({n + 1})")

    def build_terminal():
        @jax.jit
        def terminal_vjps(u_n, data):
            if terminal is None:
                z = jnp.zeros((), dtype=u_n.dtype)
                return z, jnp.zeros_like(u_n), _zeros_like_tree(data)
            val, vjp = jax.vjp(terminal, u_n, data)
            lam, gd = vjp(jnp.ones_like(val))
            return val, lam, gd

        return terminal_vjps

    def build_running():
        @jax.jit
        def running_vjps(u_k, dt, data):
            if running is None:
                z = jnp.zeros((), dtype=u_k.dtype)
                return z, jnp.zeros_like(u_k), _zeros_like_tree(data)
            val, vjp = jax.vjp(lambda u, d: running(u, dt, d), u_k, data)
            lam, gd = vjp(jnp.ones_like(val))
            return val, lam, gd

        return running_vjps

    def build_backward():
        setup, apply = make_preconditioner(precond, pc_cfg)

        @jax.jit
        def backward_step(u_new, u_old, dt, data, lam, U=None, u_mask=None):
            """Solve (∂F/∂u_new)ᵀ μ = λ, return (λ_prev, ḡ) contributions.

            With ``recycle=0`` (default) the compiled signature is the
            5-argument original — no dummy state-sized recycle arrays ride
            the program."""
            st = model.assemble_stencil(u_new, u_old, dt, data)
            pc_state = setup(st.transpose())

            _, vjp_fn = jax.vjp(
                lambda un, uo, d: model.residual(un, uo, dt, d),
                u_new, u_old, data,
            )

            def matvec_t(v):
                return vjp_fn(v)[0]

            if recycle > 0:
                from thermalporous_tpu.solve.deflate import fgmres_dr

                res, U, u_mask = fgmres_dr(
                    matvec_t, lam,
                    precond=lambda r: apply(pc_state, r),
                    U=U, u_mask=u_mask, rtol=rtol, maxiter=maxiter)
            else:
                res = fgmres(matvec_t, lam,
                             precond=lambda r: apply(pc_state, r),
                             rtol=rtol, maxiter=maxiter,
                             orth_passes=1 if orth == "cgs1" else 2,
                             orth_gram={"cgs2g": 3, "cgs2g2": 2}.get(orth, 0))
            mu = res.x
            _, w_old, w_data = vjp_fn(mu)
            out = (-w_old, jax.tree.map(jnp.negative, w_data),
                   res.iters, res.converged)
            if recycle > 0:
                out = out + (U, u_mask)
            return out

        return backward_step

    pc_key = repr(pc_cfg)
    terminal_vjps = _cached(model, ("term", terminal), build_terminal)
    running_vjps = _cached(model, ("run", running), build_running)
    backward_step = _cached(
        model, ("bwd", precond, pc_key, float(rtol), int(maxiter),
                int(recycle), orth),
        build_backward)

    u_n = states[n]
    value, lam, grad_data = terminal_vjps(u_n, data)
    total_ksp, all_conv = 0, True
    if recycle > 0:
        from thermalporous_tpu.solve.deflate import empty_recycle

        U, u_mask = empty_recycle(u_n.shape, recycle, u_n.dtype)
    for k in range(n, 0, -1):
        dt_k = jnp.asarray(dts[k - 1], dtype=states[k].dtype)
        rval, rlam, rgd = running_vjps(states[k], dt_k, data)
        value = value + rval
        lam = lam + rlam
        grad_data = jax.tree.map(jnp.add, grad_data, rgd)
        if recycle > 0:
            lam_prev, gd, iters, conv, U, u_mask = backward_step(
                states[k], states[k - 1], dt_k, data, lam, U, u_mask)
        else:
            lam_prev, gd, iters, conv = backward_step(
                states[k], states[k - 1], dt_k, data, lam)
        grad_data = jax.tree.map(jnp.add, grad_data, gd)
        lam = lam_prev
        # one host fetch per step
        it, cv = jax.device_get((iters, conv))
        total_ksp += int(it)
        all_conv = all_conv and bool(cv)
    return AdjointResult(value=value, grad_data=grad_data, grad_u0=lam,
                         ksp_iters=total_ksp, converged=all_conv)


def ensemble_adjoint_gradients(
    model,
    data_e,
    states_e: Sequence[jax.Array],
    dts: Sequence[float],
    terminal: Callable | None = None,
    running: Callable | None = None,
    precond: str = "cptr",
    pc_cfg: CPRConfig | None = None,
    rtol: float = 1e-10,
    maxiter: int = 200,
) -> AdjointResult:
    """Batched backward sweep: exact gradients for E realizations at once.

    The ensemble analog of :func:`adjoint_gradients`, composing with the
    forward ensemble axis (``dist/ensemble.py``): every per-step adjoint
    solve is ``vmap``-ped over the leading member axis — one XLA program
    computes E independent history-matching gradients (shard the axis
    with ``dist.shard_ensemble`` for one member per device).  This is a
    capability the reference stack has no analog for: batched adjoints
    of an implicit reservoir simulator in a single program.

    Args:
      data_e: :func:`dist.stack_ensemble`-stacked ProblemData (leading
        axis E on every array leaf).
      states_e: [u_0, …, u_N], each ``(E, nc, *grid)`` — a recorded
        ensemble trajectory (``record_ensemble_trajectory``).
      dts: the N accepted step sizes, SHARED across members (record the
        trajectory with a fixed schedule; per-member adaptive schedules
        would give members different step counts).
      terminal/running: per-member objectives, same signatures as
        :func:`adjoint_gradients` (they see unbatched ``(nc, *grid)``
        states under vmap).

    Returns an AdjointResult whose ``value``/``grad_*`` leaves carry the
    leading E axis and whose ``ksp_iters`` is the vmapped solves' shared
    iteration count total (members run in lockstep; the batched
    while_loop masks early-converged members — the count is the max).

    Constraint (as for ``make_ensemble_step_fn``): an adaptive-coarsening
    ``pc_cfg`` needs a shared explicit ``level_factors`` schedule.
    """
    if terminal is None and running is None:
        raise ValueError("need at least one of terminal/running objective")
    if pc_cfg is not None and pc_cfg.gmg.coarsen == "adaptive" and (
        pc_cfg.gmg.level_factors is None
    ):
        raise ValueError(
            "ensemble adjoints need a shared multigrid schedule: plan "
            "level_factors from a representative member (plan_coarsening) "
            "or use geometric coarsening"
        )
    n = len(dts)
    if len(states_e) != n + 1:
        raise ValueError(f"states ({len(states_e)}) must be dts+1 ({n + 1})")

    def build_terminal():
        def one(u_n, data):
            if terminal is None:
                z = jnp.zeros((), dtype=u_n.dtype)
                return z, jnp.zeros_like(u_n), _zeros_like_tree(data)
            val, vjp = jax.vjp(terminal, u_n, data)
            lam, gd = vjp(jnp.ones_like(val))
            return val, lam, gd

        return jax.jit(jax.vmap(one))

    def build_running():
        def one(u_k, dt, data):
            if running is None:
                z = jnp.zeros((), dtype=u_k.dtype)
                return z, jnp.zeros_like(u_k), _zeros_like_tree(data)
            val, vjp = jax.vjp(lambda u, d: running(u, dt, d), u_k, data)
            lam, gd = vjp(jnp.ones_like(val))
            return val, lam, gd

        return jax.jit(jax.vmap(one, in_axes=(0, None, 0)))

    def build_backward():
        setup, apply = make_preconditioner(precond, pc_cfg)

        def one(u_new, u_old, dt, data, lam):
            st = model.assemble_stencil(u_new, u_old, dt, data)
            pc_state = setup(st.transpose())

            _, vjp_fn = jax.vjp(
                lambda un, uo, d: model.residual(un, uo, dt, d),
                u_new, u_old, data,
            )

            res = fgmres(lambda v: vjp_fn(v)[0], lam,
                         precond=lambda r: apply(pc_state, r),
                         rtol=rtol, maxiter=maxiter)
            _, w_old, w_data = vjp_fn(res.x)
            return (-w_old, jax.tree.map(jnp.negative, w_data),
                    res.iters, res.converged)

        return jax.jit(jax.vmap(one, in_axes=(0, 0, None, 0, 0)))

    pc_key = repr(pc_cfg)
    terminal_vjps = _cached(model, ("eterm", terminal), build_terminal)
    running_vjps = _cached(model, ("erun", running), build_running)
    backward_step = _cached(
        model, ("ebwd", precond, pc_key, float(rtol), int(maxiter)),
        build_backward)

    u_n = states_e[n]
    value, lam, grad_data = terminal_vjps(u_n, data_e)
    total_ksp, all_conv = 0, True
    for k in range(n, 0, -1):
        dt_k = jnp.asarray(dts[k - 1], dtype=states_e[k].dtype)
        rval, rlam, rgd = running_vjps(states_e[k], dt_k, data_e)
        value = value + rval
        lam = lam + rlam
        grad_data = jax.tree.map(jnp.add, grad_data, rgd)
        lam_prev, gd, iters, conv = backward_step(
            states_e[k], states_e[k - 1], dt_k, data_e, lam)
        grad_data = jax.tree.map(jnp.add, grad_data, gd)
        lam = lam_prev
        it, cv = jax.device_get((iters, conv))
        total_ksp += int(it.max())
        all_conv = all_conv and bool(cv.all())
    return AdjointResult(value=value, grad_data=grad_data, grad_u0=lam,
                         ksp_iters=total_ksp, converged=all_conv)


def record_ensemble_trajectory(step_e, u0_e, dts, data_e):
    """Run a fixed-Δt-schedule ensemble forward, recording stacked states.

    ``step_e`` from :func:`dist.make_ensemble_step_fn`; every member must
    converge at every step (fixed schedules forfeit the Δt controller —
    pick one a controller run accepted)."""
    E = u0_e.shape[0]
    states = [u0_e]
    for dt in dts:
        dt_e = jnp.full((E,), float(dt), dtype=u0_e.dtype)
        u, stats = step_e(states[-1], dt_e, data_e)
        conv = jax.device_get(stats.converged)
        if not bool(conv.all()):
            raise RuntimeError(
                f"ensemble forward step dt={dt}: members "
                f"{[int(i) for i in jnp.where(~jnp.asarray(conv))[0]]} "
                f"did not converge")
        states.append(u)
    return states


def record_trajectory(sim, u0, dts):
    """Run the forward model over fixed accepted steps, recording states.

    Thin helper for adjoint workflows: ``Simulator.step`` with the given
    Δt sequence (no controller — adjoint consistency needs the EXACT
    schedule that was accepted; take one from a controller run's
    telemetry when Δt was adaptive).
    """
    states = [u0]
    for dt in dts:
        u, stats = sim.step(states[-1], float(dt))
        if not bool(jax.device_get(stats).converged):
            raise RuntimeError(f"forward step dt={dt} did not converge")
        states.append(u)
    return states
