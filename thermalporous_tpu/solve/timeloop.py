"""Simulation driver: backward-Euler time loop with adaptive Δt.

Equivalent of the reference's ``ThermalModel.solve()``
(``thermalporous/thermalmodel.py`` upstream, unverified — SURVEY.md §2.1):
a host-side Python loop driving one fully-jitted ``advance(u_old, dt)``
(Newton + FGMRES + preconditioner in a single XLA program).  The host owns
only the Δt policy and telemetry — the reference's division of labour
between its Python loop and PETSc, minus the per-iteration host crossings.

Δt controller (mechanism HIGH-confidence, exact factors config — SURVEY.md
§2.1): grow Δt by ``growth`` after an easy step (few Newton iterations),
shrink by ``cutback`` and retry on divergence, clip to hit ``t_end``.
"""

from __future__ import annotations

import dataclasses
import time
import numpy as np
from typing import Callable

import jax
import jax.numpy as jnp

from thermalporous_tpu.models.base import ProblemData, ThermalModelBase
from thermalporous_tpu.precond.cpr import (
    CPRConfig,
    make_preconditioner,
    resolve_adaptive_coarsening,
)
from thermalporous_tpu.solve.newton import (
    NewtonConfig,
    NewtonStats,
    _scoped,
    newton_solve,
)


def make_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
):
    """Build the jittable full implicit step ``advance(u_old, dt, data)``.

    The single step factory shared by the Simulator, the benchmark and the
    driver entry points — one Newton solve (assembly, CPTR setup, FGMRES,
    line search) as one XLA program, with material-balance-scaled
    convergence norms.
    """
    pc_setup, pc_apply = make_preconditioner(precond, pc_cfg)

    chop = None
    if newton_cfg.ds_max is not None and model.nc >= 3:
        ds_max = float(newton_cfg.ds_max)
        # component mask instead of slicing/concatenating the state axis:
        # one elementwise pass over the update
        comp = np.arange(model.nc).reshape((model.nc,) + (1,) * model.grid.dim)
        is_sat = jnp.asarray(comp == 2)

        def chop(u, dx):
            # Appleyard chop: clamp |ΔS_w| per cell, and the post-update
            # saturation to its physical range
            ds = jnp.clip(dx, -ds_max, ds_max)
            ds = jnp.clip(ds, -u, 1.0 - u)
            return jnp.where(is_sat, ds, dx)

    # named scopes label the layers in device traces (tools/gpu_profile.py)
    def advance(u_old, dt, data, u_guess=None):
        return newton_solve(
            residual=_scoped("residual",
                             lambda u: model.residual(u, u_old, dt, data)),
            jvp_at=lambda u: _scoped(
                "jvp", model.jvp(u, u_old, dt, data)),
            assemble=_scoped(
                "assemble",
                lambda u: model.assemble_stencil(u, u_old, dt, data)),
            pc_setup=pc_setup,
            pc_apply=pc_apply,
            u0=u_old if u_guess is None else u_guess,
            cfg=newton_cfg,
            scale=model.residual_scales(u_old, dt, data),
            # a predictor guess moves only the start point: anchor the
            # rtol target on the physical step start so the converged
            # tolerance is identical to an unpredicted run
            norm_from=None if u_guess is None else u_old,
            chop=chop,
        )

    return advance


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockStats:
    """Per-step telemetry of one jitted multi-step block (arrays of length
    ``n_steps``; entries beyond the last active step are zero)."""

    newton: jax.Array      # (n,) int32
    ksp: jax.Array         # (n,) int32
    retries: jax.Array     # (n,) int32
    dt_used: jax.Array     # (n,) accepted Δt per step
    ok: jax.Array          # (n,) bool — step accepted
    norm0: jax.Array       # (n,) initial residual norm
    norm: jax.Array        # (n,) final residual norm
    # (n, nc) per-step implicit-Euler source integral Δtₙ·Q(uₙ), computed
    # IN-DEVICE on each accepted step so the material/energy balance audit
    # closes in blocked mode too (io/balance.py; the intermediate states
    # themselves are never materialized)
    src_dt: jax.Array


def make_block_step_fn(
    model: ThermalModelBase,
    precond: str = "cptr",
    newton_cfg: NewtonConfig = NewtonConfig(),
    pc_cfg: CPRConfig | None = None,
    time_cfg: "TimeConfig" = None,
    n_steps: int = 8,
):
    """Jitted MULTI-step driver: ``n_steps`` adaptive timesteps — including
    the Δt controller's grow/cutback/retry logic — as ONE XLA program.

    Why: every host dispatch+fetch costs a round trip, which can dominate
    easy steps whose actual compute is a few ms.  The reference pays an
    analogous price in Python↔PETSc crossings per step; here the whole
    controller is scalar arithmetic, so it runs on-device and the host syncs
    once per block (SURVEY.md §2.1).

    Semantics match the host loop in :class:`Simulator.run` exactly: per
    step, attempt the Newton solve at the current Δt, halve-and-retry on
    failure (≤ ``max_retries``), then grow/shrink the next Δt by the
    iteration-count policy.  A step that exhausts its retries marks the
    block 'dead': subsequent steps no-op and the host raises, as the host
    loop would.  Reaching ``t_end`` likewise halts in-device.

    Returns ``block(u, dt, t, t_end, data, dt_cap) -> (u, dt, t, dead,
    dt_cap, BlockStats)`` where ``dt``/``t``/``dt_cap`` are f64 scalars
    when x64 is live (matching the host loop's Python-float Δt arithmetic
    bit-for-bit); ``dt_cap`` is the failure-memory regrowth cap
    (``TimeConfig.fail_frac``; pass/ignore +inf when disabled).
    """
    tc = time_cfg if time_cfg is not None else TimeConfig()
    advance = make_step_fn(model, precond, newton_cfg, pc_cfg)
    sdt = jnp.float64 if jax.config.x64_enabled else jnp.float32

    def block(u, dt, t, t_end, data, dt_cap=float("inf")):
        dt = jnp.asarray(dt, sdt)
        t = jnp.asarray(t, sdt)
        t_end = jnp.asarray(t_end, sdt)
        dt_cap = jnp.asarray(dt_cap, sdt)
        zi = jnp.zeros((n_steps,), jnp.int32)
        zf = jnp.zeros((n_steps,), sdt)
        stats = BlockStats(newton=zi, ksp=zi, retries=zi, dt_used=zf,
                           ok=jnp.zeros((n_steps,), bool), norm0=zf, norm=zf,
                           src_dt=jnp.zeros((n_steps, model.nc), sdt))

        def step_body(i, carry):
            u, dt, t, dead, cap, S = carry
            past_end = t >= t_end - 1e-12 * jnp.maximum(t_end, 1.0)
            inactive = jnp.logical_or(dead, past_end)
            # clip to the remaining time exactly as the host loop does
            # (min(dt, dt_max, t_end - t), NO dt_min floor — flooring here
            # would overshoot t_end by up to dt_min on the final partial
            # step); the tiny floor only guards against a non-positive Δt
            # in the traced-but-inactive case, where it is never used
            dt_eff0 = jnp.minimum(jnp.minimum(dt, tc.dt_max),
                                  jnp.maximum(t_end - t, 1e-30))

            dummy = NewtonStats(
                iters=jnp.asarray(0), ksp_iters=jnp.asarray(0),
                norm0=jnp.asarray(0.0, u.dtype),
                norm=jnp.asarray(0.0, u.dtype),
                converged=jnp.asarray(False), failed=jnp.asarray(True),
            )

            def attempt_cond(c):
                a, dt_try, u_new, st, ok, _cap = c
                # give up like the host loop: retries exhausted, OR the
                # last attempt already failed at the dt_min floor (the
                # host raises on `dt <= dt_min` after a failure even with
                # retries remaining — run(), dt_min check below)
                at_floor = jnp.logical_and(a > 0, dt_try <= tc.dt_min)
                return jnp.logical_and(
                    jnp.logical_not(jnp.logical_or(ok, inactive)),
                    jnp.logical_and(a <= tc.max_retries,
                                    jnp.logical_not(at_floor)),
                )

            def attempt_body(c):
                a, dt_try, _, _, _, cap_a = c
                # first pass uses dt_eff0 EXACTLY (no dt_min floor — the
                # host's final partial step can be below dt_min); later
                # passes are the controller's floored halving retries
                dt_new = jnp.where(a == 0, dt_eff0,
                                   jnp.maximum(dt_try * tc.cutback, tc.dt_min))
                u2, s2 = advance(u, dt_new.astype(u.dtype), data)
                if tc.fail_frac is not None:
                    # failure memory: every failed attempt lowers the
                    # regrowth cap (matches the host loop per attempt)
                    cap_a = jnp.where(
                        s2.failed,
                        jnp.minimum(cap_a, dt_new * tc.fail_frac), cap_a)
                return (a + 1, dt_new, u2, s2, jnp.logical_not(s2.failed),
                        cap_a)

            init = (jnp.asarray(0), dt_eff0, u, dummy,
                    jnp.asarray(False), cap)
            a, dt_used, u_new, st, ok, cap = jax.lax.while_loop(
                attempt_cond, attempt_body, init
            )

            # implicit-Euler source integral Δt·Q at the ACCEPTED state
            # (one cheap well/heater reduction per step; masked on reject —
            # a rejected u_new may be non-finite, so mask q itself first)
            q = model.source_totals(u_new, data).astype(sdt)
            q = jnp.where(ok, jnp.where(jnp.isfinite(q), q, 0.0), 0.0)

            u = jnp.where(ok, u_new, u)
            t = t + jnp.where(ok, dt_used, 0.0)
            dead = jnp.logical_or(
                dead, jnp.logical_and(jnp.logical_not(ok),
                                      jnp.logical_not(inactive))
            )
            grow = st.iters < tc.grow_below
            shrink = st.iters > tc.shrink_above
            grow_lim = jnp.minimum(dt_used * tc.growth, tc.dt_max)
            if tc.fail_frac is not None:
                # relax the wall memory on each accepted step, then cap
                # regrowth below the remembered failure Δt (host parity);
                # dt_min floor as in the host loop — the cap from a
                # failure just above dt_min must not push dt below it
                cap = jnp.where(ok, cap * tc.fail_relax, cap)
                grow_lim = jnp.maximum(jnp.minimum(grow_lim, cap),
                                       tc.dt_min)
            dt_next = jnp.where(
                grow, grow_lim,
                jnp.where(shrink,
                          jnp.maximum(dt_used * tc.cutback, tc.dt_min),
                          dt_used),
            )
            dt = jnp.where(ok, dt_next, dt)
            S = BlockStats(
                newton=S.newton.at[i].set(jnp.where(ok, st.iters, 0)),
                ksp=S.ksp.at[i].set(jnp.where(ok, st.ksp_iters, 0)),
                retries=S.retries.at[i].set(jnp.maximum(a - 1, 0)),
                dt_used=S.dt_used.at[i].set(jnp.where(ok, dt_used, 0.0)),
                ok=S.ok.at[i].set(ok),
                norm0=S.norm0.at[i].set(st.norm0.astype(sdt)),
                norm=S.norm.at[i].set(st.norm.astype(sdt)),
                src_dt=S.src_dt.at[i].set(jnp.where(ok, dt_used, 0.0) * q),
            )
            return (u, dt, t, dead, cap, S)

        u, dt, t, dead, dt_cap, stats = jax.lax.fori_loop(
            0, n_steps, step_body,
            (u, dt, t, jnp.asarray(False), dt_cap, stats)
        )
        return u, dt, t, dead, dt_cap, stats

    return block


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    dt_init: float = 3600.0
    dt_min: float = 1.0
    dt_max: float = 1e7
    growth: float = 1.5          # Δt multiplier after an easy step
    cutback: float = 0.5         # Δt multiplier on failure / hard step
    grow_below: int = 6          # grow when newton_iters < this
    shrink_above: int = 10       # shrink next Δt when newton_iters > this
    max_retries: int = 12
    # Failure memory (the ECLIPSE TUNING-style regrowth cap; None = off).
    # Without it the controller bounces against a Δt wall indefinitely:
    # grow → fail → cutback-retry → grow → fail …, paying the failed
    # attempts every other step (the measured full-SPE10 ramp behavior at
    # dt=76.8 ks).  With it, every FAILED attempt at dt_f
    # caps subsequent regrowth at ``fail_frac·dt_f``, and the cap relaxes
    # by ``fail_relax`` per accepted step so a wall that moves with the
    # physics is re-probed every few steps instead of every step.
    # Controller-state note: the cap is part of the Δt policy state but
    # is NOT persisted by checkpoints; a resume starts with the cap
    # released (one extra wall probe), everything else exact.
    fail_frac: float | None = None
    fail_relax: float = 1.25
    # Newton initial guess: "none" = previous state (the PETSc/reference
    # default), "linear" = extrapolate u + (Δt/Δt_prev)·(u − u_prev) with
    # saturation clipped to its physical range — the converged answer is
    # unchanged (same rootfind, same tolerance), only the start point moves
    predictor: str = "none"
    # >1 = advance this many adaptive steps per host dispatch as ONE XLA
    # program (make_block_step_fn): amortizes the host round trip over
    # the block.  Callbacks/checkpoints then fire at block
    # boundaries only, per-step wall times are block averages, and the
    # "linear" predictor is not applied (host-loop-only feature).
    block_steps: int = 1


@dataclasses.dataclass
class StepRecord:
    """One accepted timestep's telemetry (JSONL-friendly)."""

    step: int
    t: float
    dt: float
    newton_iters: int
    ksp_iters: int
    retries: int
    residual_norm0: float
    residual_norm: float
    wall_s: float
    next_dt: float = 0.0  # controller's Δt for the FOLLOWING step (resume)
    # failure-memory regrowth cap active AFTER this step (TimeConfig.
    # fail_frac; None = no active cap).  Saved by CheckpointManager so a
    # resumed run keeps the wall memory — without it a resume right after
    # a failed probe would immediately re-attempt the known-failing Δt.
    dt_cap: float | None = None
    # True when the ``u`` passed alongside this record is the state AT
    # ``t``.  False only for the intermediate records of a jitted
    # multi-step block (block_steps>1), whose states are never
    # materialized — state-consuming callbacks (checkpoints, VTK) must
    # skip those or they would pair a later state with an earlier clock.
    state_consistent: bool = True
    # per-equation implicit-Euler source integral Δtₙ·Q(uₙ) of THIS step,
    # computed in-device by the blocked loop (BlockStats.src_dt) so the
    # balance audit closes without materializing intermediate states;
    # None on host-loop records (the auditor evaluates Q(uₙ) itself there)
    src_dt: tuple | None = None

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SimResult:
    u: jax.Array
    t: float
    steps: int
    records: list
    total_newton: int
    total_ksp: int
    wall_s: float


class Simulator:
    """Owns the jitted step and the adaptive-Δt host loop."""

    def __init__(
        self,
        model: ThermalModelBase,
        data: ProblemData,
        precond: str = "cptr",
        pc_cfg: CPRConfig | None = None,
        newton_cfg: NewtonConfig = NewtonConfig(),
        time_cfg: TimeConfig = TimeConfig(),
    ):
        self.model = model
        self.data = data
        self.newton_cfg = newton_cfg
        self.time_cfg = time_cfg
        if pc_cfg is not None and (
            pc_cfg.gmg.coarsen == "adaptive"
            or (getattr(pc_cfg, "gmg_t", None) is not None
                and pc_cfg.gmg_t.coarsen == "adaptive")
        ):
            # bake the matrix-dependent coarsening schedule (host-side, once:
            # coupling ratios are geometry-driven, so any representative
            # state/Δt yields the same schedule — see plan_coarsening)
            u0 = model.initial_state(data)
            st = model.assemble_stencil(
                u0, u0, jnp.asarray(time_cfg.dt_init, u0.dtype), data
            )
            pc_cfg = resolve_adaptive_coarsening(st, pc_cfg)
        self.pc_cfg = pc_cfg
        self._precond_name = precond
        fn = make_step_fn(model, precond, newton_cfg, pc_cfg)
        self._advance = jax.jit(fn)
        self._advance_from = jax.jit(
            lambda u_old, dt, data, u_guess: fn(u_old, dt, data, u_guess)
        )

    def step(self, u_old: jax.Array, dt: float, u_guess: jax.Array | None = None):
        """One Newton solve (no Δt adaptivity); returns (u, stats).

        ``u_guess`` optionally overrides the Newton start point (the
        predictor path); the converged answer is unchanged."""
        dt = jnp.asarray(dt, dtype=u_old.dtype)
        if u_guess is None:
            return self._advance(u_old, dt, self.data)
        return self._advance_from(u_old, dt, self.data, u_guess)

    def _run_blocked(self, t_end, u, dt, t, step0, max_steps, callback,
                     verbose, dt_cap0=None):
        """Block-dispatch run loop: ``tc.block_steps`` adaptive steps per
        host round trip (see ``make_block_step_fn``)."""
        tc = self.time_cfg
        if not hasattr(self, "_block"):
            self._block = jax.jit(
                make_block_step_fn(
                    self.model, self._precond_name, self.newton_cfg,
                    self.pc_cfg, tc, n_steps=tc.block_steps,
                )
            )
        records: list[StepRecord] = []
        run_start = time.perf_counter()
        step_idx = step0
        # failure-memory cap, threaded across blocks (resume-seeded)
        dt_cap = float("inf") if dt_cap0 is None else float(dt_cap0)

        while t < t_end - 1e-12 * max(t_end, 1.0) and step_idx < max_steps:
            blk_start = time.perf_counter()
            u, dt_a, t_a, dead, cap_a, stats = self._block(
                u, dt, t, t_end, self.data, dt_cap)
            # ONE bulk transfer of the scalar outputs + stats arrays
            dt, t, dead, dt_cap, stats = jax.device_get(
                (dt_a, t_a, dead, cap_a, stats))
            dt_cap = float(dt_cap)
            blk_wall = time.perf_counter() - blk_start
            dt, t = float(dt), float(t)
            n_ok = int(stats.ok.sum())
            if n_ok:
                per_step_wall = blk_wall / n_ok
                for i in range(tc.block_steps):
                    if not bool(stats.ok[i]):
                        continue
                    step_idx += 1
                    rec = StepRecord(
                        step=step_idx,
                        t=float("nan"),  # filled below (cumulative)
                        dt=float(stats.dt_used[i]),
                        newton_iters=int(stats.newton[i]),
                        ksp_iters=int(stats.ksp[i]),
                        retries=int(stats.retries[i]),
                        residual_norm0=float(stats.norm0[i]),
                        residual_norm=float(stats.norm[i]),
                        wall_s=per_step_wall,
                        src_dt=tuple(float(x) for x in stats.src_dt[i]),
                    )
                    records.append(rec)
                # cumulative times: walk back from the block-final t
                acc = t
                for rec in reversed(records[-n_ok:]):
                    rec.t = acc
                    rec.next_dt = dt
                    acc -= rec.dt
                # the block-final cap pairs with the block-final record
                # (the only state-consistent, checkpointable one)
                records[-1].dt_cap = (
                    dt_cap if dt_cap != float("inf") else None
                )
                if verbose:
                    last = records[-1]
                    print(
                        f"block -> step {step_idx:4d}  t={t:.4e}  "
                        f"dt={last.dt:.3e}  newton={last.newton_iters}  "
                        f"ksp={last.ksp_iters}"
                    )
                # intermediate states are not materialized in block mode:
                # every callback receives the BLOCK-FINAL u, so only the
                # final record is marked state-consistent; CheckpointManager/
                # PVDWriter skip the others (metrics keeps per-step cadence)
                for rec in records[-n_ok:-1]:
                    rec.state_consistent = False
                if callback is not None:
                    for rec in records[-n_ok:]:
                        callback(rec.step, rec.t, u, rec)
            if bool(dead):
                raise RuntimeError(
                    f"blocked run: Newton failed and retries were exhausted "
                    f"near t={t:.4e} (dt={dt:.3e})"
                )
            if n_ok == 0:
                break  # t_end reached inside the block

        return SimResult(
            u=u,
            t=t,
            steps=len(records),
            records=records,
            total_newton=sum(r.newton_iters for r in records),
            total_ksp=sum(r.ksp_iters for r in records),
            wall_s=time.perf_counter() - run_start,
        )

    def _predict(self, u, u_prev, dt, dt_prev):
        """Linear-extrapolation initial guess, saturation clipped to [0,1]."""
        fac = jnp.asarray(dt / max(dt_prev, 1e-30), dtype=u.dtype)
        g = u + fac * (u - u_prev)
        if u.shape[0] >= 3:
            g = g.at[2].set(jnp.clip(g[2], 0.0, 1.0))
        return g

    def run(
        self,
        t_end: float,
        u0: jax.Array | None = None,
        dt0: float | None = None,
        t0: float = 0.0,
        step0: int = 0,
        max_steps: int = 100000,
        callback: Callable[[int, float, jax.Array, StepRecord], None] | None = None,
        verbose: bool = False,
        dt_cap0: float | None = None,
    ) -> SimResult:
        """Advance from (t0, u0) to t_end.  ``t0``/``step0``/``dt_cap0``
        support exact resume from a checkpoint (state, clock AND the
        failure-memory Δt cap)."""
        tc = self.time_cfg
        u = self.model.initial_state(self.data) if u0 is None else u0
        t = t0
        dt = tc.dt_init if dt0 is None else dt0
        if tc.block_steps > 1:
            return self._run_blocked(
                t_end, u, dt, t, step0, max_steps, callback, verbose,
                dt_cap0=dt_cap0,
            )
        records: list[StepRecord] = []
        run_start = time.perf_counter()
        step_idx = step0
        u_prev = None
        dt_prev = 0.0
        # failure-memory regrowth cap (fail_frac), resume-seeded
        dt_cap = float("inf") if dt_cap0 is None else float(dt_cap0)

        while t < t_end - 1e-12 * max(t_end, 1.0) and step_idx < max_steps:
            dt = min(dt, tc.dt_max, t_end - t)
            retries = 0
            step_start = time.perf_counter()
            while True:
                guess = None
                if tc.predictor == "linear" and u_prev is not None:
                    guess = self._predict(u, u_prev, dt, dt_prev)
                u_new, stats = self.step(u, dt, guess)
                # one bulk transfer of the stats pytree instead of one
                # host round trip per field
                stats = jax.device_get(stats)
                failed = bool(stats.failed)
                if not failed:
                    break
                if tc.fail_frac is not None:
                    dt_cap = min(dt_cap, dt * tc.fail_frac)
                retries += 1
                if retries > tc.max_retries or dt <= tc.dt_min:
                    raise RuntimeError(
                        f"step {step_idx}: Newton failed at dt={dt:.3e} after "
                        f"{retries - 1} retries (|F| {float(stats.norm):.3e} of "
                        f"{float(stats.norm0):.3e})"
                    )
                dt = max(dt * tc.cutback, tc.dt_min)

            t += dt
            step_idx += 1
            rec = StepRecord(
                step=step_idx,
                t=t,
                dt=dt,
                newton_iters=int(stats.iters),
                ksp_iters=int(stats.ksp_iters),
                retries=retries,
                residual_norm0=float(stats.norm0),
                residual_norm=float(stats.norm),
                wall_s=time.perf_counter() - step_start,
            )
            # Δt policy for the next step (applied before callbacks so
            # checkpoints capture the controller state for exact resume)
            if tc.fail_frac is not None and dt_cap != float("inf"):
                dt_cap *= tc.fail_relax  # relax the wall memory per accept
            rec.dt_cap = dt_cap if dt_cap != float("inf") else None
            if rec.newton_iters < tc.grow_below:
                # dt_min floor: a failure just above dt_min can push the
                # cap below the floor; without the max() the next step
                # would run below dt_min and a failure there aborts with
                # zero retries (the dt <= dt_min guard)
                dt = max(min(dt * tc.growth, tc.dt_max, dt_cap), tc.dt_min)
            elif rec.newton_iters > tc.shrink_above:
                dt = max(dt * tc.cutback, tc.dt_min)
            rec.next_dt = dt

            records.append(rec)
            u_prev, dt_prev = u, rec.dt
            u = u_new
            if verbose:
                print(
                    f"step {step_idx:4d}  t={t:.4e}  dt={rec.dt:.3e}  "
                    f"newton={rec.newton_iters}  ksp={rec.ksp_iters}  "
                    f"retries={retries}"
                )
            if callback is not None:
                callback(step_idx, t, u, rec)

        return SimResult(
            u=u,
            t=t,
            steps=len(records),  # steps taken THIS run (resume-aware)
            records=records,
            total_newton=sum(r.newton_iters for r in records),
            total_ksp=sum(r.ksp_iters for r in records),
            wall_s=time.perf_counter() - run_start,
        )

    def run_schedule(
        self,
        schedule,
        t_end: float,
        u0: jax.Array | None = None,
        dt0: float | None = None,
        t0: float = 0.0,
        step0: int = 0,
        max_steps: int = 100000,
        callback: Callable[[int, float, jax.Array, StepRecord], None] | None = None,
        verbose: bool = False,
        dt_cap0: float | None = None,
    ) -> SimResult:
        """Advance to ``t_end`` under piecewise-constant well/heater controls.

        ``schedule`` is a sequence of ``(t_start, WellFields)`` pairs
        (build each entry with ``physics.wells.build_well_fields``; the
        first ``t_start`` must be ≤ ``t0``): segment *i*'s controls apply
        on ``[t_i, t_{i+1})``.  The time loop lands a step EXACTLY on
        every boundary (the usual ``t_end`` clamp), so controls switch at
        their scheduled instant.  Well fields are jit *data*, not shapes —
        every segment reuses the same compiled step, and the Δt
        controller's state (current Δt AND the failure-memory cap)
        threads across boundaries like an exact resume.

        Callbacks that close over problem data (e.g. ``BalanceAuditor``)
        are rebound per segment via their optional ``set_data(data)`` hook.

        The reference has no control schedules (static constructor-arg
        wells — SURVEY.md §2.7); this is the standard production-simulator
        extension of that case layer.
        """
        segs = sorted(schedule, key=lambda s: s[0])
        if not segs or segs[0][0] > t0:
            raise ValueError(
                f"schedule must start at/before t0={t0} (first segment at "
                f"{segs[0][0] if segs else 'none'})"
            )
        u = self.model.initial_state(self.data) if u0 is None else u0
        t, step, dt = t0, step0, (self.time_cfg.dt_init if dt0 is None else dt0)
        dt_cap = dt_cap0  # resume-seeded failure-memory cap
        records: list[StepRecord] = []
        run_start = time.perf_counter()

        for i, (ts, wf) in enumerate(segs):
            te = segs[i + 1][0] if i + 1 < len(segs) else t_end
            te = min(te, t_end)
            if te <= t or step >= max_steps:
                continue  # segment entirely before the window (resume)
            self.data = dataclasses.replace(self.data, wells=wf)
            if callback is not None and hasattr(callback, "set_data"):
                callback.set_data(self.data)
            # max_steps is an absolute step-index cap, exactly as in run()
            res = self.run(
                t_end=te, u0=u, dt0=dt, t0=t, step0=step, max_steps=max_steps,
                callback=callback, verbose=verbose, dt_cap0=dt_cap,
            )
            records.extend(res.records)
            u, t, step = res.u, res.t, step + res.steps
            if res.records:
                dt = res.records[-1].next_dt or dt
                dt_cap = res.records[-1].dt_cap
            if t >= t_end - 1e-12 * max(t_end, 1.0):
                break

        return SimResult(
            u=u,
            t=t,
            steps=len(records),
            records=records,
            total_newton=sum(r.newton_iters for r in records),
            total_ksp=sum(r.ksp_iters for r in records),
            wall_s=time.perf_counter() - run_start,
        )
