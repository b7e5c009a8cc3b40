"""Flexible GMRES (right-preconditioned), jit-native.

Replacement for PETSc KSP FGMRES (SURVEY.md §2.12–2.16): the
reference wraps PETSc's C implementation; here the Krylov loop is a
``lax.while_loop`` over statically-shaped basis arrays, so the whole solve
lives inside one XLA program (no host round-trips per iteration).

Flexible = the preconditioner may change between iterations (CPR/CPTR
contains inner iterations), so the preconditioned vectors Z_j are stored and
the solution is reconstructed from them, exactly as PETSc's ``fgmres`` does.

The operator is matrix-free (a jvp closure); vectors keep their state shape
``(nc, *grid)`` throughout — flattening is never materialized.

f32 residual-estimate honesty ledger: the Givens
recurrence's residual ESTIMATE drifts from the TRUE residual as rounding
accumulates — measured ~100x at ~100 f32 iterations on channelized
high-contrast operators (tests/test_transfer.py
test_variational_solver_on_channelized_f32: claimed rtol 1e-6, true
relative residual ~1e-4; the exact margin varies with XLA CPU reduction
partitioning).  At production settings (ksp_rtol 1e-2/1e-3, EW forcing,
<=16-iteration solves) the drift is harmless; do NOT trust the estimate
for tight tolerances at high iteration counts without a true-residual
check (Newton gates on the true residual in solve/newton.py, which is why
production is unaffected).  Related: the bf16 basis option's true-residual
floor ~4e-3 (below).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FGMRESResult:
    x: jax.Array
    iters: jax.Array          # number of inner iterations performed
    res_norm: jax.Array       # final (estimated) residual norm
    converged: jax.Array      # bool
    breakdown: jax.Array      # bool: happy/unhappy breakdown encountered


def reduce_dtype(dtype) -> jnp.dtype:
    """f64 for f32 inputs when x64 is live — SURVEY.md §5.8's mixed-precision
    rule: global reductions accumulate in f64 even when the state is f32
    (at 3M+ dof an f32 accumulation loses ~sqrt-of-N digits that the Newton
    tolerance and the Givens residual estimate actually need)."""
    if jax.config.x64_enabled and jnp.dtype(dtype) == jnp.float32:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(dtype)


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Global dot product with f64 accumulation (see ``reduce_dtype``).
    Under a sharded jit XLA lowers the reduction to an all-reduce — the
    equivalent of PETSc's VecDot MPI allreduce."""
    rd = reduce_dtype(a.dtype)
    if rd == a.dtype:
        return jnp.vdot(a, b)
    return jnp.sum(a.astype(rd) * b.astype(rd)).astype(a.dtype)


def _norm(a: jax.Array) -> jax.Array:
    rd = reduce_dtype(a.dtype)
    if rd == a.dtype:
        return jnp.sqrt(jnp.vdot(a, a))
    return jnp.sqrt(jnp.sum(jnp.square(a.astype(rd)))).astype(a.dtype)


def fgmres(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    precond: Callable[[jax.Array], jax.Array] | None = None,
    x0: jax.Array | None = None,
    rtol: float | jax.Array = 1e-5,
    atol: float | jax.Array = 0.0,
    maxiter: int = 60,
    restart: int | None = None,
    iter_cap: jax.Array | None = None,
    basis_dtype=None,
    orth_passes: int = 2,
    orth_selective: bool = False,
    orth_gram: int = 0,
) -> FGMRESResult:
    """Solve A x = b with right-preconditioned flexible GMRES.

    ``restart=None`` runs a single cycle of ``maxiter`` Arnoldi steps with
    early exit — the CPR/CPTR-preconditioned solves this library runs
    converge in O(10) iterations ([P2]'s premise).  ``restart=r`` runs
    FGMRES(r) cycles up to a total of ``maxiter`` iterations — PETSc's
    default KSP behavior (restart 30) and a bandwidth lever: the CGS2
    orthogonalization streams the full static basis every iteration, so a
    smaller cycle keeps Krylov traffic ∝ r instead of ∝ maxiter.

    Args:
      matvec: v ↦ A v (state-shaped pytree-free array).
      precond: r ↦ M⁻¹ r; identity if None.
      rtol/atol: stop when ||r|| ≤ max(rtol·||b||, atol).
      maxiter: total iteration budget (static).
      restart: cycle size r ≤ maxiter (None = one cycle of maxiter).
      iter_cap: optional TRACED iteration cap ≤ maxiter for this call
        (storage stays maxiter-shaped; only the loop bound tightens) —
        used by the restarted driver so its final partial cycle cannot
        overrun the total budget.
      basis_dtype: optional storage dtype for the Arnoldi basis V (e.g.
        ``jnp.bfloat16``).  The CGS2 orthogonalization streams the FULL
        static (m+1)-slot basis four times per iteration — the dominant
        memory traffic of a preconditioned solve (tools/roofline.py) — so
        halving the basis bytes halves the top line.  Projections run as
        bf16×bf16 contractions with f32 accumulation; matvec/preconditioner/Hessenberg/solution stay in the
        compute dtype, and the CGS2 second pass mops up the extra
        O(eps_bf16) non-orthogonality.  The flexible basis Z (written and
        read once per slot) stays in the compute dtype so the returned x
        loses nothing.  CAVEAT: the Arnoldi relation holds only to the
        basis rounding, so the TRUE achievable relative residual is
        floored at O(eps_bf16) ≈ 4e-3 — honest only at loose tolerances
        (the production ksp_rtol=1e-3 inexact-Newton regime, where the
        nonlinear loop absorbs linear inexactness; tests/test_fgmres.py).
        None = store V in the compute dtype.
      orth_passes: Gram–Schmidt passes per iteration (static).  2 = CGS2
        (default; one reorthogonalization, MGS-grade stability).  1 =
        single classical pass — PETSc's KSPGMRES default — halving the
        basis streaming traffic at the cost of O(eps·κ) orthogonality
        drift; honest in the loose-tolerance inexact-Newton regime where
        Newton gates on the TRUE residual (see NewtonConfig.ksp_orth).
      orth_selective: with ``orth_passes=2``, take the second CGS pass
        only when the first one cancelled most of the vector —
        Rutishauser's criterion ``‖w₁‖ < η·‖w_pre‖`` with η = 1/√2 and
        ``‖w_pre‖² = ‖h‖² + ‖w₁‖²`` (Pythagoras on the orthonormal basis,
        so the test costs no extra array reduction).  Iterations with
        benign cancellation skip half the dominant basis-streaming
        traffic via a ``lax.cond`` (one branch executes);
        iterations with real cancellation — exactly where CGS1 loses
        orthogonality — still reorthogonalize.  NOTE: under ``vmap``
        (the ensemble axis) ``cond`` lowers to ``select`` and both
        branches execute — correct, but the traffic saving vanishes.
      orth_gram: low-synchronization CGS2 via an explicit Gram matrix
        (Świrydowicz et al., "low-synch Gram–Schmidt", the one-reduce
        CGS-2 used by hypre/Trilinos GMRES).  Carry G = VᵀV of the
        STORED basis (f64 scalars, (m+1)² — trivial); then the second
        projection's coefficients are algebraic — c₂ = VᵀW' = Vᵀw −
        (VᵀV)c₁ = c₁ − G c₁ — and BOTH corrections apply in one
        reconstruction pass w″ = w − V(c₁+c₂).  Classic CGS2 reads the
        full static basis 4× per iteration (2 projection + 2
        reconstruction passes), the dominant memory traffic of a
        preconditioned solve (tools/roofline.py); this variant reads:

        * ``orth_gram=3``: 3 passes — the new Gram column comes from
          REAL dots against the stored (possibly low-precision) basis,
          so G is exact-of-stored and the orthogonalization quality is
          CGS2-grade even with ``basis_dtype=bf16``.
        * ``orth_gram=2``: 2 passes — the new column is ALSO algebraic,
          Vᵀv_{j+1} = (c₁ − G(c₁+c₂))/h_{j+1,j}.  This misses (a) the
          f32 arithmetic rounding of the reconstruction axpy and (b)
          the storage rounding of v_{j+1}; (b) is a RANDOM per-cell
          perturbation, so its effect on the dot is O(eps_store/√N) —
          negligible even for bf16 at 3M dof — while (a) is the
          O(eps_f32·κ) term the literature shows stays bounded.
        ``orth_gram=0`` (default) = classic CGS per ``orth_passes``/
        ``orth_selective``.  orth_gram ignores both of those knobs.
    """
    if precond is None:
        precond = lambda r: r

    if orth_gram not in (0, 2, 3):
        raise ValueError(f"orth_gram must be 0, 2 or 3, got {orth_gram}")
    if restart is not None and int(restart) < int(maxiter):
        if iter_cap is not None:
            # the restart driver owns per-cycle caps (min(r, budget left));
            # silently dropping a caller's dynamic cap would uncap the solve
            raise ValueError("iter_cap cannot be combined with restart")
        return _fgmres_restarted(
            matvec, b, precond, x0, rtol, atol, int(maxiter), int(restart),
            basis_dtype=basis_dtype, orth_passes=orth_passes,
            orth_selective=orth_selective, orth_gram=orth_gram,
        )

    m = int(maxiter)
    dtype = b.dtype
    shape = b.shape
    bd = jnp.dtype(basis_dtype) if basis_dtype is not None else dtype
    mixed = bd != dtype

    if x0 is None:
        # cold start: r0 = b exactly — skip the matvec against zeros (one
        # full block-stencil sweep saved per Newton iteration)
        x0 = jnp.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    beta = _norm(r0)
    b_norm = _norm(b)
    tol = jnp.maximum(rtol * b_norm, atol)

    # Krylov storage: V (m+1) basis vectors (optionally low-precision, see
    # ``basis_dtype``), Z m preconditioned vectors (compute dtype).
    V = jnp.zeros((m + 1,) + shape, dtype=bd)
    Z = jnp.zeros((m,) + shape, dtype=dtype)
    H = jnp.zeros((m + 1, m), dtype=dtype)
    cs = jnp.zeros((m,), dtype=dtype)
    sn = jnp.zeros((m,), dtype=dtype)
    g = jnp.zeros((m + 1,), dtype=dtype)

    safe_beta = jnp.where(beta > 0, beta, 1.0)
    V = V.at[0].set((r0 / safe_beta).astype(bd))
    g = g.at[0].set(beta)

    jmax = m if iter_cap is None else jnp.minimum(m, iter_cap)

    axes = tuple(range(1, b.ndim + 1))
    rd = reduce_dtype(dtype)

    # Gram matrix of the stored basis for the low-synch variants (f64
    # scalars, (m+1)² — trivial next to one basis slot).  The seed entry is
    # a real self-dot of the STORED v₀ so low-precision storage is honest.
    if orth_gram:
        G = jnp.zeros((m + 1, m + 1), dtype=rd)
        v0 = V[0].astype(dtype)
        G = G.at[0, 0].set(_dot(v0, v0).astype(rd))
    else:
        G = jnp.zeros((1, 1), dtype=rd)  # placeholder carry slot

    def cond(carry):
        j, V, Z, H, cs, sn, g, G, res, done = carry
        return jnp.logical_and(j < jmax, jnp.logical_not(done))

    # MIRROR: solve/deflate.py::fgmres_dr copies this loop body (plus a
    # C-deflation step) — mirror any fix here into it (see its docstring
    # for why the two are not a shared helper).
    def body(carry):
        j, V, Z, H, cs, sn, g, G, res, done = carry
        z = precond(V[j].astype(dtype))
        w = matvec(z)
        Z = Z.at[j].set(z)

        # Orthogonalization: classical Gram-Schmidt with one reorthogonalization
        # (CGS2).  Unlike modified GS, each pass is ONE batched contraction
        # over the whole basis — 4 sweeps of V instead of m+1 dependent dots
        # per iteration — and CGS2 matches MGS stability in practice.  Unused
        # basis slots are zero, so masking beyond j is exact.
        # These batched projections stay in the BASIS dtype deliberately:
        # the second CGS pass already restores orthogonality to O(eps), and
        # upcasting the (m+1, N) contraction would forfeit the bandwidth it
        # rides on (with bf16 storage the contraction is bf16×bf16 with
        # f32 accumulation).  The f64 accumulation
        # lives in the scalar-producing _dot/_norm (beta, ||b||, h_next,
        # Givens inputs), where it sets the convergence decision
        # (tests/test_fgmres.py asserts f32-with-f64-reductions iteration
        # parity with full f64).
        active = (jnp.arange(m + 1) <= j).astype(dtype)

        def proj(x):
            """ONE read of V: batched dots <V_i, x> (mask applied by caller).
            With low-precision storage this is a broadcast-multiply-reduce,
            NOT a dot HLO: a skinny (m+1, N) low-precision dot pads its
            rows to the matrix unit's tile (measured an end-to-end loss),
            while the fused reduce reads V once at bf16 bytes with the
            convert folded into the reduction loop."""
            if mixed:
                return jnp.sum(V.astype(dtype) * x[None], axis=axes)
            return jnp.tensordot(V, x, axes=(axes, tuple(range(b.ndim))))

        def recon(hcoef, x):
            """ONE read of V: x − Σ_i hcoef_i V_i."""
            if mixed:
                exp = (slice(None),) + (None,) * b.ndim
                return x - jnp.sum(hcoef[exp].astype(dtype) * V.astype(dtype),
                                   axis=0)
            return x - jnp.tensordot(hcoef, V, axes=(0, 0))

        def orth(w):
            h = proj(w) * active
            return recon(h, w), h

        c1r = Gm = None
        if orth_gram:
            # low-synch CGS2 (see the orth_gram docstring): the second
            # projection's coefficients come from the carried Gram matrix,
            # so both corrections land in one reconstruction pass — 2
            # basis reads here (+1 for the orth_gram=3 column update).
            amask = active.astype(rd)
            Gm = G * (amask[None, :] * amask[:, None])
            c1r = (proj(w) * active).astype(rd)
            hr = c1r + (c1r - Gm @ c1r)   # c₁ + c₂, f64
            h = hr.astype(dtype)
            w = recon(h, w)
            h_next = _norm(w)
        else:
            w, h = orth(w)
            if orth_passes >= 2 and orth_selective:
                h1n = _norm(w)
                # ‖w_pre‖² = ‖h‖² + ‖w₁‖² (orthonormal V); reorthogonalize
                # only when pass 1 cancelled more than (1 - 1/√2) of w_pre —
                # the classical selective-reorthogonalization test, evaluated
                # from scalars already in hand
                hh = jnp.sum((h * h).astype(reduce_dtype(dtype))).astype(dtype)
                need = h1n * h1n < 0.5 * (hh + h1n * h1n)

                def _reorth(w):
                    w2, h2 = orth(w)
                    return w2, h2, _norm(w2)

                def _skip(w):
                    return w, jnp.zeros_like(h), h1n

                w, h2, h_next = jax.lax.cond(need, _reorth, _skip, w)
                h = h + h2
            else:
                if orth_passes >= 2:
                    w, h2 = orth(w)
                    h = h + h2
                h_next = _norm(w)
        H = H.at[:, j].set(h)
        breakdown = h_next <= 1e-300
        V = V.at[j + 1].set(
            jnp.where(breakdown, 0.0,
                      w / jnp.where(breakdown, 1.0, h_next)).astype(bd)
        )
        H = H.at[j + 1, j].set(h_next)

        if orth_gram == 3:
            # real dots against the STORED basis (V[j+1] already set, so the
            # contraction yields the exact self-dot too); exact-of-stored G
            # even under low-precision storage.  Breakdown stores a zero
            # vector, whose dots are zero — no special-casing needed.
            act1 = (jnp.arange(m + 1) <= j + 1).astype(rd)
            gcol = proj(V[j + 1].astype(dtype)).astype(rd) * act1
            G = G.at[j + 1, :].set(gcol)
            G = G.at[:, j + 1].set(gcol)
        elif orth_gram == 2:
            # algebraic column: Vᵀv_{j+1} = (Vᵀw″)/h = (c₁ − G(c₁+c₂))/h;
            # misses only arithmetic/storage rounding (see docstring)
            denom = jnp.where(breakdown, 1.0, h_next).astype(rd)
            gcol = jnp.where(breakdown, 0.0, (c1r - Gm @ hr) / denom)
            gcol = gcol.at[j + 1].set(jnp.where(breakdown, 0.0, 1.0))
            G = G.at[j + 1, :].set(gcol)
            G = G.at[:, j + 1].set(gcol)

        # apply previous Givens rotations to the new column
        def rot(i, H):
            h1 = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
            h2 = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
            H = H.at[i, j].set(jnp.where(i < j, h1, H[i, j]))
            H = H.at[i + 1, j].set(jnp.where(i < j, h2, H[i + 1, j]))
            return H

        H = jax.lax.fori_loop(0, m, rot, H)

        # new rotation annihilating H[j+1, j]
        a, bb = H[j, j], H[j + 1, j]
        r_ = jnp.sqrt(a * a + bb * bb)
        r_safe = jnp.where(r_ > 0, r_, 1.0)
        c_new = jnp.where(r_ > 0, a / r_safe, 1.0)
        s_new = jnp.where(r_ > 0, bb / r_safe, 0.0)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        H = H.at[j, j].set(c_new * a + s_new * bb)
        H = H.at[j + 1, j].set(0.0)
        g = g.at[j + 1].set(-s_new * g[j])
        g = g.at[j].set(c_new * g[j])

        res = jnp.abs(g[j + 1])
        done = jnp.logical_or(res <= tol, breakdown)
        return (j + 1, V, Z, H, cs, sn, g, G, res, done)

    init_done = beta <= tol
    carry = (jnp.asarray(0), V, Z, H, cs, sn, g, G, beta, init_done)
    j, V, Z, H, cs, sn, g, G, res, done = jax.lax.while_loop(cond, body, carry)

    # back-substitution on the k×k leading system, masked for dynamic k=j:
    # zero unused columns, unit diagonal on unused rows, zero rhs beyond k.
    idx = jnp.arange(m)
    active = idx < j
    Hm = H[:m, :m]
    Hm = jnp.where(jnp.logical_and(active[None, :], active[:, None]), Hm, 0.0)
    Hm = Hm + jnp.diag(jnp.where(active, 0.0, 1.0))
    rhs = jnp.where(active, g[:m], 0.0)
    y = jax.scipy.linalg.solve_triangular(Hm, rhs, lower=False)

    x = x0 + jnp.tensordot(y, Z, axes=(0, 0))
    converged = res <= tol
    return FGMRESResult(
        x=x,
        iters=j,
        res_norm=res,
        converged=converged,
        breakdown=jnp.logical_and(done, jnp.logical_not(converged)),
    )


def _fgmres_restarted(
    matvec, b, precond, x0, rtol, atol, maxiter: int, r: int,
    basis_dtype=None, orth_passes: int = 2, orth_selective: bool = False,
    orth_gram: int = 0,
) -> FGMRESResult:
    """FGMRES(r) restart cycles up to ``maxiter`` total iterations.

    Each cycle is the single-cycle :func:`fgmres` warm-started from the
    previous cycle's iterate (one extra matvec per restart for the true
    residual — the standard restart cost).  The cycle body is traced once
    inside a ``lax.while_loop``, so compile size does not grow with the
    number of cycles; the final partial cycle is capped dynamically so
    total iterations never exceed ``maxiter`` (PETSc's ``max_it``
    semantics).
    """
    cold = x0 is None
    x0 = jnp.zeros_like(b) if cold else x0
    ncycles = -(-maxiter // r)
    b_norm = _norm(b)
    tol = jnp.maximum(rtol * b_norm, atol)

    def cond(carry):
        cyc, x, tot, res, stop, brk = carry
        return jnp.logical_and(cyc < ncycles, jnp.logical_not(stop))

    def body(carry):
        cyc, x, tot, res, stop, brk = carry
        out = fgmres(
            matvec, b, precond=precond, x0=x, rtol=rtol, atol=atol,
            maxiter=r, iter_cap=jnp.minimum(r, maxiter - tot),
            basis_dtype=basis_dtype, orth_passes=orth_passes,
            orth_selective=orth_selective, orth_gram=orth_gram,
        )
        tot = tot + out.iters
        # carry the Arnoldi-breakdown flag separately from plain budget
        # exhaustion: both stop the driver, but only the former may be
        # reported as breakdown (matching the single-cycle path)
        brk = out.breakdown
        stop = jnp.logical_or(
            jnp.logical_or(out.converged, brk), tot >= maxiter
        )
        return (cyc + 1, out.x, tot, out.res_norm, stop, brk)

    init = (
        jnp.asarray(0),
        x0,
        jnp.asarray(0),
        # cold start: r0 = b exactly — no matvec needed for the seed norm
        b_norm if cold else _norm(b - matvec(x0)),
        jnp.asarray(False),
        jnp.asarray(False),
    )
    cyc, x, tot, res, stop, brk = jax.lax.while_loop(cond, body, init)
    converged = res <= tol
    return FGMRESResult(
        x=x,
        iters=tot,
        res_norm=res,
        converged=converged,
        breakdown=jnp.logical_and(brk, jnp.logical_not(converged)),
    )
