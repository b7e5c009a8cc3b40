"""Krylov-subspace recycling (FGCRO-DR-style deflated FGMRES).

Analog of the subspace-recycling Krylov methods production
reservoir simulators bolt onto PETSc (GCRO-DR, Parks et al. 2006; the
flexible variant of Carvalho et al.) — the reference itself relies on
plain PETSc FGMRES (SURVEY.md §2.13), but its hardest regime is exactly
where recycling pays: the dt-ramped full-SPE10 wall is root-caused as a
handful of slow COUPLED (p,T,S) modes that every Newton iteration's
Krylov solve must rediscover from scratch (``tools/diag_hard.py``).  Those modes vary slowly across Newton
iterations of a step, so a small recycled subspace harvested from one
solve deflates the next.

Mechanics (statically shaped, one XLA program — no gathers,
no strided views):

- A recycle space ``U`` of ``k`` solution-space columns rides the Newton
  while_loop carry.  At each solve: ``W = A·U`` (k batched stencil
  matvecs), QR → orthonormal ``C`` with ``A·(U R⁻¹) = C`` exactly.
- Initial deflation: ``x0 = U Cᵀb``, ``r0 = b − C Cᵀb``.
- Arnoldi runs on the projected operator ``(I − C Cᵀ) A M⁻¹``; the
  coupling matrix ``B = Cᵀ A Z`` is accumulated column-wise.
- Solution: the C-component is annihilated EXACTLY by ``α = −B y``, so
  the Givens residual estimate remains the true residual norm:
  ``x = x0 + Z y − U (B y)``.
- Harvest for the next solve: with ``A [U, Z] = [C, V] G``,
  ``G = [[I, B], [0, H̄]]`` and ``[C, V]`` orthonormal, the smallest
  singular directions of ``G`` — eigenvectors of the small symmetric
  ``GᵀG`` (``jnp.linalg.eigh``: lowerable on every backend, unlike nonsymmetric
  ``eig``) — pick the k slowest modes of A restricted to the searched
  subspace.  Inactive slots are masked by a large diagonal shift so the
  ascending eigh order never selects them.

Validity is tracked per column (``u_mask``); with an all-false mask the
solve degrades to plain FGMRES plus the harvest, so the first Newton
iteration needs no special casing.

Cost accounting: ``result.iters`` counts ARNOLDI iterations only — each
solve additionally pays k operator matvecs in :func:`prepare_recycle`
(plus the k-column QR and the small eigh harvest), so iteration counts
with recycling on are NOT the same unit as plain-FGMRES counts; wall
time is the comparable metric.

Precision note: the deflation projections run in the compute dtype (no
f64 accumulation — C is orthonormal so one pass leaves O(eps) residue),
matching fgmres.py's batched-orthogonalization policy; the f64-
accumulated scalars (norms, Givens inputs) ride the shared ``_norm``.

With ``ksp_recycle>0`` the small ``jnp.linalg.eigh`` runs inside the
Newton ``lax.while_loop``; check CPU parity (``thermalporous_tpu.qualify``)
before using it at ~1M-cell scale.  Production keeps recycling off.

The Arnoldi body mirrors :func:`fgmres.fgmres` deliberately rather than
sharing a parameterized helper: the plain solver is the measured-stable
production hot path on a backend where program-shape changes have
caused miscompiles, so it stays untouched.  ANY fix to fgmres.py's loop
body (orthogonalization, breakdown, Givens, back-substitution) must be
mirrored here — grep for "MIRROR:" in both files.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from thermalporous_tpu.solve.fgmres import FGMRESResult, _norm


def empty_recycle(shape, k: int, dtype) -> tuple[jax.Array, jax.Array]:
    """Fresh (all-invalid) recycle space for a state of ``shape``."""
    U = jnp.zeros((k,) + tuple(shape), dtype=dtype)
    mask = jnp.zeros((k,), dtype=bool)
    return U, mask


def _batched_dot(Vs: jax.Array, w: jax.Array, mask: jax.Array) -> jax.Array:
    """(k,) masked projections ``Vs_i · w`` (compute dtype, one contraction)."""
    axes = tuple(range(1, Vs.ndim))
    h = jnp.tensordot(Vs, w, axes=(axes, tuple(range(w.ndim))))
    return h * mask.astype(h.dtype)


def _combine(coef: jax.Array, Vs: jax.Array) -> jax.Array:
    """Σ_i coef_i · Vs_i (state-shaped)."""
    return jnp.tensordot(coef, Vs, axes=(0, 0))


def prepare_recycle(matvec, U: jax.Array, mask: jax.Array):
    """Orthonormalize the image of the recycle space: C = QR(A·U).

    Returns ``(U', C, mask')`` with ``A·U' = C``, ``CᵀC = I`` on valid
    columns (invalid columns are exactly zero).  Columns whose image is
    (numerically) dependent on earlier ones are invalidated — the QR is
    CGS2 over the k static columns, unrolled (k is small, default 8).
    """
    k = U.shape[0]
    dtype = U.dtype
    W = jax.vmap(matvec)(U)
    W = W * mask[(slice(None),) + (None,) * (U.ndim - 1)].astype(dtype)

    C = jnp.zeros_like(W)
    R = jnp.zeros((k, k), dtype=dtype)
    new_mask = []
    cmask = jnp.zeros((k,), dtype=bool)
    eps = float(jnp.finfo(dtype).eps)
    for i in range(k):
        w = W[i]
        w_in = _norm(w)
        # two classical GS passes against the (zero-padded) built columns
        h = _batched_dot(C, w, cmask)
        w = w - _combine(h, C)
        h2 = _batched_dot(C, w, cmask)
        w = w - _combine(h2, C)
        h = h + h2
        nrm = _norm(w)
        # relative dependence cut: a column whose image lies in the span
        # of earlier ones carries no new information
        ok = jnp.logical_and(mask[i], nrm > 100.0 * eps * w_in)
        safe = jnp.where(nrm > 0, nrm, 1.0)
        ci = jnp.where(ok, w / safe, jnp.zeros_like(w))
        C = C.at[i].set(ci)
        R = R.at[:, i].set(h)
        R = R.at[i, i].set(jnp.where(ok, nrm, 1.0))
        new_mask.append(ok)
        cmask = cmask.at[i].set(ok)
    mask_out = jnp.stack(new_mask)

    # U ← U R⁻¹ so that A·U = C.  R is k×k upper triangular with unit
    # diagonal on invalid slots; invert against I_k (tiny, static k) and
    # recombine — no wide triangular solve on the state-sized arrays.
    Rinv = jax.scipy.linalg.solve_triangular(R, jnp.eye(k, dtype=dtype),
                                             lower=False)
    Uo = jnp.tensordot(Rinv, U, axes=(0, 0))
    Uo = Uo * mask_out[(slice(None),) + (None,) * (U.ndim - 1)].astype(dtype)
    return Uo, C, mask_out


def fgmres_dr(
    matvec,
    b: jax.Array,
    precond=None,
    U: jax.Array | None = None,
    u_mask: jax.Array | None = None,
    rtol: float | jax.Array = 1e-5,
    atol: float | jax.Array = 0.0,
    maxiter: int = 60,
    basis_dtype=None,
    orth_passes: int = 2,
) -> tuple[FGMRESResult, jax.Array, jax.Array]:
    """Deflated FGMRES with recycling; cold start (x0 = 0) only.

    Returns ``(result, U_next, mask_next)`` — the harvested recycle space
    for the next solve in the sequence.  Interface mirrors
    :func:`thermalporous_tpu.solve.fgmres.fgmres` (CGS2/CGS1, optional
    bf16 basis storage with f32-accumulated projections).
    """
    if precond is None:
        precond = lambda r: r

    m = int(maxiter)
    dtype = b.dtype
    shape = b.shape
    bd = jnp.dtype(basis_dtype) if basis_dtype is not None else dtype
    mixed = bd != dtype

    assert U is not None and u_mask is not None
    k = U.shape[0]

    U, C, u_mask = prepare_recycle(matvec, U, u_mask)

    b_norm = _norm(b)
    tol = jnp.maximum(rtol * b_norm, atol)

    # initial deflation: project b onto range(C), seed x0 in range(U)
    cu = _batched_dot(C, b, u_mask)
    x0 = _combine(cu, U)
    r0 = b - _combine(cu, C)
    beta = _norm(r0)

    V = jnp.zeros((m + 1,) + shape, dtype=bd)
    Z = jnp.zeros((m,) + shape, dtype=dtype)
    H = jnp.zeros((m + 1, m), dtype=dtype)
    B = jnp.zeros((k, m), dtype=dtype)
    cs = jnp.zeros((m,), dtype=dtype)
    sn = jnp.zeros((m,), dtype=dtype)
    g = jnp.zeros((m + 1,), dtype=dtype)

    safe_beta = jnp.where(beta > 0, beta, 1.0)
    V = V.at[0].set((r0 / safe_beta).astype(bd))
    g = g.at[0].set(beta)

    axes = tuple(range(1, b.ndim + 1))

    def cond(carry):
        j, V, Z, H, B, cs, sn, g, res, done = carry
        return jnp.logical_and(j < m, jnp.logical_not(done))

    # MIRROR: the Arnoldi body below tracks fgmres.fgmres's loop body
    # (see module docstring); keep any fix to either in sync.
    def body(carry):
        j, V, Z, H, B, cs, sn, g, res, done = carry
        z = precond(V[j].astype(dtype))
        w = matvec(z)
        Z = Z.at[j].set(z)

        # deflate: remove the range(C) component (C is orthonormal, one
        # pass leaves O(eps) residue — standard GCRO-DR)
        bcol = _batched_dot(C, w, u_mask)
        w = w - _combine(bcol, C)
        B = B.at[:, j].set(bcol)

        active = (jnp.arange(m + 1) <= j).astype(dtype)

        def orth(w):
            if mixed:
                exp = (slice(None),) + (None,) * b.ndim
                h = jnp.sum(V.astype(dtype) * w[None], axis=axes) * active
                delta = jnp.sum(h[exp].astype(dtype) * V.astype(dtype),
                                axis=0)
                return w - delta, h
            h = jnp.tensordot(V, w, axes=(axes, tuple(range(b.ndim)))) * active
            return w - jnp.tensordot(h, V, axes=(0, 0)), h

        w, h = orth(w)
        if orth_passes >= 2:
            w, h2 = orth(w)
            h = h + h2
        H = H.at[:, j].set(h)
        h_next = _norm(w)
        breakdown = h_next <= 1e-300
        V = V.at[j + 1].set(
            jnp.where(breakdown, 0.0,
                      w / jnp.where(breakdown, 1.0, h_next)).astype(bd)
        )
        H = H.at[j + 1, j].set(h_next)

        def rot(i, H):
            h1 = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
            h2 = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
            H = H.at[i, j].set(jnp.where(i < j, h1, H[i, j]))
            H = H.at[i + 1, j].set(jnp.where(i < j, h2, H[i + 1, j]))
            return H

        H = jax.lax.fori_loop(0, m, rot, H)

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
        return (j + 1, V, Z, H, B, cs, sn, g, res, done)

    init_done = beta <= tol
    carry = (jnp.asarray(0), V, Z, H, B, cs, sn, g, beta, init_done)
    j, V, Z, H, B, cs, sn, g, res, done = jax.lax.while_loop(cond, body, carry)

    idx = jnp.arange(m)
    active = idx < j
    Hm = H[:m, :m]
    Hm = jnp.where(jnp.logical_and(active[None, :], active[:, None]), Hm, 0.0)
    Hm = Hm + jnp.diag(jnp.where(active, 0.0, 1.0))
    rhs = jnp.where(active, g[:m], 0.0)
    y = jax.scipy.linalg.solve_triangular(Hm, rhs, lower=False)

    # x = x0 + Z y − U (B y): α = −B y cancels the C-residual component
    # exactly, so ``res`` (the Givens estimate) is the true residual norm
    alpha = -jnp.tensordot(B, y, axes=(1, 0))
    x = x0 + jnp.tensordot(y, Z, axes=(0, 0)) + _combine(alpha, U)

    converged = res <= tol

    # ---- harvest: k smallest singular directions of G over [U, Z] ----
    # GᵀG = [[diag(mask), B·act], [(B·act)ᵀ, BᵀB + H̄ᵀH̄]] with inactive
    # slots pushed to the top of the spectrum by a large diagonal shift.
    col_act = jnp.concatenate([u_mask.astype(dtype), active.astype(dtype)])
    Bm = B * active[None, :].astype(dtype)
    Hbar = H * active[None, :].astype(dtype)
    top = jnp.concatenate([jnp.diag(u_mask.astype(dtype)), Bm], axis=1)
    bot = jnp.concatenate(
        [Bm.T, Bm.T @ Bm + Hbar.T @ Hbar], axis=1)
    Msmall = jnp.concatenate([top, bot], axis=0)
    big = jnp.asarray(1e30, dtype=dtype)
    Msmall = Msmall + jnp.diag((1.0 - col_act) * big)
    # symmetrize against roundoff for eigh
    Msmall = 0.5 * (Msmall + Msmall.T)
    _, Q = jnp.linalg.eigh(Msmall)  # ascending
    P = Q[:, :k]                    # static slice — no gather
    U_next = (jnp.tensordot(P[:k, :], U, axes=(0, 0))
              + jnp.tensordot(P[k:, :], Z, axes=(0, 0)))
    n_active = jnp.sum(u_mask.astype(jnp.int32)) + j.astype(jnp.int32)
    mask_next = jnp.arange(k) < n_active

    result = FGMRESResult(
        x=x,
        iters=j,
        res_norm=res,
        converged=converged,
        breakdown=jnp.logical_and(done, jnp.logical_not(converged)),
    )
    return result, U_next, mask_next
