"""Chebyshev iteration on Jacobi-scaled stencil operators.

Parallel replacement for the sequential smoothers the reference gets
from PETSc/hypre (ILU(0), SOR — SURVEY.md §2.12–2.16 and §7 hard part #2):
Chebyshev needs only stencil matvecs and a diagonal scale, both perfectly
vectorizable, and its smoothing quality is iteration-count
competitive for the SPD-ish pressure/temperature blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from thermalporous_tpu.core.stencil import (
    BlockStencil,
    ScalarStencil,
    apply_blocks,
    invert_blocks,
    multiply_blocks,
)


def gershgorin_lambda_max(st: ScalarStencil) -> jax.Array:
    """Upper bound on the spectrum of D⁻¹A via Gershgorin rows.

    For the M-matrix-like TPFA+accumulation stencils this is ≤ 2 and tight
    enough for Chebyshev smoothing bounds; cheap and state-free (no power
    iteration inside the Newton loop).
    """
    return jnp.max(st.row_abs_sum() / jnp.abs(st.diag))


def chebyshev(
    st: ScalarStencil,
    b: jax.Array,
    x: jax.Array | None = None,
    degree: int = 3,
    lam_max: jax.Array | float | None = None,
    lam_min_frac: float = 0.25,
    lam_max_safety: float = 1.05,
) -> jax.Array:
    """``degree`` Chebyshev iterations on D⁻¹A x = D⁻¹b, starting from ``x``.

    Targets the interval [lam_min_frac·λmax, λmax·safety] of the
    Jacobi-preconditioned operator — the standard smoothing configuration
    (high-frequency error killer for multigrid, stage-2 smoother for CPR).
    """
    if lam_max is None:
        lam_max = gershgorin_lambda_max(st)
    lmax = lam_max * lam_max_safety
    lmin = lam_max * lam_min_frac

    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_diag = 1.0 / st.diag

    if x is None:
        # zero start (every pre-smooth): b − A·0 = b EXACTLY, so skip the
        # first stencil matvec — one of (degree+1) full coefficient-array
        # streams per smooth, for free.  Math-identical to the x=0 path
        # (compiled programs may differ by ≤1 ulp of fusion rounding).
        x = jnp.zeros_like(b)
        z = inv_diag * b
    else:
        z = inv_diag * (b - st.matvec(x))
    d = z / theta
    rho = 1.0 / sigma1

    def body(_, carry):
        x, d, rho = carry
        x = x + d
        z = inv_diag * (b - st.matvec(x))
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        return (x, d, rho_new)

    x, d, rho = jax.lax.fori_loop(0, degree - 1, body, (x, d, rho))
    return x + d


def weighted_jacobi(
    st: ScalarStencil,
    b: jax.Array,
    x: jax.Array | None = None,
    sweeps: int = 2,
    omega: float = 0.8,
) -> jax.Array:
    """Damped Jacobi sweeps (fallback smoother for strongly nonsymmetric blocks)."""
    inv_diag = omega / st.diag
    start = 0
    if x is None:
        # zero start: the first sweep is x = ωD⁻¹b with no matvec
        # (math-identical — see chebyshev)
        x = jnp.zeros_like(b)
        if sweeps >= 1:
            x = inv_diag * b
            start = 1

    def body(_, x):
        return x + inv_diag * (b - st.matvec(x))

    return jax.lax.fori_loop(start, sweeps, body, x)


def _checkerboard(shape, dtype) -> jax.Array:
    """Parity mask: 1.0 on 'red' cells (even index sum)."""
    parity = jnp.zeros((), jnp.int32)
    for a, n in enumerate(shape):
        view = [1] * len(shape)
        view[a] = n
        parity = parity + jnp.arange(n, dtype=jnp.int32).reshape(view)
    return (parity % 2 == 0).astype(dtype)


def red_black_gauss_seidel(
    st: ScalarStencil,
    b: jax.Array,
    x: jax.Array | None = None,
    sweeps: int = 1,
) -> jax.Array:
    """Red-black Gauss–Seidel sweeps — the parallel Gauss–Seidel.

    A 7-point stencil is exactly 2-colorable, so each color's update is an
    independent masked Jacobi step using the OTHER color's fresh values:
    two full-grid elementwise passes per sweep, sequential-GS strength without the
    sequential dependency (the reference's PETSc SOR role — SURVEY.md §2.15).
    """
    red = _checkerboard(st.grid_shape, b.dtype)
    black = 1.0 - red
    inv_diag = 1.0 / st.diag

    def body(_, x):
        x = x + red * inv_diag * (b - st.matvec(x))
        return x + black * inv_diag * (b - st.matvec(x))

    # NOTE: the "skip the first matvec on a zero start" unroll (see
    # chebyshev) is not applied to the masked half-sweep smoothers: they
    # stay in the uniformly-looped form (block_rbgs_fused_zero is the
    # elided form of the block variant).
    if x is None:
        x = jnp.zeros_like(b)
    return jax.lax.fori_loop(0, sweeps, body, x)


def tridiag_solve_along(
    axis: int,
    lower: jax.Array,
    diag: jax.Array,
    upper: jax.Array,
    b: jax.Array,
) -> jax.Array:
    """Solve independent tridiagonal systems along ``axis``, batched over
    every other axis (the Thomas algorithm as two ``lax.scan``s).

    Convention matches :class:`ScalarStencil`: ``upper[i]`` couples cell i
    to i+1 (zero on the last slice), ``lower[i]`` couples i to i−1 (zero on
    the first slice).  All arrays share one shape; the line axis is moved to
    the front so each scan step is one fused elementwise pass over the whole
    transverse plane (e.g. SPE10 z-lines: 85 steps × a 60×220 plane).
    """
    mv = lambda a: jnp.moveaxis(a, axis, 0)
    lo, d, up, rhs = mv(lower), mv(diag), mv(upper), mv(b)

    # forward elimination: c'_i = u_i / (d_i − l_i c'_{i−1}),
    #                      y_i  = (b_i − l_i y_{i−1}) / (d_i − l_i c'_{i−1})
    def fwd(carry, row):
        c_prev, y_prev = carry
        l_i, d_i, u_i, b_i = row
        denom = d_i - l_i * c_prev
        c_i = u_i / denom
        y_i = (b_i - l_i * y_prev) / denom
        return (c_i, y_i), (c_i, y_i)

    zeros = jnp.zeros_like(d[0])
    _, (c, y) = jax.lax.scan(fwd, (zeros, zeros), (lo, d, up, rhs))

    # back substitution: x_i = y_i − c'_i x_{i+1}
    def bwd(x_next, row):
        c_i, y_i = row
        x_i = y_i - c_i * x_next
        return x_i, x_i

    _, x = jax.lax.scan(bwd, zeros, (c, y), reverse=True)
    return jnp.moveaxis(x, 0, axis)


def _line_mask(shape, line_axis: int, color: int, dtype) -> jax.Array:
    """Checkerboard over the TRANSVERSE axes: each ``line_axis`` line is one
    color, and a 7-point stencil couples a line only to opposite-color
    neighbours — the 'zebra' 2-coloring."""
    parity = jnp.zeros((), jnp.int32)
    for a, n in enumerate(shape):
        if a == line_axis % len(shape):
            continue
        view = [1] * len(shape)
        view[a] = n
        parity = parity + jnp.arange(n, dtype=jnp.int32).reshape(view)
    return (parity % 2 == color).astype(dtype)


def line_jacobi(
    st: ScalarStencil,
    b: jax.Array,
    x: jax.Array | None = None,
    axis: int = -1,
    sweeps: int = 1,
    omega: float = 1.0,
) -> jax.Array:
    """Simultaneous line-Jacobi relaxation: x ← x + ω·T⁻¹(b − Ax) with T the
    tridiagonal part of A along ``axis``.

    The classical smoother for grids with one strongly-coupled axis (SPE10:
    Δz ≈ Δx/10 ⇒ vertical transmissibility ~30× horizontal — SURVEY.md §7
    hard part #2's 'line solves along the dominant axis' candidate): exact
    line solves damp error components the point smoothers cannot.
    """
    a = axis % len(st.grid_shape)
    lo, up = st.lower[a], st.upper[a]

    def body(_, x):
        r = b - st.matvec(x)
        return x + omega * tridiag_solve_along(a, lo, st.diag, up, r)

    start = 0
    if x is None:
        # zero start: first sweep's residual is b itself (no matvec)
        x = jnp.zeros_like(b)
        if sweeps >= 1:
            x = omega * tridiag_solve_along(a, lo, st.diag, up, b)
            start = 1
    return jax.lax.fori_loop(start, sweeps, body, x)


def zebra_line_gs(
    st: ScalarStencil,
    b: jax.Array,
    x: jax.Array | None = None,
    axis: int = -1,
    sweeps: int = 1,
) -> jax.Array:
    """Zebra (red-black line) Gauss–Seidel along ``axis``: alternate exact
    solves of the two line colors, each against the other's fresh values —
    Gauss–Seidel strength, parallel within a color."""
    a = axis % len(st.grid_shape)
    lo, up = st.lower[a], st.upper[a]
    red = _line_mask(st.grid_shape, a, 0, b.dtype)
    black = 1.0 - red

    def body(_, x):
        x = x + red * tridiag_solve_along(a, lo, st.diag, up, b - st.matvec(x))
        return x + black * tridiag_solve_along(a, lo, st.diag, up, b - st.matvec(x))

    # zero-start unroll withheld: see the miscompile note in
    # red_black_gauss_seidel (same masked-half-sweep program shape)
    if x is None:
        x = jnp.zeros_like(b)
    return jax.lax.fori_loop(0, sweeps, body, x)


def block_red_black_gauss_seidel(
    st: BlockStencil,
    dinv: jax.Array,
    b: jax.Array,
    x: jax.Array | None = None,
    sweeps: int = 1,
    axes: tuple[int, ...] | None = None,
) -> jax.Array:
    """Red-black block Gauss–Seidel on a BLOCK 7-point stencil.

    The block analogue of ``red_black_gauss_seidel``: each color's cells are
    updated with exact per-cell block solves (``dinv`` = precomputed inverse
    diagonal blocks) against the other color's fresh values.  This is the
    faithful one-stage "ILU-analog" preset the reference's solver-parameter
    family keeps for ablations (SURVEY.md §2.1, §2.15): sequential-GS
    coupling strength, parallel by 2-coloring.
    """
    red = _checkerboard(st.grid_shape, b.dtype)   # (*shape,), broadcasts
    black = 1.0 - red
    if axes is None:
        mv = st.matvec
    else:
        # SPARSIFIED smoother operator: restrict the
        # neighbour coupling to ``axes`` — D + offdiag(axes).  Each
        # omitted axis drops two 9-field coefficient streams per matvec;
        # NOT exact, gate on iteration counts.
        mv = lambda v: apply_blocks(st.diag, v) + st.matvec_offdiag(
            v, axes=axes)

    def body(_, x):
        x = x + red * apply_blocks(dinv, b - mv(x))
        return x + black * apply_blocks(dinv, b - mv(x))

    if x is None:
        x = jnp.zeros_like(b)
    return jax.lax.fori_loop(0, sweeps, body, x)


def block_rbgs_fused_zero(
    st: BlockStencil,
    dinv_red: jax.Array,
    dinv_black: jax.Array,
    b: jax.Array,
    axes: tuple[int, ...] | None = None,
) -> jax.Array:
    """One zero-start block-RBGS sweep with setup-premasked diagonal inverses.

    Bit-identical to ``block_red_black_gauss_seidel(st, dinv, b, sweeps=1)``
    (proof in the two elisions below) at ~40% of its
    coefficient traffic:

    - **red half**: the looped body computes ``red·D⁻¹(b − A·0)`` — a full
      63-field coefficient stream multiplied by exact zeros.  Here the
      first matvec is gone and the mask is baked into ``dinv_red = red·D⁻¹``
      at SETUP time, so ``x_red = dinv_red·b`` (masking a linear operator's
      coefficients equals masking its output, and the elided A·0 terms were
      exact zeros).
    - **black half**: ``x_red`` is supported on red cells only, so at every
      black cell the diagonal term D·x_red of the residual matvec is an
      exact zero — ``b − A_off·x_red`` there is bit-identical to
      ``b − A·x_red``, and red cells are killed by ``dinv_black`` exactly
      as the looped form's ``black`` mask kills them.  The diag stream
      (9 of 63 fields) is elided.

    No in-apply mask multiply, no zero matvec, no fori_loop.  Qualify it
    against CPU counts at scale (``python -m thermalporous_tpu.qualify``)
    before production use.

    ``axes`` (NOT exact): restrict the black half's
    residual coupling to a subset of grid axes — a sparsified smoother
    operator that drops 18 coefficient fields per omitted axis; accept
    only at unchanged iteration counts.
    """
    x_red = apply_blocks(dinv_red, b)
    return x_red + apply_blocks(
        dinv_black, b - st.matvec_offdiag(x_red, axes=axes))


def block_tridiag_factor(
    axis: int,
    lower: jax.Array,
    diag: jax.Array,
    upper: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Forward-eliminate the block-tridiagonal part along ``axis`` once.

    Returns ``(lo, c, dinv)`` in line-axis-major layout: the Thomas
    multipliers ``c_i = (d_i − l_i c_{i−1})⁻¹ u_i`` and the modified
    diagonal inverses.  The factorization depends only on the stencil,
    so it is computed ONCE per preconditioner setup and shared by every
    color half-sweep of every zebra application (each block-Thomas
    factor costs an ``invert_blocks`` per scan step — recomputing it
    2×sweeps times per apply was the dominant cost of the smoother).
    """
    mvb = lambda a_: jnp.moveaxis(a_, 2 + axis, 0)   # (n, nc, nc, *other)
    lo, d, up = mvb(lower), mvb(diag), mvb(upper)

    def fwd(c_prev, row):
        l_i, d_i, u_i = row
        dinv = invert_blocks(d_i - multiply_blocks(l_i, c_prev))
        c_i = multiply_blocks(dinv, u_i)
        return c_i, (c_i, dinv)

    zb = jnp.zeros_like(d[0])
    _, (c, dinv) = jax.lax.scan(fwd, zb, (lo, d, up))
    return lo, c, dinv


def block_tridiag_solve_factored(
    axis: int,
    factor: tuple[jax.Array, jax.Array, jax.Array],
    b: jax.Array,
) -> jax.Array:
    """Solve with a precomputed :func:`block_tridiag_factor` (two scans,
    no block inversions)."""
    lo, c, dinv = factor
    rhs = jnp.moveaxis(b, 1 + axis, 0)               # (n, nc, *other)

    def fwd(y_prev, row):
        l_i, dinv_i, b_i = row
        y_i = apply_blocks(dinv_i, b_i - apply_blocks(l_i, y_prev))
        return y_i, y_i

    zv = jnp.zeros_like(rhs[0])
    _, y = jax.lax.scan(fwd, zv, (lo, dinv, rhs))

    def bwd(x_next, row):
        c_i, y_i = row
        x_i = y_i - apply_blocks(c_i, x_next)
        return x_i, x_i

    _, x = jax.lax.scan(bwd, zv, (c, y), reverse=True)
    return jnp.moveaxis(x, 0, 1 + axis)


def block_tridiag_solve_along(
    axis: int,
    lower: jax.Array,
    diag: jax.Array,
    upper: jax.Array,
    b: jax.Array,
) -> jax.Array:
    """Solve independent BLOCK-tridiagonal systems along ``axis``.

    The block Thomas algorithm as ``lax.scan``s: blocks are
    (nc, nc, *shape) in the :class:`BlockStencil` convention (``upper[i]``
    couples i→i+1, zero on the last slice), ``b`` is (nc, *shape).  Each
    scan step runs one fused pass over the whole transverse plane —
    e.g. full-SPE10 y-lines: 220 steps × a 60×85-line batch.  This is
    the coupling-propagation primitive the flat-parallel block smoothers
    lack: information crosses the ENTIRE line in one application (the
    reference's sequential ILU(0) role, SURVEY.md §2.15, made
    parallel by batching lines).
    """
    return block_tridiag_solve_factored(
        axis, block_tridiag_factor(axis, lower, diag, upper), b)


def block_zebra_line_gs(
    st: BlockStencil,
    b: jax.Array,
    x: jax.Array | None = None,
    axis: int = 1,
    sweeps: int = 1,
    omega: float = 1.0,
    factor: tuple[jax.Array, jax.Array, jax.Array] | None = None,
) -> jax.Array:
    """Zebra (red-black line) BLOCK Gauss–Seidel along ``axis``.

    Stage-2 smoother for coupling-bound systems: the dt=76.8 ks
    full-SPE10 decomposition (tools/diag_hard.py) shows
    every decoupled scalar row is solved in ≤8 iterations while the full
    system needs ~97 — the (p,T,S) coupling must propagate along
    O(100)-cell channels, and point-wise block-RBGS carries it one cell
    per sweep.  Exact block-line solves along the channel axis carry it
    across the whole line per application, alternating line colors
    against fresh values (Gauss–Seidel strength, parallel within a
    color).
    """
    if x is None:
        x = jnp.zeros_like(b)
    a = axis % len(st.grid_shape)
    if factor is None:
        factor = block_tridiag_factor(a, st.lower[a], st.diag, st.upper[a])
    red = _line_mask(st.grid_shape, a, 0, b.dtype)
    black = 1.0 - red

    def body(_, x):
        x = x + omega * red * block_tridiag_solve_factored(
            a, factor, b - st.matvec(x))
        return x + omega * black * block_tridiag_solve_factored(
            a, factor, b - st.matvec(x))

    return jax.lax.fori_loop(0, sweeps, body, x)
