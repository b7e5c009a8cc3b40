"""Block 7-point stencil matrices on structured grids.

Replacement for the assembled PETSc ``MatAIJ`` Jacobians the
reference hands to its preconditioners (SURVEY.md §2.12–2.16): instead of a
distributed CSR matrix we keep the Newton Jacobian's sparsity explicitly as
per-cell dense blocks —

- ``diag``  : (nc, nc, *shape)   coupling of each cell to itself,
- ``upper[a]``: (nc, nc, *shape) coupling of cell i to its +a neighbour
  (zero on the last slice along a),
- ``lower[a]``: (nc, nc, *shape) coupling of cell i to its −a neighbour
  (zero on the first slice along a).

This layout is dense, static-shaped, and purely elementwise to apply;
no CSR, no graph, no assembly scatter.  The Krylov operator itself stays
matrix-free (``jax.jvp``); stencils exist only for preconditioning, which
mirrors how the reference assembles the Jacobian chiefly to feed CPR/CPTR.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from thermalporous_tpu.core.grid import shift_minus, shift_plus


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockStencil:
    """Block 7-point (5-point in 2D) stencil operator."""

    diag: jax.Array                 # (nc, nc, *shape)
    upper: tuple[jax.Array, ...]    # per axis, (nc, nc, *shape)
    lower: tuple[jax.Array, ...]    # per axis, (nc, nc, *shape)

    @property
    def nc(self) -> int:
        return self.diag.shape[0]

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.diag.shape[2:]

    def matvec(self, v: jax.Array) -> jax.Array:
        """Apply the stencil to a state-shaped vector ``v`` of shape (nc, *shape)."""
        y = apply_blocks(self.diag, v)
        for a, (up, lo) in enumerate(zip(self.upper, self.lower)):
            y = y + apply_blocks(up, shift_minus(v, a, lead=1))
            y = y + apply_blocks(lo, shift_plus(v, a, lead=1))
        return y

    def matvec_cols(self, v: jax.Array, k: int) -> jax.Array:
        """Apply only the first ``k`` block COLUMNS to ``v`` of shape (k, *shape).

        Exactly ``A @ [v; 0]`` for a vector whose trailing nc−k components
        are zero — the elided columns would multiply exact zeros, so the
        result is bit-identical while streaming k/nc of every coefficient
        array.  Stage-2 use: CPR/CPTR's x₁ has
        support only on the stage-1 unknowns when ``s_stage == "none"``,
        so the stage-2 residual r − A·x₁ needs only block columns 0:k.
        Indexing is the scalar per-entry pattern of :func:`apply_blocks`.
        """
        y = _apply_block_cols(self.diag, v)
        for a, (up, lo) in enumerate(zip(self.upper, self.lower)):
            y = y + _apply_block_cols(up, shift_minus(v, a, lead=1))
            y = y + _apply_block_cols(lo, shift_plus(v, a, lead=1))
        return y

    def matvec_offdiag(
        self, v: jax.Array, axes: tuple[int, ...] | None = None
    ) -> jax.Array:
        """The matvec WITHOUT the diagonal-block term (neighbour coupling only).

        Red-black half-sweep use: a color's update
        needs (b − A·x) only at that color's cells, where x is supported
        on the OTHER color — there the diagonal term D·x is exactly zero,
        so eliding it is bit-identical under the color mask and saves the
        diag coefficient stream.

        ``axes`` restricts the coupling to a subset of grid axes (a
        SPARSIFIED smoother operator: dropping an
        axis drops its two 9-field coefficient streams; NOT exact, gate
        on iteration counts).  None = all axes.
        """
        axs = (tuple(range(len(self.upper))) if axes is None
               else tuple(sorted(a % len(self.grid_shape) for a in axes)))
        y = None
        for a in axs:
            t = apply_blocks(self.upper[a], shift_minus(v, a, lead=1))
            y = t if y is None else y + t
            y = y + apply_blocks(self.lower[a], shift_plus(v, a, lead=1))
        return y

    def scalar(self, row: int, col: int) -> "ScalarStencil":
        """Extract the scalar sub-stencil of one (equation, unknown) pair."""
        return ScalarStencil(
            diag=self.diag[row, col],
            upper=tuple(u[row, col] for u in self.upper),
            lower=tuple(l[row, col] for l in self.lower),
        )

    def block(self, rows: slice, cols: slice) -> "BlockStencil":
        """Extract a sub-block stencil (e.g. the (p,T) 2×2 system for CPTR).

        Built by explicit per-entry stacking of the (row, col) entries.
        """
        ri = range(*rows.indices(self.nc))
        ci = range(*cols.indices(self.nc))

        def sub(a):
            return jnp.stack(
                [jnp.stack([a[i, j] for j in ci]) for i in ri]
            )

        return BlockStencil(
            diag=sub(self.diag),
            upper=tuple(sub(u) for u in self.upper),
            lower=tuple(sub(l) for l in self.lower),
        )

    def transpose(self) -> "BlockStencil":
        """The stencil of Aᵀ (exact).

        Row i of Aᵀ couples to i+e_a through L_a[i+e_a]ᵀ and to i−e_a
        through U_a[i−e_a]ᵀ (the zero-filled shifts land exactly on the
        full-shape zero-boundary convention), and the diagonal blocks
        transpose in place.  Block transposition uses the explicit
        per-entry stacking idiom of :meth:`block`.
        Used by the discrete adjoint (`solve/adjoint.py`): the transposed
        Newton Jacobian is preconditioned with the SAME CPR/CPTR + GMG
        machinery, applied to this stencil.
        """
        nc = self.nc

        def bt(a):
            return jnp.stack(
                [jnp.stack([a[j, i] for j in range(nc)]) for i in range(nc)]
            )

        return BlockStencil(
            diag=bt(self.diag),
            upper=tuple(bt(shift_minus(l, a, lead=2))
                        for a, l in enumerate(self.lower)),
            lower=tuple(bt(shift_plus(u, a, lead=2))
                        for a, u in enumerate(self.upper)),
        )

    def diag_inverse(self) -> jax.Array:
        """Per-cell inverse of the diagonal blocks, shape (nc, nc, *shape)."""
        return invert_blocks(self.diag)

    def scale_rows(self, w: jax.Array) -> "BlockStencil":
        """Left-multiply every cell's equations by a per-cell block ``w``.

        ``w`` has shape (nc, nc, *shape); this is the decoupling operation of
        CPR/CPTR (SURVEY.md §2.8): the stencil of W·A where W = blockdiag(w).
        """
        mul = lambda blk: multiply_blocks(w, blk)
        return BlockStencil(
            diag=mul(self.diag),
            upper=tuple(mul(u) for u in self.upper),
            lower=tuple(mul(l) for l in self.lower),
        )

    def to_dense(self) -> jax.Array:
        """Materialize as a dense (nc·N, nc·N) matrix (tests / tiny grids only)."""
        nc = self.nc
        shape = self.grid_shape
        n = 1
        for s in shape:
            n *= s
        eye = jnp.eye(nc * n, dtype=self.diag.dtype)
        cols = eye.reshape((nc * n, nc) + shape)
        out = jax.vmap(self.matvec)(cols)  # (ncn, nc, *shape) = A @ e_j rows
        return out.reshape(nc * n, nc * n).T


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ScalarStencil:
    """Scalar 7-point stencil (one equation, one unknown per cell)."""

    diag: jax.Array                 # (*shape,)
    upper: tuple[jax.Array, ...]
    lower: tuple[jax.Array, ...]

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.diag.shape

    def matvec(self, v: jax.Array) -> jax.Array:
        y = self.diag * v
        for a, (up, lo) in enumerate(zip(self.upper, self.lower)):
            y = y + up * shift_minus(v, a, lead=0)
            y = y + lo * shift_plus(v, a, lead=0)
        return y

    def row_abs_sum(self) -> jax.Array:
        """Σ_j |a_ij| per cell — Gershgorin bound material."""
        s = jnp.abs(self.diag)
        for up, lo in zip(self.upper, self.lower):
            s = s + jnp.abs(up) + jnp.abs(lo)
        return s

    def to_dense(self) -> jax.Array:
        """Materialize as (N, N) by direct index scatter (one op, no probing).

        Used for the multigrid coarsest-level LU, so it runs inside every
        preconditioner setup: rows/cols are static index arithmetic; the
        boundary off-diagonal entries are exactly zero by the full-shape
        stencil convention, so their clipped scatter targets are harmless.
        """
        import numpy as _np

        shape = self.grid_shape
        n = int(_np.prod(shape))
        lin = _np.arange(n).reshape(shape)
        strides = _np.array([int(_np.prod(shape[a + 1 :])) for a in range(len(shape))])

        dense = jnp.zeros((n, n), dtype=self.diag.dtype)
        dense = dense.at[lin.ravel(), lin.ravel()].add(self.diag.reshape(n))
        for a, (up, lo) in enumerate(zip(self.upper, self.lower)):
            idx = _np.indices(shape)[a]
            cols_up = _np.where(idx < shape[a] - 1, lin + strides[a], lin)
            cols_lo = _np.where(idx > 0, lin - strides[a], lin)
            dense = dense.at[lin.ravel(), cols_up.ravel()].add(
                jnp.where(jnp.asarray(idx < shape[a] - 1), up, 0.0).reshape(n)
            )
            dense = dense.at[lin.ravel(), cols_lo.ravel()].add(
                jnp.where(jnp.asarray(idx > 0), lo, 0.0).reshape(n)
            )
        return dense


def invert_blocks(d: jax.Array) -> jax.Array:
    """Invert per-cell (nc, nc) blocks stored as (nc, nc, *shape).

    Closed forms for nc∈{1,2,3} (pure elementwise arithmetic,
    no batched LAPACK), general fallback via ``jnp.linalg.inv``.
    """
    nc = d.shape[0]
    if nc == 1:
        return 1.0 / d
    if nc == 2:
        a, b = d[0, 0], d[0, 1]
        c, e = d[1, 0], d[1, 1]
        det = a * e - b * c
        inv = jnp.stack(
            [jnp.stack([e, -b]), jnp.stack([-c, a])]
        )
        return inv / det
    if nc == 3:
        a = d
        c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
        c01 = a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]
        c02 = a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]
        c10 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
        c11 = a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]
        c12 = a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]
        c20 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
        c21 = a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]
        c22 = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        det = a[0, 0] * c00 + a[0, 1] * c10 + a[0, 2] * c20
        inv = jnp.stack(
            [
                jnp.stack([c00, c01, c02]),
                jnp.stack([c10, c11, c12]),
                jnp.stack([c20, c21, c22]),
            ]
        )
        return inv / det
    # general fallback: move block axes last, batch-invert, move back
    perm = tuple(range(2, d.ndim)) + (0, 1)
    inv = jnp.linalg.inv(jnp.transpose(d, perm))
    back = (d.ndim - 2, d.ndim - 1) + tuple(range(d.ndim - 2))
    return jnp.transpose(inv, back)


def _apply_block_cols(w: jax.Array, v: jax.Array) -> jax.Array:
    """Apply the first ``v.shape[0]`` block columns of ``w`` (nc, nc, *shape)
    to a (k, *shape) vector — all nc rows out (see BlockStencil.matvec_cols)."""
    nc = w.shape[0]
    k = v.shape[0]
    rows = []
    for i in range(nc):
        acc = w[i, 0] * v[0]
        for c in range(1, k):
            acc = acc + w[i, c] * v[c]
        rows.append(acc)
    return jnp.stack(rows)


def apply_blocks(w: jax.Array, v: jax.Array) -> jax.Array:
    """Apply per-cell blocks ``w`` (nc, nc, *shape) to a vector (nc, *shape).

    Written as explicit small-index sums, not einsum: nc² elementwise
    multiply-adds that XLA fuses into one pass, with no layout shuffle of
    the leading block axes.
    """
    nc = w.shape[0]
    rows = []
    for i in range(nc):
        acc = w[i, 0] * v[0]
        for k in range(1, nc):
            acc = acc + w[i, k] * v[k]
        rows.append(acc)
    return jnp.stack(rows)


def multiply_blocks(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-cell block product a·b, both (nc, nc, *shape) (see apply_blocks)."""
    nc = a.shape[0]
    rows = []
    for i in range(nc):
        cols = []
        for j in range(nc):
            acc = a[i, 0] * b[0, j]
            for k in range(1, nc):
                acc = acc + a[i, k] * b[k, j]
            cols.append(acc)
        rows.append(jnp.stack(cols))
    return jnp.stack(rows)
