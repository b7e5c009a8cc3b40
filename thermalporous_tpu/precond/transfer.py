"""Operator-weighted prolongation and the wide (9/27-point) stencil class.

The last unmatched BoomerAMG capability (SURVEY.md §7 hard part 1):
the baseline GMG uses piecewise-constant injection /
summation transfer, whose coarse-grid correction degrades on SPE10-class
transmissibility contrast.  This module provides the cell-centred
Kwak/BoxMG-style alternative:

- :class:`WideStencil` — a scalar stencil over the full 3^dim neighbour
  box, stored as one ``(3,)*dim + shape`` coefficient array.  Weighted-P
  Galerkin coarse operators leave the 5/7-point class but stay inside
  the box class (see support analysis below); wide stencils appear ONLY
  on GMG levels below the finest, where the extra bandwidth rides on
  ≤ half-size grids.
- :func:`transfer_weights` — per-axis two-point interpolation weights
  from the level operator's own axis couplings (flux continuity: a fine
  cell's error is the |transmissibility|-weighted average of its parent
  coarse cell and the coarse cell across its outer face).  The
  full-shape zero-boundary convention makes domain edges fall back to
  parent injection automatically.
- :func:`prolong_weighted` — P applied axis-by-axis (tensor form;
  weights for a still-coarse axis are even-index subsampled).
  Restriction stays the SUMMATION operator of the baseline GMG (the
  Kwak cell-centred pair): with R = summation and this 2-point-per-axis
  P, every Galerkin product R·A·P of a box-support A has coarse support
  |i−j| ≤ 1 per axis — the 9/27-point class — whereas the adjoint pair
  R = Pᵀ would widen support to ±2 per axis.
- :func:`galerkin_wide` — A_c = R·A·P by 3^dim-colour probing: exact
  coefficient extraction of any ≤3-support-per-axis operator from
  3^dim composed applications, independent of the P/R details and
  testable against dense RAP.

- the VARIATIONAL pair (round-3 extension, the "5-wide class" the
  ledger names as the dt=76.8 ks next step): :func:`restrict_weighted`
  is R = Pᵀ, and :func:`galerkin_variational` builds A_c = Pᵀ·A·P
  EXACTLY by per-axis coefficient conjugation — no 5^dim probing.  With
  the 2-point-per-axis P, PᵀAP widens support to |i−j| ≤ 2 along each
  CONJUGATED axis only; :class:`BoxStencil` carries static per-axis
  half-widths so z-first adaptive schedules pay for width only where
  they coarsened.  Unlike the summation-R pair this one is Galerkin in
  the variational sense: on SPD A the coarse correction is an
  A-orthogonal projection regardless of how rough the weights are
  (dense analysis: the rough-field divergence of the Kwak pair
  disappears; tests/test_transfer.py).

Lowering: the apply path (matvec, P) is pure shift/elementwise
arithmetic on full-shape arrays; probing performs one static gather per
offset at setup time only.  Signs are not assumed: weights use
|coupling|, so intermediate Galerkin levels need not be M-matrices.
All variational-path lowerings are mask × zero-fill-shift × pairwise
block-sum (no strided views, no gathers).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp

from thermalporous_tpu.core.grid import shift_minus, shift_plus
from thermalporous_tpu.core.stencil import ScalarStencil


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WideStencil:
    """Scalar stencil over the full 3^dim neighbour box.

    ``coef[o0, o1(, o2)]`` couples cell ``i`` to ``i + (o-1)`` per axis;
    entries pointing outside the domain are zero (full-shape convention,
    same as :class:`ScalarStencil`).
    """

    coef: jax.Array  # (3,)*dim + shape

    @property
    def dim(self) -> int:
        return self.coef.ndim // 2  # (3,)*dim + shape, len(shape) == dim

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.coef.shape[self.dim:]

    @property
    def diag(self) -> jax.Array:
        return self.coef[(1,) * self.dim]

    def matvec(self, v: jax.Array) -> jax.Array:
        dim = self.dim
        y = jnp.zeros_like(v)
        for off in itertools.product((0, 1, 2), repeat=dim):
            w = v
            for a, o in enumerate(off):
                if o == 2:      # neighbour at +a: bring v[i+1] to i
                    w = shift_minus(w, a, lead=0)
                elif o == 0:    # neighbour at -a
                    w = shift_plus(w, a, lead=0)
            y = y + self.coef[off] * w
        return y

    def row_abs_sum(self) -> jax.Array:
        dim = self.dim
        flat = self.coef.reshape((3 ** dim,) + self.grid_shape)
        return jnp.sum(jnp.abs(flat), axis=0)

    def to_dense(self) -> jax.Array:
        n = math.prod(self.grid_shape)
        eye = jnp.eye(n, dtype=self.coef.dtype)
        cols = eye.reshape((n,) + self.grid_shape)
        out = jax.vmap(self.matvec)(cols)
        return out.reshape(n, n).T


def as_wide(st: ScalarStencil) -> WideStencil:
    """Embed a 5/7-point ScalarStencil in the wide class (exact)."""
    dim = len(st.grid_shape)
    shape = st.grid_shape
    coef = jnp.zeros((3,) * dim + shape, dtype=st.diag.dtype)
    coef = coef.at[(1,) * dim].set(st.diag)
    for a in range(dim):
        up_idx = tuple(2 if i == a else 1 for i in range(dim))
        lo_idx = tuple(0 if i == a else 1 for i in range(dim))
        coef = coef.at[up_idx].set(st.upper[a])
        coef = coef.at[lo_idx].set(st.lower[a])
    return WideStencil(coef=coef)


def _axis_couplings(st, a: int) -> tuple[jax.Array, jax.Array]:
    """|coupling| of each cell to its -a / +a side.

    ScalarStencil/WideStencil read the axis-aligned entries (the Kwak
    face-transmissibility analogue); BoxStencil levels (variational
    hierarchy) aggregate |coef| over ALL offsets on each side of axis
    ``a`` — the ±2 and cross couplings PᵀAP introduces carry real
    directional strength that the axis-aligned entry alone understates.
    """
    if isinstance(st, BoxStencil):
        dim = st.dim
        hw = st.half_widths
        lo = jnp.zeros(st.grid_shape, st.coef.dtype)
        up = jnp.zeros(st.grid_shape, st.coef.dtype)
        for off in itertools.product(*[range(2 * h + 1) for h in hw]):
            o = off[a] - hw[a]
            if o < 0:
                lo = lo + jnp.abs(st.coef[off])
            elif o > 0:
                up = up + jnp.abs(st.coef[off])
        return lo, up
    if isinstance(st, WideStencil):
        dim = st.dim
        lo = st.coef[tuple(0 if i == a else 1 for i in range(dim))]
        up = st.coef[tuple(2 if i == a else 1 for i in range(dim))]
    else:
        lo, up = st.lower[a], st.upper[a]
    return jnp.abs(lo), jnp.abs(up)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AxisWeights:
    """Per-axis interpolation weights at that axis's application shape.

    For each fine cell along the coarsened axis: ``w_self`` multiplies the
    parent coarse value, ``w_out`` the coarse neighbour across the cell's
    outer face (the previous coarse cell for even children, the next for
    odd children).  ``w_self + w_out = 1``; boundary cells have
    ``w_self = 1`` (their outer coupling is zero by convention).
    """

    w_self: jax.Array
    w_out: jax.Array


def _axis_weights(
    wl: jax.Array, wr: jax.Array, a: int, floor: float = 0.75
) -> AxisWeights:
    """Resistance-calibrated 1D weights from |couplings| wl (-a) / wr (+a).

    Cell-centred geometry: fine cell centres sit at ±¼ coarse-cell units
    from their parent's centre, so homogeneous linear interpolation needs
    weights (¾ parent, ¼ outer) — NOT the (½, ½) a naive flux collapse
    gives.  (½, ½) is catastrophic under Galerkin with summation R: the
    averaging P makes the coarse DIFFUSION cancel (measured: level-1
    degenerates to the mass term and V-cycle iterations triple).  In
    resistance form the parent is reached through half the sibling face
    (conductance 2·T_sib → here folded as 3·T_sib against 1·T_out, which
    reproduces exactly ¾/¼ homogeneous):

      even child f (sibling at +a, outer at −a):
        w_parent = 3·wr / (3·wr + wl),  w_out = wl / (3·wr + wl)
      odd child mirrors.

    Heterogeneous limits: impermeable outer face (wl→0) → pure parent
    injection; in the other direction the parent weight is FLOORED at the
    homogeneous ¾ — heterogeneity may only pull P TOWARD injection, never
    below the linear-interpolation parent share.  Two measured failure
    modes motivate the floor (both summation-R pathologies — with R ≠ Pᵀ
    the pair is Petrov–Galerkin and has no variational safety net; dense
    two-level analysis in tests/test_transfer.py):
    - w_self → 0 (child defers to the neighbouring coarse cell) collapses
      the Galerkin coarse DIAGONAL: on full SPE10 (10⁶ channel contrast)
      row-sum/|diag| ratios reach 10⁹, Gershgorin λ overflows and the
      smoother NaNs, on every backend.
    - Even bounded w_self ∈ [½, ¾) on ROUGH (per-cell random) coefficient
      fields makes the two-level iteration DIVERGE outright (measured
      asymptotic ρ = 9.8 on a 4-decade lognormal 32² field, vs 0.93 for
      constant transfer; the variational pair Pᵀ·A·P is stable at 0.855
      but needs a 5-per-axis stencil class).  With the ¾ floor the same
      field CONVERGES and beats constant transfer (V-cycle FGMRES 33 vs
      42 in 2D, 34 vs 38 in 3D), while the smooth/layered wins are
      retained (Poisson 3D 20→7, layered 4-decade 2D 25→16).
    Zero-coupling cells inject from the parent.

    ``floor`` is the parent-weight floor: ¾ is the shipped value for the
    summation-R (Petrov–Galerkin) pair; the VARIATIONAL pair R = Pᵀ has
    the PᵀAP safety net and tolerates lower floors that track the
    heterogeneity more aggressively (the caller sweeps it).

    Lone-child guard: an even child whose sibling slot falls outside the
    domain (the last cell of an odd-length axis) IS its coarse parent —
    the raw formula reads its zero sibling coupling as "defer to the
    outer coarse cell" (w_self → floor), which at low floors starves the
    parent's P column (singular PᵀAP in the worst case).  Such cells
    inject exactly (w_self = 1).
    """
    shape = wl.shape
    idx = jnp.arange(shape[a]).reshape(
        tuple(shape[a] if i == a else 1 for i in range(len(shape)))
    )
    even = idx % 2 == 0
    se = 3.0 * wr + wl
    so = 3.0 * wl + wr
    w_par_even = jnp.where(se > 0, 3.0 * wr / jnp.where(se > 0, se, 1.0), 1.0)
    w_par_odd = jnp.where(so > 0, 3.0 * wl / jnp.where(so > 0, so, 1.0), 1.0)
    w_self = jnp.maximum(jnp.where(even, w_par_even, w_par_odd), floor)
    lone = even & (idx == shape[a] - 1)
    w_self = jnp.where(lone, 1.0, w_self)
    return AxisWeights(w_self=w_self, w_out=1.0 - w_self)


def _subsample(x: jax.Array, axes: tuple[int, ...]) -> jax.Array:
    """Even-index subsample along ``axes`` (tensor-form weight reduction).

    Implemented as even-mask × pairwise block-sum, not a strided slice:
    the same lowering the restriction uses.
    """
    from thermalporous_tpu.precond.gmg import _blocksum

    for a in axes:
        mask = _even_mask(x.shape, a, x.dtype)
        fac = tuple(2 if i == a else 1 for i in range(x.ndim))
        x = _blocksum(x * mask, x.shape, fac)
    return x


def transfer_weights(
    st, factors: tuple[int, ...], floor: float = 0.75
) -> tuple[AxisWeights | None, ...]:
    """Build per-axis weights for every coarsened axis of this level.

    Axis ``a``'s 1D interpolation is applied (during prolongation) when
    all LOWER-indexed coarsened axes are already at fine resolution and
    all higher-indexed ones are still coarse — so its weight arrays are
    the fine-grid weights even-index-subsampled along those higher axes.
    """
    dim = len(factors)
    out: list[AxisWeights | None] = []
    for a in range(dim):
        if factors[a] != 2:
            out.append(None)
            continue
        wl, wr = _axis_couplings(st, a)
        aw = _axis_weights(wl, wr, a, floor=floor)
        higher = tuple(b for b in range(a + 1, dim) if factors[b] == 2)
        out.append(AxisWeights(
            w_self=_subsample(aw.w_self, higher),
            w_out=_subsample(aw.w_out, higher),
        ))
    return tuple(out)


def _even_mask(shape: tuple[int, ...], a: int, dtype) -> jax.Array:
    idx = jnp.arange(shape[a]).reshape(
        tuple(shape[a] if i == a else 1 for i in range(len(shape)))
    )
    return (idx % 2 == 0).astype(dtype)


def _prolong_axis(e: jax.Array, fine_n: int, a: int, w: AxisWeights) -> jax.Array:
    """1D weighted prolongation along axis ``a`` (coarse m → fine n)."""
    inj = jnp.repeat(e, 2, axis=a)
    if inj.shape[a] != fine_n:
        inj = jax.lax.slice_in_dim(inj, 0, fine_n, axis=a)
    even = _even_mask(inj.shape, a, inj.dtype)
    # outer coarse neighbour's value: for even f it's the injected value
    # at f-1 (previous coarse cell), for odd f at f+1 (next coarse cell)
    outer = even * shift_plus(inj, a, lead=0) + (1.0 - even) * shift_minus(
        inj, a, lead=0
    )
    return w.w_self * inj + w.w_out * outer


def prolong_weighted(
    e: jax.Array,
    fine_shape: tuple[int, ...],
    weights: tuple[AxisWeights | None, ...],
) -> jax.Array:
    """P e: axis-by-axis weighted prolongation (axis 0 first)."""
    for a, w in enumerate(weights):
        if w is not None:
            e = _prolong_axis(e, fine_shape[a], a, w)
    return e


def galerkin_wide(
    st,
    weights: tuple[AxisWeights | None, ...],
    coarse_shape: tuple[int, ...],
) -> WideStencil:
    """A_c = R·A·P by 3^dim-colour probing, R = summation restriction.

    For every colour k ∈ {0,1,2}^dim, apply the composed operator to the
    coarse indicator of cells ≡ k (mod 3); entry (i → i+o-1) of A_c is
    then read off the probe whose colour matches the target cell.  One
    static gather per offset assembles the (3,)*dim coefficient array.
    Exactness requires coarse support |i−j| ≤ 1 per axis, which the
    summation-R / 2-point-P pair guarantees (module docstring).
    """
    from thermalporous_tpu.precond.gmg import _blocksum

    dim = len(coarse_shape)
    fine_shape = st.grid_shape
    dtype = st.diag.dtype
    factors = tuple(2 if c < f else 1 for f, c in zip(fine_shape, coarse_shape))
    idx = [
        jnp.arange(coarse_shape[a]).reshape(
            tuple(coarse_shape[a] if i == a else 1 for i in range(dim))
        )
        for a in range(dim)
    ]

    # one vmapped probe body instead of 3^dim unrolled copies: the
    # weighted hierarchy is rebuilt inside the jitted Newton loop, and an
    # unrolled probe loop over every level blows up compile time
    masks = []
    for k in itertools.product((0, 1, 2), repeat=dim):
        mask = jnp.ones(coarse_shape, dtype=dtype)
        for a in range(dim):
            mask = mask * (idx[a] % 3 == k[a]).astype(dtype)
        masks.append(mask)
    Y = jax.vmap(
        lambda m: _blocksum(
            st.matvec(prolong_weighted(m, fine_shape, weights)),
            fine_shape,
            factors,
        )
    )(jnp.stack(masks))  # (3^dim, *coarse)

    # Coefficient extraction WITHOUT a data-dependent gather.  Colours are
    # periodic with period 3 per axis, so every cell in residue class
    # r ∈ {0,1,2}^dim reads, for offset o, the CONSTANT colour
    # c(r,o) = colour(r + o - 1 mod 3): the per-cell colour lookup
    # factors into 3^dim residue masks (the SAME iota products used for
    # probing) times statically-indexed rows of Y — no data-dependent
    # gather over the colour axis.
    coefs = []
    for off in itertools.product((0, 1, 2), repeat=dim):
        inside = jnp.ones(coarse_shape, dtype=bool)
        for a in range(dim):
            j = idx[a] + (off[a] - 1)
            inside = inside & (j >= 0) & (j < coarse_shape[a])
        acc = jnp.zeros(coarse_shape, dtype=dtype)
        for ri, r in enumerate(itertools.product((0, 1, 2), repeat=dim)):
            c = 0
            for a in range(dim):
                c = c * 3 + (r[a] + off[a] - 1) % 3
            acc = acc + masks[ri] * Y[c]
        coefs.append(jnp.where(inside, acc, 0.0))
    return WideStencil(coef=jnp.stack(coefs).reshape(
        (3,) * dim + coarse_shape))


# --------------------------------------------------------------------------
# Variational pair: R = Pᵀ, A_c = Pᵀ·A·P on a per-axis-width box class
# --------------------------------------------------------------------------


def _shift_k(x: jax.Array, a: int, k: int) -> jax.Array:
    """``x[i] ← x[i+k]`` along spatial axis ``a``, zero-filled (static k).

    Composed from the proven shift_minus/shift_plus pad+slice lowerings —
    no strided views."""
    for _ in range(abs(k)):
        x = shift_minus(x, a, lead=0) if k > 0 else shift_plus(x, a, lead=0)
    return x


def _shift_table(
    base: jax.Array, offs: list[tuple[int, ...]], lead: int
) -> dict[tuple[int, ...], jax.Array]:
    """offset → ``base`` shifted by the FULL offset vector, zero-filled.

    Built incrementally — every entry is ONE unit pad+slice from its
    L1-closer parent — so a (2h+1)^dim box costs exactly one shift node
    per offset instead of an O(Σ|off|) chain per (offset, use) pair.
    This is the compile-cost fix for the variational setup: the original
    per-term formulation emitted ~10k HLO ops per conjugated axis and
    took minutes to compile even on tiny grids (measured 252 s for one
    cpr_setup at 8×16×6); the table + stacked products below bring the
    graph back to O(#offsets) nodes.  Shift composition along different
    axes commutes, and zero-fill composes exactly.
    """
    table: dict[tuple[int, ...], jax.Array] = {}

    def build(off: tuple[int, ...]) -> jax.Array:
        if off in table:
            return table[off]
        if not any(off):
            out = base
        else:
            b = next(i for i, o in enumerate(off) if o)
            s = 1 if off[b] > 0 else -1
            parent = off[:b] + (off[b] - s,) + off[b + 1:]
            p = build(parent)
            out = (shift_minus(p, b, lead=lead) if s > 0
                   else shift_plus(p, b, lead=lead))
        table[off] = out
        return out

    for off in sorted(offs, key=lambda o: sum(map(abs, o))):
        build(off)
    return table


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BoxStencil:
    """Scalar stencil over a STATIC per-axis offset box.

    ``coef[i0, i1(, i2)]`` couples cell ``c`` to ``c + (i_a − hw_a)`` per
    axis, where ``hw_a = (coef.shape[a] − 1)//2`` is axis ``a``'s
    half-width; out-of-domain couplings are zero (full-shape convention).

    The variational Galerkin product PᵀAP of the 2-point-per-axis P
    widens support to ±2 ONLY along axes the level actually coarsened,
    so — unlike a uniform 5^dim box — a z-first adaptive schedule pays
    bandwidth only where it aggregated (e.g. SPE10 level 1 is 5×3×3-wide
    after z-only coarsening, not 125-point).
    """

    coef: jax.Array  # (w0, ..., w_{dim-1}) + grid_shape, each w odd

    @property
    def dim(self) -> int:
        return self.coef.ndim // 2

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.coef.shape[self.dim:]

    @property
    def half_widths(self) -> tuple[int, ...]:
        return tuple((w - 1) // 2 for w in self.coef.shape[: self.dim])

    @property
    def diag(self) -> jax.Array:
        return self.coef[self.half_widths]

    def matvec(self, v: jax.Array) -> jax.Array:
        hw = self.half_widths
        offs = list(itertools.product(*[range(-h, h + 1) for h in hw]))
        table = _shift_table(v, offs, lead=0)
        w = jnp.stack([table[o] for o in offs])
        flat = self.coef.reshape((len(offs),) + self.grid_shape)
        return jnp.sum(flat * w, axis=0)

    def row_abs_sum(self) -> jax.Array:
        flat = self.coef.reshape((-1,) + self.grid_shape)
        return jnp.sum(jnp.abs(flat), axis=0)

    def to_dense(self) -> jax.Array:
        n = math.prod(self.grid_shape)
        eye = jnp.eye(n, dtype=self.coef.dtype)
        cols = eye.reshape((n,) + self.grid_shape)
        out = jax.vmap(self.matvec)(cols)
        return out.reshape(n, n).T


def _coef_dict(st) -> dict[tuple[int, ...], jax.Array]:
    """Signed offset → coefficient array, only offsets that exist."""
    if isinstance(st, BoxStencil):
        hw = st.half_widths
        return {
            tuple(o - h for o, h in zip(off, hw)): st.coef[off]
            for off in itertools.product(*[range(2 * h + 1) for h in hw])
        }
    dim = len(st.grid_shape)
    out = {(0,) * dim: st.diag}
    for a in range(dim):
        out[tuple(1 if i == a else 0 for i in range(dim))] = st.upper[a]
        out[tuple(-1 if i == a else 0 for i in range(dim))] = st.lower[a]
    return out


def _box_from_dict(
    coefs: dict[tuple[int, ...], jax.Array], shape: tuple[int, ...]
) -> BoxStencil:
    dim = len(shape)
    hw = tuple(max(abs(off[a]) for off in coefs) for a in range(dim))
    widths = tuple(2 * h + 1 for h in hw)
    zero = jnp.zeros(shape, next(iter(coefs.values())).dtype)
    rows = [
        coefs.get(tuple(i[a] - hw[a] for a in range(dim)), zero)
        for i in itertools.product(*[range(w) for w in widths])
    ]
    return BoxStencil(coef=jnp.stack(rows).reshape(widths + tuple(shape)))


def restrict_weighted(
    r: jax.Array, weights: tuple[AxisWeights | None, ...]
) -> jax.Array:
    """R r with R = Pᵀ — the exact adjoint of :func:`prolong_weighted`.

    P applies axis 0 first, so Pᵀ applies the highest axis's adjoint
    first (each at exactly the mixed shape its weight arrays carry).
    Per axis, coarse ``j`` collects the parent weights of its children
    (fine ``2j``, ``2j+1``) and the outer weights of the two fine cells
    whose OUTER coarse cell is ``j`` (even ``2j+2``, odd ``2j−1``).
    Mask × zero-fill-shift × pairwise block-sum lowerings only.
    """
    from thermalporous_tpu.precond.gmg import _blocksum

    for a in reversed(range(len(weights))):
        w = weights[a]
        if w is None:
            continue
        shape = r.shape
        even = _even_mask(shape, a, r.dtype)
        odd = 1.0 - even
        g = w.w_out * r
        t = even * (_shift_k(g * even, a, 2) + _shift_k(g * odd, a, -1))
        factors = tuple(2 if i == a else 1 for i in range(r.ndim))
        r = _blocksum(w.w_self * r + t, shape, factors)
    return r


def _conjugate_axis(
    coefs: dict[tuple[int, ...], jax.Array], a: int, w: AxisWeights
) -> dict[tuple[int, ...], jax.Array]:
    """Pᵀ·Ã·P along axis ``a`` on offset→coefficient dicts (exact).

    1D algebra at fixed other-axis offsets: write fine rows as
    ``f = 2j + r`` and fold P's two-point columns into residue-masked
    weight arrays ``q_r`` (``q_0/q_1`` the parent weights on even/odd
    cells, ``q_{−1}/q_2`` the outer weights).  Then

      c_d[j] = Σ_{r,r'} q_r[f] · ã_δ[f] · q_{r'}[f+δ],   δ = 2d + r' − r,

    summed over the offsets δ the input actually has; |d| ≤ 2 always
    (the box class is closed).  Every term is shift × multiply ×
    (residue mask + pairwise block-sum) — no gathers —
    and block-sums are batched once per output offset.
    """
    any_arr = next(iter(coefs.values()))
    shape, dtype = any_arr.shape, any_arr.dtype
    even = _even_mask(shape, a, dtype)
    odd = 1.0 - even
    rs = (-1, 0, 1, 2)
    q = {
        0: w.w_self * even,
        1: w.w_self * odd,
        -1: w.w_out * odd,
        2: w.w_out * even,
    }

    # Column factors q_{r'} sampled at the FULL fine offset f + off: the
    # weight arrays vary along every axis, so the shift must follow the
    # off-axis components of the coupling too (the input coefficient is
    # zero wherever f + off leaves the domain, so the zero-filled shift
    # is exact).  All four r' share one incrementally-built shift table
    # over a stacked (4, *shape) array — one pad+slice node per offset.
    offs = sorted(coefs)
    q_stack = jnp.stack([q[r] for r in rs])
    table = _shift_table(q_stack, offs, lead=1)

    # Stacked per-(r, r') products.  Within one (r, r') pair the key map
    # off → (…, d, …) is injective (d is a bijection of off[a]), so the
    # pair's terms never collide; collisions happen only ACROSS pairs and
    # are resolved by per-key slice+add below (elementwise only — no
    # scatters, no flattening reshapes: shard-safe).
    acc: dict[tuple[int, ...], jax.Array] = {}
    for ir, r in enumerate(rs):
        for irp, rp in enumerate(rs):
            sel = [o for o in offs if (o[a] + r - rp) % 2 == 0
                   and abs((o[a] + r - rp) // 2) <= 2]
            if not sel:
                continue
            C = jnp.stack([coefs[o] for o in sel])
            Q = jnp.stack([table[o][irp] for o in sel])
            g = q_stack[ir] * C * Q
            # land fine row 2j+r on the residue the block-sum reads
            if r == -1:
                g = even * shift_plus(g, a, lead=1)    # h[2j] = g[2j−1]
            elif r == 2:
                g = even * shift_minus(                 # h[2j] = g[2j+2]
                    shift_minus(g, a, lead=1), a, lead=1)
            elif r == 0:
                g = even * g
            else:
                g = odd * g                             # block-sum reads 2j+1
            for i, o in enumerate(sel):
                key = o[:a] + ((o[a] + r - rp) // 2,) + o[a + 1:]
                acc[key] = acc[key] + g[i] if key in acc else g[i]

    # batched pairwise block-sum along the conjugated axis only
    out_keys = sorted(acc)
    x = jnp.stack([acc[k] for k in out_keys])
    ax = 1 + a
    if x.shape[ax] % 2 == 1:
        pad = [(0, 0)] * x.ndim
        pad[ax] = (0, 1)
        x = jnp.pad(x, pad)
    m = x.shape[ax] // 2
    x = x.reshape(x.shape[:ax] + (m, 2) + x.shape[ax + 1:]).sum(axis=ax + 1)
    return {k: x[i] for i, k in enumerate(out_keys)}


def galerkin_variational(
    st,
    weights: tuple[AxisWeights | None, ...],
    coarse_shape: tuple[int, ...],
) -> BoxStencil:
    """A_c = Pᵀ·A·P, exact, by per-axis coefficient conjugation.

    P is the same axis-by-axis weighted prolongation as the Kwak path
    (axis 0 applied first), so A_c = P₀ᵀ·…·P_{d−1}ᵀ·A·P_{d−1}·…·P₀ is
    built by conjugating the HIGHEST coarsened axis first — at which
    point the weight arrays from :func:`transfer_weights` (subsampled
    along higher axes only) sit at exactly the current mixed shape.
    Cost scales with the offsets the operator actually has (unlike
    5^dim probing), and the result keeps minimal per-axis widths.
    """
    coefs = _coef_dict(st)
    for a in reversed(range(len(coarse_shape))):
        if weights[a] is not None:
            coefs = _conjugate_axis(coefs, a, weights[a])
    return _box_from_dict(coefs, coarse_shape)
