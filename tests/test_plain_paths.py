"""The plain jnp paths of the hot loop against dense algebra.

These paths are what XLA compiles for the GPU: the scalar and block stencil
matvecs, the Chebyshev smoother, the residual's JVP, the multigrid V/W/K
recursion, block red-black Gauss–Seidel and the dense coarse inverse.  Each
is checked against an independent dense-matrix reference at the shapes and
degrees that matter (ragged odd extents, 2D and 3D).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from thermalporous_tpu.precond import chebyshev, gershgorin_lambda_max
from thermalporous_tpu.precond.chebyshev import (
    _checkerboard,
    block_red_black_gauss_seidel,
)
from thermalporous_tpu.precond.gmg import (
    GMGConfig,
    _blocksum,
    _prolong,
    dense_inv,
    gmg_apply,
    gmg_setup,
)
from tests.test_gmg import poisson_stencil
from tests.test_variants import _random_block_stencil


@pytest.mark.parametrize("shape", [(16, 16), (13, 7), (8, 16, 8)])
def test_scalar_matvec_matches_dense(shape, rng):
    k = jnp.asarray(np.exp(rng.standard_normal(shape)))
    st = poisson_stencil(shape, k=k, shift=0.5)
    v = rng.standard_normal(shape)
    want = np.asarray(st.to_dense()) @ v.reshape(-1)
    got = np.asarray(st.matvec(jnp.asarray(v))).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _dense_chebyshev(a, b, x0, degree, lam_max, lam_min_frac=0.25,
                     safety=1.05):
    """Textbook Chebyshev iteration on D⁻¹A x = D⁻¹b (Saad, Alg. 12.1)."""
    dinv = 1.0 / np.diag(a)
    lmax, lmin = lam_max * safety, lam_max * lam_min_frac
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    x = x0.copy()
    z = dinv * (b - a @ x)
    d = z / theta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        x = x + d
        z = dinv * (b - a @ x)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    return x + d


@pytest.mark.parametrize("degree", [1, 2, 4])
def test_chebyshev_matches_dense(degree, rng):
    shape = (16, 16)
    st = poisson_stencil(shape, shift=0.1)
    b = rng.standard_normal(shape)
    x0 = rng.standard_normal(shape)
    lam = float(gershgorin_lambda_max(st))
    want = _dense_chebyshev(np.asarray(st.to_dense()), b.reshape(-1),
                            x0.reshape(-1), degree, lam)
    got = chebyshev(st, jnp.asarray(b), jnp.asarray(x0), degree=degree,
                    lam_max=lam)
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nc", [2, 3])
@pytest.mark.parametrize("shape", [(6, 5), (4, 5, 3)])
def test_block_matvec_matches_dense(nc, shape, rng):
    st = _random_block_stencil(rng, shape, nc=nc)
    v = rng.standard_normal((nc,) + shape)
    want = np.asarray(st.to_dense()) @ v.reshape(-1)
    got = np.asarray(st.matvec(jnp.asarray(v))).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _jvp_case(model_name, shape):
    from thermalporous_tpu.core import Grid
    from thermalporous_tpu.models import (
        SinglePhaseModel,
        TwoPhaseModel,
        make_problem_data,
    )
    from thermalporous_tpu.physics import PhysicalParams, Well

    pp = PhysicalParams()
    dim = len(shape)
    g = Grid(shape=shape, spacing=tuple(5.0 for _ in shape),
             thickness=10.0 if dim == 2 else None,
             gravity=9.81 if dim == 3 else 0.0)
    rng = np.random.default_rng(0)
    k = 2e-13 * np.exp(0.5 * rng.standard_normal(g.shape))
    corner = tuple(n - 1 for n in shape)
    wells = [
        Well(cells=(tuple(0 for _ in shape),), control="bhp", p_bh=4.0e7,
             T_inj=420.0),
        Well(cells=(corner,), control="bhp", p_bh=1.0e7),
        Well(cells=(tuple(2 for _ in shape),), control="rate", rate=-0.5),
    ]
    data = make_problem_data(g, pp, kx=k, phi=0.2, wells=wells)
    cls = SinglePhaseModel if model_name == "sp" else TwoPhaseModel
    model = cls(g, pp)
    u0 = model.initial_state(data)
    u = u0 + jnp.stack([1e5 * jnp.ones(g.shape), 5.0 * jnp.ones(g.shape)]
                       + ([0.1 * jnp.ones(g.shape)] if model.nc == 3 else []))
    v = jnp.asarray(np.random.default_rng(1).standard_normal(u.shape))
    return model, data, u0, u, v


@pytest.mark.parametrize("model_name,shape", [
    ("sp", (12, 12)), ("tp", (12, 12)),
    ("sp", (6, 8, 4)), ("tp", (6, 8, 4)),
])
def test_jvp_matches_jacfwd(model_name, shape):
    """model.jvp ≡ the dense Jacobian from jax.jacfwd applied to v."""
    model, data, u0, u, v = _jvp_case(model_name, shape)
    dt = 1200.0
    jac = jax.jacfwd(lambda x: model.residual(x, u0, dt, data))(u)
    n = u.size
    want = np.asarray(jac).reshape(n, n) @ np.asarray(v).reshape(-1)
    got = np.asarray(model.jvp(u, u0, dt, data)(v)).reshape(-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * scale)


def _dense_prolongation(fine_shape, coarse_shape, factors):
    """P as a dense matrix, column by column from unit coarse vectors."""
    nc = math.prod(coarse_shape)
    cols = []
    for j in range(nc):
        e = np.zeros(nc)
        e[j] = 1.0
        cols.append(np.asarray(_prolong(jnp.asarray(e.reshape(coarse_shape)),
                                        fine_shape, factors)).reshape(-1))
    return np.stack(cols, axis=1)


def _dense_cycle(mats, smooth, level, b, cfg):
    """Dense reference of gmg's V/W/K recursion over matrices ``mats``
    (each level: A, P to it from the next coarser level, or None)."""
    a, p = mats[level]
    if p is None:
        return np.linalg.solve(a, b)
    x = smooth(level, b, np.zeros_like(b))
    r = b - a @ x
    ec = _dense_correction(mats, smooth, level + 1, p.T @ r, cfg)
    x = x + p @ ec
    return smooth(level, b, x)


def _dense_correction(mats, smooth, level, rc, cfg):
    a, p = mats[level]
    e1 = _dense_cycle(mats, smooth, level, rc, cfg)
    if cfg.cycle_type == "v" or p is None or a.shape[0] < cfg.kcycle_min_cells:
        return e1
    if cfg.cycle_type == "w":
        return e1 + _dense_cycle(mats, smooth, level, rc - a @ e1, cfg)
    v1 = a @ e1
    rho1, alpha1 = v1 @ e1, rc @ e1
    x = (alpha1 / rho1) * e1
    r1 = rc - (alpha1 / rho1) * v1
    e2 = _dense_cycle(mats, smooth, level, r1, cfg)
    v2 = a @ e2
    gamma, beta, alpha2 = v1 @ e2, v2 @ e2, r1 @ e2
    rho2 = beta - gamma * gamma / rho1
    return x + (alpha2 / rho2) * (e2 - (gamma / rho1) * e1)


@pytest.mark.parametrize("cycle", ["v", "w", "k"])
@pytest.mark.parametrize("shape", [(16, 16), (8, 8, 8)])
def test_gmg_recursion_matches_dense(cycle, shape, rng):
    """gmg_apply ≡ the dense recursion: Galerkin A_c = PᵀAP, summation
    restriction, the same Chebyshev smoother, exact coarsest solve."""
    k = jnp.asarray(np.exp(rng.standard_normal(shape)))
    st = poisson_stencil(shape, k=k, shift=0.05)
    cfg = GMGConfig(cycle_type=cycle, max_coarse_cells=16,
                    kcycle_min_cells=4, degree=2)
    state = gmg_setup(st, cfg)
    levels = state.stencils
    assert len(levels) >= 3
    # dense Galerkin chain built from P alone, independent of the stencils
    mats = []
    a = np.asarray(levels[0].to_dense())
    for fine, coarse in zip(levels[:-1], levels[1:]):
        factors = tuple(2 if c < f else 1
                        for f, c in zip(fine.grid_shape, coarse.grid_shape))
        p = _dense_prolongation(fine.grid_shape, coarse.grid_shape, factors)
        mats.append((a, p))
        a = p.T @ a @ p
    mats.append((a, None))
    # the Galerkin stencils equal the dense triple products
    for (a_l, _), s in zip(mats, levels):
        np.testing.assert_allclose(np.asarray(s.to_dense()), a_l,
                                   rtol=1e-12, atol=1e-12)

    def smooth(level, b, x):
        s = levels[level]
        out = chebyshev(s, jnp.asarray(b.reshape(s.grid_shape)),
                        jnp.asarray(x.reshape(s.grid_shape)),
                        degree=cfg.degree, lam_max=state.lam_max[level],
                        lam_min_frac=cfg.lam_min_frac)
        return np.asarray(out).reshape(-1)

    b = rng.standard_normal(shape)
    want = _dense_cycle(mats, smooth, 0, b.reshape(-1), cfg)
    got = np.asarray(gmg_apply(state, jnp.asarray(b), cfg)).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_blocksum_is_prolongation_transpose(rng):
    """Summation restriction R = Pᵀ on a ragged (odd) 3D grid."""
    fine, factors = (5, 6, 3), (2, 2, 1)
    coarse = (3, 3, 3)
    p = _dense_prolongation(fine, coarse, factors)
    r = rng.standard_normal(fine)
    got = np.asarray(_blocksum(jnp.asarray(r), fine, factors)).reshape(-1)
    np.testing.assert_allclose(got, p.T @ r.reshape(-1), rtol=1e-12)


def _dense_block_rbgs(a, dinv_blocks, b, sweeps, red, nc):
    """Red-then-black block Gauss–Seidel on dense A with per-cell blocks."""
    n_cells = red.size
    x = np.zeros_like(b)
    for _ in range(sweeps):
        for color in (red.reshape(-1) > 0, red.reshape(-1) == 0):
            r = (b - a @ x).reshape(nc, n_cells)
            upd = np.einsum("ijc,jc->ic", dinv_blocks, r)
            x = x.reshape(nc, n_cells)
            x[:, color] += upd[:, color]
            x = x.reshape(-1)
    return x


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("shape", [(6, 5), (4, 5, 3)])
def test_block_rbgs_matches_dense(sweeps, shape, rng):
    nc = 3
    st = _random_block_stencil(rng, shape, nc=nc)
    dinv = st.diag_inverse()
    b = rng.standard_normal((nc,) + shape)
    red = np.asarray(_checkerboard(shape, jnp.float64))
    n_cells = math.prod(shape)
    want = _dense_block_rbgs(np.asarray(st.to_dense()),
                             np.asarray(dinv).reshape(nc, nc, n_cells),
                             b.reshape(-1), sweeps, red, nc)
    got = block_red_black_gauss_seidel(st, dinv, jnp.asarray(b),
                                       sweeps=sweeps)
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 2e-4), (np.float64, 1e-11)])
@pytest.mark.parametrize("n", [8, 33])
def test_dense_inv_matches_numpy(dtype, rtol, n, rng):
    """dense_inv is jnp.linalg.inv in the operand's own dtype."""
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    got = dense_inv(jnp.asarray(a, dtype))
    assert got.dtype == dtype
    want = np.linalg.inv(a.astype(dtype).astype(np.float64))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=rtol * np.abs(want).max())
