"""High-precision dense reference solver ("oracle").

The reference validates against Firedrake/PETSc; with the reference binary
unavailable (SURVEY.md §0), the rebuild's numerical acceptance gate is this
f64 dense-LU Newton path over the SAME residual functions: the production
Newton–FGMRES–CPTR stack must reproduce the oracle's states per-timestep to
tight tolerance (SURVEY.md §4 item 3).  Tiny grids only (dense Jacobian).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from thermalporous_tpu.models.base import ProblemData, ThermalModelBase
from thermalporous_tpu.solve.newton import NewtonConfig

#: per-component absolute tolerances (p [Pa], T [K], S_w) within which the
#: production solver at tight Newton/Krylov tolerances must reproduce the
#: oracle's state: the parity gate of the tests and of chip_smoke.py
ORACLE_ATOL = (50.0, 1e-4, 1e-7)
#: the tight Newton/Krylov tolerances of that comparison
ORACLE_NEWTON = NewtonConfig(rtol=1e-10, ksp_rtol=1e-8, ksp_maxiter=80,
                             max_iters=25)


def state_errors(u, u_ref) -> list[float]:
    """Max absolute error per state component against an oracle state."""
    u, u_ref = np.asarray(u), np.asarray(u_ref)
    return [float(np.max(np.abs(u[c] - u_ref[c]))) for c in range(u.shape[0])]


def dense_newton_step(
    model: ThermalModelBase,
    u_old: jax.Array,
    dt: float,
    data: ProblemData,
    rtol: float = 1e-12,
    atol: float = 0.0,
    max_iters: int = 50,
    max_backtracks: int = 10,
) -> np.ndarray:
    """One backward-Euler step solved by dense-LU Newton (numpy, f64)."""
    u = np.asarray(u_old, dtype=np.float64)
    shape = u.shape
    n = u.size

    def res(x):
        return np.asarray(model.residual(jnp.asarray(x), u_old, dt, data))

    f = res(u)
    nrm0 = np.linalg.norm(f)
    tol = max(rtol * nrm0, atol)
    for _ in range(max_iters):
        nrm = np.linalg.norm(f)
        if nrm <= tol:
            break
        jac = jax.jacfwd(lambda x: model.residual(x, u_old, dt, data))(jnp.asarray(u))
        jac = np.asarray(jac).reshape(n, n)
        dx = np.linalg.solve(jac, -f.reshape(n)).reshape(shape)
        alpha = 1.0
        accepted = False
        for _ in range(max_backtracks):
            u_try = u + alpha * dx
            f_try = res(u_try)
            n_try = np.linalg.norm(f_try)
            if np.isfinite(n_try) and n_try <= (1.0 - 1e-4 * alpha) * nrm:
                accepted = True
                break
            alpha *= 0.5
        if not accepted:
            # the oracle is the parity gate: never adopt a non-decreasing
            # (possibly non-finite) iterate silently — mirror newton_solve's
            # failed flag by raising here
            raise RuntimeError(
                f"oracle line search exhausted {max_backtracks} backtracks: "
                f"|F|={nrm:.3e}, best try |F|={n_try:.3e}"
            )
        u, f = u_try, f_try
    else:
        raise RuntimeError(f"oracle Newton did not converge: |F|={nrm:.3e}")
    return u


def oracle_run(
    model: ThermalModelBase,
    data: ProblemData,
    dts: list[float],
    u0: jax.Array | None = None,
    **kwargs,
) -> list[np.ndarray]:
    """Run a fixed Δt sequence; returns the state after every step."""
    u = np.asarray(model.initial_state(data) if u0 is None else u0)
    states = []
    for dt in dts:
        u = dense_newton_step(model, jnp.asarray(u), dt, data, **kwargs)
        states.append(u.copy())
    return states
