"""Dense two-level analysis: is the VARIATIONAL pair (weighted P, R = Pᵀ)
worth a 5-wide stencil class?  (The decision gate for the dt=76.8 ks wall —
docs/parity.md known-gaps.)

Compares asymptotic two-level convergence factors ρ(E), E = S²·CGC·S²
(deg-2 damped-Jacobi smoothing, exact coarse solve) for:
  - constant:   injection P, summation R            (production)
  - kwak¾:      ¾-floored weighted P, summation R   (shipped "weighted")
  - var(f):     weighted P at floor f, R = Pᵀ, Ac = PᵀAP (the candidate)
on (a) the rough lognormal field of the round-3 ledger, (b) channelized
synthetic-SPE10 crops in 2D and 3D, (c) a hard-dt-like tiny diagonal
shift (dt=76.8 ks makes accumulation ≪ transmissibility).

CPU-only, pure dense numpy on top of the in-repo prolong_weighted.

Usage: python tools/diag_var.py
"""

from __future__ import annotations

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from thermalporous_tpu.core.stencil import ScalarStencil
from thermalporous_tpu.precond.transfer import prolong_weighted, transfer_weights


def tpfa_stencil(k: np.ndarray, shift: float) -> ScalarStencil:
    """TPFA-like operator from a permeability field: harmonic-mean face
    transmissibilities, zero at domain faces, diag = row sum + shift."""
    shape = k.shape
    dim = len(shape)
    uppers, lowers = [], []
    diag = np.full(shape, shift, np.float64)
    for a in range(dim):
        kn = np.roll(k, -1, axis=a)
        t = 2.0 * k * kn / (k + kn)
        idx = np.arange(shape[a]).reshape(
            tuple(shape[a] if i == a else 1 for i in range(dim)))
        t = t * (idx < shape[a] - 1)
        lo = np.roll(t, 1, axis=a) * (idx > 0)
        uppers.append(jnp.asarray(-t))
        lowers.append(jnp.asarray(-lo))
        diag = diag + t + lo
    return ScalarStencil(diag=jnp.asarray(diag),
                         upper=tuple(uppers), lower=tuple(lowers))


def dense_P_weighted(st, shape, floor):
    factors = tuple(2 for _ in shape)
    w = transfer_weights(st, factors, floor=floor)
    nc = tuple(-(-n // 2) for n in shape)
    Nc = int(np.prod(nc))
    cols = jnp.asarray(np.eye(Nc).reshape((Nc,) + nc))
    P = jax.vmap(lambda e: prolong_weighted(e, shape, w))(cols)
    return np.asarray(P).reshape(Nc, -1).T


def dense_P_const(shape):
    nc = tuple(-(-n // 2) for n in shape)
    N, Nc = int(np.prod(shape)), int(np.prod(nc))
    P = np.zeros((N, Nc))
    for fi in np.ndindex(*shape):
        ci = tuple(f // 2 for f in fi)
        P[np.ravel_multi_index(fi, shape), np.ravel_multi_index(ci, nc)] = 1.0
    return P


def rho(A: np.ndarray, P: np.ndarray, R: np.ndarray) -> float:
    D = np.diag(A)
    S = np.eye(A.shape[0]) - 0.8 * (A / D[:, None])
    Ac = R @ A @ P
    CGC = np.eye(A.shape[0]) - P @ np.linalg.solve(Ac, R @ A)
    E = np.linalg.matrix_power(S, 2) @ CGC @ np.linalg.matrix_power(S, 2)
    return float(np.max(np.abs(np.linalg.eigvals(E))))


def row(tag, st):
    A = np.asarray(st.to_dense())
    shape = st.grid_shape
    Pc = dense_P_const(shape)
    out = [("const", rho(A, Pc, Pc.T))]
    P34 = dense_P_weighted(st, shape, 0.75)
    out.append(("kwak3/4+sumR", rho(A, P34, Pc.T)))
    for f in (0.75, 0.5, 0.0):
        Pw = dense_P_weighted(st, shape, f)
        out.append((f"var({f})", rho(A, Pw, Pw.T)))
    print(f"{tag:34s} " + "  ".join(f"{k}={v:7.4f}" for k, v in out))


def channel_field(shape, seed, decades=6.0):
    from thermalporous_tpu.data.spe10 import synthetic_spe10

    if len(shape) == 2:
        f = synthetic_spe10(shape=shape + (4,), seed=seed)
        k = np.asarray(f.kx, np.float64)[..., 0]
    else:
        f = synthetic_spe10(shape=shape, seed=seed)
        k = np.asarray(f.kx, np.float64)
    k = np.log(k)
    k = (k - k.min()) / max(k.max() - k.min(), 1e-30)
    return 10.0 ** (decades * (k - 0.5))


def main():
    rng = np.random.default_rng(7)

    # (a) the ledger's rough lognormal 2D field (4 decades)
    n = 32
    k = 10.0 ** rng.uniform(-2, 2, size=(n, n))
    row("rough lognormal 32^2, shift 1e-2", tpfa_stencil(k, 1e-2))
    row("rough lognormal 32^2, shift 1e-6", tpfa_stencil(k, 1e-6))

    # (b) channelized synthetic-SPE10 2D crop, 6 decades
    k2 = channel_field((48, 48), seed=3)
    row("channelized 48^2, shift 1e-2", tpfa_stencil(k2, 1e-2))
    row("channelized 48^2, shift 1e-6", tpfa_stencil(k2, 1e-6))

    # (c) channelized 3D crop with thin-cell-style z anisotropy (x30)
    k3 = channel_field((16, 16, 8), seed=3)
    st3 = tpfa_stencil(k3, 1e-6)
    st3 = ScalarStencil(
        diag=st3.diag + 29.0 * (-st3.upper[2] - st3.lower[2]),
        upper=st3.upper[:2] + (30.0 * st3.upper[2],),
        lower=st3.lower[:2] + (30.0 * st3.lower[2],),
    )
    row("channelized 16x16x8 aniso-z, 1e-6", st3)

    # (d) odd-length axes (SPE10 z=85-style lone children)
    k4 = channel_field((15, 13), seed=5)
    row("channelized 15x13 (odd), 1e-6", tpfa_stencil(k4, 1e-6))


if __name__ == "__main__":
    sys.exit(main())
