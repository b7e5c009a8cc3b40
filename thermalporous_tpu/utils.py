"""Utilities: finite-checks, profiling, convergence-history summaries.

Covers the reference's auxiliary subsystems (SURVEY.md §5):
§5.1 tracing/profiling → ``trace`` (XProf/Perfetto) and ``Timer``;
§5.2 sanitizers → ``assert_all_finite`` (the substitute for race
detection is NaN/Inf guarding plus the sharded-vs-replicated equality
tests); §2.9 helpers → convergence-history aggregation.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np


def all_finite(tree) -> bool:
    """True iff every array leaf is free of NaN/Inf (host-side check)."""
    leaves = jax.tree.leaves(tree)
    return all(bool(jnp.isfinite(leaf).all()) for leaf in leaves if hasattr(leaf, "dtype"))


def assert_all_finite(tree, name: str = "array"):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        if hasattr(leaf, "dtype") and not bool(jnp.isfinite(leaf).all()):
            bad = int(jnp.sum(~jnp.isfinite(leaf)))
            raise FloatingPointError(f"{name}[leaf {i}]: {bad} non-finite entries")


def finite_guard(fn):
    """Wrap a step function to raise on non-finite outputs (debug tool)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, name=getattr(fn, "__name__", "step output"))
        return out

    return wrapped


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with XProf/TensorBoard/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Blocking wall-clock timer for device code sections."""

    def __init__(self, name: str = "", sync=None):
        self.name = name
        self.sync = sync

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            jax.block_until_ready(self.sync)
        self.seconds = time.perf_counter() - self.t0


def power_iteration(matvec, shape, dtype=jnp.float64, iters: int = 20, seed: int = 0):
    """Estimate the dominant eigenvalue magnitude of a linear operator."""
    v = jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=dtype)
    v = v / jnp.linalg.norm(v.ravel())
    lam = jnp.asarray(0.0, dtype)
    for _ in range(iters):
        w = matvec(v)
        lam = jnp.linalg.norm(w.ravel())
        v = w / jnp.where(lam > 0, lam, 1.0)
    return lam


def convergence_summary(records) -> dict:
    """Aggregate a run's StepRecords into the papers' headline numbers."""
    if not records:
        return {}
    newton = np.array([r.newton_iters for r in records])
    ksp = np.array([r.ksp_iters for r in records])
    dts = np.array([r.dt for r in records])
    per_newton = ksp / np.maximum(newton, 1)
    return {
        "steps": len(records),
        "newton_per_step_mean": float(newton.mean()),
        "newton_per_step_max": int(newton.max()),
        "ksp_per_newton_mean": float(per_newton.mean()),
        "ksp_per_newton_max": float(per_newton.max()),
        "dt_min": float(dts.min()),
        "dt_max": float(dts.max()),
        "total_newton": int(newton.sum()),
        "total_ksp": int(ksp.sum()),
        "retries": int(sum(r.retries for r in records)),
    }
