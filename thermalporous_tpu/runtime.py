"""Process set-up shared by the entry points: compile cache and device checks.

``bench.py``, ``chip_smoke.py``, ``examples/run_case.py`` and the
``thermalporous_tpu.qualify`` CLI call :func:`enable_compile_cache` before
their first compile, and the GPU-only paths call :func:`require_gpu` so that
a machine without a card fails instead of timing the CPU.
"""

from __future__ import annotations

import os
import subprocess

import jax

#: root of the checkout this package lives in
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: compile cache used when JAX_COMPILATION_CACHE_DIR is not set (a fixed
#: path: the cache key includes it, so a moving directory never hits)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here; otherwise the cache goes to
    ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu() -> jax.Device:
    """Return JAX's first device, or raise if it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind}); this path measures or checks the card "
            "and does not fall back to the CPU")
    return dev


def device_summary() -> dict:
    """Platform, kind and count of the devices JAX reports."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


#: published peak device-memory bandwidth [bytes/s] by ``device_kind``
#: (NVIDIA H100 data sheet, SXM part: 3.35 TB/s of HBM3)
PEAK_MEMORY_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_memory_bandwidth(device=None) -> float:
    """Published peak memory bandwidth of ``device`` (default: JAX's first
    device); raises for a device kind the table does not know."""
    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAK_MEMORY_BW:
        raise KeyError(f"no published memory bandwidth for device kind "
                       f"{kind!r}; known: {sorted(PEAK_MEMORY_BW)}")
    return PEAK_MEMORY_BW[kind]


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
