"""Every preset, and every opt-in stage-2/transfer variant at the padded
flagship shapes, builds (traces and lowers) a full implicit step at its
real grid size.

Nothing is allocated at those sizes: the step is lowered against abstract
arguments (``jax.ShapeDtypeStruct``) whose grid dimensions are the target's,
with the data pytree's structure taken from a small instance of the case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from thermalporous_tpu.core import Grid
from thermalporous_tpu.models import TwoPhaseModel
from thermalporous_tpu.precond import CPRConfig, GMGConfig
from thermalporous_tpu.presets import PRESETS, get_case, tp_spe10_3d
from thermalporous_tpu.solve import make_step_fn


def _abstract(tree, small_shape, big_shape):
    """ShapeDtypeStructs of ``tree`` with trailing grid dims resized."""
    k = len(small_shape)

    def leaf(a):
        shape = tuple(a.shape)
        if len(shape) >= k and shape[-k:] == tuple(small_shape):
            shape = shape[:-k] + tuple(big_shape)
        return jax.ShapeDtypeStruct(shape, jnp.float32
                                    if jnp.issubdtype(a.dtype, jnp.floating)
                                    else a.dtype)

    return jax.tree.map(leaf, tree)


def _lower_step(model, small_data, small_shape, precond, newton_cfg, pc_cfg):
    step = make_step_fn(model, precond, newton_cfg, pc_cfg)
    shape = model.grid.shape
    u = jax.ShapeDtypeStruct((model.nc,) + tuple(shape), jnp.float32)
    dt = jax.ShapeDtypeStruct((), jnp.float32)
    data = _abstract(small_data, small_shape, shape)
    return jax.jit(step).lower(u, dt, data)


#: opt-in variants no preset selects, with the flagship's coarsest-level
#: size; on the card, qualify.py checks their counts against the CPU
_GMG = GMGConfig(max_coarse_cells=1024)
GUARDED = {
    "stage2_fused": dict(stage2="rbgs", stage2_fused=True, gmg=_GMG),
    "stage2_axes": dict(stage2="rbgs", stage2_axes=(2,), gmg=_GMG),
    "batch_pt": dict(batch_pt=True, triangular=False, gmg=_GMG),
    "pc_lag_step_weighted": dict(gmg=dataclasses.replace(
        _GMG, transfer="weighted")),
}


@pytest.mark.parametrize("nz", [120, 128])
@pytest.mark.parametrize("variant", sorted(GUARDED))
def test_formerly_guarded_variant_builds_at_padded_shape(variant, nz):
    small = tp_spe10_3d(nx=6, ny=5, nz=4)
    shape = (60, 220, nz)
    model = TwoPhaseModel(Grid(shape=shape, spacing=(6.096, 3.048, 0.6096),
                               gravity=9.81), small.model.pp, s_init=0.15)
    kw = dict(GUARDED[variant])
    pc_cfg = CPRConfig(**kw)
    newton_cfg = small.newton_cfg
    if variant == "pc_lag_step_weighted":
        newton_cfg = dataclasses.replace(newton_cfg, pc_lag="step")
    lowered = _lower_step(model, small.data, (6, 5, 4), "cptr", newton_cfg,
                          pc_cfg)
    assert lowered.out_info[0].shape == (3,) + shape


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_every_preset_builds_its_step(name):
    """The preset's own configuration, lowered at its real grid size."""
    case = get_case(name)
    lowered = _lower_step(case.model, case.data, case.model.grid.shape,
                          case.precond, case.newton_cfg, case.pc_cfg)
    assert lowered.out_info is not None
