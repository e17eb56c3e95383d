"""The shadow variants and UNets no ported avatar builds (``render/shadow.py``
``ShadowUNetPoseCond`` / ``FloorShadowDecoder`` / ``DistMapShadowUNet``,
``render/unet.py`` ``UNetWBConcat`` / ``UNetW``) against the JAX package's,
on the CPU, at small widths: JAX params (the init's shapes filled from
numpy, nonzero biases and gains other than 1, so every parameter counts) -> ``convert.*_state_dict_from_jax`` -> the port's
modules, loaded strictly; the same NHWC / NCHW inputs; outputs within 2e-5
of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.render import shadow as j_shadow
from audio2photoreal_tpu.render import unet as j_unet
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.render import shadow, unet
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

REL = 2e-5


def _params(jmod, j_inputs, seed):
    """The module's param tree from ``jax.eval_shape`` of its init, filled
    from numpy: v N(0, 1), g 1 + N(0, 0.1²), biases N(0, 0.1²)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "v":
            return rng.randn(*s.shape).astype(np.float32)
        if name == "g":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *j_inputs))


def _check(jmod, pmod, convert_fn, j_inputs, key="shadow_map"):
    params = _params(jmod, j_inputs, 1)
    want = jax.jit(jmod.apply)(params, *j_inputs)
    want = np.asarray(want[key] if isinstance(want, dict) else want)
    pmod.load_state_dict(convert_fn(params), strict=True)
    p_inputs = [torch.from_numpy(np.array(x)) for x in j_inputs]
    p_inputs = [x.permute(0, 3, 1, 2) if x.dim() == 4 else x for x in p_inputs]
    with torch.no_grad():
        got = pmod(*p_inputs)
    got = (got[key] if isinstance(got, dict) else got).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max(), rtol=0)


def _img(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_shadow_unet_pose_cond_matches_jax():
    ao_mean = _img((16, 16, 1), 2)
    jmod = j_shadow.ShadowUNetPoseCond(uv_size=32, shadow_size=16, ao_mean=jnp.asarray(ao_mean), n_pose_dims=104,
                                       n_dims=8)
    pmod = shadow.ShadowUNetPoseCond(32, 16, torch.from_numpy(ao_mean).permute(2, 0, 1), n_pose_dims=104, n_dims=8)
    pose = np.random.RandomState(3).randn(2, 104).astype(np.float32)
    # the AO map at 32 x 32: resized to the 16 x 16 shadow size on both sides
    _check(jmod, pmod, convert.shadow_unet_state_dict_from_jax, (jnp.asarray(_img((2, 32, 32, 1), 4)),
                                                                  jnp.asarray(pose)))


def test_floor_shadow_decoder_matches_jax():
    jmod = j_shadow.FloorShadowDecoder(uv_size=24, n_dims=4)
    pmod = shadow.FloorShadowDecoder(24, in_channels=1, n_dims=4)
    _check(jmod, pmod, convert.floor_shadow_state_dict_from_jax, (jnp.asarray(_img((2, 16, 16, 1), 5)),))


def test_dist_map_shadow_unet_matches_jax():
    jmod = j_shadow.DistMapShadowUNet(uv_size=32, shadow_size=16, n_channels=3, n_dims=8)
    pmod = shadow.DistMapShadowUNet(32, 16, n_channels=3, n_dims=8)
    _check(jmod, pmod, convert.shadow_unet_state_dict_from_jax, (jnp.asarray(_img((2, 24, 24, 3), 6)),))


@pytest.mark.parametrize("name", ["UNetWBConcat", "UNetW"])
def test_unet_variants_match_jax(name):
    jmod = getattr(j_unet, name)(out_channels=3, size=32, n_init_ftrs=4)
    pmod = getattr(unet, name)(5, 3, 32, n_init_ftrs=4)
    _check(jmod, pmod, convert.unet_state_dict_from_jax, (jnp.asarray(_img((2, 32, 32, 5), 7) - 0.5),))


def test_unet_wb_converter_still_takes_the_avatars_unet():
    """``unet_state_dict_from_jax`` on a UNetWB (transpose-conv ups, untied
    biases), the avatar's view UNet."""
    jmod = j_unet.UNetWB(out_channels=3, size=32, n_init_ftrs=4)
    pmod = unet.UNetWB(5, 3, 32, n_init_ftrs=4)
    _check(jmod, pmod, convert.unet_state_dict_from_jax, (jnp.asarray(_img((2, 32, 32, 5), 8) - 0.5),))
