"""Render modules of the port (audio2photoreal_tpu_torch.render) against the JAX package.

Each JAX module gets numpy parameters (shapes from ``jax.eval_shape`` of its
init, values from a seed: ``v`` N(0, 1), ``g`` 1 + N(0, 0.1²), everything
else N(0, 0.1²)), which reach the port module through the converters in
``audio2photoreal_tpu_torch/convert.py``.  Inputs are numpy from a seed.
Tolerance: f32 2e-5 (absolute and relative); the display-space seam pass
within one 8-bit count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.render import blocks as j_blocks
from audio2photoreal_tpu.render import color as j_color
from audio2photoreal_tpu.render import face as j_face
from audio2photoreal_tpu.render import geometry as j_geometry
from audio2photoreal_tpu.render import layers as j_layers
from audio2photoreal_tpu.render import quaternion as j_quat
from audio2photoreal_tpu.render import shadow as j_shadow
from audio2photoreal_tpu.render import unet as j_unet
from audio2photoreal_tpu.render.assets import make_synthetic_assets as j_make_assets
from audio2photoreal_tpu.render.assets import synthetic_seam_sampler as j_seam_sampler
from audio2photoreal_tpu.render.mesh_vae import RendererConfig as JRendererConfig
from audio2photoreal_tpu.ops.gridsample import pack_rgb8, unpack_rgb8
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.render import blocks, color, face, geometry, layers, quaternion, shadow, unet
from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_seam_sampler
from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

TOL = 2e-5
TINY = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_face_embs=256,
            n_pose_enc_channels=8, n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4,
            shadow_size=32, view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
            image_height=48, image_width=32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(x: torch.Tensor):
    return x.detach().permute(0, 2, 3, 1).numpy()


def rand_params(module, *args, seed=0):
    """Numpy parameters for a flax module, shaped by ``jax.eval_shape``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "v":
            return rng.randn(*s.shape).astype(np.float32)
        if name == "g":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(module: torch.nn.Module, fill, p) -> torch.nn.Module:
    """Fill a port module from a JAX subtree with a converter helper."""
    sd = {}
    fill(sd, "m", p)
    module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return module.eval()


# ---------------------------------------------------------- quaternion -- #


@pytest.mark.parametrize("op", ["mul", "invert", "rotate", "from_xyz", "to_matrix", "normalize"])
def test_quaternion_matches_jax(op):
    rng = np.random.RandomState(0)
    q1 = rng.randn(5, 7, 4).astype(np.float32)
    q2 = rng.randn(5, 7, 4).astype(np.float32)
    v = rng.randn(5, 7, 3).astype(np.float32)
    args = {"mul": (q1, q2), "invert": (q1,), "rotate": (q1, v), "from_xyz": (v,), "to_matrix": (q1,),
            "normalize": (q1,)}[op]
    want = getattr(j_quat, op)(*(jnp.asarray(a) for a in args))
    _close(getattr(quaternion, op)(*(_t(a) for a in args)), want)


# ----------------------------------------------------- assets, lbs, geo -- #


@pytest.fixture(scope="module")
def tiny_assets():
    return j_make_assets(JRendererConfig(**TINY)), make_synthetic_assets(RendererConfig(**TINY))


def _asset_arrays(a, port: bool):
    """Every array of a RendererAssets, image-like ones as [H, W, C]."""
    hwc = (lambda x: np.asarray(x).transpose(1, 2, 0)) if port else np.asarray
    out = {
        "tex_mean": hwc(a.tex_mean), "ao_mean": hwc(a.ao_mean), "face_cond_mask": hwc(a.face_cond_mask),
        "pose_cond_mask": hwc(a.pose_cond_mask), "body_cond_mask": hwc(a.body_cond_mask),
        "non_head_mask": hwc(a.non_head_mask), "face_tex_mask": hwc(a.face_tex_mask),
        "frontal_view": np.asarray(a.frontal_view), "tex_std": np.float32(a.tex_std),
    }
    for name in ("faces", "uv_coords", "uv_faces", "vert_index_img", "bary_img", "valid_mask", "v2uv"):
        out[f"geo.{name}"] = np.asarray(getattr(a.geo, name))
    for name in ("transform", "transform_offsets", "bind_state", "skin_indices", "skin_weights",
                 "template_verts"):
        out[f"lbs.{name}"] = np.asarray(getattr(a.lbs, name))
    for s in ("seam", "seam_2k"):
        for name in ("impaint_dst", "impaint_src", "resample_uvs", "resample_dst", "resample_weights"):
            out[f"{s}.{name}"] = np.asarray(getattr(getattr(a, s), name)).reshape(-1)
    return out


@pytest.mark.parametrize("density,sizes", [(1, {}), (10, dict(uv_size=256, upscale_size=512))])
def test_synthetic_assets_equal_jax(density, sizes):
    cfg = dict(TINY, **sizes)
    want = _asset_arrays(j_make_assets(JRendererConfig(**cfg), seed=3, mesh_density=density), port=False)
    got = _asset_arrays(make_synthetic_assets(RendererConfig(**cfg), seed=3, mesh_density=density), port=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].astype(np.float64), want[k].astype(np.float64), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    if density == 10:
        assert len(got["geo.faces"]) == 9322


def test_lbs_pose_unpose_match_jax(tiny_assets):
    ja, pa = tiny_assets
    rng = np.random.RandomState(1)
    pose = (rng.randn(3, 104) * 0.3).astype(np.float32)
    delta = (rng.randn(3, pa.lbs.template_verts.shape[1], 3) * 0.05).astype(np.float32)
    posed = ja.lbs.pose(jnp.asarray(delta), jnp.asarray(pose))
    _close(pa.lbs.pose(_t(delta), _t(pose)), posed)
    _close(pa.lbs.template_pose(_t(pose)), ja.lbs.template_pose(jnp.asarray(pose)))
    _close(pa.lbs.unpose(_t(np.asarray(posed)), _t(pose)), ja.lbs.unpose(posed, jnp.asarray(pose)), 1e-4)


def test_geometry_matches_jax(tiny_assets):
    ja, pa = tiny_assets
    rng = np.random.RandomState(2)
    V = pa.lbs.template_verts.shape[1]
    verts = (np.asarray(ja.lbs.template_verts) + rng.randn(2, V, 3) * 0.02).astype(np.float32)
    vals = rng.randn(2, V, 5).astype(np.float32)
    _close(_nhwc(pa.geo.to_uv(_t(vals))), ja.geo.to_uv(jnp.asarray(vals)))
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    _close(pa.geo.from_uv(_nchw(img)), ja.geo.from_uv(jnp.asarray(img)))
    campos = rng.randn(2, 3).astype(np.float32) * 3
    _close(geometry.compute_view_cos(_t(verts), pa.geo.faces, _t(campos)),
           j_geometry.compute_view_cos(jnp.asarray(verts), ja.geo.faces, jnp.asarray(campos)))
    K = np.array([[[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]]] * 2, np.float32)
    Rt = np.array([[[1.0, 0, 0, 0], [0, 0, -1, 1.0], [0, 1, 0, 3.0]]] * 2, np.float32)
    for got, want in zip(geometry.project_points(_t(verts), _t(K), _t(Rt)),
                         j_geometry.project_points(jnp.asarray(verts), jnp.asarray(K), jnp.asarray(Rt))):
        _close(got, want, 1e-4)


# -------------------------------------------------------------- layers -- #


def _x(shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LAYER_CASES = {
    "linear": (lambda: j_layers.LinearWN(12), (4, 9), lambda: layers.LinearWN(9, 12), convert._wn_linear),
    "conv_k1_s2_groups2": (lambda: j_layers.Conv2dWN(6, kernel_size=1, stride=2, padding=0, groups=2),
                           (2, 8, 8, 4), lambda: layers.Conv2dWN(4, 6, 1, 2, 0, groups=2), convert._wn_conv),
    "conv_ub_k3": (lambda: j_layers.Conv2dWNUB(5, 8, 8, 3, 1, 1), (2, 8, 8, 3),
                   lambda: layers.Conv2dWNUB(3, 5, 8, 8, 3, 1, 1), convert._wn_conv),
    "conv_ub_k4_s2": (lambda: j_layers.Conv2dWNUB(5, 4, 4, 4, 2, 1), (2, 8, 8, 3),
                      lambda: layers.Conv2dWNUB(3, 5, 4, 4, 4, 2, 1), convert._wn_conv),
    "convt_ub": (lambda: j_layers.ConvTranspose2dWNUB(5, 16, 16, 4, 2, 1), (2, 8, 8, 3),
                 lambda: layers.ConvTranspose2dWNUB(3, 5, 16, 16, 4, 2, 1), convert._wn_convt),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_wn_layer_matches_jax(case):
    jmod_fn, shape, pmod_fn, fill = LAYER_CASES[case]
    x = _x(shape)
    jm = jmod_fn()
    p = rand_params(jm, x)
    want = jm.apply(p, jnp.asarray(x))
    pm = _load(pmod_fn(), fill, p["params"])
    got = pm(_t(x)) if len(shape) == 2 else _nhwc(pm(_nchw(x)))
    _close(got, want)


@pytest.mark.parametrize("hw,size,align", [
    (16, 32, False), (16, 32, True), (16, 8, True), (12, 20, False), (32, 16, False), (10, 10, True),
])
def test_resize_bilinear_matches_jax(hw, size, align):
    x = _x((2, hw, hw + 2, 3))
    want = j_layers.resize_bilinear(jnp.asarray(x), (size, size + 2), align_corners=align)
    _close(_nhwc(layers.resize_bilinear(_nchw(x), (size, size + 2), align_corners=align)), want)


def test_pixel_shuffle_and_tile2d_match_jax():
    x = _x((2, 5, 6, 12))
    _close(_nhwc(layers.pixel_shuffle(_nchw(x), 2)), j_layers.pixel_shuffle(jnp.asarray(x), 2))
    v = _x((3, 7))
    _close(_nhwc(layers.tile2d(_t(v), 4)), j_layers.tile2d(jnp.asarray(v), 4))


# -------------------------------------------------- blocks, unet, etc. -- #


BLOCK_CASES = {
    "conv_block": (lambda: j_blocks.ConvBlock(6, 8), (2, 8, 8, 5), lambda: blocks.ConvBlock(5, 6, 8),
                   convert._conv_block),
    "conv_block_1x1": (lambda: j_blocks.ConvBlock(6, 8, kernel_size=1, padding=0), (2, 8, 8, 5),
                       lambda: blocks.ConvBlock(5, 6, 8, kernel_size=1, padding=0), convert._conv_block),
    "conv_down_block": (lambda: j_blocks.ConvDownBlock(6, 16), (2, 16, 16, 4),
                        lambda: blocks.ConvDownBlock(4, 6, 16), convert._conv_block),
    "up_conv_block_groups2": (lambda: j_blocks.UpConvBlockDeep(8, 32, groups=2), (2, 16, 16, 12),
                              lambda: blocks.UpConvBlockDeep(12, 8, 32, groups=2), convert._conv_block),
    "upscale_net": (lambda: j_blocks.UpscaleNet(3, 16, size=16), (2, 16, 16, 6),
                    lambda: blocks.UpscaleNet(6, 3, 16, size=16), convert.upscale_net_state_dict),
    "unet_wb": (lambda: j_unet.UNetWB(3, 64, n_init_ftrs=4), (2, 64, 64, 4),
                lambda: unet.UNetWB(4, 3, 64, n_init_ftrs=4), convert.unet_wb_state_dict),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_matches_jax(case):
    jmod_fn, shape, pmod_fn, fill = BLOCK_CASES[case]
    x = _x(shape, seed=4)
    jm = jmod_fn()
    p = rand_params(jm, x, seed=5)
    want = jax.jit(jm.apply)(p, jnp.asarray(x))
    got = _load(pmod_fn(), fill, p["params"])(_nchw(x))
    _close(_nhwc(got), want)


def test_pose_to_shadow_matches_jax():
    pose = _x((2, 104), seed=6) * 0.3
    jm = j_shadow.PoseToShadow(104, 256)
    p = rand_params(jm, pose, seed=7)
    want = jax.jit(jm.apply)(p, jnp.asarray(pose))["shadow_map"]
    pm = _load(shadow.PoseToShadow(104, 256), convert.pose_to_shadow_state_dict, p["params"])
    _close(_nhwc(pm(_t(pose))["shadow_map"]), want)


@pytest.mark.parametrize("biases", [True, False])
def test_shadow_unet_matches_jax(biases):
    ao_mean = np.random.RandomState(8).rand(32, 32, 1).astype(np.float32)
    ao = _x((2, 32, 32, 1), seed=9)
    jm = j_shadow.ShadowUNet(uv_size=64, shadow_size=32, ao_mean=jnp.asarray(ao_mean), n_dims=8, biases=biases)
    p = rand_params(jm, ao, seed=10)
    want = jax.jit(jm.apply)(p, jnp.asarray(ao))
    pm = _load(shadow.ShadowUNet(64, 32, _t(ao_mean.transpose(2, 0, 1)), n_dims=8, biases=biases),
               convert.shadow_unet_state_dict, p["params"])
    got = pm(_nchw(ao))
    for k in ("shadow_map", "shadow_map_lowres"):
        _close(_nhwc(got[k]), want[k])


def test_face_decoder_matches_jax():
    codes = _x((2, 256), seed=11) * 0.3
    view = np.array([0.0, 0.0, 1.0], np.float32)
    jm = j_face.FaceDecoderFrontal(jnp.asarray(view), n_latent=256, n_vert_out=3 * 64, tex_size=64)
    p = rand_params(jm, codes, seed=12)
    want = jax.jit(jm.apply)(p, jnp.asarray(codes))
    pm = _load(face.FaceDecoderFrontal(view, 256, 3 * 64, 64), convert.face_decoder_state_dict, p["params"])
    got = pm(_t(codes))
    _close(got["face_geom"], want["face_geom"])
    _close(_nhwc(got["face_tex"]), want["face_tex"], 255 * TOL)


# -------------------------------------------------------- color, seams -- #


def test_display_transform_matches_jax():
    img = np.random.RandomState(13).rand(2, 9, 7, 3).astype(np.float32) * 300 - 20
    _close(color.linear2srgb(_t(img / 255)), j_color.linear2srgb(jnp.asarray(img / 255)))
    _close(color.linear2display_batch(_t(img)), j_color.linear2display_batch(jnp.asarray(img)), 255 * TOL)


@pytest.fixture(scope="module")
def seam_pair():
    return (j_seam_sampler(32, 150, np.random.RandomState(14)),
            synthetic_seam_sampler(32, 150, np.random.RandomState(14)))


@pytest.mark.parametrize("n_resample", [0, 1, 2])
def test_seam_passes_match_jax(seam_pair, n_resample):
    js, ps = seam_pair
    tex = _x((2, 32, 32, 5), seed=15)
    got = _nhwc(ps.apply(_nchw(tex), n_resample))
    _close(got, js.fused_apply(jnp.asarray(tex), n_resample=n_resample))
    if n_resample == 1:
        _close(got, js(jnp.asarray(tex)))  # the JAX package's sequential form


def test_display_seam_pass_within_one_count_of_jax(seam_pair):
    js, ps = seam_pair
    disp = np.random.RandomState(16).rand(2, 32, 32, 3).astype(np.float32) * 255
    want = np.asarray(unpack_rgb8(js.fused_apply_packed(pack_rgb8(jnp.asarray(disp)), 2)))
    q = torch.round(_nchw(disp)).clamp(0, 255)
    got = _nhwc(ps.apply_display(q, 2))
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.01
    assert np.array_equal(got, np.round(got))
