"""The renderer's bf16 compute mode (``render/layers.py:render_compute_dtype``)
against the JAX package's, on the CPU.

The tiny BodyAvatar of ``tests/test_torch_render.py`` (its JAX parameters
reach the port through ``convert.body_avatar_state_dict_from_jax``) renders
three ways: the port in bf16, the JAX package in bf16 and the JAX package in
f32, each inside its ``render_compute_dtype``.  The JAX bf16 runs are
compiled with ``xla_allow_excess_precision`` off, so that XLA rounds after
every op as eager PyTorch does (``tests/test_torch_bf16.py``, ``STRICT``).
The bars are that file's: the accuracy-ratio bar ``err(port bf16 vs JAX
f32) <= 1.5 err(JAX bf16 vs JAX f32) + 1e-3 scale`` and ``err(port bf16 vs
JAX bf16) <= 2e-2 scale``, ``scale`` the largest magnitude of the JAX f32
result.  Both sides decode from the template's f32 body embedding, as the
renderer computes it once and the JAX benchmark hoists it.  The rendered
images are held by the ratio bar on the pixels that show the same face in
all three renders: the bf16 geometry moves a few pixels onto another face
or off the body, in either framework at different pixels, and such a pixel
changes by up to a whole texel's value (at weight seed 1 the port's
display frame changed 2 pixels' faces, by up to 158 counts, where JAX
bf16's changed none; on the other pixels its largest error was 64.5 counts
against JAX's 59.9).  The geometry is held by its own bar, and the count of
pixels that change face by the ratio bar (its slack 1% of the covered
pixels); the pixels within one count of JAX bf16's are printed as a
reading.

Also: each weight-norm layer by the same bars; the port's counterpart of
``tests/test_avatar.py::test_bf16_render_close_to_f32``; the plain bf16
display chain against JAX's strict chain (``tex_rec`` bit for bit, display
values within one count); the dtypes and the context; and
``render_sequence_multicam`` under the context.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.ops.gridsample import pack_rgb8 as j_pack_rgb8
from audio2photoreal_tpu.render import layers as j_layers
from audio2photoreal_tpu.render.color import linear2display_batch as j_linear2display_batch
from audio2photoreal_tpu.render.mesh_vae import BodyAvatar as JAvatar
from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer, Camera
from audio2photoreal_tpu_torch.kernels import display_pack
from audio2photoreal_tpu_torch.render import layers
from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets
from test_torch_bf16 import RATIO, _ratio, _run
from test_torch_render import CAMS, avatar, frame_inputs  # noqa: F401  (module fixtures)
from test_torch_render_modules import LAYER_CASES, _load, _nchw, _nhwc, _x, rand_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

BF16 = torch.bfloat16
RANGE_SHARE = 0.02  # test_avatar.py:test_bf16_render_close_to_f32's bar
FACE_CHANGED_SHARE = 0.01  # the slack of the face-change count's ratio bar, of the covered pixels
DECODE_KEYS = ("tex_mean_rec", "geom", "shadow_map", "shadow_seamed", "geom_delta_rec")
VIEW_KEYS = ("tex_rec", "tex_view_rec", "rgb")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _port(x, nchw=True):
    """A port tensor as numpy f32 in the JAX layout (NCHW images to NHWC;
    the rendered images are NHWC already)."""
    x = x.detach().float()
    return (x.permute(0, 2, 3, 1) if x.dim() == 4 and nchw else x).numpy()


def _ratio_images(port, jax16, jax32, what):
    """The ratio bar on the rendered images, over the pixels whose face is
    the f32 render's in both bf16 renders; the pixels whose face changed by
    the ratio bar on their count, its slack ``FACE_CHANGED_SHARE`` of the
    covered pixels."""
    face, face16, face32 = port["pix_to_face"].numpy(), np.asarray(jax16["pix_to_face"]), np.asarray(jax32["pix_to_face"])
    stable = (face == face32) & (face16 == face32)
    changed, changed16, covered = int((face != face32).sum()), int((face16 != face32).sum()), int((face32 >= 0).sum())
    print(f"{what}: {changed} of {covered} covered pixels changed face (JAX bf16: {changed16})")
    assert changed <= RATIO * changed16 + FACE_CHANGED_SHARE * covered, what
    _ratio(port["rgb"].numpy()[stable], np.asarray(jax16["rgb"])[stable], np.asarray(jax32["rgb"])[stable], what,
           direct=False)


# ------------------------------------------------------- weight-norm layers -- #


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_wn_layer_in_bf16_matches_jax(case):
    """f32 parameters, the weight normalised in f32 and cast, the input and
    bias cast: the port's bf16 layer by the ratio bar and 2e-2 of scale."""
    jmod_fn, shape, pmod_fn, fill = LAYER_CASES[case]
    x = _x(shape)
    jm = jmod_fn()
    p = rand_params(jm, x)

    def apply(dtype):
        def fn(params, xx):
            with j_layers.render_compute_dtype(dtype):
                return jm.apply(params, xx)
        return fn

    want32 = _run(apply(jnp.float32), p, x)
    want16 = _run(apply(jnp.bfloat16), p, x, strict=True)
    assert want16.dtype == jnp.bfloat16
    pm = _load(pmod_fn(), fill, p["params"])
    with torch.no_grad(), layers.render_compute_dtype(BF16):
        got = pm(_t(x)) if len(shape) == 2 else pm(_nchw(x))
    assert got.dtype == BF16
    _ratio(got if len(shape) == 2 else _nhwc(got.float()), want16, want32, case)


# ---------------------------------------------------- decode and render_view -- #


def _jax_render(a, f, dtype):
    """JAX decode_frame + render_view (linear and display) inside its
    ``render_compute_dtype(dtype)``; bf16 compiled strictly."""
    jm = a["jm"]
    embs1 = jax.jit(lambda p: jm.apply(p, method=JAvatar.template_body_embs))(a["params"])
    B = f["motion"].shape[0]

    def run(p, motion, face, campos, K, Rt):
        with j_layers.render_compute_dtype(dtype):
            d = jm.apply(p, motion, face_embs=face, embs=jnp.broadcast_to(embs1, (B, embs1.shape[-1])),
                         encode=False, method=JAvatar.decode_frame)
            keys = {k: d[k] for k in ("geom", "tex_mean_rec", "shadow_seamed")}
            lin = jm.apply(p, keys, campos, K, Rt, render_display=False, method=JAvatar.render_view)
            disp = jm.apply(p, keys, campos, K, Rt, render_display=True, method=JAvatar.render_view)
        return d, lin, disp

    return _run(run, a["params"], f["motion"], f["face"], f["campos"], f["K"], f["Rt"],
                strict=dtype == jnp.bfloat16)


def _port_render(a, f, dtype):
    pm = a["pm"]
    with torch.no_grad():
        embs = pm.template_body_embs()  # f32, outside the context, as BodyRenderer makes it
        with layers.render_compute_dtype(dtype):
            d = pm.decode_frame(_t(f["motion"]), face_embs=_t(f["face"]),
                                embs=embs.expand(f["motion"].shape[0], -1), encode=False)
            cams = (_t(f["campos"]), _t(f["K"]), _t(f["Rt"]))
            lin = pm.render_view(d, *cams, render_display=False)
            disp = pm.render_view(d, *cams, render_display=True)
    return d, lin, disp


@pytest.fixture(scope="module")
def renders(avatar, frame_inputs):  # noqa: F811
    return dict(jax32=_jax_render(avatar, frame_inputs, jnp.float32),
                jax16=_jax_render(avatar, frame_inputs, jnp.bfloat16),
                port16=_port_render(avatar, frame_inputs, BF16),
                port32=_port_render(avatar, frame_inputs, torch.float32))


@pytest.mark.parametrize("key", DECODE_KEYS)
def test_decode_frame_in_bf16_matches_jax(renders, key):
    got, want16, want32 = renders["port16"][0][key], renders["jax16"][0][key], renders["jax32"][0][key]
    assert got.dtype == (BF16 if want16.dtype == jnp.bfloat16 else torch.float32), (key, got.dtype, want16.dtype)
    _ratio(_port(got), want16, want32, key)


@pytest.mark.parametrize("display", [False, True])
@pytest.mark.parametrize("key", VIEW_KEYS)
def test_render_view_in_bf16_matches_jax(renders, key, display):
    i = 2 if display else 1
    got, want16, want32 = renders["port16"][i][key], renders["jax16"][i][key], renders["jax32"][i][key]
    assert got.dtype == (BF16 if want16.dtype == jnp.bfloat16 else torch.float32), (key, got.dtype, want16.dtype)
    if key == "rgb":
        _ratio_images(renders["port16"][i], renders["jax16"][i], renders["jax32"][i], f"rgb display={display}")
    else:
        _ratio(_port(got), want16, want32, f"{key} display={display}")


def test_display_frames_in_bf16_near_jax(renders):
    """The display frames' coverage against JAX bf16's, and the share of
    covered pixels within one count of JAX bf16's (printed, a reading)."""
    got = renders["port16"][2]
    want16, want32 = renders["jax16"][2], renders["jax32"][2]
    cov = got["pix_to_face"].numpy() >= 0
    cov16, cov32 = np.asarray(want16["pix_to_face"]) >= 0, np.asarray(want32["pix_to_face"]) >= 0
    assert (cov != cov32).sum() <= RATIO * (cov16 != cov32).sum() + FACE_CHANGED_SHARE * cov32.sum()
    assert 0.05 < cov.mean() < 0.9
    q = lambda x: np.asarray(x).astype(np.uint8).astype(int)  # noqa: E731
    for name, a, b in (("port bf16 vs JAX bf16", got["rgb"].numpy(), want16["rgb"]),
                       ("JAX bf16 vs JAX f32", want16["rgb"], want32["rgb"])):
        diff = np.abs(q(a) - q(b))
        print(f"display frames, {name}: {(diff.max(-1) <= 1)[cov].mean():.4f} of covered pixels within 1 count, "
              f"max {diff.max()}")


def test_bf16_render_close_to_f32(avatar, frame_inputs):  # noqa: F811
    """The port's counterpart of test_avatar.py:test_bf16_render_close_to_f32:
    the full forward (the encode of the posed template included) in bf16
    within 2% of the f32 texture's dynamic range."""
    pm, f = avatar["pm"], frame_inputs
    geom = pm.assets.lbs.pose(None, _t(f["motion"]))
    args = dict(geom=geom, face_embs=_t(f["face"]), K=_t(f["K"]), Rt=_t(f["Rt"]))
    with torch.no_grad():
        f32 = pm(_t(f["motion"]), _t(f["campos"]), **args)["tex_rec"]
        with layers.render_compute_dtype(BF16):
            bf16 = pm(_t(f["motion"]), _t(f["campos"]), **args)["tex_rec"]
    assert f32.dtype == torch.float32 and bf16.dtype == BF16
    a, c = f32.numpy(), bf16.float().numpy()
    rng = max(a.max() - a.min(), 1e-6)
    assert np.abs(a - c).max() / rng < RANGE_SHARE


# ------------------------------------------------------------ display chain -- #


def test_plain_bf16_display_chain_matches_jax_strict():
    """``finalize_display_reference`` on a bf16 texture: JAX's strict chain
    (mesh_vae.py:428-431 as written: std and mean cast to the texture's
    dtype, the shadow cast to it, then ``linear2display_batch`` of the f32
    ``tex_rec``, packed) gives the same tex_rec bits and display values
    within one count (the CPU divides where the chain's f32 steps round)."""
    rng = np.random.RandomState(4)
    B, H, W = 2, 24, 40
    tex = torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32) * 0.4).to(BF16)
    shadow = torch.from_numpy(rng.rand(B, 1, H, W).astype(np.float32)).to(BF16)
    mean = torch.from_numpy(rng.rand(3, H, W).astype(np.float32) * 220.0)
    std = 37.7

    def chain(t, sh, m):
        t = t * jnp.asarray(std, t.dtype) + m[None].astype(t.dtype)
        t = t * sh.astype(t.dtype)
        return t, j_pack_rgb8(j_linear2display_batch(t.astype(jnp.float32)))

    jt = lambda x: jnp.asarray(x.float().permute(0, 2, 3, 1).numpy() if x.dim() == 4  # noqa: E731
                               else x.permute(1, 2, 0).numpy())
    want_rec, want_packed = _run(chain, jt(tex).astype(jnp.bfloat16), jt(shadow).astype(jnp.bfloat16), jt(mean),
                                 strict=True)
    display, rec = display_pack.finalize_display_reference(tex, shadow, mean, std)
    assert rec.dtype == BF16 and display.dtype == torch.float32
    np.testing.assert_array_equal(_port(rec), np.asarray(want_rec.astype(jnp.float32)))
    want = np.stack([(np.asarray(want_packed) >> s) & 0xFF for s in (0, 8, 16)], 1)  # [B, 3, H, W]
    assert np.abs(display.numpy().astype(int) - want).max() <= 1
    # the wrapper on CPU tensors is the plain version; the packed form agrees with the planar one
    got, got_rec = display_pack.finalize_display(tex, shadow.float(), mean, std)
    assert torch.equal(got, display) and torch.equal(got_rec, rec)
    assert torch.equal(display_pack.finalize_display_packed(tex, shadow, mean, std), display_pack.pack_rgb8(display))


def test_the_f32_display_chain_is_unchanged():
    """An f32 texture takes the f32 chain as written before the bf16 mode:
    (tex * std + mean) * shadow, bit for bit."""
    rng = np.random.RandomState(5)
    tex, shadow = _t(rng.randn(2, 3, 8, 12) * 0.4), _t(rng.rand(2, 1, 8, 12))
    mean = _t(rng.rand(3, 8, 12) * 220.0)
    display, rec = display_pack.finalize_display_reference(tex, shadow, mean, 37.7)
    assert torch.equal(rec, (tex * 37.7 + mean[None]) * shadow)


# ----------------------------------------------------- dtypes and the context -- #


def test_parameters_stay_f32_and_the_context_restores(avatar, frame_inputs):  # noqa: F811
    pm, f = avatar["pm"], frame_inputs
    assert layers.compute_dtype() == torch.float32
    with pytest.raises(RuntimeError, match="inside"):
        with layers.render_compute_dtype(BF16):
            assert layers.compute_dtype() == BF16
            with layers.render_compute_dtype(torch.float32):
                assert layers.compute_dtype() == torch.float32
            raise RuntimeError("inside")
    assert layers.compute_dtype() == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    with torch.no_grad():
        embs = pm.template_body_embs()
        out = pm.decode_frame(_t(f["motion"]), face_embs=_t(f["face"]), embs=embs.expand(2, -1), encode=False)
        with layers.render_compute_dtype(torch.float32):
            inside = pm.decode_frame(_t(f["motion"]), face_embs=_t(f["face"]), embs=embs.expand(2, -1),
                                     encode=False)
    for k in DECODE_KEYS:
        assert out[k].dtype == torch.float32 and torch.equal(out[k], inside[k]), k


def test_render_sequence_multicam_in_bf16(avatar):  # noqa: F811
    """A 2-frame, 2-camera video under the context equals decode_frame +
    render_view run directly in bf16, camera by camera."""
    a = avatar
    r = BodyRenderer(a["cfg"], make_synthetic_assets(a["cfg"]), a["sd"], {n: Camera(**c) for n, c in CAMS.items()},
                     frame_batch=2, device="cpu")
    rng = np.random.RandomState(6)
    pose = (rng.randn(2, 104) * 0.05).astype(np.float32)
    face = (rng.randn(2, 256) * 0.05).astype(np.float32)
    with layers.render_compute_dtype(BF16):
        video = r.render_sequence_multicam(pose, face)
    f32 = r.render_sequence_multicam(pose, face)
    m = r.model
    with torch.no_grad(), layers.render_compute_dtype(BF16):
        d = m.decode_frame(_t(pose), face_embs=_t(face), embs=r._template_embs[0].expand(2, -1), encode=False)
        views = [m.render_view(d, _t(np.stack([c["campos"]] * 2)), _t(np.stack([c["K"]] * 2)),
                               _t(np.stack([c["Rt"]] * 2)), render_display=True)["rgb"] for c in CAMS.values()]
    want = torch.cat(views, dim=2).to(torch.uint8).numpy()
    assert video.dtype == np.uint8 and video.shape == (2, 48, 64, 3)
    np.testing.assert_array_equal(video, want)
    assert not np.array_equal(video, f32)  # the context reached the render
