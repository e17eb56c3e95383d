"""The display pass's plain version against the JAX package's TPU kernel.

``kernels/display_pack.py:finalize_display_packed`` on CPU tensors (its plain
version, the render's composed chain) against
``audio2photoreal_tpu/ops/pallas/display_pack.py:finalize_display_packed``
run in Pallas interpret mode, on the same numpy inputs (the port's planar
layout transposed to JAX's channels-last).  Bar: >= 99.99% of the channel
values exact and none more than one count off (the f32 power function and
division of the two frameworks may round a value across .5).  With an H that
is no multiple of the JAX kernel's 64-row block, the JAX kernel leaves the
trailing rows unwritten: there the port is held to JAX's composed ops
(``pack_rgb8(linear2display_batch(...))``), on every row.  Also: the CPU
dispatch, the planar mode's relation to the packed one, input checks, and
the render's display pass going through the wrapper.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.ops.gridsample import pack_rgb8 as j_pack_rgb8
from audio2photoreal_tpu.ops.pallas.display_pack import finalize_display_packed as j_finalize
from audio2photoreal_tpu.render.color import linear2display_batch as j_linear2display
from audio2photoreal_tpu_torch.kernels import display_pack, launch_counts
from audio2photoreal_tpu_torch.render import mesh_vae
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

STD = 35.0


def _inputs(B, H, W, seed=0):
    """The render's ranges, as the JAX package's own test of its kernel:
    a raw texture of N(0, 0.3), shadow in [0, 1), mean up to 200."""
    rng = np.random.RandomState(seed)
    tex = (rng.randn(B, 3, H, W) * 0.3).astype(np.float32)
    shadow = rng.rand(B, 1, H, W).astype(np.float32)
    mean = (rng.rand(3, H, W) * 200.0).astype(np.float32)
    return tex, shadow, mean


def _channels(packed):
    packed = np.asarray(packed)
    return np.stack([(packed >> s) & 0xFF for s in (0, 8, 16)], -1).astype(np.int32)


def _assert_close(got, want):
    d = np.abs(_channels(got) - _channels(want))
    assert d.max() <= 1, f"max channel difference {d.max()}"
    assert (d == 0).mean() >= 0.9999, f"exact share {(d == 0).mean()}"


def _jax_inputs(tex, shadow, mean):
    return (jnp.asarray(tex.transpose(0, 2, 3, 1)), jnp.asarray(shadow.transpose(0, 2, 3, 1)),
            jnp.asarray(mean.transpose(1, 2, 0)))


def test_plain_version_matches_jax_kernel():
    tex, shadow, mean = _inputs(2, 256, 256)
    want = j_finalize(*_jax_inputs(tex, shadow, mean), STD, block_h=64, interpret=True)
    before = sum(launch_counts.values())
    got = display_pack.finalize_display_packed(*map(torch.from_numpy, (tex, shadow, mean)), STD)
    assert sum(launch_counts.values()) == before  # CPU tensors launch nothing
    assert got.dtype == torch.int32 and got.shape == (2, 256, 256)
    _assert_close(got.numpy(), want)


def test_every_row_is_written_when_h_is_not_a_multiple_of_the_block():
    B, H, W = 2, 200, 96
    tex, shadow, mean = _inputs(B, H, W, seed=1)
    jt, js, jm = _jax_inputs(tex, shadow, mean)
    kernel = np.asarray(j_finalize(jt, js, jm, STD, block_h=64, interpret=True))
    composed = np.asarray(j_pack_rgb8(j_linear2display((jt * STD + jm[None]) * js)))
    got = display_pack.finalize_display_packed(*map(torch.from_numpy, (tex, shadow, mean)), STD).numpy()
    rows = (H // 64) * 64  # the rows the JAX kernel writes
    _assert_close(got[:, :rows], kernel[:, :rows])
    _assert_close(got, composed)


def test_planar_mode_is_the_packed_mode_unpacked():
    tex, shadow, mean = map(torch.from_numpy, _inputs(1, 61, 77, seed=2))
    display, tex_rec = display_pack.finalize_display(tex, shadow, mean, STD)
    assert display.shape == tex_rec.shape == (1, 3, 61, 77)
    assert torch.equal(tex_rec, (tex * STD + mean[None]) * shadow)
    assert torch.equal(display, display.round()) and display.min() >= 0 and display.max() <= 255
    assert torch.equal(display_pack.pack_rgb8(display),
                       display_pack.finalize_display_packed(tex, shadow, mean, STD))
    assert display_pack.finalize_display(tex, shadow, mean, STD, with_tex_rec=False)[1] is None


def test_wrapper_rejects_what_it_does_not_take():
    tex, shadow, mean = map(torch.from_numpy, _inputs(1, 8, 8))
    with pytest.raises(ValueError, match=r"\[B, 3, H, W\]"):
        display_pack.finalize_display(tex[:, :2], shadow, mean, STD)
    with pytest.raises(ValueError, match="shadow"):
        display_pack.finalize_display(tex, shadow[..., :4], mean, STD)
    with pytest.raises(ValueError, match="mean"):
        display_pack.finalize_display(tex, shadow, mean[None], STD)
    with pytest.raises(ValueError, match="no display kernel"):
        display_pack.finalize_display(*(t.to("meta") for t in (tex, shadow, mean)), STD)


def test_render_display_pass_goes_through_the_wrapper(monkeypatch):
    """render_view(render_display=True) computes its display texture and
    tex_rec with ``finalize_display``; the linear path does not call it."""
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets
    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig

    cfg = RendererConfig(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_pose_enc_channels=8,
                         n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32,
                         view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
                         image_height=48, image_width=32)
    model = BodyAvatar(cfg, make_synthetic_assets(cfg)).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    calls = []
    real = display_pack.finalize_display
    monkeypatch.setattr(mesh_vae, "finalize_display", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    rng = np.random.RandomState(0)
    motion = torch.from_numpy((rng.randn(2, 104) * 0.05).astype(np.float32))
    face = torch.from_numpy((rng.randn(2, 256) * 0.05).astype(np.float32))
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]]).expand(2, 3, 3)
    Rt = torch.tensor([[1.0, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]]).expand(2, 3, 4)
    campos = torch.tensor([[0.0, -3.0, 1.0]] * 2)
    with torch.no_grad():
        dec = model.decode_frame(motion, face_embs=face, embs=model.template_body_embs().expand(2, -1),
                                 encode=False)
        shown = model.render_view(dec, campos, K, Rt, render_display=True)
        assert calls == [(2, 3, 128, 128)]
        linear = model.render_view(dec, campos, K, Rt, render_display=False)
    assert len(calls) == 1
    # tex_rec is the kernel's second output: the texture before the last
    # seam pass, which the display path runs in display space
    a = model.assets
    assert torch.equal(shown["tex_rec"], (model.upscale_tex(dec["tex_mean_rec"], shown["tex_view_rec"])
                                          * a.tex_std + a.tex_mean[None]) * dec["shadow_seamed"])
    assert shown["rgb"].shape == linear["rgb"].shape
