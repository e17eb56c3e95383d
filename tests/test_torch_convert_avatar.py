"""The real per-person asset converter and the avatar checkpoint converter of
the port (render/assets.py, apps/convert_checkpoint.py) against the JAX
package's, on the CPU.

A ``static_assets.pt`` in the reference's layout
(``render/assets.py:reference_static_assets``; mesh_vae_drivable.py:90-200,
the schema of ``tests/test_avatar_fullcomp.py``) at a small renderer
config: the cylinder mesh with a seam-duplicated ``v2uv`` (K = 2, the
second UV copy a little apart), a momentum-style LBS model with three
per-joint scale columns and ``lbs_scale``, ``global_scaling`` 1.1, dense
seam tables, a ``head_cond_mask``.  Both
packages' ``convert_static_assets`` read it: masks and index tables equal,
float assets within 1e-6, LBS ``pose`` / ``unpose`` within 2e-5 of their
scale.  ``load_render_defaults`` is held to JAX's for both file layouts.
``convert_avatar_checkpoint`` turns a ``ca_body/data/<person>/`` tree into a
bundle whose weights are the checkpoint's tensors, whose render equals the
source avatar's bit for bit, and whose fallback camera is JAX's.  Its
``body_dec.ckpt`` holds what a trained ca_body AutoEncoder's state dict
holds beyond the port's parameters (``_reference_extras``: the asset
buffers, the geometry, seam and LBS modules under each submodule that keeps
them, the calibration): the port drops exactly the keys that JAX's
``convert_body_avatar`` does not read, and a key of neither kind raises.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps import convert_checkpoint as j_convert
from audio2photoreal_tpu.render import assets as j_assets
from audio2photoreal_tpu.render.mesh_vae import RendererConfig as JRendererConfig
from audio2photoreal_tpu.train.convert import convert_body_avatar
from audio2photoreal_tpu_torch.apps import convert_checkpoint
from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer, load_body_renderer
from audio2photoreal_tpu_torch.render import assets
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

SMALL = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=16, n_face_embs=16, n_pose_enc_channels=8,
             n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32, view_unet_ftrs=4,
             encoder_in_size=64, face_tex_size=64, n_face_verts=64, image_height=48, image_width=32)
PERSON = "PXB184"


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    cfg, jcfg = RendererConfig(**SMALL), JRendererConfig(**SMALL)
    path = str(tmp_path_factory.mktemp("person") / "static_assets.pt")
    torch.save(assets.reference_static_assets(cfg, seed=0), path)
    return dict(path=path, cfg=cfg, got=assets.convert_static_assets(path, cfg),
                want=j_assets.convert_static_assets(path, jcfg))


def _chw(x):
    x = np.asarray(x)
    return x.transpose(2, 0, 1) if x.ndim == 3 else x


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("part", ["geometry", "skinning", "seams", "masks", "images"])
def test_convert_static_assets_matches_jax(converted, part):
    g, w = converted["got"], converted["want"]
    if part == "geometry":
        for k in ("faces", "uv_faces", "vert_index_img", "v2uv"):
            _equal(getattr(g.geo, k), getattr(w.geo, k))
        assert tuple(g.geo.v2uv.shape) == (48, 2)
        for k in ("uv_coords", "bary_img", "valid_mask"):
            _close(getattr(g.geo, k), getattr(w.geo, k))
    elif part == "skinning":
        _equal(g.lbs.skin_indices, w.lbs.skin_indices)
        _equal(g.lbs.skel.joint_parents, w.lbs.skel.joint_parents)
        for k in ("skin_weights", "transform", "transform_offsets", "bind_state", "template_verts"):
            _close(getattr(g.lbs, k), getattr(w.lbs, k))
        assert g.lbs.global_scaling == w.lbs.global_scaling == pytest.approx(1.1)
    elif part == "seams":
        for ours, theirs in ((g.seam, w.seam), (g.seam_2k, w.seam_2k)):
            for k in ("impaint_dst", "impaint_src", "resample_dst"):
                _equal(getattr(ours, k), getattr(theirs, k))
            for k in ("resample_uvs", "resample_weights"):
                _close(getattr(ours, k), getattr(theirs, k))
            assert ours.uv_size == theirs.uv_size and ours.resample_dst.numel() > 0
    elif part == "masks":
        for k in ("face_cond_mask", "pose_cond_mask", "body_cond_mask", "non_head_mask"):
            _equal(getattr(g, k), _chw(getattr(w, k)))
        head = torch.load(converted["path"], weights_only=False)["head_cond_mask"]
        assert not (g.pose_cond_mask * torch.from_numpy(head)).any() and g.pose_cond_mask.any()
        _close(g.face_tex_mask, _chw(w.face_tex_mask))
    else:
        for k in ("tex_mean", "ao_mean"):
            _close(getattr(g, k), _chw(getattr(w, k)))
        _close(g.frontal_view, w.frontal_view)
        assert g.tex_std == w.tex_std == 81.0
        assert tuple(g.tex_mean.shape) == (3, 128, 128) and tuple(g.ao_mean.shape) == (1, 32, 32)


def test_converted_lbs_and_from_uv_match_jax(converted):
    """pose / unpose with the folded scales, the bind from the offsets
    before the fold and the global scale; from_uv's mean over K = 2."""
    g, w = converted["got"], converted["want"]
    rng = np.random.RandomState(1)
    motion = (rng.randn(2, 104) * 0.3).astype(np.float32)
    delta = (rng.randn(2, 48, 3) * 0.05).astype(np.float32)
    with torch.no_grad():
        posed = g.lbs.pose(torch.from_numpy(delta), torch.from_numpy(motion))
        back = g.lbs.unpose(posed, torch.from_numpy(motion))
        uv_img = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
        verts = g.geo.from_uv(uv_img)


    @jax.jit  # one compile: op by op, JAX's FK chain dispatches for seconds
    def want(d, m, img):
        p = w.lbs.pose(d, m)
        return p, w.lbs.unpose(p, m), w.geo.from_uv(img)

    jposed, jback, jverts = want(jnp.asarray(delta), jnp.asarray(motion),
                                 jnp.asarray(uv_img.permute(0, 2, 3, 1).numpy()))
    _close(posed, jposed, 2e-5)
    _close(back, jback, 2e-5)
    _close(back, delta, 1e-4)
    _close(verts, jverts, 2e-5)


@pytest.mark.parametrize("layout", ["one_camera", "per_camera"])
def test_load_render_defaults_matches_jax(tmp_path, layout):
    rng = np.random.RandomState(2)

    def cam(with_campos):
        R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
        d = {"K": torch.as_tensor([[900.0, 0, 333], [0, 900.0, 512], [0, 0, 1]]),
             "Rt": torch.as_tensor(np.concatenate([R, rng.randn(3, 1).astype(np.float32)], 1))}
        if with_campos:
            d["campos"] = torch.as_tensor(rng.randn(3).astype(np.float32))
        return d

    data = cam(False) if layout == "one_camera" else {"400029": cam(True), "400013": cam(False), "meta": 3}
    path = str(tmp_path / f"render_defaults_{PERSON}.pth")
    torch.save(data, path)
    got, want = assets.load_render_defaults(path), j_assets.load_render_defaults(path)
    assert list(got) == list(want) == (["default"] if layout == "one_camera" else ["400029", "400013"])
    for n in got:
        for k in ("campos", "K", "Rt"):
            _close(getattr(got[n], k), getattr(want[n], k))


def _random_avatar(cfg, seed):
    model = BodyAvatar(cfg, assets.make_synthetic_assets(cfg))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05 + (1.0 if n.endswith("weight_g") else 0.0))
    return model


def test_convert_avatar_checkpoint_writes_the_checkpoints_bundle(converted, tmp_path):
    cfg = converted["cfg"]
    person = tmp_path / "ca_body" / "data" / PERSON
    person.mkdir(parents=True)
    sa = str(person / "static_assets.pt")
    torch.save(torch.load(converted["path"], weights_only=False), sa)
    model = _random_avatar(cfg, 3)
    extras = {k: torch.randn(v.shape) for k, v in _reference_extras(cfg).items()}
    torch.save({"model_state_dict": dict(model.state_dict(), **extras), "iteration": 7},
               str(person / "body_dec.ckpt"))
    out = convert_checkpoint.convert_avatar_checkpoint(str(person), str(tmp_path / "renderer"), cfg=cfg)
    sd = torch.load(os.path.join(out, "model.pt"), weights_only=True)
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    assert filecmp.cmp(sa, os.path.join(out, "static_assets.pt"), shallow=False)
    assert not os.path.exists(os.path.join(out, "assets.json"))
    bcfg, bassets, _, cams = assets.load_bundle_parts(out)
    assert bcfg == cfg and list(cams) == ["frontal"]
    want_cam = convert_checkpoint.frontal_rig(torch.load(sa, weights_only=False)["lbs_template_verts"], cfg)
    for k in ("campos", "K", "Rt"):
        _equal(getattr(cams["frontal"], k), getattr(want_cam["frontal"], k))
    # the bundle renders what the source avatar renders, from the converted assets
    rng = np.random.RandomState(4)
    pose, face = (rng.randn(2, 104) * 0.1).astype(np.float32), (rng.randn(2, 16) * 0.1).astype(np.float32)
    got = load_body_renderer(out, frame_batch=2, device="cpu").render_sequence_multicam(pose, face)
    src = BodyRenderer(cfg, assets.convert_static_assets(sa, cfg), model.state_dict(), cams, frame_batch=2,
                       device="cpu").render_sequence_multicam(pose, face)
    assert got.shape == (2, 48, 32, 3) and np.array_equal(got, src)


def test_frontal_rig_matches_jax(converted, tmp_path, monkeypatch):
    """The fallback rig at RendererConfig(): JAX's convert_avatar_checkpoint
    run with its weight converter and bundle writer stubbed, its cameras
    caught."""
    person = tmp_path / PERSON
    person.mkdir()
    sa = str(person / "static_assets.pt")
    torch.save(torch.load(converted["path"], weights_only=False), sa)
    torch.save({"model_state_dict": {}}, str(person / "body_dec.ckpt"))
    caught = {}
    monkeypatch.setattr(j_convert, "convert_body_avatar", lambda sd, n_blocks: {})
    monkeypatch.setattr(j_assets, "save_renderer_bundle", lambda out, cfg, params, cams: caught.update(cams))
    j_convert.convert_avatar_checkpoint(str(person), str(tmp_path / "jax_out"))
    got = convert_checkpoint.frontal_rig(torch.load(sa, weights_only=False)["lbs_template_verts"], RendererConfig())
    assert list(got) == list(caught) == ["frontal"]
    for k in ("campos", "K", "Rt"):
        _close(getattr(got["frontal"], k), getattr(caught["frontal"], k), 1e-7)


class _Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def test_full_width_avatar_checkpoint_converts_by_name(converted, tmp_path):
    """A full-width body_dec.ckpt under the reference's names, with a trained
    AutoEncoder's buffers and calibration beside the parameters (broadcast
    tensors: the names and shapes are what is checked), converts at
    RendererConfig() and keeps exactly the keys that JAX's
    ``convert_body_avatar`` reads; a key of neither kind raises before
    anything is written."""
    cfg = RendererConfig()
    person = tmp_path / PERSON
    person.mkdir()
    torch.save(torch.load(converted["path"], weights_only=False), str(person / "static_assets.pt"))
    params = {k: torch.zeros(()).expand(s) for k, s in _full_width_shapes(cfg).items()}
    sd = dict(params, **_reference_extras(cfg))
    torch.save({"model": sd}, str(person / "body_dec.ckpt"))
    out = convert_checkpoint.convert_avatar_checkpoint(str(person), str(tmp_path / "renderer"))
    got = torch.load(os.path.join(out, "model.pt"), weights_only=True)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in params.items()}
    assert len(got) > 300
    jax_reads = _Reads({k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in sd.items()})
    convert_body_avatar(jax_reads, n_blocks=4)
    assert jax_reads.read == set(got)
    torch.save({"model": dict(sd, **{"decoder.bogus.weight": torch.zeros(2)})}, str(person / "body_dec.ckpt"))
    with pytest.raises(RuntimeError, match="bogus"):
        convert_checkpoint.convert_avatar_checkpoint(str(person), str(tmp_path / "renderer2"))
    assert not os.path.exists(tmp_path / "renderer2")


def _reference_extras(cfg, n_cameras=4, n_verts=7306, n_faces=14_000):
    """Broadcast stand-ins for what a ca_body AutoEncoder built for training
    (mesh_vae_drivable.py:AutoEncoder with cal, pixel_cal and learn_blur)
    holds in its state dict beyond the port's parameters: the asset buffers,
    the geometry and seam modules under each submodule that keeps them, the
    LBS module, the calibration and the training renderer."""
    U, S, E = cfg.upscale_size, cfg.uv_size, cfg.encoder_in_size
    geo = dict(vi=(n_faces, 3), vt=(n_verts + 300, 2), vti=(n_faces, 3), v2uv=(n_verts, 2), index_image=(S, S, 3),
               bary_image=(S, S, 3), face_index_image=(S, S))
    seam = dict(dst_ij=(500, 2), src_ij=(500, 2), uvs=(S, S, 2), weights=(S, S))
    shapes = {
        "tex_mean": (1, 3, U, U), "face_cond_mask": (1, 1, S // 16, S // 16), "meye_mask": (1, 1, U, U),
        "encoder.mask": (1, 1, E, E), "decoder.pose_cond_mask": (1, 98, S // 16, S // 16),
        "decoder.head_cond_mask": (1, 1, S // 16, S // 16), "shadow_net.ao_mean": (1, 1, 256, 256),
        "decoder_face.frontal_view": (3,), "lbs_fn.lbs_template_verts": (n_verts, 3), "lbs_fn.lbs_scale": (1, 3),
        "lbs_fn.global_scaling": (1,), "lbs_fn.lbs_fn.skin_weights": (n_verts, 8),
        "lbs_fn.param_transform.transform": (159 * 7, 104), "cal.weight": (n_cameras, 3), "cal.bias": (n_cameras, 3),
        "learn_blur.weights": (n_cameras, 3), "pixel_cal.pixel_bias": (n_cameras, 1, 128, 84),
        "renderer.bg": (1, 3, 1024, 667),
    }
    for owner in ("", "decoder.", "decoder_view.", "encoder."):
        shapes.update({f"{owner}geo_fn.{k}": s for k, s in geo.items()})
    for owner in ("", "decoder.", "decoder_view."):
        shapes.update({f"{owner}seam_sampler.{k}": s for k, s in seam.items()})
    shapes.update({f"seam_sampler_2k.{k}": s for k, s in seam.items()})
    return {k: torch.zeros(()).expand(s) for k, s in shapes.items()}


def _full_width_shapes(cfg):
    with torch.device("meta"):
        model = BodyAvatar(cfg, assets.make_synthetic_assets(dataclasses.replace(
            cfg, uv_size=64, upscale_size=128, encoder_in_size=64, init_uv_size=16)))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}
