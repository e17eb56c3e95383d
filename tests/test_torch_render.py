"""The photoreal render slice, port vs JAX package, on the CPU.

A tiny BodyAvatar (the renderer config of ``tests/test_parallel.py``) with
numpy parameters (shapes from ``jax.eval_shape`` of its init) reaches the
port through ``convert.body_avatar_state_dict_from_jax``.  The avatar's
stages are held at f32 2e-5 (2e-5 of the scale for the 0..255 texture);
uint8 frames within one count (the JAX package's own bar between its render
paths).  Also: ``generate(plot=True)`` through a renderer bundle, the
entry points' device rule, and the full-width state_dict against the JAX
tree through ``train/convert.py:convert_body_avatar``.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps.render_pipeline import BodyRenderer as JBodyRenderer
from audio2photoreal_tpu.apps.render_pipeline import Camera as JCamera
from audio2photoreal_tpu.render.assets import make_synthetic_assets as j_make_assets
from audio2photoreal_tpu.render.mesh_vae import BodyAvatar as JAvatar
from audio2photoreal_tpu.render.mesh_vae import RendererConfig as JRendererConfig
from audio2photoreal_tpu.train.convert import convert_body_avatar
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import generate, render_pipeline
from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer, Camera, load_body_renderer
from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, save_config
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.render import assets as render_assets
from audio2photoreal_tpu_torch.render.assets import (load_bundle_parts, make_synthetic_assets,
                                                     save_renderer_bundle, synthetic_rig)
from audio2photoreal_tpu_torch.render.geometry import project_points
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

TOL = 2e-5
TINY = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_face_embs=256,
            n_pose_enc_channels=8, n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4,
            shadow_size=32, view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
            image_height=48, image_width=32)
K = np.array([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]], np.float32)
CAMS = {
    "cam0": dict(campos=np.array([0.0, -3.0, 1.0], np.float32), K=K,
                 Rt=np.array([[1, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32)),
    "cam1": dict(campos=np.array([0.5, -3.0, 1.0], np.float32), K=K,
                 Rt=np.array([[1, 0, 0, -0.5], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32)),
}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _fill(path, s, rng):
    name = path[-1].key
    if name == "v":
        return rng.randn(*s.shape).astype(np.float32)
    if name == "g":
        return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
    return (0.1 * rng.randn(*s.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def avatar():
    """JAX avatar + numpy params, and the port avatar with the same weights."""
    jcfg, cfg = JRendererConfig(**TINY), RendererConfig(**TINY)
    ja = j_make_assets(jcfg)
    jm = JAvatar(jcfg, ja)
    B = 2
    z = np.zeros
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), z((B, 104), np.float32), z((B, 3), np.float32),
        geom=np.asarray(ja.lbs.template_verts).repeat(B, 0), face_embs=z((B, 256), np.float32),
        ao=z((B, 32, 32, 1), np.float32), training=True))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)
    sd = convert.body_avatar_state_dict_from_jax(params, cfg)
    pm = BodyAvatar(cfg, make_synthetic_assets(cfg))
    pm.load_state_dict(sd, strict=True)
    return dict(jm=jm, ja=ja, params=params, pm=pm.eval(), sd=sd, cfg=cfg, jcfg=jcfg)


@pytest.fixture(scope="module")
def frame_inputs():
    rng = np.random.RandomState(1)
    B = 2
    return dict(
        motion=(rng.randn(B, 104) * 0.1).astype(np.float32),
        face=(rng.randn(B, 256) * 0.1).astype(np.float32),
        campos=np.stack([CAMS["cam0"]["campos"]] * B),
        K=np.stack([K] * B), Rt=np.stack([CAMS["cam0"]["Rt"]] * B),
    )


@pytest.fixture(scope="module")
def decoded(avatar, frame_inputs):
    """decode_frame on both sides, driving mode (the body encode hoisted)."""
    a, f = avatar, frame_inputs
    jm, params = a["jm"], a["params"]
    embs1 = jax.jit(lambda p: jm.apply(p, method=JAvatar.template_body_embs))(params)
    B = f["motion"].shape[0]

    @jax.jit
    def run(p, motion, face):
        return jm.apply(p, motion, face_embs=face, embs=jnp.broadcast_to(embs1, (B, embs1.shape[-1])),
                        encode=False, method=JAvatar.decode_frame)

    want = run(params, f["motion"], f["face"])
    with torch.no_grad():
        pembs = a["pm"].template_body_embs()
        got = a["pm"].decode_frame(_t(f["motion"]), face_embs=_t(f["face"]), embs=pembs.expand(B, -1),
                                   encode=False)
    return dict(got=got, want=want, embs=(pembs, embs1))


@pytest.mark.parametrize("key", ["template_embs", "geom_delta_rec", "tex_mean_rec", "geom", "shadow_map",
                                 "shadow_seamed", "embs_conv", "pose_conv"])
def test_decode_frame_matches_jax(decoded, key):
    if key == "template_embs":
        got, want = decoded["embs"]
    else:
        got, want = decoded["got"][key], decoded["want"][key]
        got = _nhwc(got) if got.dim() == 4 else got
    _close(got, want)


def test_encode_matches_jax(avatar, frame_inputs):
    a, f = avatar, frame_inputs
    geom = np.asarray(a["ja"].lbs.pose(None, f["motion"]))
    want = jax.jit(lambda p: a["jm"].apply(p, geom, f["motion"], f["face"], method=JAvatar.encode))(a["params"])
    with torch.no_grad():
        got = a["pm"].encode(_t(geom), _t(f["motion"]), _t(f["face"]))
    for k in ("embs", "embs_logvar", "face_embs", "face_embs_logvar"):
        _close(got[k], want[k])
    _close(_nhwc(got["face_dec_preds"]["face_tex"]), want["face_dec_preds"]["face_tex"])


@pytest.mark.parametrize("display", [False, True])
def test_render_view_matches_jax(avatar, frame_inputs, decoded, display):
    a, f = avatar, frame_inputs
    keys = ("geom", "tex_mean_rec", "shadow_seamed")
    want = jax.jit(lambda p, d: a["jm"].apply(p, d, f["campos"], f["K"], f["Rt"], render_display=display,
                                              method=JAvatar.render_view))(
        a["params"], {k: decoded["want"][k] for k in keys})
    with torch.no_grad():
        got = a["pm"].render_view({k: decoded["got"][k] for k in keys}, _t(f["campos"]), _t(f["K"]),
                                  _t(f["Rt"]), render_display=display)
    _close(_nhwc(got["tex_view_rec"]), want["tex_view_rec"])
    _close(_nhwc(got["tex_rec"]), want["tex_rec"])
    np.testing.assert_array_equal(got["pix_to_face"].numpy() >= 0, np.asarray(want["pix_to_face"]) >= 0)
    cov = got["pix_to_face"].numpy() >= 0
    assert 0.05 < cov.mean() < 0.9
    rgb, jrgb = got["rgb"].numpy(), np.asarray(want["rgb"])
    if display:
        diff = np.abs(rgb.astype(np.uint8).astype(int) - jrgb.astype(np.uint8).astype(int))
        assert diff.max() <= 1
    else:
        _close(rgb, jrgb)


def _cams(cls):
    return {n: cls(**c) for n, c in CAMS.items()}


@pytest.fixture(scope="module")
def port_renderer(avatar):
    return BodyRenderer(avatar["cfg"], make_synthetic_assets(avatar["cfg"]), avatar["sd"], _cams(Camera),
                        frame_batch=4, device="cpu")


def test_render_sequence_multicam_matches_jax(avatar, port_renderer):
    rng = np.random.RandomState(2)
    T = 6
    pose = (rng.randn(T, 104) * 0.05).astype(np.float32)
    face = (rng.randn(T, 256) * 0.05).astype(np.float32)
    jr = JBodyRenderer(avatar["jcfg"], avatar["ja"], avatar["params"], _cams(JCamera), frame_batch=4)
    want = jr.render_sequence_multicam(pose, face)
    got = port_renderer.render_sequence_multicam(pose, face)
    assert got.dtype == np.uint8 and got.shape == want.shape == (T, 48, 2 * 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # one camera through the full per-frame encode path: the same frames
    one = port_renderer.render_sequence(pose, face, camera_name="cam1")
    assert np.abs(one.astype(int) - got[:, :, 32:].astype(int)).max() <= 1


def _plot_inputs(root, avatar, T=64):
    """A synthetic person, a tiny pose model's checkpoint dir and a renderer
    bundle of the avatar fixture."""
    make_synthetic_person(root, "SYNTH01", num_scenes=5, frames_per_scene=T, seed=3)
    mcfg = DenoiserConfig(data_format="pose", latent_dim=16, ff_size=32, num_layers=1, num_heads=2,
                          max_seq_length=T, dropout=0.0)
    model = FiLMDenoiser(mcfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model_dir = os.path.join(root, "pose_model")
    save_config(model_dir, denoiser=mcfg, diffusion=DiffusionConfig(),
                data=DataConfig(person="SYNTH01", max_seq_length=T))
    torch.save(model.state_dict(), os.path.join(model_dir, generate.MODEL_FILE))
    bundle = save_renderer_bundle(os.path.join(root, "renderer"), avatar["cfg"], avatar["sd"],
                                  _cams(Camera))
    return model_dir, bundle


def test_generate_plot_writes_each_sample_through_a_bundle(tmp_path, avatar):
    T = 64
    root = str(tmp_path)
    model_dir, bundle = _plot_inputs(root, avatar, T)
    out_dir = os.path.join(root, "out")
    path = generate.generate(model_dir, root, num_samples=2, timestep_respacing="ddim2", device="cpu",
                             output_dir=out_dir)
    res = np.load(path, allow_pickle=True).item()
    # a face model's results.npy: same audio, 256-d codes as [B, 256, 1, T]
    codes = np.random.RandomState(4).randn(2, 256, 1, T).astype(np.float32) * 0.05
    face_path = os.path.join(root, "face_results.npy")
    np.save(face_path, {"motions": codes, "gt": codes, "audio": res["audio"], "lengths": res["lengths"]})
    generate.generate(model_dir, root, num_samples=2, timestep_respacing="ddim2", device="cpu",
                      output_dir=out_dir, plot=True, face_codes=face_path, renderer_path=bundle,
                      render_gt=True)
    for i in range(2):
        for tag in ("pred", "gt"):
            files = [f for f in os.listdir(out_dir) if f.startswith(f"sample{i:02d}_rep00_{tag}")]
            assert len(files) == 1, os.listdir(out_dir)
    r = load_body_renderer(bundle, device="cpu", frame_batch=4)
    body = res["motions"][0].transpose(2, 0, 1)[:8, :, 0]
    frames = r.render_sequence_multicam(body, codes[0].transpose(2, 0, 1)[:8, :, 0])
    if files[0].endswith(".npz"):
        pred = np.load(os.path.join(out_dir, "sample01_rep00_pred.npz"))["frames"]
        assert pred.shape == (int(res["lengths"][1]), 48, 64, 3) and pred.dtype == np.uint8
    assert frames.shape == (8, 48, 64, 3)
    bad = dict(res, audio=res["audio"] + 1.0)
    np.save(face_path, {"motions": codes, "audio": bad["audio"], "lengths": res["lengths"]})
    with pytest.raises(ValueError, match="other audio"):
        generate.generate(model_dir, root, num_samples=1, timestep_respacing="ddim2", device="cpu",
                          output_dir=out_dir, plot=True, face_codes=face_path, renderer_path=bundle)
    shutil.rmtree(tmp_path)  # a person, a model, a bundle and their video frames


def test_generate_plot_renders_every_repetition(tmp_path, avatar):
    """2 samples x 2 repetitions: the motions hold a row per (repetition,
    sample), lengths / audio / gt a row per sample; every
    ``sampleNN_repMM`` video is written, each from its own motion row."""
    T = 64
    root = str(tmp_path)
    model_dir, bundle = _plot_inputs(root, avatar, T)
    out_dir = os.path.join(root, "out")
    path = generate.generate(model_dir, root, num_samples=2, num_repetitions=2, timestep_respacing="ddim2",
                             device="cpu", output_dir=out_dir)
    res = np.load(path, allow_pickle=True).item()
    assert res["motions"].shape[0] == 4 and res["audio"].shape[0] == res["lengths"].shape[0] == 2
    codes = np.random.RandomState(5).randn(4, 256, 1, T).astype(np.float32) * 0.05
    face_path = os.path.join(root, "face_results.npy")
    np.save(face_path, {"motions": codes, "gt": codes[:2], "audio": res["audio"], "lengths": res["lengths"]})
    generate.generate(model_dir, root, num_samples=2, num_repetitions=2, timestep_respacing="ddim2",
                      device="cpu", output_dir=out_dir, plot=True, face_codes=face_path, renderer_path=bundle)
    for i in range(2):
        for r in range(2):
            files = [f for f in os.listdir(out_dir) if f.startswith(f"sample{i:02d}_rep{r:02d}_pred")]
            assert len(files) == 1, os.listdir(out_dir)
    if files[0].endswith(".npz"):
        got = {(i, r): np.load(os.path.join(out_dir, f"sample{i:02d}_rep{r:02d}_pred.npz"))["frames"]
               for i in range(2) for r in range(2)}
        for i in range(2):
            assert got[i, 0].shape == got[i, 1].shape == (int(res["lengths"][i]), 48, 64, 3)
            assert not np.array_equal(got[i, 0], got[i, 1])  # each repetition its own motion
    shutil.rmtree(tmp_path)  # a person, a model, a bundle and their video frames


def test_bundle_with_the_jax_only_fields_loads(tmp_path, avatar):
    """A renderer.json that names the JAX config's s2d_tail (a TPU layout
    switch) loads with it dropped; noise_std, which the avatar trainer
    reads, is kept."""
    bundle = save_renderer_bundle(str(tmp_path / "renderer"), avatar["cfg"], avatar["sd"], _cams(Camera))
    path = os.path.join(bundle, "renderer.json")
    with open(path) as f:
        fields = json.load(f)
    assert "s2d_tail" not in fields and fields["noise_std"] == 1.0
    with open(path, "w") as f:
        json.dump(dict(fields, noise_std=0.5, s2d_tail=True), f)
    cfg, _, sd, cams = load_bundle_parts(bundle)
    assert cfg == dataclasses.replace(avatar["cfg"], noise_std=0.5)
    assert set(sd) == set(avatar["sd"]) and set(cams) == set(CAMS)
    assert Camera is render_assets.Camera  # apps/ takes the render layer's


def test_synthetic_rig_frames_most_of_the_image_height():
    cfg = RendererConfig(**TINY)
    assets = make_synthetic_assets(cfg)
    verts = assets.lbs.pose(None, torch.zeros(1, 104))
    for cam in synthetic_rig((0.0, 0.0, 1.0), 1024, 667).values():
        pix, depth = project_points(verts, torch.from_numpy(cam.K)[None], torch.from_numpy(cam.Rt)[None])
        rows = pix[0, :, 1].max() - pix[0, :, 1].min()
        assert 0.6 * 1024 < rows < 1024 and (depth > 0).all()
        assert pix[0, :, 0].min() > 0 and pix[0, :, 0].max() < 666


def test_entry_points_run_on_the_card_unless_told(monkeypatch, tmp_path, avatar):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.generate(str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BodyRenderer(avatar["cfg"], make_synthetic_assets(avatar["cfg"]), avatar["sd"], _cams(Camera))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_pipeline.load_body_renderer(str(tmp_path))


def test_full_width_state_dict_loads_through_the_jax_converter():
    """The full-width port avatar, built on the meta device, has exactly the
    parameter names and shapes that ``convert_body_avatar`` turns into the
    JAX package's BodyAvatar tree at RendererConfig(): a released
    body_dec.ckpt loads into the port by name."""
    cfg, jcfg = RendererConfig(), JRendererConfig()
    assets = make_synthetic_assets(cfg)
    with torch.device("meta"):
        pm = BodyAvatar(cfg, assets)
    stand_in = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in pm.state_dict().items()}
    tree = convert_body_avatar(stand_in, n_blocks=4)
    ja = j_make_assets(jcfg)
    jm = JAvatar(jcfg, ja)
    z = np.zeros
    want = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), z((1, 104), np.float32), z((1, 3), np.float32),
        geom=np.asarray(ja.lbs.template_verts), face_embs=z((1, 256), np.float32),
        ao=z((1, 256, 256, 1), np.float32), training=True))
    flat = lambda t: {jax.tree_util.keystr(k): tuple(np.shape(v))  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got_shapes, want_shapes = flat(tree), flat(want)
    assert got_shapes == want_shapes
    assert len(got_shapes) > 300
