"""The demo server of the port (apps/demo.py) against the JAX package's, on the CPU.

``prepare_audio`` is held bit for bit (the same mono mix, the port's
resampler and the same ``RandomState`` channel).  ``DemoPipeline.generate``
runs a tiny face model (latent 16, max_seq_length 120: one 4 s request) and
``test_torch_generate``'s tiny pose model, with and without ``guide/`` and
``vq/`` dirs beside the pose model; both sides sample from the same x_T
(JAX's ``jax.random.normal`` and the port's ``demo.draw_noise`` answered
from numpy) and, with the guide dirs, the same keyframes (each side's
``GuideKeyframer`` answered from numpy after its arguments are checked; the
guide and VQ themselves are held to JAX's in ``test_torch_generate.py``); face
codes and pose within 1e-4 of their scale after DDIM-10.  JAX's
``DemoPipeline._sample`` runs under ``jax.jit`` (one compile a model, where
its eager flax calls would compile op by op), the same math.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio2photoreal_tpu.apps import demo as j_demo
from audio2photoreal_tpu.apps import generate as j_generate
from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.train import checkpoints
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import demo, generate
from audio2photoreal_tpu_torch.data.dataset import write_wav
from audio2photoreal_tpu_torch.render.assets import Camera, make_synthetic_assets, save_renderer_bundle
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from test_torch_generate import slice_setup  # noqa: F401  (a module fixture)
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

FACE = dict(data_format="face", nfeats=256, latent_dim=16, ff_size=32, num_layers=1, num_heads=2,
            cond_encoder_layers=1, max_seq_length=120, dropout=0.0)
REL = 1e-4
RENDER_TINY = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_face_embs=256,
                   n_pose_enc_channels=8, n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4,
                   shadow_size=32, view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
                   image_height=48, image_width=32)


def _close_scaled(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("sr", [16_000, 44_100, 48_000])
@pytest.mark.parametrize("channels", [1, 2])
def test_prepare_audio_matches_jax_bit_for_bit(sr, channels):
    wav = (np.random.RandomState(sr + channels).randn(int(4.6 * sr), channels) * 0.3).astype(np.float32)
    wav = wav[:, 0] if channels == 1 else wav
    got, want = demo.prepare_audio(wav, sr, seed=3), j_demo.prepare_audio(wav, sr, seed=3)
    assert got.shape == (4 * 48_000, 2) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_prepare_audio_refuses_a_clip_under_four_seconds():
    with pytest.raises(ValueError, match="4 seconds"):
        demo.prepare_audio(np.zeros(3 * 16_000, np.float32), 16_000)


@pytest.fixture(scope="module")
def demo_dirs(slice_setup):  # noqa: F811
    """Face dirs (JAX orbax, port model.pt) beside the pose fixture's; pose
    dirs with ``guide/`` and ``vq/`` dirs beside the model (their keyframers
    are answered from numpy)."""
    s, root = slice_setup, slice_setup["root"]
    jcfg = j_config.DenoiserConfig(**FACE)
    T = FACE["max_seq_length"]
    rng = np.random.RandomState(13)

    def fill(path, leaf):  # the init's shapes, filled from numpy: lecun-normal kernels, nonzero biases
        name, shape = path[-1].key, leaf.shape
        if name.endswith("kernel"):
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        return ((1.0 if name.startswith("null_") else 0.1) * rng.randn(*shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
        JDenoiser(jcfg).init, {"params": jax.random.PRNGKey(11), "cond_drop": jax.random.PRNGKey(12)},
        jnp.zeros((1, T, 256)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, T * 1600, 2))))
    sections = dict(diffusion=j_config.DiffusionConfig(), data=j_config.DataConfig(
        person="SYNTH01", data_format="face", max_seq_length=T))
    d = {"j_face": f"{root}/demo_j_face", "p_face": f"{root}/demo_p_face"}
    for k in ("j_face", "p_face"):
        j_config.save_config(d[k], denoiser=jcfg, **sections)
    checkpoints.save(f"{d['j_face']}/ckpt", 0, {"params": params}, block=True)
    torch.save(convert.film_denoiser_state_dict_from_jax(params, "face", FACE["num_layers"]),
               f"{d['p_face']}/{generate.MODEL_FILE}")
    for side in ("j", "p"):
        pose = d[f"{side}_pose_guided"] = f"{root}/demo_{side}_pose_guided"
        os.makedirs(pose, exist_ok=True)
        for name in os.listdir(s[f"{side}_dir"]):
            os.symlink(os.path.join(s[f"{side}_dir"], name), os.path.join(pose, name))
        os.makedirs(os.path.join(pose, "guide"))
        os.makedirs(os.path.join(pose, "vq"))
        d[f"{side}_pose"] = s[f"{side}_dir"]
    wav = (np.random.RandomState(14).randn(int(4.3 * 16_000)) * 0.2).astype(np.float32)
    yield dict(d, root=root, wav=wav, x_T={256: rng.randn(1, T, 256).astype(np.float32),
                                           104: rng.randn(1, T, 104).astype(np.float32)})
    for k in ("j_face", "p_face", "j_pose_guided", "p_pose_guided"):  # 0.38 GB; the slice's own dirs stay
        shutil.rmtree(d[k])


@pytest.fixture(scope="module")
def jax_pipelines(demo_dirs):
    """JAX's DemoPipeline without and with guide dirs, sharing the face
    and pose entries (the same checkpoints), each ``_sample`` jitted once a
    (model, guidance)."""
    d = demo_dirs
    plain = j_demo.DemoPipeline(d["j_face"], d["j_pose"], d["root"], "SYNTH01", timestep_respacing="ddim10")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_generate.GuideKeyframer, "__init__", lambda self, guide_dir, vq_dir: None)
        guided = j_demo.DemoPipeline(d["j_face"], d["j_pose_guided"], d["root"], "SYNTH01",
                                     timestep_respacing="ddim10")
    guided.face, guided.pose = plain.face, plain.pose
    compiled = {}

    def jitted_sample(entry, audio_n, kf, kv, guidance, key):
        k = (id(entry), guidance)
        if k not in compiled:  # the params an argument: closed over, XLA would fold them as constants

            def run(params, a, f, v, r):
                return j_demo.DemoPipeline._sample(plain, {**entry, "params": params}, a, f, v, guidance, r)

            compiled[k] = jax.jit(run)
        return compiled[k](entry["params"], audio_n, kf, kv, key)

    for p in (plain, guided):
        p._sample = jitted_sample
    return {False: plain, True: guided}


@pytest.mark.parametrize("guided", [False, True], ids=["zero_keyframes", "guide_keyframes"])
def test_demo_generate_matches_jax(demo_dirs, jax_pipelines, guided, monkeypatch):
    d = demo_dirs
    x_T = d["x_T"]
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(x_T[shape[-1]], dtype))
    monkeypatch.setattr(demo, "draw_noise", lambda shape, g, device: torch.from_numpy(x_T[shape[-1]]))
    kf = np.random.RandomState(16).randn(1, 4, 104).astype(np.float32)
    calls = []

    def keyframes(self, audio, num_keyframes, key_or_generator, top_p=0.94):
        calls.append((np.asarray(audio), num_keyframes, top_p))
        return jnp.asarray(kf) if isinstance(audio, jax.Array) else torch.from_numpy(kf)

    monkeypatch.setattr(j_generate.GuideKeyframer, "__call__", keyframes)
    monkeypatch.setattr(generate.GuideKeyframer, "__call__", keyframes)
    monkeypatch.setattr(generate.GuideKeyframer, "__init__", lambda self, guide_dir, vq_dir, device: None)
    jp = jax_pipelines[guided]
    assert (jp.keyframer is not None) == guided
    want = jp.generate(d["wav"], 16_000, top_p=0.9, seed=5)
    pose = "pose_guided" if guided else "pose"
    pp = demo.DemoPipeline(d["p_face"], d[f"p_{pose}"], d["root"], "SYNTH01", timestep_respacing="ddim10",
                           device="cpu")
    assert (pp.keyframer is not None) == guided
    timings = {}
    got = pp.generate(d["wav"], 16_000, top_p=0.9, seed=5, timings=timings)
    assert sorted(got) == sorted(want) == ["audio", "face", "pose"]
    assert got["face"].shape == (120, 256) and got["pose"].shape == (120, 104)
    np.testing.assert_array_equal(got["audio"], want["audio"])
    _close_scaled(got["face"], want["face"])
    _close_scaled(got["pose"], want["pose"])
    assert min(timings.values()) >= 0.0 and timings["face_ddim_s"] > 0.0
    if guided:  # each keyframer asked for ceil(120 / 30) keyframes of the same normalised audio
        (ja, jk, jt), (pa, pk, pt) = calls
        assert jk == pk == 4 and jt == pt == 0.9
        np.testing.assert_array_equal(pa, ja)
    else:
        assert not calls


def test_render_video_on_a_tiny_bundle(demo_dirs, tmp_path):
    d = demo_dirs
    cfg = RendererConfig(**RENDER_TINY)
    avatar = BodyAvatar(cfg, make_synthetic_assets(cfg, seed=0))
    K = np.array([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]], np.float32)
    cams = {f"cam{i}": Camera(campos=np.array([0.5 * i, -3.0, 1.0], np.float32), K=K,
                              Rt=np.array([[1, 0, 0, -0.5 * i], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32))
            for i in range(2)}
    bundle = save_renderer_bundle(str(tmp_path / "renderer"), cfg, avatar.state_dict(), cams)
    pp = demo.DemoPipeline(d["p_face"], d["p_pose"], d["root"], "SYNTH01", renderer_path=bundle, device="cpu")
    n, rng = 4, np.random.RandomState(17)  # a few frames of a result (one frame batch) keep the CPU render short
    result = {"face": (rng.randn(n, 256) * 0.1).astype(np.float32), "pose": pp.stats.pose_mean[None].repeat(n, 0),
              "audio": demo.prepare_audio(d["wav"], 16_000)[: n * 1600]}
    path = pp.render_video(result, str(tmp_path / "demo_video"))
    assert os.path.basename(path).startswith("demo_video_pred")
    if path.endswith(".npz"):  # no ffmpeg: the frames themselves
        frames = np.load(path)["frames"]
        assert frames.shape == (n, 48, 2 * 32, 3) and frames.dtype == np.uint8 and frames.any()
    pp.renderer = None
    with pytest.raises(ValueError, match="renderer_path"):
        pp.render_video(result, "x")


def test_main_writes_demo_results(demo_dirs, tmp_path, capsys, monkeypatch):
    """``main``'s flow on the CPU; the pipeline's DDIM-100 respaced to 2
    steps to keep it short (the samplers are held above)."""
    d = demo_dirs
    respaced = demo.maybe_respaced
    monkeypatch.setattr(demo, "maybe_respaced", lambda schedule, steps, spacing: respaced(schedule, steps, "ddim2"))
    wav_path = str(tmp_path / "in.wav")
    audio = (np.random.RandomState(15).randn(4 * 48_000 + 100, 2) * 0.2).astype(np.float32)
    write_wav(wav_path, audio, 48_000)
    out = str(tmp_path / "out")
    demo.main(["--wav", wav_path, "--face_model", d["p_face"], "--pose_model", d["p_pose"],
               "--data_root", d["root"], "--person", "SYNTH01", "--out", out, "--device", "cpu"])
    res = np.load(os.path.join(out, "demo_results.npy"), allow_pickle=True).item()
    assert sorted(res) == ["audio", "face", "pose"]
    assert res["face"].shape == (120, 256) and res["pose"].shape == (120, 104) and res["audio"].shape == (192_000, 2)
    assert np.isfinite(res["face"]).all() and np.isfinite(res["pose"]).all()
    assert "saved" in capsys.readouterr().out


def test_demo_runs_on_the_card_by_default(demo_dirs, monkeypatch):
    d = demo_dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.DemoPipeline(d["p_face"], d["p_pose"], d["root"], "SYNTH01")
