"""The face generate slice, port vs JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; weights
reach the port through ``convert`` (the inverse of ``train/convert.py``).
Bars: every module within 2e-5 of its output's largest magnitude, the
wav2vec encoder and the 12-layer aggregator included (measured on this CPU:
aggregator 5.6e-7, encoder 6.4e-7, lip regressor 1.1e-6, ``encode_lip``
1.4e-6, rotary encoder layer 2.3e-7); the face DDIM-10 CFG loop and
``generate``'s ``results.npy`` within 1e-4 atol and rtol, the pose slice's
bar, at the pose slice's guidance 2.0.  The guidance scale multiplies the
two frameworks' rounding differences in every step: at the face guidance
10.0 the DDIM-10 loop differs by up to 4.3e-4 on outputs of magnitude ~100
(4e-6 of the scale), which the 1e-4 atol does not take where an output is
near 0.  The card runs 10.0 (chip_smoke.py, card vs CPU).

The denoiser is tiny (latent 16, 2 layers) at ``max_seq_length=150`` with
``flash_attention=True``: its queries (150) and audio keys (500) reach the
128 gate, so the JAX side runs its Pallas attention in interpret mode and
the port its kernel wrapper (the plain version on CPU tensors).  The lip
regressor's widths (512, 4 heads, FF 1024) are fixed by the JAX module; 150
frames make one full 120-frame chunk and a 30-frame remainder.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps import generate as j_generate
from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.diffusion import respace as j_respace
from audio2photoreal_tpu.diffusion import sampling as j_sampling
from audio2photoreal_tpu.models import audio_encoder as j_audio
from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.models.cfg import cfg_model_fn_cached as j_cfg_cached
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.models.lip_regressor import LipRegressor as JLipRegressor
from audio2photoreal_tpu.ops import embeddings as j_emb
from audio2photoreal_tpu.ops import rotary as j_rotary
from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.train import checkpoints
from audio2photoreal_tpu.train.convert import convert_film_denoiser, convert_lip_regressor
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import generate
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.diffusion import respace, sampling
from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention_reference
from audio2photoreal_tpu_torch.models import audio_encoder, blocks
from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn, cfg_model_fn_cached
from audio2photoreal_tpu_torch.models.lip_regressor import LipRegressor
from audio2photoreal_tpu_torch.ops import embeddings, rotary
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

T = 150
MODEL = dict(data_format="face", nfeats=256, latent_dim=16, ff_size=32, num_layers=2, num_heads=2,
             max_seq_length=T, dropout=0.0, flash_attention=True)
TOL = dict(atol=1e-4, rtol=1e-4)
GUIDANCE = 2.0


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _perturb(params, seed):
    """Nonzero biases and non-identity norms: JAX init leaves them 0 and 1."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, params
    )


def _close_scaled(got, want, rel):
    """Within ``rel`` of the output's largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------- ops -- #


@pytest.mark.parametrize("T_,dim", [(37, 512), (5, 9)])
def test_absolute_pos_encoding_matches_jax(T_, dim):
    got = embeddings.absolute_pos_encoding(T_, dim)
    _close_scaled(got, j_emb.absolute_pos_encoding(T_, dim), 2e-5)


# ----------------------------------------------------------- frontend -- #


def test_conv_aggregator_matches_jax():
    x = np.random.RandomState(1).randn(2, 40, 512).astype(np.float32)
    jm = j_audio.ConvAggregator()
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    pm = audio_encoder.ConvAggregator()
    pm.load_state_dict(_strip(convert.wav2vec_aggregator_state_dict_from_jax(params["params"], "a"), "a."),
                       strict=True)
    with torch.no_grad():
        _close_scaled(pm(_t(x)), want, 2e-5)


def test_wav2vec_encoder_matches_jax():
    frames = (np.random.RandomState(3).randn(2, 30, 1600) * 0.3).astype(np.float32)  # 1 s
    jm = j_audio.Wav2VecEncoder()
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(frames)), 4)
    want = jax.jit(jm.apply)(params, jnp.asarray(frames))
    pm = audio_encoder.Wav2VecEncoder()
    p = params["params"]
    sd = {**convert.wav2vec_extractor_state_dict_from_jax(p["feature_extractor"], "wav2vec_model.feature_extractor"),
          **convert.wav2vec_aggregator_state_dict_from_jax(p["feature_aggregator"],
                                                            "wav2vec_model.feature_aggregator")}
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(_t(frames))
    assert got.shape == (2, 100, 512)
    _close_scaled(got, want, 2e-5)


# ------------------------------------------------------------- blocks -- #


@pytest.mark.parametrize("Tx,flash", [(20, False), (130, True)])
def test_rotary_encoder_layer_matches_jax(Tx, flash, monkeypatch):
    D, H, ff = 32, 2, 64
    x = np.random.RandomState(Tx).randn(2, Tx, D).astype(np.float32)
    jl = j_blocks.RotaryEncoderLayer(D, H, ff, dropout=0.0, flash=flash)
    jrot = j_rotary.make_rotary_table(D, 200)
    params = _perturb(jax.jit(lambda k, a: jl.init(k, a, rotary=jrot))(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    j_flash.reset_trace_flops()
    want = jax.jit(lambda p, a: jl.apply(p, a, rotary=jrot))(params, jnp.asarray(x))
    assert (j_flash.trace_flops() > 0) == flash  # the JAX side took its Pallas kernel
    calls = []
    monkeypatch.setattr(blocks, "flash_attention", lambda *a: calls.append(1) or flash_attention_reference(*a))
    sd = {}
    convert.rotary_encoder_layer_state_dict(sd, "l", params["params"])
    pl = blocks.RotaryEncoderLayer(D, H, ff, dropout=0.0, flash=flash).eval()
    pl.load_state_dict(_strip(sd, "l."), strict=True)
    with torch.no_grad():
        got = pl(_t(x), rotary=rotary.make_rotary_table(D, 200))
    assert len(calls) == int(flash)
    _close_scaled(got, want, 2e-5)


def test_lip_regressor_matches_jax():
    frames = (np.random.RandomState(6).randn(1, 30, 1600) * 0.5).astype(np.float32)  # 1 s
    jm = JLipRegressor()
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(frames)), 7)
    want = jax.jit(jm.apply)(params, jnp.asarray(frames))
    pm = LipRegressor().eval()
    sd = convert.lip_regressor_state_dict_from_jax(params["params"])
    pm.load_state_dict(sd, strict=True)
    # the reference's names: train/convert.py reads them back to the same tree
    back = convert_lip_regressor(sd)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    with torch.no_grad():
        got = pm(_t(frames))
    assert got.shape == (1, 30, 338, 3)
    _close_scaled(got, want, 2e-5)


# ------------------------------------------------------ face denoiser -- #


@pytest.fixture(scope="module")
def face(tmp_path_factory):
    """A synthetic person, JAX params for the tiny face model, the port's
    model loaded from them, both models' checkpoint dirs, a fixed x_T."""
    root = str(tmp_path_factory.mktemp("face"))
    make_synthetic_person(root, "SYNTH01", num_scenes=5, frames_per_scene=T, seed=4)
    jcfg = j_config.DenoiserConfig(**MODEL)
    jm = JDenoiser(jcfg)
    rng = np.random.RandomState(0)
    B = 2
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(1), "cond_drop": jax.random.PRNGKey(2)},
        jnp.zeros((B, T, 256)), jnp.zeros((B,), jnp.int32), jnp.zeros((B, T * 1600, 2)),
    )
    params = _perturb(params, 8)
    sections = dict(diffusion=j_config.DiffusionConfig(), data=j_config.DataConfig(
        person="SYNTH01", data_format="face", max_seq_length=T))
    j_dir, p_dir = f"{root}/jax_model", f"{root}/port_model"
    j_config.save_config(j_dir, denoiser=jcfg, **sections)
    checkpoints.save(f"{j_dir}/ckpt", 0, {"params": params}, block=True)
    j_config.save_config(p_dir, denoiser=jcfg, **sections)
    sd = convert.film_denoiser_state_dict_from_jax(params, "face", MODEL["num_layers"])
    torch.save(sd, f"{p_dir}/{generate.MODEL_FILE}")
    pm = generate.load_model(p_dir, "cpu")
    audio = (rng.randn(B, T * 1600, 2) * 0.5).astype(np.float32)
    x_T = rng.randn(B, T, 256).astype(np.float32)
    yield dict(root=root, jm=jm, params=params, sd=sd, pm=pm, j_dir=j_dir, p_dir=p_dir, audio=audio, x_T=x_T)
    shutil.rmtree(root)  # the models' dirs, 0.4 GB


def test_face_state_dict_round_trips_through_the_jax_converter(face):
    sd, params, pm = face["sd"], face["params"], face["pm"]
    assert set(sd) == set(pm.state_dict())
    assert any(k.startswith("lip_model.regression_model.transformer_decoder.3.") for k in sd)
    assert not any(k.startswith(("null_pose_embed", "post_pose_layers", "frame_")) for k in sd)
    back = convert_film_denoiser({k: v.numpy() for k, v in pm.state_dict().items()}, "face",
                                 MODEL["num_layers"])
    a = jax.tree_util.tree_leaves_with_path(back)
    b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_encode_lip_matches_jax(face):
    """T = 150 frames: one full 120-frame chunk and the 30-frame remainder,
    resized to the 498 audio tokens."""
    jm, params, pm, audio = face["jm"], face["params"], face["pm"], face["audio"]
    want = jax.jit(functools.partial(jm.apply, params, method=JDenoiser.encode_lip), static_argnums=1)(
        jnp.asarray(audio), 498)
    with torch.no_grad():
        got = pm.encode_lip(_t(audio), 498)
        verts = pm.lip_vertices(_t(audio))
    assert verts.shape == (2, T, 1014) and got.shape == (2, 498, 1014)
    _close_scaled(got, want, 2e-5)


def _face_cfg_ddim(face, guidance):
    """Encode, cached CFG at ``guidance`` and DDIM-10 from one x_T on both
    sides: (port cond tokens, JAX cond tokens, port pred_xstart, JAX
    pred_xstart)."""
    jm, params, pm, audio = face["jm"], face["params"], face["pm"], face["audio"]

    @jax.jit
    def run_jax(a, x):
        cond = jm.apply(params, a, method=JDenoiser.encode_conditioning)
        fn = j_cfg_cached(jm, params, cond, guidance)
        sched = j_respace.maybe_respaced("cosine", 1000, "ddim10")
        return cond.cond_tokens, j_sampling.ddim_sample_loop(sched, "xstart", fn, x, jax.random.PRNGKey(0)).pred_xstart

    j_flash.reset_trace_flops()
    want_tokens, want = run_jax(jnp.asarray(audio), jnp.asarray(face["x_T"]))
    assert j_flash.trace_flops() > 0  # the JAX side went through the Pallas kernel
    with torch.no_grad():
        cond = pm.encode_conditioning(_t(audio))
        sched = respace.maybe_respaced("cosine", 1000, "ddim10")
        got = sampling.ddim_sample_loop(sched, "xstart", cfg_model_fn_cached(pm, cond, guidance), _t(face["x_T"]))
    return cond.cond_tokens, want_tokens, got.pred_xstart, want


def test_face_encode_cfg_ddim_matches_jax(face, monkeypatch):
    pm, audio = face["pm"], face["audio"]
    calls = []
    monkeypatch.setattr(blocks, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or flash_attention_reference(*a))
    tokens, want_tokens, got, want = _face_cfg_ddim(face, GUIDANCE)
    with torch.no_grad():
        cond = pm.encode_conditioning(_t(audio))
        assert cond.pose_tokens is None and cond.cond_tokens.shape == (2, 498, 16)
        x_T = _t(face["x_T"])
        uncached = cfg_model_fn(pm, cond, GUIDANCE)(x_T, torch.tensor([999, 999]))
        cached = cfg_model_fn_cached(pm, cond, GUIDANCE)(x_T, torch.tensor([999, 999]))
    _close_scaled(tokens, want_tokens, 2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cached.numpy(), uncached.numpy(), atol=2e-5, rtol=2e-5)
    # the cond-encoder's self-attention (once per encode), then self- and
    # cross-attention of every layer at every step (10 DDIM + the two
    # checks), all at batch 2B
    assert len(calls) == 2 * 2 + MODEL["num_layers"] * 2 * (10 + 2)
    assert calls[0] == (2, 2, 498, 8) and calls[2] == (4, 2, T, 8)


def test_face_encode_cfg_ddim_matches_jax_at_guidance_10(face):
    """The reference's face guidance: DDIM-10 within 2e-5 of the output's
    largest magnitude, the f32 module bar (the guidance multiplies both
    frameworks' rounding, so an absolute 1e-4 does not hold near 0)."""
    tokens, want_tokens, got, want = _face_cfg_ddim(face, 10.0)
    _close_scaled(tokens, want_tokens, 2e-5)
    _close_scaled(got, want, 2e-5)


def test_face_generate_results_match_jax(face, monkeypatch, tmp_path):
    x_T = face["x_T"]

    def fake_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == x_T.shape
        return jnp.asarray(x_T, dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(generate, "draw_noise", lambda shape, g, device: torch.from_numpy(x_T))
    kw = dict(num_samples=2, guidance_param=GUIDANCE, timestep_respacing="ddim10")
    want = np.load(j_generate.generate(face["j_dir"], face["root"], output_dir=str(tmp_path / "j"), **kw),
                   allow_pickle=True).item()
    timings = {}
    got = np.load(generate.generate(face["p_dir"], face["root"], output_dir=str(tmp_path / "p"),
                                    device="cpu", timings=timings, **kw), allow_pickle=True).item()
    assert sorted(got) == sorted(want) == ["audio", "gt", "lengths", "motions"]  # no keyframes
    assert got["motions"].shape == (2, 256, 1, T)
    np.testing.assert_allclose(got["motions"], want["motions"], **TOL)
    for k in ("gt", "audio", "lengths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0.0 < timings["lip_s"] <= timings["encode_s"] and timings["ddim_s"] > 0.0

