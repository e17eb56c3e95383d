"""The pose generate slice, port vs JAX package, on the CPU.

``max_seq_length=128`` with ``flash_attention=True``: both sequence axes
reach the 128 floor, so the JAX side really runs its Pallas attention kernel
(interpret mode on the CPU) and the port runs its kernel wrapper (the plain
version, the tensors being on the CPU).  The same weights go to both sides
through ``convert.film_denoiser_state_dict_from_jax`` and the same numpy x_T
is injected; tolerance 1e-4 atol and rtol after DDIM-10.  With guide
keyframes, a tiny guide (latent 64, 2 layers, 32 tokens) and VQ (width 16,
depth 2) go to both sides through ``convert.guide_state_dict_from_jax`` /
``vqvae_state_dict_from_jax`` and JAX's Gumbel noise is injected: the tokens
equal, the keyframes within 2e-5 of their scale, the motions within 1e-4.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio2photoreal_tpu.apps import generate as j_generate
from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.diffusion import respace as j_respace
from audio2photoreal_tpu.diffusion import sampling as j_sampling
from audio2photoreal_tpu.models.cfg import cfg_model_fn_cached as j_cfg_cached
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.models.guide import GuideTransformer as JGuide
from audio2photoreal_tpu.models.vqvae import TemporalVertexCodec as JCodec
from audio2photoreal_tpu.models.vqvae import VQState
from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.train import checkpoints
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import generate
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.diffusion import respace, sampling
from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention_reference
from audio2photoreal_tpu_torch.models import blocks, guide
from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn, cfg_model_fn_cached
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

T = 128
MODEL = dict(data_format="pose", latent_dim=16, ff_size=32, num_layers=2, num_heads=2,
             max_seq_length=T, dropout=0.0, flash_attention=True)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """A synthetic person, JAX params for the tiny model, and both models' dirs."""
    root = str(tmp_path_factory.mktemp("slice"))
    make_synthetic_person(root, "SYNTH01", num_scenes=5, frames_per_scene=T, seed=3)
    jcfg = j_config.DenoiserConfig(**MODEL)
    jm = JDenoiser(jcfg)
    rng = np.random.RandomState(0)
    B = 2
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(1), "cond_drop": jax.random.PRNGKey(2)},
        jnp.zeros((B, T, 104)), jnp.zeros((B,), jnp.int32), jnp.zeros((B, T * 1600, 2)),
        jnp.zeros((B, 5, 104)), jnp.ones((B, 5)),
    )
    # nonzero biases and non-identity norms, so every parameter is exercised
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, params)
    sections = dict(diffusion=j_config.DiffusionConfig(), data=j_config.DataConfig(
        person="SYNTH01", max_seq_length=T))
    j_dir, p_dir = f"{root}/jax_model", f"{root}/port_model"
    j_config.save_config(j_dir, denoiser=jcfg, **sections)
    checkpoints.save(f"{j_dir}/ckpt", 0, {"params": params}, block=True)
    j_config.save_config(p_dir, denoiser=jcfg, **sections)
    torch.save(convert.film_denoiser_state_dict_from_jax(params, "pose", MODEL["num_layers"]),
               f"{p_dir}/{generate.MODEL_FILE}")
    x_T = rng.randn(B, T, 104).astype(np.float32)
    return dict(root=root, jm=jm, params=params, j_dir=j_dir, p_dir=p_dir, x_T=x_T)


def test_encode_cfg_ddim_matches_jax(slice_setup, monkeypatch):
    s = slice_setup
    rng = np.random.RandomState(9)
    audio = rng.randn(2, T * 1600, 2).astype(np.float32)
    kf = rng.randn(2, 5, 104).astype(np.float32)
    kv = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], np.float32)
    jm, params = s["jm"], s["params"]

    @jax.jit
    def run_jax(a, k, v, x):
        cond = jm.apply(params, a, k, v, method=JDenoiser.encode_conditioning)
        fn = j_cfg_cached(jm, params, cond, 2.0)
        sched = j_respace.maybe_respaced("cosine", 1000, "ddim10")
        return j_sampling.ddim_sample_loop(sched, "xstart", fn, x, jax.random.PRNGKey(0)).pred_xstart

    j_flash.reset_trace_flops()
    want = np.asarray(run_jax(*(jnp.asarray(a) for a in (audio, kf, kv, s["x_T"]))))
    assert j_flash.trace_flops() > 0  # the JAX side went through the Pallas kernel
    calls = []
    monkeypatch.setattr(blocks, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or flash_attention_reference(*a))
    model = generate.load_model(s["p_dir"], "cpu")
    with torch.no_grad():
        cond = model.encode_conditioning(*(torch.from_numpy(a) for a in (audio, kf, kv)))
        # 1998-token scale: the flash gate is open on both attention axes
        assert cond.cond_tokens.shape[1] >= 128
        x_T = torch.from_numpy(s["x_T"])
        sched = respace.maybe_respaced("cosine", 1000, "ddim10")
        got = sampling.ddim_sample_loop(sched, "xstart", cfg_model_fn_cached(model, cond, 2.0), x_T)
        uncached = cfg_model_fn(model, cond, 2.0)(x_T, torch.tensor([999, 999]))
        cached = cfg_model_fn_cached(model, cond, 2.0)(x_T, torch.tensor([999, 999]))
    np.testing.assert_allclose(got.pred_xstart.numpy(), want, **TOL)
    np.testing.assert_allclose(cached.numpy(), uncached.numpy(), atol=2e-5, rtol=2e-5)
    # self- and audio cross-attention of every layer, every step, through the gate
    assert len(calls) == MODEL["num_layers"] * 2 * (10 + 2)


def test_generate_results_match_jax(slice_setup, monkeypatch, tmp_path):
    s = slice_setup
    x_T = s["x_T"]

    def fake_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == x_T.shape
        return jnp.asarray(x_T, dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(generate, "draw_noise", lambda shape, g, device: torch.from_numpy(x_T))
    kw = dict(num_samples=2, guidance_param=2.0, timestep_respacing="ddim10")
    want = np.load(j_generate.generate(s["j_dir"], s["root"], output_dir=str(tmp_path / "j"), **kw),
                   allow_pickle=True).item()
    got = np.load(generate.generate(s["p_dir"], s["root"], output_dir=str(tmp_path / "p"),
                                    device="cpu", **kw), allow_pickle=True).item()
    assert sorted(got) == sorted(want) == ["audio", "gt", "keyframes", "lengths", "motions"]
    assert got["motions"].shape == (2, 104, 1, T)
    np.testing.assert_allclose(got["motions"], want["motions"], **TOL)
    for k in ("gt", "audio", "lengths", "keyframes"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


GUIDE = dict(tokens=32, latent_dim=64, ff_size=96, num_layers=2, num_heads=2, vq_depth=2, dropout=0.0)
VQ = dict(nfeats=104, emb_width=16, code_dim=32, depth=2, kmeans_init=False)


@pytest.fixture(scope="module")
def guide_dirs(slice_setup):
    """A tiny guide and VQ, saved for the JAX package (orbax ``ckpt``) and
    for the port (``model.pt``), each with its ``config.json``."""
    root, rng = slice_setup["root"], np.random.RandomState(4)
    perturb = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, t)
    gcfg, vcfg = j_config.GuideConfig(**GUIDE), j_config.VQConfig(**VQ)
    gparams = perturb(jax.jit(JGuide(gcfg).init)(
        {"params": jax.random.PRNGKey(5), "cond_drop": jax.random.PRNGKey(6)},
        jnp.zeros((2, 4), jnp.int32), jnp.zeros((2, 30 * 1600, 2))))
    vq = VQState.create(jax.random.PRNGKey(7), vcfg)
    vparams = perturb(JCodec(vcfg).init(jax.random.PRNGKey(8), jnp.zeros((2, 5, 104)), vq))
    dirs = {k: f"{root}/{k}" for k in ("j_guide", "j_vq", "p_guide", "p_vq")}
    for side in ("j", "p"):
        j_config.save_config(dirs[f"{side}_guide"], guide=gcfg)
        j_config.save_config(dirs[f"{side}_vq"], vq=vcfg)
    checkpoints.save(f"{dirs['j_guide']}/ckpt", 0, {"params": gparams}, block=True)
    checkpoints.save(f"{dirs['j_vq']}/ckpt", 0, {"params": vparams, "vq": {
        "embed": vq.embed, "embed_avg": vq.embed_avg, "cluster_size": vq.cluster_size}}, block=True)
    torch.save(convert.guide_state_dict_from_jax(gparams), f"{dirs['p_guide']}/{generate.MODEL_FILE}")
    torch.save(convert.vqvae_state_dict_from_jax(vparams, vq), f"{dirs['p_vq']}/{generate.MODEL_FILE}")
    return dirs


def test_generate_with_guide_keyframes_matches_jax(slice_setup, guide_dirs, monkeypatch, tmp_path):
    s, d = slice_setup, guide_dirs
    x_T = s["x_T"]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(x_T, dtype))
    monkeypatch.setattr(generate, "draw_noise", lambda shape, g, device: torch.from_numpy(x_T))
    # JAX's tokens and the key its keyframer draws them from
    seen = {}
    j_call = j_generate.GuideKeyframer.__call__

    def j_spy(self, audio, num_keyframes, key, top_p=0.94):
        seen["key"], seen["n"] = key, num_keyframes * self.vcfg.depth
        codec = self.codec

        class Tokens:  # the codes JAX's keyframer decodes are its guide's tokens, [B, K, depth]
            def apply(_, params, codes, *a, **k):
                seen["jax"] = np.asarray(codes).reshape(codes.shape[0], -1)
                return codec.apply(params, codes, *a, **k)

        self.codec = Tokens()
        try:
            return j_call(self, audio, num_keyframes, key, top_p)
        finally:
            self.codec = codec

    monkeypatch.setattr(j_generate.GuideKeyframer, "__call__", j_spy)
    kw = dict(num_samples=2, guidance_param=2.0, timestep_respacing="ddim10", top_p=0.9)
    want = np.load(j_generate.generate(s["j_dir"], s["root"], guide_path=d["j_guide"], vq_path=d["j_vq"],
                                       output_dir=str(tmp_path / "j"), **kw), allow_pickle=True).item()
    assert seen["jax"].shape == (2, 5 * 2)  # ceil(128 / 30) keyframes x depth 2

    # the port, with the Gumbel noise of JAX's steps
    key, noise = seen["key"], []
    for _ in range(seen["n"]):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.gumbel(sub, (2, GUIDE["tokens"]))))
    it = iter(noise)
    monkeypatch.setattr(guide, "draw_gumbel", lambda shape, g, device: torch.from_numpy(next(it)))
    p_generate = guide.GuideTransformer.generate

    def p_spy(self, *a, **k):
        seen["port"] = p_generate(self, *a, **k).numpy()
        return torch.from_numpy(seen["port"])

    monkeypatch.setattr(guide.GuideTransformer, "generate", p_spy)
    timings = {}
    got = np.load(generate.generate(s["p_dir"], s["root"], guide_path=d["p_guide"], vq_path=d["p_vq"],
                                    output_dir=str(tmp_path / "p"), device="cpu", timings=timings, **kw),
                  allow_pickle=True).item()
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert sorted(got) == sorted(want) == ["audio", "gt", "keyframes", "lengths", "motions"]
    assert got["keyframes"].shape == (2, 5, 104)
    scale = np.abs(want["keyframes"]).max()
    np.testing.assert_allclose(got["keyframes"], want["keyframes"], atol=2e-5 * scale, rtol=0)
    np.testing.assert_allclose(got["motions"], want["motions"], **TOL)
    for k in ("gt", "audio", "lengths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert timings["guide_s"] > 0.0
    # the keyframes are the guide's, not the dataset's
    gt = np.load(generate.generate(s["p_dir"], s["root"], output_dir=str(tmp_path / "gt"), device="cpu", **kw),
                 allow_pickle=True).item()
    assert not np.allclose(gt["keyframes"], got["keyframes"], atol=1e-3)


def test_generate_refuses_what_is_not_ported(slice_setup, guide_dirs, tmp_path):
    s = slice_setup
    # the render is ported; it refuses to start without its two inputs
    for kw in (dict(), dict(renderer_path="r"), dict(face_codes="f")):
        with pytest.raises(ValueError, match="--plot needs"):
            generate.generate(s["p_dir"], s["root"], device="cpu", plot=True, **kw)
    # a guide needs its VQ (a bf16 frontend is ported: test_generate_with_a_bf16_guide_frontend)
    with pytest.raises(ValueError, match="--resume_vq"):
        generate.generate(s["p_dir"], s["root"], device="cpu", guide_path=guide_dirs["p_guide"])


def test_generate_with_a_bf16_guide_frontend(slice_setup, guide_dirs, tmp_path):
    """A guide whose config runs its frozen frontend in bf16 keyframes the
    pose model, as the JAX GuideKeyframer follows the guide's config; the
    guide itself computes in f32."""
    s = slice_setup
    bf16 = str(tmp_path / "bf16_guide")
    j_config.save_config(bf16, guide=j_config.GuideConfig(frontend_dtype="bfloat16", **GUIDE))
    shutil.copy(f"{guide_dirs['p_guide']}/{generate.MODEL_FILE}", f"{bf16}/{generate.MODEL_FILE}")
    keyframer = generate.GuideKeyframer(bf16, guide_dirs["p_vq"], "cpu")
    assert keyframer.guide.audio_model.feature_extractor.dtype == torch.bfloat16
    assert all(layer.dtype == torch.float32 for layer in keyframer.guide.layers)
    res = np.load(generate.generate(s["p_dir"], s["root"], device="cpu", guide_path=bf16, vq_path=guide_dirs["p_vq"],
                                    num_samples=1, timestep_respacing="ddim2", output_dir=str(tmp_path / "out")),
                  allow_pickle=True).item()
    assert np.isfinite(res["motions"]).all() and np.isfinite(res["keyframes"]).all()
