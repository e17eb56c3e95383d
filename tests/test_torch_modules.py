"""Port modules (audio2photoreal_tpu_torch) against their JAX counterparts.

Inputs are made with numpy from a seed and fed to both packages; weights
reach the port through ``convert.film_denoiser_state_dict_from_jax`` (the
inverse of ``train/convert.py:convert_film_denoiser``).  Tolerances: f32
modules 2e-5; the wav2vec frontend 1e-4 of its output scale, because its
512-channel conv sums run in another order.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core.config import DenoiserConfig as JDenoiserConfig
from audio2photoreal_tpu.models import audio_encoder as j_audio
from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.models.film_transformer import CondTokens as JCond
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.ops import attention as j_attn
from audio2photoreal_tpu.ops import convs as j_convs
from audio2photoreal_tpu.ops import embeddings as j_emb
from audio2photoreal_tpu.ops import resample as j_resample
from audio2photoreal_tpu.ops import rotary as j_rotary
from audio2photoreal_tpu.train.convert import convert_film_denoiser
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.core.config import DenoiserConfig
from audio2photoreal_tpu_torch.models import audio_encoder, blocks
from audio2photoreal_tpu_torch.models.film_transformer import CondTokens, FiLMDenoiser
from audio2photoreal_tpu_torch.ops import attention, convs, embeddings, resample, rotary
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _perturb(params, seed):
    """Nonzero biases and non-identity norms: JAX init leaves them 0 and 1."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, params
    )


# ---------------------------------------------------------------- ops -- #


@pytest.mark.parametrize("T", [4800, 4801, 1003])
def test_resample_matches_jax(T):
    x = np.random.RandomState(T).randn(2, T).astype(np.float32)
    got = resample.resample(_t(x), 48_000, 16_000)
    want = j_resample.resample(jnp.asarray(x), 48_000, 16_000)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("stride,dilation,padding", [
    (1, 1, (1, 1)), (2, 1, (0, 1)), (1, 3, (4, 2)), (5, 1, (0, 0)), (1, 2, (0, 0)),
])
def test_conv1d_matches_jax(stride, dilation, padding):
    rng = np.random.RandomState(stride * 10 + dilation)
    x = rng.randn(2, 31, 5).astype(np.float32)
    w = rng.randn(3, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    got = convs.conv1d(_t(x), _t(w), _t(b), stride=stride, dilation=dilation, padding=padding)
    want = j_convs.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                          dilation=dilation, padding=padding)
    _close(got, want)
    if padding == (0, 0) and dilation == 1:
        _close(convs.valid_conv1d(_t(x), _t(w), _t(b), stride=stride),
               j_convs.valid_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride))


@pytest.mark.parametrize("offset", [0, 7])
def test_rotary_matches_jax(offset):
    x = np.random.RandomState(offset).randn(2, 9, 16).astype(np.float32)
    got = rotary.apply_rotary(_t(x), rotary.make_rotary_table(16, 40), offset)
    want = j_rotary.apply_rotary(jnp.asarray(x), j_rotary.make_rotary_table(16, 40), offset)
    _close(got, want)


def test_sinusoidal_pos_emb_matches_jax():
    t = np.array([0, 3, 999, 517])
    _close(embeddings.sinusoidal_pos_emb(torch.from_numpy(t), 16),
           j_emb.sinusoidal_pos_emb(jnp.asarray(t), 16))


def test_plain_attention_matches_jax():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 3, T, 8).astype(np.float32) for T in (5, 11, 11))
    valid = (np.arange(11)[None] < np.array([[6], [11]])).astype(np.float32)
    got = attention.dot_product_attention(
        _t(q), _t(k), _t(v), attention.padding_bias(_t(valid)) + attention.causal_bias(5, 11))
    want = j_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        j_attn.padding_bias(jnp.asarray(valid)) + j_attn.causal_bias(5, 11))
    _close(got, want)


# ----------------------------------------------------------- frontend -- #


def test_wav2vec_extractor_matches_jax():
    audio = (np.random.RandomState(1).randn(2, 9600, 2) * 0.3).astype(np.float32)
    assert audio_encoder.feature_frames(3200) == j_audio.feature_frames(3200) == 18
    jm = j_audio.Wav2VecFeatureExtractor()
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(audio)), 2)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(audio)))
    pm = audio_encoder.Wav2VecFeatureExtractor()
    pm.load_state_dict(convert.wav2vec_extractor_state_dict_from_jax(
        params["params"]["feature_extractor"], "feature_extractor"), strict=True)
    with torch.no_grad():
        got = pm(_t(audio)).numpy()
    assert got.shape == want.shape == (2, 18, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------- blocks -- #


def test_film_decoder_layer_matches_jax():
    D, H, ff, T, Tm, Tk = 16, 2, 32, 10, 23, 4
    rng = np.random.RandomState(3)
    x, mem, mem2 = (rng.randn(2, n, D).astype(np.float32) for n in (T, Tm, Tk))
    tv = rng.randn(2, D).astype(np.float32)
    jl = j_blocks.FiLMDecoderLayer(D, H, ff, dropout=0.0, use_cm=True)
    jrot = j_rotary.make_rotary_table(D, 40)
    args = (jnp.asarray(x), jnp.asarray(mem), jnp.asarray(tv), True)
    fwd = jax.jit(lambda p, *a: jl.apply(p, *a, True, memory2=jnp.asarray(mem2), rotary=jrot))
    params = _perturb(jax.jit(lambda k, *a: jl.init(k, *a, True, memory2=jnp.asarray(mem2), rotary=jrot))(
        jax.random.PRNGKey(0), *args[:3]), 4)
    want = fwd(params, *args[:3])

    sd = {}
    convert._decoder_layer(sd, "l", params["params"])
    pl = blocks.FiLMDecoderLayer(D, H, ff, use_cm=True)
    pl.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    rot = rotary.make_rotary_table(D, 40)
    with torch.no_grad():  # JAX projects the memory inside the layer, the port outside
        cross_kv = pl.multihead_attn.project_kv(rotary.apply_rotary(_t(mem), rot), _t(mem))
        got = pl(_t(x), _t(tv), cross_kv, _t(mem2), rotary=rot)
    _close(got, want)


# ----------------------------------------------------------- denoiser -- #

CFG = dict(data_format="pose", nfeats=16, latent_dim=16, ff_size=32, num_layers=2,
           num_heads=2, max_seq_length=24, keyframe_step=6, dropout=0.0)


@pytest.fixture(scope="module")
def denoisers():
    """(jitted JAX methods, JAX params, port model, numpy inputs) at tiny width."""
    B, T = 2, CFG["max_seq_length"]
    rng = np.random.RandomState(5)
    inp = {
        "x": rng.randn(B, T, CFG["nfeats"]).astype(np.float32),
        "audio": (rng.randn(B, T * 1600, 2) * 0.5).astype(np.float32),
        "kf": rng.randn(B, 4, 104).astype(np.float32),
        "kv": np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32),
        "t": np.array([3, 777]),
    }
    jm = JDenoiser(JDenoiserConfig(**CFG))
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(3), "cond_drop": jax.random.PRNGKey(4)},
        jnp.asarray(inp["x"]), jnp.zeros((B,), jnp.int32), jnp.asarray(inp["audio"]),
        jnp.asarray(inp["kf"]), jnp.asarray(inp["kv"]),
    )
    params = _perturb(params, 6)
    pm = FiLMDenoiser(DenoiserConfig(**CFG)).eval()
    pm.load_state_dict(convert.film_denoiser_state_dict_from_jax(params, "pose", CFG["num_layers"]),
                       strict=True)
    japply = {m: jax.jit(functools.partial(jm.apply, params, method=getattr(JDenoiser, m)))
              for m in ("encode_conditioning", "build_cond_cache", "denoise_cached", "denoise")}
    return japply, params, pm, inp


def test_state_dict_round_trips_through_the_jax_converter(denoisers):
    _, params, pm, _ = denoisers
    sd = convert.film_denoiser_state_dict_from_jax(params, "pose", CFG["num_layers"])
    assert set(sd) == set(pm.state_dict())
    back = convert_film_denoiser(sd, "pose", CFG["num_layers"])
    a = jax.tree_util.tree_leaves_with_path(back)
    b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_encode_conditioning_matches_jax(denoisers):
    japply, _, pm, inp = denoisers
    want = japply["encode_conditioning"](jnp.asarray(inp["audio"]), jnp.asarray(inp["kf"]),
                                         jnp.asarray(inp["kv"]))
    with torch.no_grad():
        got = pm.encode_conditioning(_t(inp["audio"]), _t(inp["kf"]), _t(inp["kv"]))
    assert got.cond_tokens.shape == (2, 78, 16)
    _close(got.cond_tokens, want.cond_tokens, tol=1e-4)
    _close(got.pose_tokens, want.pose_tokens)


def _cond(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 78, 16).astype(np.float32), rng.randn(2, 4, 16).astype(np.float32)


def test_build_cond_cache_and_denoise_cached_match_jax(denoisers):
    japply, _, pm, inp = denoisers
    ct, pt = _cond(7)
    keep = np.array([True, False])
    jcache = japply["build_cond_cache"](JCond(jnp.asarray(ct), jnp.asarray(pt)), jnp.asarray(keep))
    with torch.no_grad():
        cache = pm.build_cond_cache(CondTokens(_t(ct), _t(pt)), torch.from_numpy(keep))
        for name in ("ks", "vs", "cond_hidden", "pose_tokens"):
            _close(cache[name], jcache[name])
        assert cache["n_cond"] == jcache["n_cond"]
        got = pm.denoise_cached(_t(inp["x"]), torch.from_numpy(inp["t"]), cache)
    want = japply["denoise_cached"](jnp.asarray(inp["x"]), jnp.asarray(inp["t"], jnp.int32), jcache)
    _close(got, want)


@pytest.mark.parametrize("keep", [[True, True], [True, False], [False, False]])
def test_denoise_matches_jax(denoisers, keep):
    japply, _, pm, inp = denoisers
    ct, pt = _cond(8)
    keep = np.array(keep)
    want = japply["denoise"](jnp.asarray(inp["x"]), jnp.asarray(inp["t"], jnp.int32),
                             JCond(jnp.asarray(ct), jnp.asarray(pt)), jnp.asarray(keep))
    with torch.no_grad():
        got = pm.denoise(_t(inp["x"]), torch.from_numpy(inp["t"]),
                         CondTokens(_t(ct), _t(pt)), torch.from_numpy(keep))
    _close(got, want)


def test_face_branch_and_bf16_raise():
    """The face denoiser builds (lip regressor and rotary cond-encoder,
    frozen lip model, no pose-only modules); a bf16 config builds with f32
    parameters and bf16 compute (tests/test_torch_bf16.py holds it to JAX),
    and a dtype outside the policy raises."""
    face = FiLMDenoiser(DenoiserConfig(**{**CFG, "data_format": "face", "nfeats": 256}))
    assert face.cond_projection.in_features == 1024 + 1014 and len(face.cond_encoder) == 2
    assert not any(p.requires_grad for p in face.lip_model.parameters())
    assert not any(n.startswith(("null_pose_embed", "post_pose_layers", "frame_")) for n in face.state_dict())
    bf16 = FiLMDenoiser(DenoiserConfig(**{**CFG, "dtype": "bfloat16", "frontend_dtype": "bfloat16"}))
    assert bf16.dtype == bf16.layers[0].dtype == torch.bfloat16
    assert bf16.audio_model.feature_extractor.dtype == torch.bfloat16
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}
    for bad in (dict(dtype="float16"), dict(frontend_dtype="float16")):
        with pytest.raises(ValueError, match="float16"):
            FiLMDenoiser(DenoiserConfig(**{**CFG, **bad}))


def test_reset_parameters_is_seeded():
    a, b = FiLMDenoiser(DenoiserConfig(**CFG)), FiLMDenoiser(DenoiserConfig(**CFG))
    a.reset_parameters(torch.Generator().manual_seed(1))
    b.reset_parameters(torch.Generator().manual_seed(1))
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    assert a.null_cond_embed.std() > 0.5 and torch.all(a.norm_cond.weight == 1)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import audio2photoreal_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax', 'audio2photoreal_tpu')]\n"
        "assert len(names) > 20 and not bad, (len(names), bad)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
