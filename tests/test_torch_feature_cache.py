"""The port's frozen-frontend feature cache (audio2photoreal_tpu_torch/
data/feature_cache.py) and the ``n_valid`` group-norm moments of its
wav2vec frontend, against the JAX package's, on the CPU; and the
``audio_features`` bypasses of the denoisers and the guide.

Weights go port -> state_dict -> ``train/convert.py`` -> JAX.  Bars: the
frontend and the built caches (features, lip vertices, both silences)
within 2e-5 of their largest magnitude; the cache geometry equal; a cached
crop against the live frontend on that exact crop at the JAX package's own
bar (``tests/test_feature_cache.py``: cosine > 0.99, median interior
relative error < 0.05; the group norm spans the cache's segment, not the
crop); the bypasses exact.  Segments are 64 tokens (not 2000) and lip
chunks 12 frames (not 120), so a 66-frame scene spans four segments, the
last one partial, and six chunks, the last one padded.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.data import dataset as j_dataset
from audio2photoreal_tpu.data import feature_cache as j_cache
from audio2photoreal_tpu.data.loader import SceneIndex as JSceneIndex
from audio2photoreal_tpu.models import audio_encoder as j_audio
from audio2photoreal_tpu.models.lip_regressor import LipRegressor as JLipRegressor
from audio2photoreal_tpu.train.convert import convert_lip_regressor, convert_wav2vec_extractor
from audio2photoreal_tpu_torch.core.config import DenoiserConfig, GuideConfig
from audio2photoreal_tpu_torch.data import dataset, feature_cache
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.data.loader import SceneIndex
from audio2photoreal_tpu_torch.data.stats import DataStats
from audio2photoreal_tpu_torch.models.audio_encoder import Wav2VecFeatureExtractor, feature_frames
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.models.guide import GuideTransformer
from audio2photoreal_tpu_torch.models.lip_regressor import LipRegressor
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

REL = 2e-5
SEG, LIP_CHUNK = 64, 12


def _perturbed(module, seed):
    """``module`` with nonzero biases and non-identity norms, in eval mode."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return module.eval()


def assert_scaled(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.fixture(scope="module")
def frontends():
    torch.manual_seed(0)
    fe = _perturbed(Wav2VecFeatureExtractor(), 1)
    lip = _perturbed(LipRegressor(), 2)
    fe_params = {"params": {"feature_extractor": convert_wav2vec_extractor(
        {k: v.numpy() for k, v in fe.state_dict().items()}, "feature_extractor")}}
    lip_params = convert_lip_regressor({k: v.numpy() for k, v in lip.state_dict().items()})
    return dict(fe=fe, lip=lip, jfe=j_audio.Wav2VecFeatureExtractor(), fe_params=fe_params,
                jlip=JLipRegressor(), lip_params=lip_params)


# ------------------------------------------------------ n_valid frontend -- #


@pytest.mark.parametrize("per_row", [True, False])
def test_n_valid_frontend_matches_jax(frontends, per_row):
    """Zero-padded inputs with masked moments: [B] counts or one count."""
    rng = np.random.RandomState(3)
    W = 24000
    n_valid = np.array([W, 15000]) if per_row else 17000
    audio = (rng.randn(2, W, 2) * 0.4).astype(np.float32)
    audio[np.broadcast_to(np.arange(W)[None] >= np.reshape(n_valid, (-1, 1)), (2, W))] = 0.0
    want = frontends["jfe"].apply(frontends["fe_params"], jnp.asarray(audio), jnp.asarray(n_valid))
    with torch.no_grad():
        got = frontends["fe"](torch.from_numpy(audio), torch.as_tensor(n_valid))
    assert_scaled(got, want)


def test_n_valid_frames_equal_the_unpadded_signal(frontends):
    """The first ``feature_frames(n_valid)`` frames equal the extractor's
    output on the signal without its zero padding; ``n_valid=None`` is the
    plain extractor."""
    rng = np.random.RandomState(4)
    audio = (rng.randn(1, 24000, 2) * 0.4).astype(np.float32)
    audio[:, 15000:] = 0.0
    fe = frontends["fe"]
    with torch.no_grad():
        padded = fe(torch.from_numpy(audio), 15000)
        alone = fe(torch.from_numpy(audio[:, :15000]))
        plain = fe(torch.from_numpy(audio))
    n = feature_frames(5000)
    assert alone.shape[1] == n
    assert_scaled(padded[:, :n], alone)
    assert_scaled(plain, frontends["jfe"].apply(frontends["fe_params"], jnp.asarray(audio)))


# ------------------------------------------------------------- geometry -- #


@pytest.mark.parametrize("n_frames", [3, 6, 9, 36, 66, 600, 1998])
def test_tokens_for_frames_matches_jax(n_frames):
    assert feature_cache.tokens_for_frames(n_frames) == j_cache.tokens_for_frames(n_frames)


def test_tokens_tile_the_stream():
    assert feature_cache.tokens_for_frames(600) == feature_frames(320000) == 1998
    for n in range(3, 120, 3):  # 3 frames more are 10 tokens more
        assert feature_cache.tokens_for_frames(n + 3) == feature_cache.tokens_for_frames(n) + 10


@pytest.mark.parametrize("start,length,frames,min_length", [
    (7, 50, 66, 12), (0, 66, 66, 12), (60, 66, 66, 12), (13, 9, 66, 4), (5, 700, 66, 400),
    (1, 1, 2, 1), (299, 401, 700, 400), (598, 600, 601, 400)])
def test_quantize_window_matches_jax(start, length, frames, min_length):
    got = feature_cache.quantize_window(start, length, frames, min_length)
    assert got == j_cache.quantize_window(start, length, frames, min_length)
    s, n = got
    q = feature_cache.FRAME_QUANTUM
    assert s % q == 0 and n % q == 0 and s >= 0 and n >= q
    if frames >= q:
        assert s + n <= frames


@pytest.mark.parametrize("n_samples,seg", [(66 * 1600, 64), (600 * 1600, 2000), (1234567, 2000), (4800, 64),
                                           (2000 * 160 * 3 + 2000, 2000)])
def test_segment_windows_match_jax(n_samples, seg):
    assert feature_cache._segment_windows_48k(n_samples, seg) == j_cache._segment_windows_48k(n_samples, seg)


# ------------------------------------------------------------- the cache -- #


@pytest.fixture(scope="module")
def person(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cache"))
    make_synthetic_person(root, "SYNTH01", num_scenes=4, frames_per_scene=66, seed=5)
    return root


@pytest.fixture(scope="module")
def caches(person, frontends):
    """The cache built by each package from the same weights and scenes.
    The JAX builder's lip branch reshapes both audio channels into 1600-sample
    frames, which raises for stereo scenes, so the JAX lip cache is built
    here from its ``make_lip_apply`` on channel 0, chunk by chunk as its
    builder chunks; the features come from its builder."""
    stats = DataStats.load(os.path.join(person, "SYNTH01", "data_stats.npz"))
    index = SceneIndex(person, "SYNTH01", "train", 1, 1)
    jindex = JSceneIndex(person, "SYNTH01", "train", 1, 1)
    assert index.entries == jindex.entries and len(index.entries) == 2
    audios = [dataset.read_wav(b + "_audio.wav")[: f * 1600] for b, f in index.entries]
    jaudios = [j_dataset.read_wav(b + "_audio.wav")[: f * 1600] for b, f in jindex.entries]
    got = feature_cache.build_audio_feature_cache(
        feature_cache.make_frontend_apply(frontends["fe"]), audios, stats.norm_audio,
        lip_apply=feature_cache.make_lip_apply(frontends["lip"]), seg_tokens=SEG, lip_chunk=LIP_CHUNK,
        verbose=False)
    want = j_cache.build_audio_feature_cache(
        j_cache.make_frontend_apply(frontends["jfe"], frontends["fe_params"]["params"]), jaudios,
        stats.norm_audio, seg_tokens=SEG, verbose=False)
    jlip = j_cache.make_lip_apply(frontends["jlip"], frontends["lip_params"]["params"])
    want.lip_silence = np.asarray(jlip(np.zeros((1, LIP_CHUNK, 1600), np.float32)))[0, LIP_CHUNK // 2]
    want.lip = []
    for raw in jaudios:
        frames = stats.norm_audio(raw)[:, 0].reshape(-1, 1600)
        n = -(-len(frames) // LIP_CHUNK) * LIP_CHUNK
        padded = np.pad(frames, ((0, n - len(frames)), (0, 0)))
        want.lip.append(np.concatenate([np.asarray(jlip(c[None]))[0] for c in
                                        padded.reshape(-1, LIP_CHUNK, 1600)])[: len(frames)])
    return dict(got=got, want=want, index=index, stats=stats)


def test_cache_matches_jax(caches):
    got, want = caches["got"], caches["want"]
    assert len(got.features) == len(want.features) == 2
    for i, (a, b) in enumerate(zip(got.features, want.features)):
        assert a.shape == b.shape == (feature_cache.tokens_for_frames(66), 1024), i
        assert_scaled(a, b, what=f"features {i}")
    for i, (a, b) in enumerate(zip(got.lip, want.lip)):
        assert a.shape == b.shape == (66, 1014), i
        assert_scaled(a, b, what=f"lip {i}")
    assert_scaled(got.silence, want.silence, what="silence")
    assert_scaled(got.lip_silence, want.lip_silence, what="lip silence")
    assert got.nbytes() == want.nbytes()


def test_cache_in_float16_matches_jax(caches, frontends):
    """``dtype=np.float16`` storage on both sides: the stored features are
    f16 and within 1e-3 of JAX's (relative to their scale), and of the f32
    cache's; the silence response stays f32 in both."""
    index, stats = caches["index"], caches["stats"]
    audios = [dataset.read_wav(b + "_audio.wav")[: f * 1600] for b, f in index.entries]
    got = feature_cache.build_audio_feature_cache(
        feature_cache.make_frontend_apply(frontends["fe"]), audios, stats.norm_audio, seg_tokens=SEG,
        dtype=np.float16, verbose=False)
    want = j_cache.build_audio_feature_cache(
        j_cache.make_frontend_apply(frontends["jfe"], frontends["fe_params"]["params"]), audios,
        stats.norm_audio, seg_tokens=SEG, dtype=np.float16, verbose=False)
    assert len(got.features) == len(want.features) == 2
    for i, (a, b, f32) in enumerate(zip(got.features, want.features, caches["got"].features)):
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape == f32.shape, i
        assert_scaled(a.astype(np.float32), b.astype(np.float32), 1e-3, f"f16 features {i}")
        assert_scaled(a.astype(np.float32), f32, 1e-3, f"f16 vs f32 features {i}")
    assert got.silence.dtype == want.silence.dtype == np.float32
    assert_scaled(got.silence, want.silence, what="silence")
    assert got.nbytes() == want.nbytes() < caches["got"].nbytes()


def test_cache_for_index_is_the_scene_build(caches, person, frontends):
    """``build_cache_for_index`` reads the index's scenes in order."""
    direct = feature_cache.build_cache_for_index(caches["index"], caches["stats"].norm_audio,
                                                 feature_cache.make_frontend_apply(frontends["fe"]),
                                                 seg_tokens=SEG, verbose=False)
    assert direct.lip is None
    for a, b in zip(direct.features, caches["got"].features):
        np.testing.assert_array_equal(a, b)


def test_cache_windows(caches):
    cache = caches["got"]
    n66 = feature_cache.tokens_for_frames(66)
    np.testing.assert_array_equal(cache.window(1, 0, 66, n66), cache.features[1])
    n12 = feature_cache.tokens_for_frames(12)
    w = cache.window(0, 6, 12, n66)  # mid-scene: tokens from 20 on, then silence
    np.testing.assert_array_equal(w[:n12], cache.features[0][20 : 20 + n12])
    np.testing.assert_array_equal(w[n12:], np.broadcast_to(cache.silence, (n66 - n12, 1024)))
    lw = cache.lip_window(0, 60, 12, 20)  # runs past the scene: 6 frames, then silence
    np.testing.assert_array_equal(lw[:6], cache.lip[0][60:])
    np.testing.assert_array_equal(lw[6:], np.broadcast_to(cache.lip_silence, (14, 1014)))


def test_cached_crop_matches_the_live_frontend(caches, frontends):
    """A crop that starts mid-scene, against the frontend run on that crop."""
    base, _ = caches["index"].entries[0]
    start, L = 6, 36
    audio = caches["stats"].norm_audio(
        dataset.read_wav(base + "_audio.wav")[start * 1600 : (start + L) * 1600]).astype(np.float32)
    with torch.no_grad():
        exact = frontends["fe"](torch.from_numpy(audio[None]))[0].numpy()
    cached = caches["got"].window(0, start, L, feature_cache.tokens_for_frames(L))
    assert cached.shape == exact.shape
    a, b = cached.ravel(), exact.ravel()
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    assert cos > 0.99, cos
    rel = np.abs(cached[5:-2] - exact[5:-2]) / (np.abs(exact[5:-2]) + 1e-2)
    assert float(np.median(rel)) < 0.05, float(np.median(rel))


# ------------------------------------------------------------ bypasses -- #


def _audio(B, T, seed):
    return torch.from_numpy((np.random.RandomState(seed).randn(B, T * 1600, 2) * 0.1).astype(np.float32))


def test_denoiser_feature_bypass_exact():
    """model(audio_features=encode_audio(audio)) equals model(audio)."""
    torch.manual_seed(0)
    model = FiLMDenoiser(DenoiserConfig(data_format="pose", nfeats=8, latent_dim=16, ff_size=32, num_layers=2,
                                        num_heads=2, max_seq_length=12, keyframe_step=6))
    model = _perturbed(model, 3)
    B, T = 2, 12
    x, audio = torch.randn(B, T, 8), _audio(B, T, 1)
    t, kf, kv = torch.tensor([3, 7]), torch.randn(B, 2, 104), torch.ones(B, 2)
    with torch.no_grad():
        feats = model.encode_audio(audio)
        y_raw = model(x, t, audio, kf, kv)
        y_feat = model(x, t, None, kf, kv, audio_features=feats)
    assert torch.equal(y_raw, y_feat)


def test_face_feature_bypass_exact():
    """Face: cached wav2vec features and per-frame lip vertices give the
    raw-audio forward exactly (T < 120: the lip model runs one chunk at its
    true length either way).  The frozen frontends stay in eval mode when
    the model trains."""
    torch.manual_seed(1)
    model = FiLMDenoiser(DenoiserConfig(data_format="face", nfeats=16, latent_dim=16, ff_size=32, num_layers=2,
                                        num_heads=2, max_seq_length=12, cond_encoder_layers=1))
    model = _perturbed(model, 4)
    B, T = 1, 12
    x, audio, t = torch.randn(B, T, 16), _audio(B, T, 2), torch.tensor([5])
    with torch.no_grad():
        feats = model.encode_audio(audio)
        lip = model.lip_vertices(audio)
        assert lip.shape == (B, T, 1014)
        y_raw = model(x, t, audio)
        y_feat = model(x, t, None, audio_features=feats, lip_verts=lip)
    assert torch.equal(y_raw, y_feat)
    model.train()
    assert model.training and not model.lip_model.training and not model.audio_model.training
    assert model.cond_encoder[0].training


def test_guide_feature_bypass_exact():
    torch.manual_seed(2)
    model = _perturbed(GuideTransformer(GuideConfig(tokens=16, vq_depth=2, latent_dim=16, num_layers=2,
                                                    num_heads=2, ff_size=32)), 5)
    B, T = 2, 30
    audio = _audio(B, T, 3)
    tokens = torch.zeros((B, 4), dtype=torch.long)
    with torch.no_grad():
        feats = model.audio_model(audio)
        y_raw = model(tokens, audio)
        y_feat = model(tokens, None, audio_features=feats)
        cond_raw = model.encode_conditioning(audio, torch.tensor([True, False]))
        cond_feat = model.encode_conditioning(None, torch.tensor([True, False]), audio_features=feats)
    assert torch.equal(y_raw, y_feat)
    assert all(torch.equal(a, b) for a, b in zip(cond_raw, cond_feat))
