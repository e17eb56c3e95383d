"""The AudioTcn family, port vs JAX package, on the CPU: ``causal_conv1d``,
the mel spectrogram, ``Wav2VecDownsampler`` and ``AudioTcn``.

Inputs are made with numpy from a seed; JAX parameters come from
``jax.eval_shape`` of the module's init filled with numpy draws and reach
the port through ``convert``.  Bars: 2e-5 of the output's largest
magnitude for the modules, 1e-5 of its largest value for the mel
spectrogram (torch's STFT against JAX's framed rfft), the filterbank
exactly, and each parameter gradient of a scalar loss within 1e-4 of that
tensor's largest element.  Dropout takes JAX's keep masks
(``audio_encoder.draw_keep`` answered from ``jax.random.bernoulli``'s).

``Wav2VecDownsampler`` resizes with ``F.interpolate``; the JAX
``interp_to`` extrapolates the first rows when it grows the sequence
(ROADMAP, faults in the JAX package), so there the port is held to a numpy
model of the module with ``F.interpolate``'s clamped source positions, the
same model that reproduces JAX with the clamp off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.models import audio_encoder as j_audio
from audio2photoreal_tpu.ops import convs as j_convs
from audio2photoreal_tpu.ops import melspec as j_melspec
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.models import audio_encoder
from audio2photoreal_tpu_torch.ops import convs, melspec
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

TOL = 2e-5
GRAD_TOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _fill(shapes, seed):
    """numpy draws for a JAX param tree: kernels N(0, 1/fan_in), vectors
    (biases, norm scales) 0.1-scale noise around 0 or 1."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        name = path[-1].key
        if len(s.shape) >= 2:
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _frames(B, T, seed):
    return (np.random.RandomState(seed).randn(B, T, 1600) * 0.1).astype(np.float32)


# ----------------------------------------------------------------- ops ---- #


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_causal_conv1d_matches_jax(dilation):
    rng = np.random.RandomState(dilation)
    x = rng.randn(2, 17, 5).astype(np.float32)
    k = rng.randn(3, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    want = j_convs.causal_conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), dilation=dilation)
    got = convs.causal_conv1d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), dilation=dilation)
    assert got.shape == (2, 17, 7)
    _close(got, want)
    # output t sees inputs <= t only
    x2 = x.copy()
    x2[:, 9:] += 1.0
    got2 = convs.causal_conv1d(torch.from_numpy(x2), torch.from_numpy(k), torch.from_numpy(b), dilation=dilation)
    np.testing.assert_array_equal(got2[:, :9].numpy(), got[:, :9].numpy())
    assert not np.allclose(got2[:, 9].numpy(), got[:, 9].numpy())


def test_mel_filterbank_is_jax_s():
    for args in ((24_000, 1024, 80), (16_000, 512, 40), (24_000, 1024, 80, 50.0, 8000.0)):
        want = j_melspec.mel_filterbank(*args)
        got = melspec.mel_filterbank(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(melspec.hz_to_mel([0.0, 700.0, 8000.0]), j_melspec.hz_to_mel([0.0, 700.0, 8000.0]))
    np.testing.assert_array_equal(melspec.mel_to_hz([0.0, 1000.0]), j_melspec.mel_to_hz([0.0, 1000.0]))


@pytest.mark.parametrize("n", [24_000, 8_000 + 123])
def test_melspectrogram_matches_jax(n):
    """1 s of noise at 24 kHz, and a length that is no multiple of the hop:
    power mel [B, 80, 1 + n // 400] within 1e-5 of its largest value; the
    log mel the AudioTcn takes within 1e-5 of its scale."""
    wav = (np.random.RandomState(n).randn(2, n) * 0.3).astype(np.float32)
    want = np.asarray(j_melspec.melspectrogram(jnp.asarray(wav)))
    got = melspec.melspectrogram(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 80, 1 + n // 400)
    _close(got, want, 1e-5, "mel")
    log = lambda m: np.log(np.clip(np.asarray(m), 1e-10, None))  # noqa: E731
    _close(log(got.numpy()), log(want), 1e-5, "log mel")


# ---------------------------------------------------- Wav2VecDownsampler -- #


def _downsampler(dim, cin, T, seed):
    jm = j_audio.Wav2VecDownsampler(dim=dim)
    x = jnp.zeros((2, T, cin))
    params = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, 5)), seed)
    pm = audio_encoder.Wav2VecDownsampler(dim, cin)
    pm.load_state_dict(convert.wav2vec_downsampler_state_dict_from_jax(params), strict=True)
    return jm, params, pm


def _np_downsampler(params, x, target, clamp):
    """The module in numpy: ``clamp`` takes F.interpolate's source position
    max(pos, 0), without it JAX's ``interp_to``."""
    p = params["params"]

    def conv(x, k, b):  # causal conv, [B, T, C] x [K, Cin, Cout]
        K = k.shape[0]
        xp = np.pad(x, ((0, 0), (K - 1, 0), (0, 0)))
        return sum(xp[:, i:i + x.shape[1]] @ k[i] for i in range(K)) + b

    def interp(x, n):
        T = x.shape[1]
        pos = (np.arange(n) + 0.5) * T / n - 0.5
        if clamp:
            pos = np.maximum(pos, 0.0)
        i0 = np.clip(np.floor(pos).astype(int), 0, T - 1)
        i1 = np.clip(i0 + 1, 0, T - 1)
        w = (pos - i0)[None, :, None]
        return x[:, i0] * (1 - w) + x[:, i1] * w

    x = np.maximum(conv(x, p["conv1_kernel"], p["conv1_bias"]), 0.0)
    x = interp(x, (x.shape[1] + target) // 2)
    x = interp(conv(x, p["conv2_kernel"], p["conv2_bias"]), target)
    mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + 1e-5) * p["norm"]["scale"] + p["norm"]["bias"]


@pytest.mark.parametrize("T,target", [(100, 30), (64, 31), (12, 11)])
def test_wav2vec_downsampler_matches_jax_when_it_shrinks(T, target):
    jm, params, pm = _downsampler(24, 20, T, 1)
    x = np.random.RandomState(T).randn(2, T, 20).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), target)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), target)
    assert got.shape == (2, target, 24)
    _close(got, want)
    x64 = x.astype(np.float64)
    _close(_np_downsampler(params, x64, target, clamp=True), want, 1e-5, "numpy model")


@pytest.mark.parametrize("T,target", [(8, 20), (30, 100)])
def test_wav2vec_downsampler_follows_interpolate_when_it_grows(T, target):
    """Growing, the port is F.interpolate's (the numpy model with the clamp),
    JAX is the model without it, and the two differ in the first rows."""
    jm, params, pm = _downsampler(24, 20, T, 2)
    x = np.random.RandomState(T).randn(2, T, 20).astype(np.float32)
    want_jax = np.asarray(jm.apply(params, jnp.asarray(x), target))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), target)
    x64 = x.astype(np.float64)
    _close(got, _np_downsampler(params, x64, target, clamp=True), TOL, "port vs F.interpolate model")
    _close(_np_downsampler(params, x64, target, clamp=False), want_jax, 1e-5, "JAX vs its model")
    first = np.abs(got.numpy()[:, 0] - want_jax[:, 0]).max()
    assert first > 1e-2 * np.abs(want_jax).max(), first


def test_interpolate_growth_divergence_in_numbers():
    """4 -> 8 rows of [1, 2, 3, 4]: F.interpolate starts at 1.0, the JAX
    formula at 0.75."""
    x = torch.arange(1.0, 5.0)[None, None]
    got = torch.nn.functional.interpolate(x, size=8, mode="linear", align_corners=False)[0, 0]
    pos = (np.arange(8) + 0.5) * 4 / 8 - 0.5
    i0 = np.clip(np.floor(pos).astype(int), 0, 3)
    jax_rows = np.arange(1.0, 5.0)[i0] * (1 - (pos - i0)) + np.arange(1.0, 5.0)[np.clip(i0 + 1, 0, 3)] * (pos - i0)
    assert got[0].item() == 1.0 and jax_rows[0] == 0.75
    np.testing.assert_allclose(got[1:].numpy(), jax_rows[1:], rtol=1e-6)


# -------------------------------------------------------------- AudioTcn -- #

BRANCHES = {"melspec": (True, False), "wav2vec": (False, True), "both": (True, True)}
E, T_FRAMES = 16, 8


def _tcn(branch, seed=3):
    mel, w2v = BRANCHES[branch]
    jm = j_audio.AudioTcn(encoding_dim=E, use_melspec=mel, use_wav2vec=w2v)
    frames = jnp.zeros((2, T_FRAMES, 1600))
    params = _fill(jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, frames)), seed)
    pm = audio_encoder.AudioTcn(E, use_melspec=mel, use_wav2vec=w2v)
    pm.load_state_dict(convert.audio_tcn_state_dict_from_jax(params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_audio_tcn_matches_jax(branch):
    jm, params, pm = _tcn(branch)
    frames = _frames(2, T_FRAMES, 5)
    want = jm.apply(params, jnp.asarray(frames))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(frames))
    assert got.shape == (2, T_FRAMES, E)
    _close(got, want, what=branch)


@pytest.fixture(scope="module")
def tcn_train():
    """One training forward and the gradients of sum(out * R) on both sides,
    both branches on, JAX's keep masks recorded and replayed."""
    jm, params, pm = _tcn("both", seed=4)
    frames = _frames(2, T_FRAMES, 6)
    R = np.random.RandomState(7).randn(2, T_FRAMES, E).astype(np.float32)
    masks, real = [], jax.random.bernoulli

    def record(key, p, shape):
        masks.append(np.array(real(key, p, shape)))
        return jnp.asarray(masks[-1])

    rngs = {"dropout": jax.random.PRNGKey(9)}
    jax.random.bernoulli = record
    try:
        want = np.asarray(jm.apply(params, jnp.asarray(frames), deterministic=False, rngs=rngs))
        replay = iter(list(masks))
        jax.random.bernoulli = lambda key, p, shape: jnp.asarray(next(replay))
        loss = lambda p: jnp.sum(jm.apply(p, jnp.asarray(frames), deterministic=False, rngs=rngs) * R)  # noqa: E731
        jgrads = jax.grad(loss)(params)
    finally:
        jax.random.bernoulli = real
    assert len(masks) == 6 and 0.7 < np.mean([m.mean() for m in masks]) < 0.9
    port_masks = iter([torch.from_numpy(m.transpose(0, 2, 1)) for m in masks])
    orig = audio_encoder.draw_keep
    audio_encoder.draw_keep = lambda shape, g, device: next(port_masks)
    try:
        got = pm.train()(torch.from_numpy(frames))
        (got * torch.from_numpy(R)).sum().backward()
    finally:
        audio_encoder.draw_keep = orig
    return dict(want=want, got=got, jgrads=jgrads, pm=pm)


def test_audio_tcn_training_forward_matches_jax(tcn_train):
    _close(tcn_train["got"], tcn_train["want"], what="train forward")


def test_audio_tcn_gradients_match_jax(tcn_train):
    pm = tcn_train["pm"]
    want = convert.audio_tcn_state_dict_from_jax(tcn_train["jgrads"])
    trained = [n for n in want if not n.startswith("wav2vec_")]
    assert len(trained) == 2 * (6 + 1 + 1)
    for name, p in pm.named_parameters():
        if name.startswith("wav2vec_"):  # the frozen branch: JAX's stop_gradient
            assert p.grad is None, name
            assert not np.any(want[name].numpy()), name
        else:
            _close(p.grad, want[name], GRAD_TOL, name)


def test_audio_tcn_draws_from_the_generator():
    _, _, pm = _tcn("melspec")
    frames = torch.from_numpy(_frames(1, T_FRAMES, 8))
    pm.train()
    a = pm(frames, torch.Generator().manual_seed(1))
    b = pm(frames, torch.Generator().manual_seed(1))
    c = pm(frames, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    with torch.no_grad():
        d = pm.eval()(frames)
    assert not torch.allclose(a, d)


def test_audio_tcn_is_causal_up_to_its_mel_lookahead():
    """The TCN sees frames <= t, and the mel frames of visual frame t reach
    half a frame into frame t + 1 (the STFT's centred 800-sample window), so
    a change to the audio from frame t + 2 on leaves outputs <= t as they
    were, and a change from frame t + 1 on reaches output t."""
    _, _, pm = _tcn("melspec")
    frames = _frames(2, T_FRAMES, 10)
    t = 3
    with torch.no_grad():
        base = pm.eval()(torch.from_numpy(frames))
        later = frames.copy()
        later[:, t + 2:] = _frames(2, T_FRAMES - t - 2, 11)
        moved = pm(torch.from_numpy(later))
        sooner = frames.copy()
        sooner[:, t + 1:] = _frames(2, T_FRAMES - t - 1, 12)
        reached = pm(torch.from_numpy(sooner))
    np.testing.assert_allclose(moved[:, :t + 1].numpy(), base[:, :t + 1].numpy(), rtol=0, atol=1e-6)
    assert not np.allclose(moved[:, t + 2:].numpy(), base[:, t + 2:].numpy())
    assert not np.allclose(reached[:, t].numpy(), base[:, t].numpy())


def test_reset_parameters_draws_lecun_normal():
    pm = audio_encoder.AudioTcn(E, use_melspec=True, use_wav2vec=False)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    w = pm.tcn[0].weight
    assert abs(float(w.detach().std()) * np.sqrt(w[0].numel()) - 1.0) < 0.05
    assert not pm.tcn[0].bias.any()
    ds = audio_encoder.Wav2VecDownsampler(32, 16)
    ds.reset_parameters(torch.Generator().manual_seed(0))
    assert not ds.conv1.bias.any() and bool((ds.norm.weight == 1).all())
