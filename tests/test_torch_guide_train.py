"""The guide trainer of the port (train/loops.py:guide_loss and
guide_train_step, apps/train_guide.py) against the JAX package's, on the CPU.

A tiny guide (latent 64, 2 layers, 2 heads, its pre-net 1024 wide, the
width of the wav2vec features it reads) over a tiny VQ (width 8, 16 codes,
depth 2); 2 s of audio (150 cond tokens), 3 keyframes x depth 2 = 6 tokens
a clip.  Port weights go to JAX through ``train/convert.py:convert_guide`` /
``convert_vqvae``; JAX gradients come back through
``convert.guide_state_dict_from_jax``.

The step is held to JAX's on cached features, with dropout out of the way
and the conditioning dropout injected: the port in eval mode with
``keep_mask``; JAX's ``make_guide_train_step`` with flax's ``Dropout`` made
the identity (its pre-net drops at a fixed 0.2) and ``jax.random.bernoulli``
answering the cond-drop draw with the same mask.  Bars: loss and grad norm
within 1e-5 relative, accuracy equal, the tokens of the frozen codec equal,
every gradient within 1e-4 of its largest element, parameters after AdamW
(grad clip 1.0, as the JAX CLI trains) within 2 lr and 99.9% within 1e-6.
On raw audio the step equals the cached step on the frontend's features,
bit for bit; the pre-net's backward on those features is held to float64.
"""

import copy
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.models import guide as j_guide
from audio2photoreal_tpu.models import vqvae as j_vqvae
from audio2photoreal_tpu.train import loops as j_loops
from audio2photoreal_tpu.train import state as j_state
from audio2photoreal_tpu.train.convert import convert_guide, convert_vqvae
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import generate, train_guide, train_vq
from audio2photoreal_tpu_torch.core.config import (DataConfig, DenoiserConfig, DiffusionConfig, GuideConfig,
                                                   TrainConfig, VQConfig, load_config, save_config)
from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.models.guide import GuideTransformer
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
from audio2photoreal_tpu_torch.train import loops
from audio2photoreal_tpu_torch.train.state import TrainState, trainable_parameters
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

GUIDE = dict(tokens=16, latent_dim=64, ff_size=96, num_layers=2, num_heads=2, vq_depth=2, dropout=0.0)
VQ = dict(nfeats=104, emb_width=8, code_dim=16, depth=2, kmeans_init=False)
B, FRAMES = 2, 60
KEEP = np.array([True, False])  # the second clip's conditioning dropped
LR = 2e-4  # the JAX guide CLI's


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


class _Grab:
    """A stand-in train state: the JAX step hands it the gradients."""

    def __init__(self, params):
        self.params, self.step = params, 0

    def apply_gradients(self, grads):
        return grads


def _models(seed=0):
    codec = TemporalVertexCodec(VQConfig(**VQ))
    codec.reset_parameters(torch.Generator().manual_seed(seed))
    guide = GuideTransformer(GuideConfig(**GUIDE))
    guide.reset_parameters(torch.Generator().manual_seed(seed + 1))
    rng = np.random.RandomState(seed + 2)
    with torch.no_grad():  # nonzero biases and non-identity norms: every parameter counts
        for p in guide.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return codec.eval(), guide.eval()


def _batch(cached, seed=3):
    rng = np.random.RandomState(seed)
    b = {"keyframes": rng.randn(B, 3, 104).astype(np.float32),
         "keyframe_valid": np.array([[1, 1, 1], [1, 1, 0]], np.float32)}
    if cached:
        b["audio_features"] = rng.rand(B, tokens_for_frames(FRAMES), 1024).astype(np.float32)
    else:
        b["audio"] = (rng.randn(B, FRAMES * 1600, 2) * 0.5).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def jax_step():
    """JAX's guide step (dropout off, the keep mask injected) on cached
    features: batch -> (gradients, metrics, params after AdamW); JAX's
    tokens."""
    codec, guide = _models()
    vparams, vq = convert_vqvae({k: v.numpy().copy() for k, v in codec.state_dict().items()}, VQ["depth"])
    vq = j_vqvae.VQState(**{k: jnp.asarray(v) for k, v in vq.items()})
    params = convert_guide({k: v.numpy().copy() for k, v in guide.state_dict().items()}, GUIDE["num_layers"])
    jcodec = j_vqvae.TemporalVertexCodec(j_config.VQConfig(**VQ))
    jm = j_guide.GuideTransformer(j_config.GuideConfig(**GUIDE))

    def tokenize(kf):
        return jcodec.apply(vparams, kf, vq, method=j_vqvae.TemporalVertexCodec.encode)

    step = j_loops.make_guide_train_step(jm, tokenize, VQ["depth"], cond_drop_prob=0.2)
    jitted = jax.jit(lambda p, batch: step(_Grab(p), batch, jax.random.PRNGKey(5)))

    def run(batch):
        mp = pytest.MonkeyPatch()
        try:  # the pre-net's dropout off, the cond-drop draw answered by the mask
            mp.setattr(nn.Dropout, "__call__", lambda self, inputs, deterministic=None, rng=None: inputs)
            mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(~KEEP))
            jgrads, jmetrics = jitted(params, {k: jnp.asarray(v) for k, v in batch.items()})
        finally:
            mp.undo()
        jafter = j_state.create_train_state(params, j_config.TrainConfig(lr=LR, grad_clip=1.0)).apply_gradients(
            jgrads).params
        return jgrads, {k: float(v) for k, v in jmetrics.items()}, jafter

    return dict(run=run, tokenize=tokenize)


def _port_step(model, codec, batch):
    state = TrainState(model, TrainConfig(lr=LR, grad_clip=1.0))
    return loops.guide_train_step(state, codec, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                                  keep_mask=torch.from_numpy(KEEP))


@pytest.fixture(scope="module")
def guide_step(jax_step):
    """The port's step and JAX's on the same cached features."""
    codec, guide = _models()
    b = _batch(cached=True)
    out = dict(guide=guide, metrics=_port_step(guide, codec, b))
    with torch.no_grad():
        out["tokens"] = _np(codec.encode(torch.from_numpy(b["keyframes"])))
    out["jtokens"] = np.asarray(jax_step["tokenize"](jnp.asarray(b["keyframes"])))
    out["jgrads"], out["jmetrics"], out["jafter"] = jax_step["run"](b)
    return out


def test_guide_step_loss_acc_and_tokens_match_jax(guide_step):
    s = guide_step
    np.testing.assert_array_equal(s["tokens"], s["jtokens"])
    np.testing.assert_allclose(s["metrics"]["loss"], s["jmetrics"]["loss"], rtol=1e-5)
    assert s["metrics"]["acc"] == s["jmetrics"]["acc"]
    np.testing.assert_allclose(s["metrics"]["grad_norm"], s["jmetrics"]["grad_norm"], rtol=1e-5)


def test_guide_step_gradients_and_params_match_jax(guide_step):
    s = guide_step
    want = convert.guide_state_dict_from_jax(s["jgrads"])
    after = convert.guide_state_dict_from_jax(s["jafter"])
    trainable = {id(p) for p in trainable_parameters(s["guide"])}
    unclip = max(s["metrics"]["grad_norm"], 1.0)  # the step clipped the gradients in place to norm 1
    diffs = []
    for name, p in s["guide"].named_parameters():
        if id(p) not in trainable:  # the frozen frontend
            assert p.grad is None, name
            continue
        g, w = _np(p.grad) * unclip, _np(want[name])
        if name == "null_cond_embed":  # only the cond length's rows are read
            assert not g[:, 150:].any() and not w[:, 150:].any()
        np.testing.assert_allclose(g, w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=0, err_msg=name)
        d = np.abs(_np(p) - _np(after[name])).ravel()
        assert d.max() <= 2 * LR, name
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).sum()


def test_raw_step_equals_the_step_on_its_frontends_features():
    """On raw audio the step is the cached step on the frozen frontend's
    features, bit for bit (loss, metrics, gradients, parameters after the
    update); the frontend is held to JAX's by tests/test_torch_guide.py."""
    codec, raw = _models()
    twin = _models()[1]
    b = _batch(cached=False)
    with torch.no_grad():
        feats = _np(twin.audio_model(torch.from_numpy(b["audio"])))
    assert _port_step(raw, codec, b) == _port_step(twin, codec, {**{k: v for k, v in b.items() if k != "audio"},
                                                                  "audio_features": feats})
    twin = dict(twin.named_parameters())
    for name, p in raw.named_parameters():
        assert (p.grad is None) == (twin[name].grad is None), name
        assert p.grad is None or torch.equal(p.grad, twin[name].grad), name
        assert torch.equal(p, twin[name]), name


def test_prenet_gradient_on_wav2vec_features():
    """The pre-net's backward on the frontend's features of 2 s of audio,
    against the same pre-net in float64, within 1e-5 (relative L2) on every
    conv.  Its 12 leaky ReLUs make the gradient jump where a pre-activation
    crosses 0, so a forward whose rounding moves one across takes the other
    slope there: JAX's f32 pre-net on the CPU read 1.4e-3 from float64 on
    these inputs, and at batch 32 x 798 frames the port's f32 reads 1.3e-3
    on the CPU and 3.7e-3 on the card (PERF.md, PR 11); here no
    pre-activation of the port's lies that close to 0."""
    _, guide = _models()
    b = _batch(cached=False)
    with torch.no_grad():
        feats = guide.audio_model(torch.from_numpy(b["audio"]))
    ct = torch.from_numpy(np.random.RandomState(2).randn(B, feats.shape[1] - 48, 1024).astype(np.float32))
    pre64 = copy.deepcopy(guide.pre_audio).double().eval()
    pre = guide.pre_audio.eval()
    (pre(feats) * ct).sum().backward()
    (pre64(feats.double()) * ct.double()).sum().backward()
    for i in range(0, len(pre), 3):
        g, r = pre[i].weight.grad.double(), pre64[i].weight.grad
        assert ((g - r).norm() / r.norm()).item() <= 1e-5, i


def test_guide_loss_label_smoothing_and_validity():
    """The smoothed CE and the accuracy over valid tokens only, against
    their formulas in float64."""
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 5, 7).astype(np.float32)
    targets = rng.randint(0, 7, (2, 5))
    valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    loss, acc = loops.guide_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(valid))
    x = logits.astype(np.float64)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp, targets[..., None], -1)[..., 0]
    ce = 0.9 * nll - 0.1 * logp.mean(-1)
    assert abs(loss.item() - (ce * valid).sum() / valid.sum()) < 1e-6
    assert acc.item() == pytest.approx(((x.argmax(-1) == targets) * valid).sum() / valid.sum())
    zero, _ = loops.guide_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.zeros(2, 5))
    assert zero.item() == 0.0  # no valid token: 0 over max(0, 1)


# ------------------------------------------------------------ the app -- #

DATA = dict(person="SYNTH01", data_format="pose", max_seq_length=60, min_seq_length=60, batch_size=2)


@pytest.fixture(scope="module")
def vq_dir(tmp_path_factory):
    """A synthetic person (val and test chunks of 60 frames) and a VQ
    trained on it for 2 steps."""
    root = str(tmp_path_factory.mktemp("guide_person"))
    make_synthetic_person(root, "SYNTH01", num_scenes=8, frames_per_scene=96, seed=5)
    d = os.path.join(root, "vq")
    train_vq.train(root, d, VQConfig(nfeats=104, emb_width=8, code_dim=16, depth=2, kmeans_iters=2),
                   DataConfig(**DATA), TrainConfig(lr=1e-3, num_steps=2, save_interval=2, log_interval=1),
                   device="cpu")
    return root, d


def _gcfg():
    return GuideConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=2)


def _tcfg(steps):
    return TrainConfig(lr=LR, num_steps=steps, save_interval=steps, log_interval=1, grad_clip=1.0)


def test_train_guide_resumes_and_generate_samples_its_keyframes(vq_dir, tmp_path):
    """The vocabulary comes from the VQ; 1 step, resumed to 2; ``generate``
    samples keyframes from the save dir and the VQ dir.  Then 1 step on the
    feature cache."""
    root, vq = vq_dir
    d = str(tmp_path / "guide")
    timings = {}
    train_guide.train(root, d, vq, _gcfg(), DataConfig(**DATA), _tcfg(1), device="cpu", timings=timings)
    assert len(timings["step_s"]) == 1 and "cache_s" not in timings
    state = train_guide.train(root, d, vq, _gcfg(), DataConfig(**DATA), _tcfg(2), device="cpu")
    assert state.step == 2
    logged = [json.loads(l) for l in open(os.path.join(d, "log.jsonl"))]
    assert [r["step"] for r in logged] == [0, 1] and all(np.isfinite(r["loss"]) for r in logged)
    gcfg = load_config(d)["guide"]
    assert (gcfg.tokens, gcfg.vq_depth) == (16, 2)
    T = 60
    mcfg = DenoiserConfig(data_format="pose", latent_dim=16, ff_size=32, num_layers=1, num_heads=2,
                          max_seq_length=T, dropout=0.0)
    model = FiLMDenoiser(mcfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model_dir = str(tmp_path / "pose")
    save_config(model_dir, denoiser=mcfg, diffusion=DiffusionConfig(), data=DataConfig(**DATA))
    torch.save(model.state_dict(), os.path.join(model_dir, generate.MODEL_FILE))
    res = np.load(generate.generate(model_dir, root, num_samples=2, timestep_respacing="ddim2", guide_path=d,
                                    vq_path=vq, device="cpu"), allow_pickle=True).item()
    assert res["keyframes"].shape == (2, 2, 104) and np.isfinite(res["motions"]).all()

    cached = str(tmp_path / "cached")
    timings = {}
    train_guide.train(root, cached, vq, _gcfg(), DataConfig(**DATA), _tcfg(1), cache_audio_features=True,
                      device="cpu", timings=timings)
    assert timings["cache_s"] > 0 and os.path.exists(os.path.join(cached, "model.pt"))
