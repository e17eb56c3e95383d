"""The pose diffusion trainer of the port (audio2photoreal_tpu_torch/train,
apps/train_diffusion.py) against the JAX package's, on the CPU.

Weights go port -> state_dict -> ``train/convert.py:convert_film_denoiser``
-> JAX; JAX gradients come back through ``convert.film_denoiser_state_dict_
from_jax`` (a gradient pytree has the parameters' tree), so the tests compare
them name by name.  Inputs, t and noise are made with numpy and fed to both.

The step parity runs with dropout off (``deterministic=True`` on the JAX
side, eval mode here): the JAX model's attention uses the TPU "prng" mask,
and its post-net drops at a fixed 0.2 under a path-folded key, neither of
which a port can replay.  ``flash_attention=True`` at T 128 opens the flash
gate on both sides, so the JAX gradient goes through ``_flash_bwd`` in
interpret mode and the port's through ``FlashAttention``'s plain backward.
Tolerances: loss 1e-5 relative; each gradient 1e-4 of its largest element
(f32 sums in another order through the 8 projections, the wav2vec-fed cross
attention and the post-net); params after one AdamW step within 2 lr (the
first step moves a parameter by about lr times the sign of its gradient, and
a near-zero gradient's sign can differ) and 99.9% of them within 1e-6.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.diffusion import gaussian as j_gaussian
from audio2photoreal_tpu.diffusion import losses as j_losses
from audio2photoreal_tpu.diffusion import tsample as j_tsample
from audio2photoreal_tpu.diffusion.schedules import make_schedule as j_make_schedule
from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.train import state as j_state
from audio2photoreal_tpu.train.convert import convert_film_denoiser
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import train_diffusion
from audio2photoreal_tpu_torch.apps.generate import generate
from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, TrainConfig
from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.diffusion import gaussian, losses, tsample
from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention_reference
from audio2photoreal_tpu_torch.models import blocks
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.train import checkpoints, logging
from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
from audio2photoreal_tpu_torch.train.state import TrainState, trainable_parameters
from audio2photoreal_tpu_torch.utils.profiling import Timer, profile_trace
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

T = 128
MODEL = dict(data_format="pose", latent_dim=64, ff_size=128, num_layers=2, num_heads=2, max_seq_length=T,
             flash_attention=True, dropout=0.1, hash_dropout=True)
LR = 1e-4


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _port_model(seed=0, **overrides):
    m = FiLMDenoiser(DenoiserConfig(**{**MODEL, **overrides}))
    m.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():  # nonzero biases and non-identity norms: every parameter is exercised
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return m


def _batch(B=2, seed=3):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, 100:] = 0.0
    kv = np.ones((B, 5), np.float32)
    kv[1, 4] = 0.0
    return {
        "motion": rng.randn(B, T, 104).astype(np.float32) * mask[..., None],
        "mask": mask,
        "audio": (rng.randn(B, T * 1600, 2) * 0.3).astype(np.float32),
        "keyframes": rng.randn(B, 5, 104).astype(np.float32),
        "keyframe_valid": kv,
    }


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def step_parity():
    """One deterministic step on both sides from the same weights, batch, t
    and noise."""
    pm = _port_model()
    # {"params": ...}; cloned, since the converter's arrays would share the port's memory
    jparams = convert_film_denoiser({k: v.clone() for k, v in pm.state_dict().items()}, "pose", MODEL["num_layers"])
    b = _batch()
    rng = np.random.RandomState(4)
    t = np.array([37, 912])
    noise = rng.randn(2, T, 104).astype(np.float32)

    jm = JDenoiser(j_config.DenoiserConfig(**MODEL))
    jsched = j_make_schedule("cosine", 1000)

    def loss_fn(params):
        x0, tt = jnp.asarray(b["motion"]), jnp.asarray(t, jnp.int32)
        xt = j_gaussian.q_sample(jsched, x0, tt, jnp.asarray(noise))
        out = jm.apply(params, xt, tt, jnp.asarray(b["audio"]), jnp.asarray(b["keyframes"]),
                       jnp.asarray(b["keyframe_valid"]), cond_drop_prob=0.0, deterministic=True)
        terms = j_losses.training_losses(jsched, "xstart", out, x0, xt, tt, jnp.asarray(b["mask"])[..., None])
        return terms["loss"].mean(), terms

    j_flash.reset_trace_flops()
    (jloss, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    assert j_flash.trace_flops() > 0  # the JAX side went through the Pallas kernels, forward and backward
    jstate = j_state.create_train_state(jparams, j_config.TrainConfig(lr=LR)).apply_gradients(jgrads)

    state = TrainState(pm.eval(), TrainConfig(lr=LR))
    metrics, _ = diffusion_train_step(state, make_schedule().to_device("cpu"), DiffusionConfig(cond_drop_prob=0.0),
                                      _torch_batch(b), t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    return dict(pm=pm, metrics=metrics, jloss=float(jloss), jterms=jterms, jgrads=jgrads,
                jparams_after=jstate.params, b=b)


def test_step_loss_matches_jax(step_parity):
    s = step_parity
    assert s["metrics"]["skipped_nonfinite"] == 0.0
    np.testing.assert_allclose(s["metrics"]["loss"], s["jloss"], rtol=1e-5)
    np.testing.assert_allclose(s["metrics"]["mse"], float(s["jterms"]["mse"].mean()), rtol=1e-5)
    np.testing.assert_allclose(s["metrics"]["vb"], float(s["jterms"]["vb"].mean()), rtol=1e-4)


def test_step_gradients_match_jax(step_parity):
    s = step_parity
    want = convert.film_denoiser_state_dict_from_jax(s["jgrads"], "pose", MODEL["num_layers"])
    pm = s["pm"]
    trainable = {id(p) for p in trainable_parameters(pm)}
    for name, p in pm.named_parameters():
        if id(p) not in trainable:  # the frozen frontend: no gradient on either side
            assert p.grad is None and not want[name].abs().max() > 0, name
            continue
        got, w = _np(p.grad), _np(want[name])
        np.testing.assert_allclose(got, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


def test_params_after_one_adamw_step_match_jax(step_parity):
    s = step_parity
    want = convert.film_denoiser_state_dict_from_jax(s["jparams_after"], "pose", MODEL["num_layers"])
    diffs = []
    for name, p in s["pm"].named_parameters():
        d = np.abs(_np(p) - _np(want[name])).ravel()
        assert d.max() <= 2 * LR, name
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).sum()


# ------------------------------------------------- the face step vs JAX -- #

TF = 129  # a multiple of 3 (the cache's grid) above the 128 gate: 428 cond tokens
FACE = dict(data_format="face", nfeats=256, latent_dim=64, ff_size=128, num_layers=2, num_heads=2,
            max_seq_length=TF, flash_attention=True, dropout=0.1, hash_dropout=True)


def _face_batch(cached, B=2, seed=8):
    """A face batch: frames 40-49 of sample 0 missing (``mask`` 0), sample 1
    100 frames long; raw audio, or features and per-frame lip vertices."""
    rng = np.random.RandomState(seed)
    lengths = np.array([TF, 100], np.int32)
    mask = (np.arange(TF)[None] < lengths[:, None]).astype(np.float32)
    mask[0, 40:50] = 0.0
    b = {"motion": rng.randn(B, TF, 256).astype(np.float32) * mask[..., None], "mask": mask, "lengths": lengths}
    if cached:
        b["audio_features"] = rng.rand(B, tokens_for_frames(TF), 1024).astype(np.float32)
        b["lip_verts"] = rng.randn(B, TF, 1014).astype(np.float32)
    else:
        b["audio"] = (rng.randn(B, TF * 1600, 2) * 0.3).astype(np.float32)
    return b


@pytest.fixture(scope="module", params=[False, True], ids=["raw", "cached"])
def face_step_parity(request):
    """One deterministic face step on both sides from the same weights,
    batch, t and noise, on raw audio (the frozen frontends in the step) or
    on cached features."""
    cached = request.param
    pm = FiLMDenoiser(DenoiserConfig(**FACE))
    pm.reset_parameters(torch.Generator().manual_seed(2))
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for p in pm.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    jparams = convert_film_denoiser({k: v.clone() for k, v in pm.state_dict().items()}, "face", FACE["num_layers"])
    b = _face_batch(cached)
    t = np.array([120, 700])
    noise = rng.randn(2, TF, 256).astype(np.float32)
    jm = JDenoiser(j_config.DenoiserConfig(**FACE))
    jsched = j_make_schedule("cosine", 1000)
    get = lambda k: jnp.asarray(b[k]) if k in b else None  # noqa: E731

    def loss_fn(params):
        x0, tt = jnp.asarray(b["motion"]), jnp.asarray(t, jnp.int32)
        xt = j_gaussian.q_sample(jsched, x0, tt, jnp.asarray(noise))
        out = jm.apply(params, xt, tt, get("audio"), cond_drop_prob=0.0, deterministic=True,
                       audio_features=get("audio_features"), lip_verts=get("lip_verts"))
        terms = j_losses.training_losses(jsched, "xstart", out, x0, xt, tt, jnp.asarray(b["mask"])[..., None])
        return terms["loss"].mean(), terms

    j_flash.reset_trace_flops()
    (jloss, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    assert j_flash.trace_flops() > 0  # the JAX side went through the Pallas kernels
    jstate = j_state.create_train_state(jparams, j_config.TrainConfig(lr=LR)).apply_gradients(jgrads)

    state = TrainState(pm.eval(), TrainConfig(lr=LR))
    metrics, _ = diffusion_train_step(state, make_schedule().to_device("cpu"), DiffusionConfig(cond_drop_prob=0.0),
                                      _torch_batch(b), t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    return dict(pm=pm, metrics=metrics, jloss=float(jloss), jterms=jterms, jgrads=jgrads,
                jparams_after=jstate.params)


def test_face_step_loss_matches_jax(face_step_parity):
    test_step_loss_matches_jax(face_step_parity)


def test_face_step_gradients_match_jax(face_step_parity):
    s = face_step_parity
    want = convert.film_denoiser_state_dict_from_jax(s["jgrads"], "face", FACE["num_layers"])
    pm = s["pm"]
    trainable = {id(p) for p in trainable_parameters(pm)}
    assert any(n.startswith("cond_encoder.") and id(p) in trainable for n, p in pm.named_parameters())
    for name, p in pm.named_parameters():
        if id(p) not in trainable:  # the frozen frontends: no gradient on either side
            assert name.startswith(("audio_model.", "lip_model.")), name
            assert p.grad is None and not want[name].abs().max() > 0, name
            continue
        got, w = _np(p.grad), _np(want[name])
        np.testing.assert_allclose(got, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


def test_face_params_after_one_adamw_step_match_jax(face_step_parity):
    s = face_step_parity
    want = convert.film_denoiser_state_dict_from_jax(s["jparams_after"], "face", FACE["num_layers"])
    diffs = []
    for name, p in s["pm"].named_parameters():
        d = np.abs(_np(p) - _np(want[name])).ravel()
        assert d.max() <= 2 * LR, name
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).sum()


# ---------------------------------------------------- dropout in training -- #


def _one_step_loss(model, seed, cond_drop_prob=0.2):
    state = TrainState(model, TrainConfig(lr=LR))
    metrics, _ = diffusion_train_step(state, make_schedule().to_device("cpu"),
                                      DiffusionConfig(cond_drop_prob=cond_drop_prob), _torch_batch(_batch()),
                                      torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed))
    return metrics


def test_training_step_with_dropout_is_seeded_and_differs_from_eval():
    base = _port_model(seed=5)
    a = _one_step_loss(copy.deepcopy(base).train(), 7)
    b = _one_step_loss(copy.deepcopy(base).train(), 7)
    c = _one_step_loss(copy.deepcopy(base).eval(), 7)
    assert np.isfinite(a["loss"]) and a["skipped_nonfinite"] == 0.0
    assert a == b  # the same generator seed gives the same step
    assert a["loss"] != c["loss"]  # dropout (and the guidance draws) moved the loss


@pytest.mark.parametrize("hash_dropout", [True, False])
def test_dropout_keep_rates(hash_dropout):
    """The observed keep share of every FF, residual and post-net mask of a
    training forward is within 3 sigma of 1 - rate."""
    model = _port_model(seed=6, hash_dropout=hash_dropout).train()
    seen = {}

    def hook(name):
        def fn(mod, inputs, out):
            live = inputs[0] != 0
            kept, n = ((out != 0) & live).sum().item(), live.sum().item()
            k0, n0, _ = seen.get(name, (0, 0, mod.rate))
            seen[name] = (k0 + kept, n0 + n, mod.rate)
        return fn

    for name, mod in model.named_modules():
        if isinstance(mod, blocks.Dropout):
            kind = "post" if name == "post_drop" else name.rsplit(".", 1)[-1]
            mod.register_forward_hook(hook(kind))
    b = _torch_batch(_batch())
    with torch.no_grad():
        x = torch.randn(2, T, 104, generator=torch.Generator().manual_seed(0))
        model(x, torch.tensor([3, 500]), b["audio"], b["keyframes"], b["keyframe_valid"],
              generator=torch.Generator().manual_seed(1))
    assert set(seen) == {"drop", "ff_drop", "post"}
    for kind, (kept, n, rate) in seen.items():
        p = 1.0 - rate
        assert abs(kept / n - p) <= 3 * np.sqrt(p * (1 - p) / n), (kind, kept / n, p)
    assert seen["post"][2] == 0.2 and seen["drop"][2] == MODEL["dropout"]


def test_hash_drop_mult_matches_jax():
    for i, shape in enumerate([(3, 50, 70), (2, 128, 64), (1000,)]):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        seed = int(j_blocks._key_to_seed(key))
        for rate in (0.1, 0.2):
            want = np.asarray(j_blocks.hash_drop_mult(key, shape, rate, jnp.float32))
            np.testing.assert_array_equal(blocks.hash_drop_mult(seed, shape, rate).numpy(), want)


def test_frozen_frontend_is_left_out():
    model = _port_model()
    names = {id(p) for p in trainable_parameters(model)}
    for name, p in model.named_parameters():
        assert (id(p) in names) == (not name.startswith("audio_model.")), name
        assert p.requires_grad == (id(p) in names), name


# --------------------------------------------- components against JAX -- #


def test_q_posterior_and_p_mean_variance_match_jax():
    rng = np.random.RandomState(0)
    x0, xt, out = (rng.randn(3, 7, 5).astype(np.float32) for _ in range(3))
    t = np.array([0, 1, 999])
    js, ps = j_make_schedule("cosine", 1000), make_schedule().to_device("cpu")
    tt, jt = torch.from_numpy(t), jnp.asarray(t, jnp.int32)
    np.testing.assert_allclose(gaussian.q_sample(ps, torch.from_numpy(x0), tt, torch.from_numpy(xt)).numpy(),
                               j_gaussian.q_sample(js, x0, jt, xt), rtol=1e-6, atol=1e-6)
    for a, b in zip(gaussian.q_posterior_mean_variance(ps, torch.from_numpy(x0), torch.from_numpy(xt), tt),
                    j_gaussian.q_posterior_mean_variance(js, x0, xt, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for predict in ("xstart", "eps", "v"):
        for var_type in ("fixed_small", "fixed_large"):
            got = gaussian.p_mean_variance(ps, predict, var_type, torch.from_numpy(out), torch.from_numpy(xt), tt)
            want = j_gaussian.p_mean_variance(js, predict, var_type, out, xt, jt)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("predict,lambda_vel", [("xstart", 0.0), ("xstart", 0.5), ("eps", 0.0), ("v", 0.3)])
def test_training_losses_match_jax(predict, lambda_vel):
    rng = np.random.RandomState(1)
    # x0 inside the 1/255-binned likelihood's [-1, 1] and a close prediction,
    # where the t=0 term is well conditioned in f32
    x0 = rng.uniform(-0.9, 0.9, (3, 20, 6)).astype(np.float32)
    xt = rng.randn(3, 20, 6).astype(np.float32)
    out = (x0 + 0.05 * rng.randn(3, 20, 6)).astype(np.float32)
    mask = (rng.rand(3, 20, 1) > 0.2).astype(np.float32)
    t = np.array([0, 400, 999])
    got = losses.training_losses(make_schedule().to_device("cpu"), predict, *(torch.from_numpy(a) for a in
                                 (out, x0, xt, t, mask)), lambda_vel=lambda_vel)
    want = j_losses.training_losses(j_make_schedule("cosine", 1000), predict, out, x0, xt, jnp.asarray(t, jnp.int32),
                                    mask, lambda_vel=lambda_vel)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-5, atol=2e-5, err_msg=k)


def test_velocity_loss_is_masked_by_lengths_not_by_missing_frames():
    """A face-style batch: sample 0 has frames 90-99 missing (``mask`` 0)
    inside its valid length, sample 1 is 100 frames long.  With lambda_vel
    > 0 the step's loss is JAX ``training_losses`` (diffusion/losses.py:89)
    with ``vel_mask=`` the validity mask from ``lengths`` passed explicitly,
    within 1e-5 relative, and not the loss whose velocity term takes
    ``mask`` (the JAX train step's behaviour)."""
    pm = _port_model(seed=3)
    b = _batch()
    b["mask"][0, 90:100] = 0.0
    b["motion"] = b["motion"] * b["mask"][..., None]
    lengths = np.array([T, 100], np.int32)
    b["lengths"] = lengths
    t = np.array([37, 912])
    noise = np.random.RandomState(5).randn(2, T, 104).astype(np.float32)
    sched = make_schedule().to_device("cpu")
    tb = _torch_batch(b)
    with torch.no_grad():  # the step's model output, before its update
        xt = gaussian.q_sample(sched, tb["motion"], torch.from_numpy(t), torch.from_numpy(noise))
        out = pm.eval()(xt, torch.from_numpy(t), tb["audio"], tb["keyframes"], tb["keyframe_valid"],
                        cond_drop_prob=0.0)
    dcfg = DiffusionConfig(cond_drop_prob=0.0, lambda_vel=0.5)
    metrics, _ = diffusion_train_step(TrainState(pm, TrainConfig(lr=LR)), sched, dcfg, tb, t=torch.from_numpy(t),
                                      noise=torch.from_numpy(noise))
    valid = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)[..., None]
    args = (j_make_schedule("cosine", 1000), "xstart", _np(out), b["motion"], _np(xt), jnp.asarray(t, jnp.int32),
            b["mask"][..., None])
    want = float(j_losses.training_losses(*args, lambda_vel=0.5, vel_mask=valid)["loss"].mean())
    jax_step = float(j_losses.training_losses(*args, lambda_vel=0.5)["loss"].mean())
    assert abs(metrics["loss"] - want) <= 1e-5 * abs(want)
    assert abs(jax_step - want) > 1e-3 * abs(want)  # the two masks give different losses here


def test_loss_second_moment_sampler_matches_jax():
    T_, H = 6, 3
    js, ps = j_tsample.LossSecondMomentState.init(T_, H), tsample.LossSecondMomentState.init(T_, H)
    rng = np.random.RandomState(2)
    for _ in range(5):
        t = rng.randint(0, T_, 8)
        l = rng.rand(8).astype(np.float32)
        js = j_tsample.loss_second_moment_update(js, jnp.asarray(t), jnp.asarray(l), axis=None)
        ps = tsample.loss_second_moment_update(ps, torch.from_numpy(t), torch.from_numpy(l))
        np.testing.assert_allclose(ps.history.numpy(), np.asarray(js.history), rtol=1e-6)
        np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_allclose(tsample.loss_second_moment_weights(ps).numpy(),
                                   np.asarray(j_tsample.loss_second_moment_weights(js)), rtol=1e-6)
    t, w = tsample.loss_second_moment_sample(torch.Generator().manual_seed(0), ps, 1000)
    p = tsample.loss_second_moment_weights(ps)
    assert t.min() >= 0 and t.max() < T_
    torch.testing.assert_close(w, 1.0 / (T_ * p[t]))
    t, w = tsample.uniform_sample(torch.Generator().manual_seed(0), 1000, 64)
    assert t.shape == (64,) and 0 <= t.min() and t.max() < 1000 and torch.all(w == 1)


@pytest.mark.parametrize("anneal,warmup,clip,ema", [(3, 0, 0.5, 0.9), (0, 2, 0.0, 0.0), (0, 0, 100.0, 0.0)])
def test_optimizer_matches_optax(anneal, warmup, clip, ema):
    """AdamW + schedule + global-norm clip + EMA over three steps, against
    the JAX package's optax chain on the same gradients: within 1e-5, 1e-4 of
    the lr (torch and optax order the bias corrections and the decay term
    differently, in f32)."""
    cfg = dict(lr=0.1, lr_anneal_steps=anneal, warmup_steps=warmup, grad_clip=clip, ema_decay=ema,
               weight_decay=0.01)
    rng = np.random.RandomState(3)
    lin = torch.nn.Linear(3, 4)
    jp = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(jp["w"]))
        lin.bias.copy_(torch.from_numpy(jp["b"]))
    state = TrainState(lin, TrainConfig(**cfg))
    jst = j_state.create_train_state(jp, j_config.TrainConfig(**cfg))
    for _ in range(3):
        g = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
        lin.weight.grad, lin.bias.grad = torch.from_numpy(g["w"]), torch.from_numpy(g["b"])
        state.apply_gradients(float(np.sqrt(sum((x**2).sum() for x in g.values()))))
        jst = jst.apply_gradients(g)
        if ema:
            jst = j_state.update_ema(jst, ema)
    np.testing.assert_allclose(_np(lin.weight), np.asarray(jst.params["w"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(lin.bias), np.asarray(jst.params["b"]), rtol=0, atol=1e-5)
    if ema:
        np.testing.assert_allclose(_np(state.ema["weight"]), np.asarray(jst.ema_params["w"]), rtol=0, atol=1e-5)
    assert state.step == 3


# --------------------------------------------------------- the trainer -- #


TINY = dict(latent_dim=64, ff_size=128, num_layers=1, num_heads=1, max_seq_length=T, flash_attention=True,
            hash_dropout=True)


@pytest.fixture(scope="module")
def person(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    make_synthetic_person(root, "SYNTH01", num_scenes=8, frames_per_scene=T, seed=3)
    return root


def _train(root, save_dir, num_steps, ema_decay=0.0, **kw):
    return train_diffusion.train(
        root, save_dir, DenoiserConfig(**TINY), DiffusionConfig(),
        DataConfig(person="SYNTH01", max_seq_length=T, min_seq_length=100, batch_size=2),
        TrainConfig(num_steps=num_steps, log_interval=1, save_interval=1000, seed=5, ema_decay=ema_decay), **kw)


def test_train_writes_a_checkpoint_that_resumes_and_samples(person, tmp_path):
    run = str(tmp_path / "run")
    state = _train(person, run, 2, device="cpu")
    assert state.step == 2
    assert {"config.json", "model.pt", "log.jsonl", "ckpt"} <= set(os.listdir(run))
    assert checkpoints.latest_step(os.path.join(run, "ckpt")) == 2
    # resume: one more step from the saved one, the same as three in a row
    state = _train(person, run, 3, device="cpu")
    assert state.step == 3 and checkpoints.steps(os.path.join(run, "ckpt")) == [2, 3]
    assert [l.split('"step": ')[1].split(",")[0] for l in open(os.path.join(run, "log.jsonl"))] == ["0", "1", "2"]
    straight = _train(person, str(tmp_path / "straight"), 3, device="cpu")
    for (name, a), b in zip(state.model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(a, b), name
    # the save dir is a checkpoint that generate samples from
    res = np.load(generate(run, person, num_samples=1, timestep_respacing="ddim2", device="cpu",
                           output_dir=str(tmp_path / "samples")), allow_pickle=True).item()
    assert res["motions"].shape == (1, 104, 1, T) and np.isfinite(res["motions"]).all()


def test_generate_samples_from_the_ema(person, tmp_path):
    """``generate(use_ema=True)`` takes the EMA the trainer keeps in its
    latest checkpoint: it samples as a model.pt holding those parameters
    does.  Without an EMA it warns and samples from model.pt."""
    run = str(tmp_path / "run")
    state = _train(person, run, 2, ema_decay=0.5, device="cpu")
    ema_dir = str(tmp_path / "ema_model")
    os.makedirs(ema_dir)
    with open(os.path.join(run, "config.json")) as f, open(os.path.join(ema_dir, "config.json"), "w") as g:
        g.write(f.read())
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    sd.update({k: v.cpu() for k, v in state.ema.items()})
    torch.save(sd, os.path.join(ema_dir, "model.pt"))
    kw = dict(num_samples=1, timestep_respacing="ddim2", device="cpu")

    def motions(path, name, **k):
        return np.load(generate(path, person, output_dir=str(tmp_path / name), **kw, **k),
                       allow_pickle=True).item()["motions"]

    ema = motions(run, "ema", use_ema=True)
    np.testing.assert_array_equal(ema, motions(ema_dir, "ema_file"))
    assert not np.allclose(ema, motions(run, "raw"))
    plain = str(tmp_path / "plain")
    _train(person, plain, 1, device="cpu")
    with pytest.warns(UserWarning, match="no EMA"):
        without = motions(plain, "no_ema", use_ema=True)
    np.testing.assert_array_equal(without, motions(plain, "plain_raw"))


def test_train_runs_on_the_card_by_default(person, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train(person, str(tmp_path / "run"), 1)


def test_train_refuses_an_unknown_reader(person, tmp_path):
    with pytest.raises(ValueError, match="reader"):
        _train(person, str(tmp_path), 1, reader="c", device="cpu")


def test_train_runs_with_remat_and_writes_tensorboard_events(person, tmp_path):
    run = str(tmp_path / "run")
    state = train_diffusion.train(
        person, run, DenoiserConfig(**{**TINY, "remat": True}), DiffusionConfig(),
        DataConfig(person="SYNTH01", max_seq_length=T, min_seq_length=100, batch_size=2),
        TrainConfig(num_steps=2, log_interval=1, save_interval=1000, seed=5), device="cpu")
    assert state.step == 2 and state.model.cfg.remat
    assert [json.loads(line)["step"] for line in open(os.path.join(run, "log.jsonl"))] == [0, 1]
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(run))


# ------------------------------------------------------------- remat -- #

SMALL = dict(data_format="pose", nfeats=8, latent_dim=16, ff_size=32, num_layers=2, num_heads=2,
             max_seq_length=12, keyframe_step=6, dropout=0.1)


def _small_batch(B=2, Ts=12, seed=21):
    rng = np.random.RandomState(seed)
    return {"motion": rng.randn(B, Ts, 8).astype(np.float32), "mask": np.ones((B, Ts), np.float32),
            "audio": (rng.randn(B, Ts * 1600, 2) * 0.1).astype(np.float32),
            "keyframes": rng.randn(B, 2, 104).astype(np.float32), "keyframe_valid": np.ones((B, 2), np.float32)}


def _step(model, batch, t, noise, generator=None, dcfg=None):
    state = TrainState(model, TrainConfig(lr=LR))
    metrics, _ = diffusion_train_step(state, make_schedule().to_device("cpu"), dcfg or DiffusionConfig(cond_drop_prob=0.0),
                                      _torch_batch(batch), generator, t=torch.from_numpy(t),
                                      noise=torch.from_numpy(noise))
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_remat_step_equals_the_plain_step_with_dropout(monkeypatch):
    """Training mode at T 128 (the flash gate open), hash dropout 0.1 and the
    guidance drop: the checkpointed step replays every draw, so loss and
    gradients equal the plain step's bit for bit; the decoder's attention
    runs once more per layer (the recompute); the step's generator ends
    where the plain step leaves it."""
    b = _batch()
    rng = np.random.RandomState(22)
    t, noise = np.array([37, 912]), rng.randn(2, T, 104).astype(np.float32)
    calls, out = [], {}
    monkeypatch.setattr(blocks, "flash_attention", lambda *a: calls.append(a[0].shape) or
                        flash_attention_reference(*a))
    for remat in (False, True):
        m = _port_model(seed=7, remat=remat).train()
        g = torch.Generator().manual_seed(8)
        calls.clear()
        out[remat] = (*_step(m, b, t, noise, g, DiffusionConfig(cond_drop_prob=0.2)), len(calls), g.get_state())
    (m0, g0, n0, s0), (m1, g1, n1, s1) = out[False], out[True]
    assert m0["loss"] == m1["loss"] and sorted(g0) == sorted(g1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)
    assert n0 == 2 * MODEL["num_layers"] and n1 == 2 * n0  # self- and cross-attention a layer, twice under remat
    assert torch.equal(s0, s1)


def test_remat_step_caches_no_cast():
    """bf16 compute: the checkpointed forward and its recompute run with
    grad on, so ``blocks.kept`` keeps no cast of a parameter."""
    b = _small_batch()
    rng = np.random.RandomState(23)
    m = FiLMDenoiser(DenoiserConfig(**{**SMALL, "remat": True, "dtype": "bfloat16"}))
    m.reset_parameters(torch.Generator().manual_seed(3))
    metrics, grads = _step(m.train(), b, np.array([5, 500]), rng.randn(2, 12, 8).astype(np.float32),
                           torch.Generator().manual_seed(4))
    assert np.isfinite(metrics["loss"]) and grads
    assert not any(mod.__dict__.get("_casts") for mod in m.modules())


def test_remat_step_matches_jax_remat_step():
    """One deterministic step (eval mode, no guidance drop) of a small pose
    model with ``remat`` on both sides, JAX's under ``nn.remat``: the
    step-parity bars (loss 1e-5 relative, each gradient 1e-4 of its largest
    element), and the port's gradients equal to its plain step's."""
    pm = FiLMDenoiser(DenoiserConfig(**{**SMALL, "remat": True}))
    pm.reset_parameters(torch.Generator().manual_seed(9))
    rng = np.random.RandomState(10)
    with torch.no_grad():
        for p in pm.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    plain = copy.deepcopy(pm)
    plain.cfg = DenoiserConfig(**SMALL)
    b, t = _small_batch(), np.array([37, 912])
    noise = rng.randn(2, 12, 8).astype(np.float32)
    jparams = convert_film_denoiser({k: v.clone() for k, v in pm.state_dict().items()}, "pose", SMALL["num_layers"])
    jm = JDenoiser(j_config.DenoiserConfig(**{**SMALL, "remat": True}))
    jsched = j_make_schedule("cosine", 1000)

    def loss_fn(params):
        x0, tt = jnp.asarray(b["motion"]), jnp.asarray(t, jnp.int32)
        xt = j_gaussian.q_sample(jsched, x0, tt, jnp.asarray(noise))
        out = jm.apply(params, xt, tt, jnp.asarray(b["audio"]), jnp.asarray(b["keyframes"]),
                       jnp.asarray(b["keyframe_valid"]), cond_drop_prob=0.0, deterministic=True)
        return j_losses.training_losses(jsched, "xstart", out, x0, xt, tt, jnp.asarray(b["mask"])[..., None])["loss"].mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    metrics, grads = _step(pm.eval(), b, t, noise)
    _, plain_grads = _step(plain.eval(), b, t, noise)
    np.testing.assert_allclose(metrics["loss"], float(jloss), rtol=1e-5)
    want = convert.film_denoiser_state_dict_from_jax(jgrads, "pose", SMALL["num_layers"])
    for name, g in grads.items():
        w = _np(want[name])
        np.testing.assert_allclose(_np(g), w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)
        torch.testing.assert_close(g, plain_grads[name], rtol=0, atol=0, msg=name)


# ----------------------------------------------- logging and profiling -- #


def test_platforms(tmp_path):
    assert isinstance(logging.create_platform("NoPlatform", None), logging.NoPlatform)
    with pytest.raises(ValueError, match="unknown train platform"):
        logging.create_platform("NopePlatform", None)
    with pytest.raises(ModuleNotFoundError, match="clearml"):  # the SDK is imported at construction
        logging.create_platform("ClearmlPlatform", str(tmp_path / "clearml"))
    d = str(tmp_path / "tb")
    tb = logging.create_platform("TensorboardPlatform", d)
    tb.report_args(TrainConfig(lr=3e-4), name="train_args")
    tb.report_scalar("loss", 1.5, 3, group_name="train")
    tb.close()
    assert json.load(open(os.path.join(d, "train_args.json")))["lr"] == 3e-4
    assert json.loads(open(os.path.join(d, "log.jsonl")).readline())["train/loss"] == 1.5
    events = [f for f in os.listdir(d) if f.startswith("events.out.tfevents")]
    assert events and os.path.getsize(os.path.join(d, events[0])) > 0


def test_kv_logger_means_dump_and_profile_kv(tmp_path, capsys, monkeypatch):
    log = logging.KVLogger(str(tmp_path))
    log.logkv_mean("a", 1.0)
    log.logkv_mean("a", 3.0)
    with log.profile_kv("step"):
        pass
    log.dump(7)
    log.log(8, {"b": 2})
    log.close()
    rows = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    assert [r["step"] for r in rows] == [7, 8] and rows[0]["a"] == 2.0 and rows[0]["wall_step"] >= 0.0
    assert rows[1]["b"] == 2.0 and "a" not in rows[1]
    assert "[step 7] a 2" in capsys.readouterr().out
    # no SummaryWriter to be had: the logger runs without TensorBoard
    import torch.utils.tensorboard as tb_mod

    def refuse(*a, **k):
        raise ImportError("no tensorboard")

    monkeypatch.setattr(tb_mod, "SummaryWriter", refuse)
    quiet = logging.KVLogger(str(tmp_path / "no_tb"), tensorboard=True)
    quiet.log(0, {"c": 1.0})
    quiet.close()
    assert not any(f.startswith("events") for f in os.listdir(tmp_path / "no_tb"))


def test_timer_and_profile_trace(tmp_path):
    timer = Timer(ema=0.5)
    first = timer.tick()
    second = timer.tick(4)
    assert first > 0 and second > 0 and timer.rate == second
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


# ------------------------------------------------- the face trainer -- #


FACE_TINY = dict(data_format="face", nfeats=256, latent_dim=32, ff_size=64, num_layers=1, num_heads=1,
                 cond_encoder_layers=1, max_seq_length=TF, flash_attention=True, hash_dropout=True)


@pytest.fixture(scope="module")
def face_person(tmp_path_factory):
    """Seven scenes: one in the train split, whose cache a face run builds."""
    root = str(tmp_path_factory.mktemp("train_face"))
    make_synthetic_person(root, "SYNTH01", num_scenes=7, frames_per_scene=TF, seed=4)
    return root


def _train_face(root, save_dir, num_steps, timings=None, **kw):
    return train_diffusion.train(
        root, save_dir, DenoiserConfig(**FACE_TINY), DiffusionConfig(),
        DataConfig(person="SYNTH01", data_format="face", max_seq_length=TF, min_seq_length=90, batch_size=2),
        TrainConfig(num_steps=num_steps, log_interval=1, save_interval=1000, seed=6), cache_audio_features=True,
        device="cpu", timings=timings, **kw)


def test_face_train_on_the_cache_resumes_and_samples(face_person, tmp_path):
    """Face ``train()`` on cached features: a checkpoint, a resumed run equal
    to an uninterrupted one (each run builds the cache from its weights as
    resumed; the frontends are frozen, so the caches agree), and ``generate``
    samples the face checkpoint."""
    run = str(tmp_path / "run")
    timings = {}
    state = _train_face(face_person, run, 2, timings, reader="numpy")
    assert state.step == 2 and timings["reader"] == "numpy" and timings["cache_s"] > 0
    assert len(timings["batch_s"]) == len(timings["step_s"]) == 2
    assert checkpoints.latest_step(os.path.join(run, "ckpt")) == 2
    state = _train_face(face_person, run, 3)
    assert state.step == 3
    logged = [json.loads(l) for l in open(os.path.join(run, "log.jsonl"))]
    assert [r["step"] for r in logged] == [0, 1, 2] and all(np.isfinite(r["loss"]) for r in logged)
    straight = _train_face(face_person, str(tmp_path / "straight"), 3)
    for (name, a), b in zip(state.model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(a, b), name
    res = np.load(generate(run, face_person, num_samples=1, timestep_respacing="ddim2", device="cpu",
                           output_dir=str(tmp_path / "samples")), allow_pickle=True).item()
    assert res["motions"].shape == (1, 256, 1, TF) and np.isfinite(res["motions"]).all()
