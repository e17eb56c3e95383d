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
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.diffusion import gaussian, losses, tsample
from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
from audio2photoreal_tpu_torch.models import blocks
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.train import checkpoints, logging
from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
from audio2photoreal_tpu_torch.train.state import TrainState, trainable_parameters

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


def _train(root, save_dir, num_steps, **kw):
    return train_diffusion.train(
        root, save_dir, DenoiserConfig(**TINY), DiffusionConfig(),
        DataConfig(person="SYNTH01", max_seq_length=T, min_seq_length=100, batch_size=2),
        TrainConfig(num_steps=num_steps, log_interval=1, save_interval=1000, seed=5), **kw)


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


def test_train_runs_on_the_card_by_default(person, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train(person, str(tmp_path / "run"), 1)


def test_train_refuses_what_is_not_ported(person, tmp_path):
    kw = dict(device="cpu")
    with pytest.raises(NotImplementedError, match="face"):
        train_diffusion.train(person, str(tmp_path), DenoiserConfig(data_format="face"), DiffusionConfig(),
                              DataConfig(), TrainConfig(), **kw)
    with pytest.raises(NotImplementedError, match="feature cache"):
        _train(person, str(tmp_path), 1, cache_audio_features=True, **kw)
    for name in ("TensorboardPlatform", "ClearmlPlatform"):
        with pytest.raises(NotImplementedError):
            logging.create_platform(name, str(tmp_path))
    assert isinstance(logging.create_platform("NoPlatform", None), logging.NoPlatform)
