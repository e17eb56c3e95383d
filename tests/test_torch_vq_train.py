"""The VQ trainer of the port (models/vqvae.py's training half,
train/loops.py:vq_train_step, apps/train_vq.py) against the JAX package's,
on the CPU.

Tiny codec: width 8, 16 codes, depth 2, 2 k-means iterations (the JAX
package's own e2e test, tests/test_apps_e2e.py:40).  Port weights go to JAX
through ``train/convert.py:convert_vqvae``; JAX gradients come back through
``convert.vqvae_state_dict_from_jax``.  The port's random rows (k-means'
initial means, dead-code replacements) are drawn by ``vqvae.draw_rows``,
which the tests replace by JAX's indices under JAX's key tree
(``init_key, *layer_keys = split(fold_in(rng, step), depth + 1)``; k-means
at depth d draws under ``fold_in(init_key, d)``), in the order the port
draws them: every k-means layer, then every layer's expiry.  The draw itself
is tested by law.

Bars: k-means means within 2e-5 of their scale with the bins equal; one step
(k-means firing in it): loss, recon and commit within 1e-5 relative, codes
equal, the codebook state after the step within 2e-5 of its scale, every
gradient within 1e-4 of its largest element, parameters after AdamW within
2 lr and 99.9% of them within 1e-6 (a first AdamW step moves a parameter by
about lr times its gradient's sign, and a near-zero gradient's sign can
differ).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps import train_vq as j_train_vq
from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.data import dataset as j_dataset
from audio2photoreal_tpu.models import vqvae as j_vqvae
from audio2photoreal_tpu.train import loops as j_loops
from audio2photoreal_tpu.train import state as j_state
from audio2photoreal_tpu.train.convert import convert_vqvae
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import train_guide, train_vq
from audio2photoreal_tpu_torch.apps.generate import find_stats
from audio2photoreal_tpu_torch.core.config import DataConfig, TrainConfig, VQConfig
from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.models import vqvae
from audio2photoreal_tpu_torch.train.loops import huber, vq_train_step
from audio2photoreal_tpu_torch.train.state import TrainState
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

VQ = dict(nfeats=104, emb_width=8, code_dim=16, depth=2, kmeans_iters=2)
B, K = 4, 20  # 80 keyframe vectors for 16 codes
LR = 1e-3  # the JAX VQ CLI's
REL = 2e-5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def assert_scaled(got, want, rel=REL, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def jax_rows(rng, step, n_rows, cfg, kmeans=True):
    """JAX's row indices of a train step, in the port's draw order."""
    init_key, *layer_keys = jax.random.split(jax.random.fold_in(rng, step), cfg.depth + 1)
    keys = [jax.random.fold_in(init_key, d) for d in range(cfg.depth)] if kmeans else []
    keys += layer_keys
    return [np.asarray(jax.random.randint(k, (cfg.code_dim,), 0, n_rows)) for k in keys]


def inject(monkeypatch, rows):
    it = iter(rows)
    monkeypatch.setattr(vqvae, "draw_rows", lambda n, num, g, device: torch.tensor(next(it), dtype=torch.long, device=device))
    return it


def _port_codec(seed=0, **overrides):
    model = vqvae.TemporalVertexCodec(VQConfig(**{**VQ, **overrides}))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():  # nonzero biases: every parameter counts
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return model


class _Grab:
    """A stand-in train state: the JAX step hands it the gradients."""

    def __init__(self, params, step):
        self.params, self.step = params, step

    def apply_gradients(self, grads):
        return grads


def _jax_step(cfg, params, vq, keyframes, rng, step):
    jm = j_vqvae.TemporalVertexCodec(cfg)
    fn = j_loops.make_vq_train_step(jm, cfg.commit_weight)
    grads, vq_new, metrics = jax.jit(lambda p, v, b: fn(_Grab(p, step), v, b, rng))(
        params, vq, {"keyframes": jnp.asarray(keyframes)})
    codes = jm.apply(params, jnp.asarray(keyframes), vq, train=True, key=jax.random.fold_in(rng, step))[3]
    return grads, vq_new, {k: float(v) for k, v in metrics.items()}, np.asarray(codes)


def _state_of(model):
    books = [l._codebook for l in model.quantizer.layers]
    return {n: torch.stack([getattr(cb, n) for cb in books]) for n in ("embed", "embed_avg", "cluster_size")}


@pytest.fixture(scope="module")
def vq_step():
    """One step, k-means firing in it, from the same weights and keyframes."""
    cfg = j_config.VQConfig(**VQ)
    model = _port_codec()
    params, _ = convert_vqvae({k: v.numpy().copy() for k, v in model.state_dict().items()}, cfg.depth)
    vq0 = j_vqvae.VQState.create(jax.random.PRNGKey(0), cfg)
    assert not bool(vq0.inited) and not np.asarray(vq0.embed).any()
    keyframes = np.random.RandomState(2).randn(B, K, 104).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    jgrads, jvq, jmetrics, jcodes = _jax_step(cfg, params, vq0, keyframes, rng, 0)
    jparams_after = j_state.create_train_state(params, j_config.TrainConfig(lr=LR)).apply_gradients(jgrads).params

    mp = pytest.MonkeyPatch()
    try:
        rows = inject(mp, jax_rows(rng, 0, B * K, cfg))
        seen = []
        model.register_forward_hook(lambda m, i, o: seen.append(o.codes))
        state = TrainState(model, TrainConfig(lr=LR))
        metrics = vq_train_step(state, {"keyframes": torch.from_numpy(keyframes)}, None, cfg.commit_weight)
        assert next(rows, None) is None  # every row JAX drew, the port drew
    finally:
        mp.undo()
    return dict(cfg=cfg, model=model, metrics=metrics, codes=seen[0], jgrads=jgrads, jvq=jvq, jmetrics=jmetrics,
                jcodes=jcodes, jparams_after=jparams_after, keyframes=keyframes, rng=rng)


def test_kmeans_matches_jax(monkeypatch):
    """Means within 2e-5 of their scale, bins equal; with rows drawn twice,
    the duplicate means' empty bins keep them where they were."""
    rng = np.random.RandomState(3)
    samples = rng.randn(80, 8).astype(np.float32)
    key = jax.random.PRNGKey(11)
    idx = np.asarray(jax.random.randint(key, (16,), 0, 80))
    for rows, iters in ((idx, 3), (np.concatenate([idx[:8], idx[:8]]), 1)):
        inject(monkeypatch, [rows])
        means, bins = vqvae.kmeans(torch.from_numpy(samples), 16, iters)
        with monkeypatch.context() as m:  # JAX's draw replaced by the same rows
            m.setattr(j_vqvae, "_sample_vectors", lambda k, s, num: s[jnp.asarray(rows)])
            want_means, want_bins = j_vqvae.kmeans(key, jnp.asarray(samples), 16, iters)
        np.testing.assert_array_equal(_np(bins), np.asarray(want_bins))
        assert_scaled(means, want_means, what="means")
    # each duplicate loses every tie to its first copy: its bin is empty and it stays
    assert not _np(bins)[8:].any() and np.array_equal(_np(means)[8:], samples[idx[:8]])


def test_draw_rows_is_uniform_with_replacement():
    g = torch.Generator().manual_seed(0)
    rows = vqvae.draw_rows(40, 200_000, g, "cpu")
    counts = torch.bincount(rows, minlength=40).double()
    assert rows.min() == 0 and rows.max() == 39
    expect = 200_000 / 40
    assert ((counts - expect).abs() <= 5 * (expect * (1 - 1 / 40)) ** 0.5).all()


def test_vq_step_loss_and_codes_match_jax(vq_step):
    s = vq_step
    for k in ("loss", "recon", "commit"):
        np.testing.assert_allclose(s["metrics"][k], s["jmetrics"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(s["metrics"]["perplexity"], s["jmetrics"]["perplexity"], rtol=1e-6)
    np.testing.assert_array_equal(_np(s["codes"]), s["jcodes"])


def test_vq_step_codebook_state_matches_jax(vq_step):
    s = vq_step
    got = _state_of(s["model"])
    for name in ("embed", "embed_avg", "cluster_size"):
        assert_scaled(got[name], getattr(s["jvq"], name), what=name)
    assert all(l._codebook.inited.item() == 1.0 for l in s["model"].quantizer.layers)
    # at this operating point most codes sit below the dead-code threshold and were replaced
    assert (np.asarray(s["jvq"].cluster_size) < 2.0).any()


def test_vq_step_gradients_and_params_match_jax(vq_step):
    s = vq_step
    want = convert.vqvae_state_dict_from_jax(s["jgrads"], s["jvq"])
    after = convert.vqvae_state_dict_from_jax(s["jparams_after"], s["jvq"])
    diffs = []
    for name, p in s["model"].named_parameters():
        g, w = _np(p.grad), _np(want[name])
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)
        d = np.abs(_np(p) - _np(after[name])).ravel()
        assert d.max() <= 2 * LR, name
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).sum()
    np.testing.assert_allclose(s["metrics"]["grad_norm"], s["jmetrics"]["grad_norm"], rtol=1e-5)


def test_second_step_runs_no_kmeans_and_matches_jax(vq_step, monkeypatch):
    """Step 2 from JAX's step-1 weights and codebooks, inited: only the
    expiry rows are drawn, and the step matches JAX's."""
    s = vq_step
    cfg = s["cfg"]
    model = _port_codec()
    sd = convert.vqvae_state_dict_from_jax(s["jparams_after"], s["jvq"])
    model.load_state_dict(sd, strict=True)
    assert all(l._codebook.inited.item() == 1.0 for l in model.quantizer.layers)
    keyframes = np.random.RandomState(9).randn(B, K, 104).astype(np.float32)
    jgrads, jvq, jmetrics, jcodes = _jax_step(cfg, s["jparams_after"], s["jvq"], keyframes, s["rng"], 1)
    rows = inject(monkeypatch, jax_rows(s["rng"], 1, B * K, cfg, kmeans=False))
    monkeypatch.setattr(vqvae, "kmeans", lambda *a, **k: pytest.fail("k-means ran on inited codebooks"))
    state = TrainState(model, TrainConfig(lr=LR))
    metrics = vq_train_step(state, {"keyframes": torch.from_numpy(keyframes)}, None, cfg.commit_weight)
    assert next(rows, None) is None
    for k in ("loss", "recon", "commit"):
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, err_msg=k)
    got = _state_of(model)
    for name in ("embed", "embed_avg", "cluster_size"):
        assert_scaled(got[name], getattr(jvq, name), what=name)


def test_inited_flags_round_trip_and_default_to_inited():
    model = _port_codec()
    sd = model.state_dict()
    assert sd["quantizer.layers.0._codebook.inited"].item() == 0.0
    old = {k: v for k, v in sd.items() if not k.endswith("inited")}  # a model.pt of PR 8-10
    fresh = _port_codec()
    fresh.load_state_dict(old, strict=True)
    assert all(l._codebook.inited.item() == 1.0 for l in fresh.quantizer.layers)
    fresh.load_state_dict(sd, strict=True)
    assert all(l._codebook.inited.item() == 0.0 for l in fresh.quantizer.layers)


# ------------------------------------------------------------ the app -- #

DATA = dict(person="SYNTH01", data_format="pose", max_seq_length=60, min_seq_length=60, batch_size=4)


@pytest.fixture(scope="module")
def person(tmp_path_factory):
    """8 scenes of 96 frames: 2 in the train split, 2 in val (one 60-frame
    chunk each, what ``evaluate`` reads), 4 in test."""
    root = str(tmp_path_factory.mktemp("vq_person"))
    make_synthetic_person(root, "SYNTH01", num_scenes=8, frames_per_scene=96, seed=4)
    return root


def _tcfg(save_dir, steps, save_interval):
    return TrainConfig(save_dir=save_dir, lr=LR, num_steps=steps, save_interval=save_interval, log_interval=1,
                       warmup_steps=1000)


def test_evaluate_matches_jax(person):
    cfg = VQConfig(**VQ, kmeans_init=False)
    model = _port_codec(kmeans_init=False).eval()
    pdir = os.path.join(person, "SYNTH01")
    val = SocialDataset(load_local_data(person, "SYNTH01"), find_stats(pdir), DataConfig(**DATA), "val")
    assert len(val) == 2
    got = train_vq.evaluate(model, val)
    params, vq = convert_vqvae({k: v.numpy().copy() for k, v in model.state_dict().items()}, cfg.depth)
    jval = j_dataset.SocialDataset(j_dataset.load_local_data(person, "SYNTH01"), j_train_vq.find_stats(pdir),
                                   j_config.DataConfig(**DATA), "val")
    want = j_train_vq.evaluate(j_vqvae.TemporalVertexCodec(j_config.VQConfig(**VQ)), params,
                               j_vqvae.VQState(**{k: jnp.asarray(v) for k, v in vq.items()}), jval)
    for k in ("val_recon", "val_ppl"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_train_vq_resumes_without_kmeans_and_feeds_the_guide(person, tmp_path, monkeypatch):
    """3 steps (evaluate and ckpt_best at step 3), then resumed to 5 without
    k-means: the same weights and codebooks as 5 steps in one run; the save
    dir is a VQ directory that ``train_guide.load_tokenizer`` reads."""
    vcfg, dc = VQConfig(**VQ), DataConfig(**DATA)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    timings = {}
    train_vq.train(person, one, vcfg, dc, _tcfg(one, 5, 3), device="cpu")
    state = train_vq.train(person, two, vcfg, dc, _tcfg(two, 3, 3), device="cpu", timings=timings)
    assert len(timings["step_s"]) == 3 and len(timings["eval_s"]) == 1
    assert os.path.exists(os.path.join(two, train_vq.BEST_DIR, "model.pt"))
    assert all(l._codebook.inited.item() == 1.0 for l in state.model.quantizer.layers)
    monkeypatch.setattr(vqvae, "kmeans", lambda *a, **k: pytest.fail("k-means ran on resume"))
    state = train_vq.train(person, two, vcfg, dc, _tcfg(two, 5, 3), device="cpu")
    assert state.step == 5
    codec = train_guide.load_tokenizer(two, "cpu")
    ref = train_guide.load_tokenizer(one, "cpu")
    for (n, a), (_, b) in zip(codec.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), n
    assert not codec.training and not any(p.requires_grad for p in codec.parameters())
    logged = [l for l in open(os.path.join(two, "log.jsonl"))]
    assert any("val_recon" in l for l in logged) and all("nan" not in l.lower() for l in logged)
    assert huber(torch.zeros(3), torch.tensor([0.5, 1.0, 3.0])).item() == pytest.approx((0.125 + 0.5 + 2.5) / 3)
