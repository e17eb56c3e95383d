"""Guide-LM keyframing, port vs JAX package, on the CPU.

Tiny configs: the guide at latent 64, 2 layers, 2 heads, 32 tokens (its
pre-net is 1024 wide, the width of the wav2vec features it reads), the VQ
at width 16, 32 codes, depth 2; 2 s of audio give 150 cond tokens after the
pre-net's 48.  Weights are JAX's init with nonzero biases and non-identity
norms, carried to the port by ``convert.*_state_dict_from_jax``; inputs are
seeded numpy.  Bars: modules within 2e-5 of their output's largest
magnitude; the nucleus order exact, ties included; the keep mask exact but
where the strictly-previous sum lies within 1e-6 of ``top_p`` (XLA and torch
may round a cumulative sum differently there; those cases are counted, not
avoided); the renormalised kept probabilities within 1e-6; tokens equal to
JAX's for the same Gumbel noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.models import guide as j_guide
from audio2photoreal_tpu.models import vqvae as j_vqvae
from audio2photoreal_tpu.ops import attention as j_attention
from audio2photoreal_tpu.ops import rotary as j_rotary
from audio2photoreal_tpu.train.convert import convert_guide, convert_vqvae, film_decoder_layer
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.core.config import GuideConfig, VQConfig
from audio2photoreal_tpu_torch.models import blocks, guide, vqvae
from audio2photoreal_tpu_torch.ops import attention, rotary
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

GUIDE = dict(tokens=32, latent_dim=64, ff_size=96, num_layers=2, num_heads=2, vq_depth=2, dropout=0.0)
VQ = dict(nfeats=104, emb_width=16, code_dim=32, depth=2)
B, FRAMES = 2, 60  # 2 s of 48 kHz audio: 198 wav2vec frames, 150 cond tokens
REL = 2e-5
BOUNDARY = 1e-6  # a strictly-previous sum this close to top_p may round to either side


def assert_scaled(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _perturb(params, rng):
    """Nonzero biases and non-identity norms, so every parameter counts."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, params)


def jax_gumbel_stream(key, n, shape):
    """The noise of JAX ``GuideTransformer.generate``'s steps: per step
    ``k, sub = split(k)`` and ``categorical(sub, ...)``, which draws
    ``gumbel(sub, shape)``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, shape)))
    return out


def inject(monkeypatch, noise):
    it = iter(noise)
    monkeypatch.setattr(guide, "draw_gumbel", lambda shape, g, device: torch.from_numpy(next(it)).to(device))


@pytest.fixture(scope="module")
def guide_setup():
    rng = np.random.RandomState(0)
    jm = j_guide.GuideTransformer(j_config.GuideConfig(**GUIDE))
    audio = (rng.randn(B, FRAMES * 1600, 2) * 0.5).astype(np.float32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(1), "cond_drop": jax.random.PRNGKey(2)},
                              jnp.zeros((B, 4), jnp.int32), jnp.asarray(audio))
    params = _perturb(params, rng)
    model = guide.GuideTransformer(GuideConfig(**GUIDE)).eval()
    model.load_state_dict(convert.guide_state_dict_from_jax(params), strict=True)
    return dict(jm=jm, params=params, model=model, audio=audio, rng=rng)


@pytest.fixture(scope="module")
def vq_setup():
    rng = np.random.RandomState(1)
    cfg = j_config.VQConfig(kmeans_init=False, **VQ)
    jm = j_vqvae.TemporalVertexCodec(cfg)
    vq = j_vqvae.VQState.create(jax.random.PRNGKey(3), cfg)
    vq = vq._replace(embed_avg=vq.embed_avg + 0.5, cluster_size=vq.cluster_size + 2.0)
    motion = rng.randn(B, 20, VQ["nfeats"]).astype(np.float32)
    params = _perturb(jm.init(jax.random.PRNGKey(4), jnp.asarray(motion), vq), rng)
    model = vqvae.TemporalVertexCodec(VQConfig(**VQ)).eval()
    model.load_state_dict(convert.vqvae_state_dict_from_jax(params, vq), strict=True)
    return dict(jm=jm, params=params, vq=vq, model=model, motion=motion, rng=rng)


# ------------------------------------------------------------------ VQ -- #


def test_causal_conv_stack_matches_jax(vq_setup):
    s = vq_setup
    x = s["motion"]
    for side in ("encoder", "decoder"):
        stack = getattr(s["model"], side)
        jstack = j_vqvae._CausalConvStack(
            specs=tuple((c.in_channels, c.out_channels, c.kernel_size[0], c.dilation[0]) for c in stack.convs),
            receptive_field=8)
        inp = x if side == "encoder" else s["rng"].randn(B, 20, VQ["emb_width"]).astype(np.float32)
        want = jstack.apply({"params": s["params"]["params"][side]}, jnp.asarray(inp))
        with torch.no_grad():
            got = stack(torch.from_numpy(inp))
        assert got.shape == (B, 20, stack.convs[-1].out_channels)
        assert_scaled(got.numpy(), want, what=side)


def test_rvq_encode_decode_match_jax(vq_setup):
    s = vq_setup
    cfg = j_config.VQConfig(**VQ)
    x = s["rng"].randn(64, VQ["emb_width"]).astype(np.float32) * 0.05
    embed = s["model"].quantizer.embed
    codes = vqvae.rvq_encode(torch.from_numpy(x), embed)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_vqvae.rvq_encode(jnp.asarray(x), s["vq"], cfg)))
    want = j_vqvae.rvq_decode(jnp.asarray(codes.numpy()), s["vq"], cfg)
    assert_scaled(vqvae.rvq_decode(codes, embed).numpy(), want)
    for d in range(VQ["depth"]):
        np.testing.assert_array_equal(
            vqvae._quantize_one(embed[d], torch.from_numpy(x)).numpy(),
            np.asarray(j_vqvae._quantize_one(s["vq"].embed[d], jnp.asarray(x))))
    assert np.isclose(float(vqvae.perplexity(codes, VQ["code_dim"])),
                      float(j_vqvae.perplexity(jnp.asarray(codes.numpy()), VQ["code_dim"])), rtol=1e-6)


def test_codec_decode_encode_forward_match_jax(vq_setup):
    s = vq_setup
    jm, params, vq, model = s["jm"], s["params"], s["vq"], s["model"]
    codes = s["rng"].randint(0, VQ["code_dim"], (B, 20, VQ["depth"]))
    want = jm.apply(params, jnp.asarray(codes), vq, method=j_vqvae.TemporalVertexCodec.decode)
    with torch.no_grad():
        assert_scaled(model.decode(torch.from_numpy(codes)).numpy(), want, what="decode")
        got = model(torch.from_numpy(s["motion"]))
        enc = model.encode(torch.from_numpy(s["motion"]))
    recon, commit, ppl, jcodes, _ = jm.apply(params, jnp.asarray(s["motion"]), vq)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jcodes))
    assert_scaled(got.recon.numpy(), recon, what="recon")
    assert float(got.commit_loss) == float(commit) == 0.0
    assert np.isclose(float(got.perplexity), float(ppl), rtol=1e-6)


def test_vqvae_state_dict_round_trips_through_convert_vqvae(vq_setup):
    s = vq_setup
    params, vq = convert_vqvae({k: v.numpy() for k, v in s["model"].state_dict().items()}, VQ["depth"])
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(s["params"])}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params)}
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(v), err_msg=path)
    for name in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_array_equal(vq[name], np.asarray(getattr(s["vq"], name)), err_msg=name)


def test_vq_reset_parameters_draws_codebooks_he_uniform():
    """Without k-means init the codebooks are drawn he-uniform and inited;
    with it (``VQConfig()``'s default) they are 0 and not inited, as
    ``VQState.create`` makes them."""
    model = vqvae.TemporalVertexCodec(VQConfig(kmeans_init=False))
    model.reset_parameters(torch.Generator().manual_seed(0))
    embed = model.quantizer.embed
    limit = (6.0 / (1024 * 4)) ** 0.5  # he-uniform over [depth, codes, dim]: fan-in codes x depth
    assert embed.shape == (4, 1024, 64) and embed.abs().max() <= limit
    assert 0.9 * limit < embed.abs().max() and abs(embed.std().item() - limit / 3**0.5) < 0.01 * limit
    cb = model.quantizer.layers[0]._codebook
    assert torch.equal(cb.embed_avg, cb.embed) and not cb.cluster_size.any() and cb.inited.item() == 1.0
    model = vqvae.TemporalVertexCodec(VQConfig())
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert not model.quantizer.embed.any()
    assert all(l._codebook.inited.item() == 0.0 for l in model.quantizer.layers)


# --------------------------------------------------------------- guide -- #


def test_prenet_and_encode_conditioning_match_jax(guide_setup):
    s = guide_setup
    jm, params, model, audio = s["jm"], s["params"], s["model"], s["audio"]
    keep = np.array([True, False])
    for keep_mask in (None, keep):
        want = jm.apply(params, jnp.asarray(audio), None if keep_mask is None else jnp.asarray(keep_mask),
                        method=j_guide.GuideTransformer.encode_conditioning)
        with torch.no_grad():
            got = model.encode_conditioning(torch.from_numpy(audio),
                                            None if keep_mask is None else torch.from_numpy(keep_mask))
        assert got.cond_tokens.shape == (B, 198 - 48, GUIDE["latent_dim"])
        assert_scaled(got.cond_tokens.numpy(), want.cond_tokens, what=f"cond_tokens, keep {keep_mask}")
        assert_scaled(got.cond_hidden.numpy(), want.cond_hidden, what=f"cond_hidden, keep {keep_mask}")
    # the dropped clip takes the null rows, sliced to the cond length
    null = model.null_cond_embed[:, :150]
    assert torch.allclose(got.cond_tokens[1], model.norm_cond(null)[0])
    assert torch.equal(got.cond_hidden[1], model.null_cond_hidden[0])


def test_decode_logits_matches_jax(guide_setup):
    s = guide_setup
    tokens = s["rng"].randint(0, GUIDE["tokens"] + 1, (B, 11)).astype(np.int32)
    want = s["jm"].apply(s["params"], jnp.asarray(tokens), jnp.asarray(s["audio"]))
    with torch.no_grad():
        got = s["model"](torch.from_numpy(tokens).long(), torch.from_numpy(s["audio"]))
    assert got.shape == (B, 11, GUIDE["tokens"])
    assert_scaled(got.numpy(), want)


def test_forward_drops_the_conditioning_by_its_generator(guide_setup):
    model, audio = guide_setup["model"], torch.from_numpy(guide_setup["audio"])
    tokens = torch.zeros((B, 3), dtype=torch.long)
    with torch.no_grad():
        full = model(tokens, audio)
        a = model(tokens, audio, 0.5, torch.Generator().manual_seed(0))
        b = model(tokens, audio, 0.5, torch.Generator().manual_seed(0))
        null = model.decode_logits(tokens, model.encode_conditioning(audio, torch.zeros(B, dtype=torch.bool)))
    assert torch.equal(a, b)
    keep = torch.rand((B,), generator=torch.Generator().manual_seed(0)) >= 0.5
    for i in range(B):
        assert torch.allclose(a[i], (full if keep[i] else null)[i], atol=1e-5)


def test_decoder_layer_step_matches_causal_forward_and_jax():
    rng = np.random.RandomState(5)
    D, H, L, Tm = 32, 2, 9, 13
    layer = blocks.FiLMDecoderLayer(D, H, 48).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.3))
    x = rng.randn(B, L, D).astype(np.float32)
    mem = rng.randn(B, Tm, D).astype(np.float32)
    t = rng.randn(B, D).astype(np.float32)
    table = rotary.make_rotary_table(D, 64)
    with torch.no_grad():
        xs, ms, ts = (torch.from_numpy(a) for a in (x, mem, t))
        full = layer(xs, ts, rotary=table, memory=ms, self_bias=attention.causal_bias(L, L))
        ck, cv = layer.precompute_cross(ms, table)
        ks, vs = torch.full((B, L, D), 7.0), torch.full((B, L, D), -7.0)  # rows past pos are masked
        steps = torch.cat([layer.step(xs[:, i : i + 1], i, ks, vs, ck, cv, ts, table) for i in range(L)], dim=1)
    assert_scaled(steps.numpy(), full.numpy(), what="step vs forward")

    sd = {f"layer.{k}": v.numpy() for k, v in layer.state_dict().items()}
    jl = j_blocks.FiLMDecoderLayer(D, H, 48, dropout=0.0)
    for offset in (0, 5):  # rotary positions offset.. of x, the memory's from 0
        want = jl.apply({"params": film_decoder_layer(sd, "layer", use_cm=False)},
                        jnp.asarray(x), jnp.asarray(mem), jnp.asarray(t),
                        self_bias=j_attention.causal_bias(L, L)[None, None],
                        rotary=j_rotary.make_rotary_table(D, 64), x_offset=offset)
        with torch.no_grad():
            got = layer(xs, ts, rotary=table, memory=ms, self_bias=attention.causal_bias(L, L), x_offset=offset)
        assert_scaled(got.numpy(), want, what=f"forward vs JAX, offset {offset}")


def _quantised_logits(rng, rows, vocab):
    """Logits on a 1/8 grid: distinct values differ by far more than any
    rounding, and equal values tie exactly (many planted ties a row)."""
    logits = np.round(rng.randn(rows, vocab) * 2.0 * 8) / 8
    logits[0] = 0.0  # every token tied
    logits[1, ::2] = logits[1, 1]  # half the row tied with one value
    return logits.astype(np.float32)


@pytest.mark.parametrize("top_p", [0.3, 0.7, 0.94, 1.0])
def test_nucleus_probs_match_jax(top_p):
    logits = _quantised_logits(np.random.RandomState(7), 256, 32)
    j_idx, j_keep, j_kept = (np.asarray(a) for a in j_guide.nucleus_probs(jnp.asarray(logits), top_p))
    idx, keep, kept = (a.numpy() for a in guide.nucleus_probs(torch.from_numpy(logits), top_p))
    np.testing.assert_array_equal(idx, j_idx)  # JAX's order: among ties the higher index first
    assert list(idx[0]) == list(range(31, -1, -1))
    # a mismatch of the keep mask only where the strictly-previous sum lies at top_p
    j_probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    j_sorted = np.take_along_axis(j_probs, j_idx, -1)
    shifted = np.concatenate([np.zeros((256, 1), np.float32), np.cumsum(j_sorted, -1)[:, :-1]], -1)
    differ = keep != j_keep
    boundary = np.abs(shifted - top_p) <= BOUNDARY
    assert not (differ & ~boundary).any()
    rows = ~differ.any(-1)
    assert rows.sum() >= 250, f"{(~rows).sum()} rows at the boundary"
    np.testing.assert_allclose(kept[rows], j_kept[rows], atol=1e-6, rtol=0)
    assert keep[:, 0].all() and np.allclose(kept.sum(-1), 1.0, atol=1e-6)


def test_gumbel_draw_is_jaxs_categorical():
    """The installed ``jax.random.categorical`` is the Gumbel-max draw the
    port reproduces; a JAX that drew otherwise fails here, not silently."""
    logits = jnp.asarray(_quantised_logits(np.random.RandomState(8), 64, 32))
    key = jax.random.PRNGKey(12)
    want = np.asarray(jax.random.categorical(key, logits, axis=-1))
    noise = np.array(jax.random.gumbel(key, logits.shape))
    np.testing.assert_array_equal(np.argmax(noise + np.asarray(logits), -1), want)
    # and the port's nucleus_sample is the same draw through the nucleus
    sorted_idx, _, kept = j_guide.nucleus_probs(logits, 0.8)
    j_tok = np.asarray(j_guide.nucleus_sample(key, logits, 0.8))
    tok = guide.nucleus_sample(torch.from_numpy(np.array(logits)), 0.8, torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(tok, j_tok)


def test_draw_gumbel_law():
    g = guide.draw_gumbel((200_000,), torch.Generator().manual_seed(0), "cpu").double()
    assert abs(g.mean().item() - 0.5772156649) < 0.01  # Euler-Mascheroni
    assert abs(g.var().item() - np.pi**2 / 6) < 0.03


def test_nucleus_sample_empirical_distribution_matches_law():
    """The draw by law, as tests/test_models.py holds JAX's: 4096 draws from
    fixed logits with the port's own Gumbel noise reproduce the shifted
    nucleus' renormalised distribution."""
    rng = np.random.RandomState(3)
    row = (rng.randn(8) * 1.5).astype(np.float32)
    top_p, n = 0.7, 4096
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    draws = guide.nucleus_sample(logits, top_p, guide.draw_gumbel((n, 8), torch.Generator().manual_seed(11), "cpu"))
    sorted_idx, _, kept = guide.nucleus_probs(logits[:1], top_p)
    law = np.zeros(8)
    law[sorted_idx[0].numpy()] = kept[0].numpy()
    emp = np.bincount(draws.numpy(), minlength=8) / n
    assert emp[law == 0].sum() == 0.0
    for tok in np.nonzero(law)[0]:
        sigma = np.sqrt(law[tok] * (1 - law[tok]) / n)
        assert abs(emp[tok] - law[tok]) < 4 * sigma + 1e-3, (tok, emp[tok], law[tok])


@pytest.mark.parametrize("top_p,n", [(0.94, 8), (1.0, 5), (0.5, 6)])
def test_generate_cached_uncached_and_jax_agree(guide_setup, monkeypatch, top_p, n):
    s = guide_setup
    key = jax.random.PRNGKey(n)
    audio = jnp.asarray(s["audio"])
    want = {}
    for use_cache in (True, False):
        want[use_cache] = np.asarray(s["jm"].apply(s["params"], audio, n, key, top_p=top_p, use_cache=use_cache,
                                                   method=j_guide.GuideTransformer.generate))
    np.testing.assert_array_equal(want[True], want[False])
    noise = jax_gumbel_stream(key, n, (B, GUIDE["tokens"]))
    for use_cache in (True, False):
        inject(monkeypatch, noise)
        got = s["model"].generate(torch.from_numpy(s["audio"]), n, None, top_p, use_cache).numpy()
        assert got.shape == (B, n) and got.dtype == np.int64
        np.testing.assert_array_equal(got, want[True], err_msg=f"use_cache={use_cache}")


def test_generate_refuses_training_mode(guide_setup):
    model = guide_setup["model"]
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval mode"):
            model.generate(torch.from_numpy(guide_setup["audio"]), 2)
    finally:
        model.eval()


def test_guide_state_dict_round_trips_through_convert_guide(guide_setup):
    s = guide_setup
    sd = {k: v.numpy() for k, v in s["model"].state_dict().items()}
    back = convert_guide(sd, num_layers=GUIDE["num_layers"])
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(s["params"])}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(v), err_msg=path)
    # a reference checkpoint's null_cond_embed has its clips' 1998 rows:
    # loaded strictly, zero-padded to 2048 as convert_guide pads it
    short = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    short["null_cond_embed"] = short["null_cond_embed"][:, :1998].clone()
    m = guide.GuideTransformer(GuideConfig(**GUIDE))
    m.load_state_dict(short, strict=True)
    null = m.null_cond_embed.detach()
    assert null.shape == (1, guide.NULL_EMBED_LEN, GUIDE["latent_dim"])
    assert torch.equal(null[:, :1998], short["null_cond_embed"]) and not null[:, 1998:].any()
    padded = convert_guide({**sd, "null_cond_embed": short["null_cond_embed"].numpy()}, GUIDE["num_layers"])
    np.testing.assert_array_equal(padded["params"]["null_cond_embed"], null.numpy())


def test_guide_runs_in_f32_and_refuses_a_bf16_frontend():
    """The guide computes in f32 whatever ``dtype`` says, as the JAX guide
    does; its frozen frontend follows ``frontend_dtype`` (bf16 is ported, a
    dtype outside the policy is refused)."""
    assert GuideConfig().dtype == "bfloat16"  # never read by the JAX guide either: it computes in f32
    g = guide.GuideTransformer(GuideConfig(**GUIDE))
    assert g.audio_model.feature_extractor.dtype == torch.float32
    g = guide.GuideTransformer(GuideConfig(frontend_dtype="bfloat16", **GUIDE))
    assert g.audio_model.feature_extractor.dtype == torch.bfloat16
    assert all(layer.dtype == torch.float32 for layer in g.layers)
    with pytest.raises(ValueError, match="float16"):
        guide.GuideTransformer(GuideConfig(frontend_dtype="float16", **GUIDE))
