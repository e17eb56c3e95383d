"""bf16 compute in the port (core/dtypes.py: f32 parameters and optimizer
state, bf16 compute, f32 output) against the JAX package's bf16 policy, on
the CPU.

Inputs are made with numpy from a seed; weights reach the port through the
existing converters.  Each comparison runs three ways: the port in bf16, the
JAX package in bf16 and the JAX package in f32.  The two frameworks round
bf16 at places that differ a little (a fused bias add, the order of a sum),
so the port is held to the JAX package's own bf16 error: the accuracy-ratio
bar ``err(port bf16 vs JAX f32) <= 1.5 * err(JAX bf16 vs JAX f32) + 1e-3 *
scale``, and, for everything but gradients, directly ``err(port bf16 vs JAX
bf16) <= 2e-2 * scale``, with ``scale`` the largest magnitude of the JAX f32
result.  A train step's loss is held within 1e-2 relative of JAX bf16's,
and each gradient tensor to the ratio bar on its relative L2 error (the
largest error of a small tensor is the tail of a few hundred rounding draws
and moves past the bar and back from one weight seed to the next).

By default XLA keeps f32 across the ops it fuses and rounds to bf16 only
where a fusion ends; eager PyTorch rounds after every op.  Where that
difference alone decides a bar, the JAX bf16 yardstick is also compiled
with ``xla_allow_excess_precision`` off (``STRICT``), so that it rounds
after every op as the port does: the gradient tensors (the pose time
embedding's reads 1.07 of the bar against the default build and 0.89
against the strict one) and the DDIM-10 output's direct bar (the two JAX
builds themselves land 1.7% of the face model's scale apart there).

The attention's rounding points are held to the Pallas kernel in interpret
mode (as tests/test_flash_attention.py runs it): the port's plain bf16
forward and backward (``kernels/flash_attn.py``), which the bf16 CUDA
kernels are held to on the card, within 1e-2 of the largest output and of
each largest gradient, with and without the replayed hash dropout.

Sizes are small (2 layers, latent 64, 2 heads, T <= 130), with T >= 128 where
the flash gate must open on both sides.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.data import feature_cache as j_cache
from audio2photoreal_tpu.diffusion import gaussian as j_gaussian
from audio2photoreal_tpu.diffusion import losses as j_losses
from audio2photoreal_tpu.diffusion import respace as j_respace
from audio2photoreal_tpu.diffusion import sampling as j_sampling
from audio2photoreal_tpu.diffusion.schedules import make_schedule as j_make_schedule
from audio2photoreal_tpu.models import audio_encoder as j_audio
from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.models.cfg import cfg_model_fn_cached as j_cfg_cached
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.ops import rotary as j_rotary
from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.train.convert import convert_wav2vec_extractor
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.core.config import DenoiserConfig, DiffusionConfig, TrainConfig
from audio2photoreal_tpu_torch.core.dtypes import DTypePolicy, compute_dtype, default_policy
from audio2photoreal_tpu_torch.data import feature_cache
from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
from audio2photoreal_tpu_torch.diffusion import respace, sampling
from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention
from audio2photoreal_tpu_torch.models import audio_encoder, blocks
from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached
from audio2photoreal_tpu_torch.models.film_transformer import CondTokens, FiLMDenoiser
from audio2photoreal_tpu_torch.ops import rotary
from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
from audio2photoreal_tpu_torch.train.state import TrainState, trainable_parameters
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

BF16 = torch.bfloat16
RATIO, SLACK, DIRECT = 1.5, 1e-3, 2e-2
ATTN_REL = 1e-2
LR = 1e-4
STRICT = {"xla_allow_excess_precision": False}  # XLA rounds every bf16 op's result, as eager PyTorch does


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ratio(port_bf16, jax_bf16, jax_f32, what="", direct=True):
    """The accuracy-ratio bar and (unless ``direct`` is False) the direct
    bar of the head note, on the largest absolute error."""
    p, jb, jf = _np(port_bf16), _np(jax_bf16), _np(jax_f32)
    assert p.shape == jb.shape == jf.shape, what
    scale = np.abs(jf).max()
    e_port, e_jax = np.abs(p - jf).max(), np.abs(jb - jf).max()
    assert e_port <= RATIO * e_jax + SLACK * scale, f"{what}: {e_port} > {RATIO} x {e_jax} + {SLACK} x {scale}"
    if direct:
        d = np.abs(p - jb).max()
        assert d <= DIRECT * scale, f"{what}: {d} > {DIRECT} x {scale} from JAX bf16"


def _run(fn, *args, strict=False):
    """``fn`` jitted and run on ``args``; ``strict`` compiles it with
    ``STRICT``'s options."""
    lowered = jax.jit(fn).lower(*args)
    return (lowered.compile(compiler_options=STRICT) if strict else lowered.compile())(*args)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even) and back to f32, so every run
    starts from the same values."""
    return torch.from_numpy(x).to(BF16).float().numpy()


def _perturb(params, seed):
    """Nonzero biases and non-identity norms: JAX init leaves them 0 and 1."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, params)


def test_dtype_policy_is_the_jax_one():
    """core/dtypes.py: param f32, compute bf16, output f32; the name rule."""
    p = default_policy()
    assert (p.param_dtype, p.compute_dtype, p.output_dtype) == (torch.float32, BF16, torch.float32)
    assert default_policy("bf16") == p == DTypePolicy()
    assert compute_dtype("float32") == compute_dtype("f32") == torch.float32
    with pytest.raises(ValueError, match="float16"):
        default_policy("float16")


def test_layer_norm_in_bf16_is_f32_statistics_cast_once():
    """A bf16 LayerNorm computes its statistics and affine in f32 and casts
    once, as flax's LayerNorm(dtype=bf16) does; the gradient reaches the
    f32 parameters."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 7, 32).astype(np.float32) * 3 + 1).to(BF16)
    norm = torch.nn.LayerNorm(32)
    with torch.no_grad():
        norm.weight.normal_()
        norm.bias.normal_()
    got = blocks.layer_norm(norm, x, BF16)
    assert got.dtype == BF16 and torch.equal(got, norm(x.float()).to(BF16))
    got.float().sum().backward()
    assert norm.weight.grad.dtype == torch.float32


# ------------------------------------------------ the attention's rounding -- #

ATTN_CASES = [  # (Tq, Tk, kv_valid and causal, dropout)
    (40, 72, False, 0.0),
    (40, 72, False, 0.1),
    (37, 72, True, 0.0),  # a ragged Tq: 3 q-blocks of 16, the last of 5 rows
    (37, 72, True, 0.1),
]


@pytest.mark.parametrize("Tq,Tk,masked,rate", ATTN_CASES)
def test_plain_bf16_attention_rounds_as_the_pallas_kernel(Tq, Tk, masked, rate):
    B, H, Dh, block_q, seed = 2, 2, 16, 16, 12345
    rng = np.random.RandomState(Tq + int(masked) + int(10 * rate))
    q, k, v, g = (_bf16(rng.randn(B, H, T, Dh).astype(np.float32)) for T in (Tq, Tk, Tk, Tq))
    valid = (np.arange(Tk)[None] < np.array([[50], [Tk]])).astype(np.float32) if masked else None

    def jax_fn(q_, k_, v_):
        return j_flash.flash_attention(q_, k_, v_, None if valid is None else jnp.asarray(valid),
                                       jnp.asarray([seed], jnp.int32), masked, rate, block_q, True, "hash")

    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
    want, vjp = jax.vjp(jax_fn, *jb[:3])
    want_grads = vjp(jb[3])
    tq, tk, tv = (torch.from_numpy(x).to(BF16).requires_grad_() for x in (q, k, v))
    got = flash_attention(tq, tk, tv, None if valid is None else torch.from_numpy(valid), masked, rate, seed,
                          block_q)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g).to(BF16))
    assert got.dtype == BF16 and all(x.dtype == BF16 for x in grads)
    for name, a, w in [("out", got, want), *zip(("dq", "dk", "dv"), grads, want_grads)]:
        a, w = _np(a), _np(w)
        err, scale = np.abs(a - w).max(), np.abs(w).max()
        assert err <= ATTN_REL * scale, f"{name}: {err} > {ATTN_REL} x {scale}"


# ------------------------------------------------------------- modules -- #


def test_film_decoder_layer_bf16_matches_jax():
    D, H, ff, T, Tm = 64, 2, 128, 130, 140
    rng = np.random.RandomState(3)
    x, mem = _bf16(rng.randn(2, T, D).astype(np.float32)), _bf16(rng.randn(2, Tm, D).astype(np.float32))
    mem2, tv = _bf16(rng.randn(2, 5, D).astype(np.float32)), rng.randn(2, D).astype(np.float32)
    jrot = j_rotary.make_rotary_table(D, 200)
    outs = {}
    params = None
    for name, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jl = j_blocks.FiLMDecoderLayer(D, H, ff, dropout=0.0, use_cm=True, dtype=jdt, flash=True)
        a = (jnp.asarray(x, jdt), jnp.asarray(mem, jdt), jnp.asarray(tv))
        kw = dict(memory2=jnp.asarray(mem2, jdt), rotary=jrot)
        if params is None:
            params = _perturb(jax.jit(lambda key, *a_: jl.init(key, *a_, True, **kw))(jax.random.PRNGKey(0), *a), 4)
        j_flash.reset_trace_flops()
        outs[name] = jax.jit(lambda p, *a_: jl.apply(p, *a_, True, **kw))(params, *a)
        assert j_flash.trace_flops() > 0  # the Pallas kernel on the JAX side
    assert outs["bf16"].dtype == jnp.bfloat16
    sd = {}
    convert._decoder_layer(sd, "l", params["params"])
    pl = blocks.FiLMDecoderLayer(D, H, ff, use_cm=True, flash=True, dtype=BF16)
    pl.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    rot = rotary.make_rotary_table(D, 200)
    m = torch.from_numpy(mem).to(BF16)
    with torch.no_grad():
        cross_kv = pl.multihead_attn.project_kv(rotary.apply_rotary(m, rot), m)
        got = pl(torch.from_numpy(x).to(BF16), torch.from_numpy(tv), cross_kv, torch.from_numpy(mem2).to(BF16),
                 rotary=rot)
    assert got.dtype == BF16 and cross_kv[0].dtype == BF16
    _ratio(got, outs["bf16"], outs["f32"], "FiLMDecoderLayer")


def test_rotary_encoder_layer_bf16_matches_jax():
    D, H, ff, T = 64, 2, 128, 130
    x = _bf16(np.random.RandomState(5).randn(2, T, D).astype(np.float32))
    jrot = j_rotary.make_rotary_table(D, 200)
    outs, params = {}, None
    for name, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jl = j_blocks.RotaryEncoderLayer(D, H, ff, dropout=0.0, dtype=jdt, flash=True)
        if params is None:
            params = _perturb(jax.jit(lambda key, a: jl.init(key, a, rotary=jrot))(
                jax.random.PRNGKey(1), jnp.asarray(x)), 6)
        outs[name] = jax.jit(lambda p, a: jl.apply(p, a, rotary=jrot))(params, jnp.asarray(x, jdt))
    sd = {}
    convert.rotary_encoder_layer_state_dict(sd, "l", params["params"])
    pl = blocks.RotaryEncoderLayer(D, H, ff, dropout=0.0, flash=True, dtype=BF16).eval()
    pl.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pl(torch.from_numpy(x).to(BF16), rotary=rotary.make_rotary_table(D, 200))
    assert got.dtype == BF16
    _ratio(got, outs["bf16"], outs["f32"], "RotaryEncoderLayer")


@pytest.fixture(scope="module")
def frontend_params():
    torch.manual_seed(0)
    fe = audio_encoder.Wav2VecFeatureExtractor()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for p in fe.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    sd = fe.state_dict()
    return sd, {"params": {"feature_extractor": convert_wav2vec_extractor(
        {k: v.numpy() for k, v in sd.items()}, "feature_extractor")}}


@pytest.mark.parametrize("n_valid", [None, np.array([9600, 7000])], ids=["raw", "n_valid"])
def test_bf16_frontend_matches_jax(frontend_params, n_valid):
    """The frozen wav2vec frontend on bf16 convs (f32 sums), f32 group-norm
    moments (masked by ``n_valid``), features out in f32."""
    sd, params = frontend_params
    audio = (np.random.RandomState(2).randn(2, 9600, 2) * 0.3).astype(np.float32)
    if n_valid is not None:
        audio[1, 7000:] = 0.0
    nv = None if n_valid is None else jnp.asarray(n_valid)
    outs = {name: jax.jit(j_audio.Wav2VecFeatureExtractor(compute_dtype=name).apply)(params, jnp.asarray(audio), nv)
            for name in ("float32", "bfloat16")}
    pm = audio_encoder.Wav2VecFeatureExtractor(compute_dtype="bfloat16")
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(audio), None if n_valid is None else torch.from_numpy(n_valid))
    assert got.dtype == torch.float32 and got.shape == (2, 18, 1024)
    _ratio(got, outs["bfloat16"], outs["float32"], "frontend")


def test_bf16_feature_cache_matches_jax(frontend_params):
    """The feature cache built with the bf16 frontend (as train() builds it
    when ``frontend_dtype`` says bf16), against the JAX package's builds."""
    sd, params = frontend_params
    rng = np.random.RandomState(9)
    audios = [(rng.randn(66 * 1600, 2) * 0.3).astype(np.float32), (rng.randn(40 * 1600, 2) * 0.3).astype(np.float32)]
    norm = lambda a: a  # noqa: E731
    kw = dict(seg_tokens=64, verbose=False)
    jx = {name: j_cache.build_audio_feature_cache(
        j_cache.make_frontend_apply(j_audio.Wav2VecFeatureExtractor(compute_dtype=name), params["params"]),
        audios, norm, **kw) for name in ("float32", "bfloat16")}
    model = FiLMDenoiser(DenoiserConfig(max_seq_length=66, frontend_dtype="bfloat16", dtype="bfloat16"))
    model.audio_model.load_state_dict(sd, strict=True)
    got = feature_cache.build_audio_feature_cache(feature_cache.make_frontend_apply(model.audio_model.eval()),
                                                  audios, norm, **kw)
    assert len(got.features) == 2
    for i in range(2):
        _ratio(got.features[i], jx["bfloat16"].features[i], jx["float32"].features[i], f"scene {i}")
    _ratio(got.silence, jx["bfloat16"].silence, jx["float32"].silence, "silence")


# ------------------------------------------- the denoisers, encode to DDIM -- #

T = 128
POSE = dict(data_format="pose", nfeats=104, latent_dim=64, ff_size=128, num_layers=2, num_heads=2,
            max_seq_length=T, dropout=0.0, flash_attention=True)
TF = 129  # a multiple of 3 above the 128 gate (the cache's grid: 428 cond tokens)
FACE = dict(data_format="face", nfeats=256, latent_dim=64, ff_size=128, num_layers=2, num_heads=2,
            max_seq_length=TF, dropout=0.0, flash_attention=True)


def _jax_params(cfg, seed):
    """Perturbed JAX params of a denoiser config."""
    jm = JDenoiser(j_config.DenoiserConfig(**cfg))
    B, Tm = 2, cfg["max_seq_length"]
    extra = (jnp.zeros((B, 5, 104)), jnp.ones((B, 5))) if cfg["data_format"] == "pose" else ()
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed), "cond_drop": jax.random.PRNGKey(seed + 1)},
                              jnp.zeros((B, Tm, cfg["nfeats"])), jnp.zeros((B,), jnp.int32),
                              jnp.zeros((B, Tm * 1600, 2)), *extra)
    return _perturb(params, seed + 2)


def _port(cfg, params, **overrides):
    pm = FiLMDenoiser(DenoiserConfig(**{**cfg, **overrides}))
    pm.load_state_dict(convert.film_denoiser_state_dict_from_jax(params, cfg["data_format"], cfg["num_layers"]),
                       strict=True)
    return pm.eval()


@pytest.mark.parametrize("cfg", [POSE, FACE], ids=["pose", "face"])
def test_bf16_encode_cfg_ddim_matches_jax(cfg):
    """encode_conditioning, the CFG cache, one cached denoise step and
    DDIM-10 with cached CFG at guidance 2.0 from one x_T.  The frozen
    frontends' outputs are handed in (``audio_features``, ``lip_verts``: the
    frontend's bf16 path has its own test, and generate runs it in f32), and
    the attention takes the einsum path on both sides (the kernels' rounding
    points have their own test): the Pallas kernel in interpret mode inside
    a 10-step scan would take minutes.  A bf16 model's cond tokens and cache
    stay bf16 and its output is f32.

    Both bars hold on every output.  The DDIM-10 output is held directly to
    the JAX bf16 build that rounds after every op (``STRICT``): the default
    build and the strict one land 1.7% of the face model's scale apart there
    (10 steps that feed each output back), so the 2e-2 bar measures the
    rounding model against it, and the port rounds as the strict build."""
    cfg = {**cfg, "flash_attention": False}
    params = _jax_params(cfg, 11)
    Tm, nf, B = cfg["max_seq_length"], cfg["nfeats"], 2
    rng = np.random.RandomState(4)
    feats = rng.rand(B, audio_encoder.feature_frames(Tm * 1600 // 3), 1024).astype(np.float32)
    x_T = rng.randn(B, Tm, nf).astype(np.float32)
    pose = cfg["data_format"] == "pose"
    kf, kv = rng.randn(B, 5, 104).astype(np.float32), np.array([[1, 1, 1, 1, 0], [1] * 5], np.float32)
    lip = None if pose else rng.randn(B, Tm, 1014).astype(np.float32)
    keep, t = np.array([True, False]), np.array([500, 20])
    cond_args = (jnp.asarray(kf), jnp.asarray(kv)) if pose else (None, None)
    outs = {}
    for key, name, strict in (("float32", "float32", False), ("bfloat16", "bfloat16", False),
                              ("strict", "bfloat16", True)):
        jm = JDenoiser(j_config.DenoiserConfig(**{**cfg, "dtype": name}))

        def run(f, x, *c, jm=jm):
            cond = jm.apply(params, None, *c[:2], audio_features=f, lip_verts=None if pose else c[2],
                            method=JDenoiser.encode_conditioning)
            cache = jm.apply(params, cond, jnp.asarray(keep), method=JDenoiser.build_cond_cache)
            step = jm.apply(params, x, jnp.asarray(t), cache, method=JDenoiser.denoise_cached)
            fn = j_cfg_cached(jm, params, cond, 2.0)
            sched = j_respace.maybe_respaced("cosine", 1000, "ddim10")
            ddim = j_sampling.ddim_sample_loop(sched, "xstart", fn, x, jax.random.PRNGKey(0)).pred_xstart
            return cond.cond_tokens, cache["ks"], cache["vs"], step, ddim

        outs[key] = _run(run, jnp.asarray(feats), jnp.asarray(x_T), *cond_args,
                         *(() if pose else (jnp.asarray(lip),)), strict=strict)
    pm = _port(cfg, params, dtype="bfloat16")
    with torch.no_grad():
        kw = dict(audio_features=torch.from_numpy(feats))
        if pose:
            cond = pm.encode_conditioning(None, torch.from_numpy(kf), torch.from_numpy(kv), **kw)
        else:
            cond = pm.encode_conditioning(None, lip_verts=torch.from_numpy(lip), **kw)
        cache = pm.build_cond_cache(cond, torch.from_numpy(keep))
        step = pm.denoise_cached(torch.from_numpy(x_T), torch.from_numpy(t), cache)
        fn = cfg_model_fn_cached(pm, cond, 2.0)
        sched = respace.maybe_respaced("cosine", 1000, "ddim10")
        ddim = sampling.ddim_sample_loop(sched, "xstart", fn, torch.from_numpy(x_T)).pred_xstart
    assert cond.cond_tokens.dtype == cache["ks"].dtype == cache["vs"].dtype == BF16
    assert step.dtype == ddim.dtype == torch.float32 and torch.isfinite(ddim).all()
    got = (cond.cond_tokens, cache["ks"], cache["vs"], step, ddim)
    for i, what in enumerate(("cond_tokens", "ks", "vs", "denoise_cached", "DDIM-10")):
        _ratio(got[i], outs["bfloat16"][i], outs["float32"][i], f"{cfg['data_format']} {what}",
               direct=what != "DDIM-10")
    _ratio(got[4], outs["strict"][4], outs["float32"][4], f"{cfg['data_format']} DDIM-10 (strict)")


# ------------------------------------------------------ one bf16 train step -- #


def _train_batch(cfg, cached, seed):
    rng = np.random.RandomState(seed)
    Tm, B = cfg["max_seq_length"], 2
    mask = np.ones((B, Tm), np.float32)
    mask[1, 100:] = 0.0
    b = {"motion": rng.randn(B, Tm, cfg["nfeats"]).astype(np.float32) * mask[..., None], "mask": mask}
    if cfg["data_format"] == "pose":
        b["keyframes"] = rng.randn(B, 5, 104).astype(np.float32)
        b["keyframe_valid"] = np.array([[1, 1, 1, 1, 0], [1] * 5], np.float32)
    if cached:
        b["audio_features"] = rng.rand(B, tokens_for_frames(Tm), 1024).astype(np.float32)
        b["lip_verts"] = rng.randn(B, Tm, 1014).astype(np.float32)
    else:
        b["audio"] = (rng.randn(B, Tm * 1600, 2) * 0.3).astype(np.float32)
    return b


@pytest.fixture(scope="module", params=[("pose", False), ("face", True)], ids=["pose_raw", "face_cached"])
def bf16_step(request):
    """One deterministic step (dropout off) from the same weights, batch, t
    and noise: JAX f32, JAX bf16 as built by default and with ``STRICT``
    (both frontends bf16 where they run), and the port's
    ``diffusion_train_step`` in bf16."""
    fmt, cached = request.param
    cfg = POSE if fmt == "pose" else FACE
    params = _jax_params(cfg, 21)
    b = _train_batch(cfg, cached, 5)
    t = np.array([37, 912])
    noise = np.random.RandomState(6).randn(2, cfg["max_seq_length"], cfg["nfeats"]).astype(np.float32)
    jsched = j_make_schedule("cosine", 1000)
    get = lambda k: jnp.asarray(b[k]) if k in b else None  # noqa: E731
    jax_runs = {}
    for key, name, strict in (("float32", "float32", False), ("bfloat16", "bfloat16", False),
                              ("strict", "bfloat16", True)):
        jm = JDenoiser(j_config.DenoiserConfig(**{**cfg, "dtype": name, "frontend_dtype": name}))

        def loss_fn(p, jm=jm):
            x0, tt = jnp.asarray(b["motion"]), jnp.asarray(t, jnp.int32)
            xt = j_gaussian.q_sample(jsched, x0, tt, jnp.asarray(noise))
            out = jm.apply(p, xt, tt, get("audio"), get("keyframes"), get("keyframe_valid"), cond_drop_prob=0.0,
                           deterministic=True, audio_features=get("audio_features"), lip_verts=get("lip_verts"))
            return j_losses.training_losses(jsched, "xstart", out, x0, xt, tt, jnp.asarray(b["mask"])[..., None])[
                "loss"].mean()

        loss, grads = _run(jax.value_and_grad(loss_fn), params, strict=strict)
        jax_runs[key] = (float(loss), convert.film_denoiser_state_dict_from_jax(grads, fmt, cfg["num_layers"]))
    pm = _port(cfg, params, dtype="bfloat16", frontend_dtype="bfloat16")
    before = [p.detach().clone() for p in pm.parameters()]
    state = TrainState(pm, TrainConfig(lr=LR))
    metrics, _ = diffusion_train_step(state, make_schedule().to_device("cpu"), DiffusionConfig(cond_drop_prob=0.0),
                                      {k: torch.from_numpy(v) for k, v in b.items()}, t=torch.from_numpy(t),
                                      noise=torch.from_numpy(noise))
    return dict(fmt=fmt, cfg=cfg, pm=pm, state=state, metrics=metrics, jax=jax_runs, before=before)


def test_bf16_step_loss_matches_jax(bf16_step):
    s = bf16_step
    assert s["metrics"]["skipped_nonfinite"] == 0.0
    np.testing.assert_allclose(s["metrics"]["loss"], s["jax"]["bfloat16"][0], rtol=1e-2)


def test_bf16_step_gradients_match_jax(bf16_step):
    """Each trainable tensor's gradient by the ratio bar on its relative L2
    error, against the strict JAX bf16 build, and all of them as one vector
    against the default build."""
    s = bf16_step
    pm = s["pm"]
    js, jb, jf = s["jax"]["strict"][1], s["jax"]["bfloat16"][1], s["jax"]["float32"][1]
    trainable = {id(p) for p in trainable_parameters(pm)}
    got, want_b, want_f = [], [], []
    for name, p in pm.named_parameters():
        if id(p) not in trainable:  # the frozen frontends
            assert p.grad is None, name
            continue
        assert p.grad.dtype == torch.float32, name  # the gradient reaches the f32 parameter through the casts
        assert torch.isfinite(p.grad).all(), name
        g, f = _np(p.grad).ravel(), _np(jf[name]).ravel()
        ref = max(np.linalg.norm(f), 1e-30)  # the null embeddings' gradients are 0 without the cond drop
        e_port, e_jax = np.linalg.norm(g - f) / ref, np.linalg.norm(_np(js[name]).ravel() - f) / ref
        assert e_port <= RATIO * e_jax + SLACK, f"gradient of {name}: {e_port} > {RATIO} x {e_jax} + {SLACK}"
        got.append(g)
        want_b.append(_np(jb[name]).ravel())
        want_f.append(f)
    assert len(got) > 20
    g, b, f = (np.concatenate(x) for x in (got, want_b, want_f))
    e_port, e_jax = np.linalg.norm(g - f) / np.linalg.norm(f), np.linalg.norm(b - f) / np.linalg.norm(f)
    assert e_port <= RATIO * e_jax + SLACK, f"gradient: {e_port} > {RATIO} x {e_jax} + {SLACK}"


def test_params_and_adamw_state_stay_f32_after_a_bf16_step(bf16_step):
    """As JAX tests/test_precision.py:36-41: parameters (and here the AdamW
    moments) are f32 after a bf16 step, and the step moved them."""
    state = bf16_step["state"]
    assert state.step == 1
    for p in state.model.parameters():
        assert p.dtype == torch.float32
    moments = [v for st in state.optimizer.state.values() for v in st.values() if isinstance(v, torch.Tensor)
               and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    moved = [(a - b).abs().max().item() for a, b in zip(state.model.parameters(), bf16_step["before"])]
    assert max(moved) > 0 and max(moved) <= 2 * LR


# ------------------------------------------- train() and generate() in bf16 -- #


@pytest.fixture(scope="module")
def people(tmp_path_factory):
    """A synthetic person of eight 128-frame scenes and one of seven
    129-frame scenes."""
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person

    pose, face = (str(tmp_path_factory.mktemp(n)) for n in ("bf16_pose", "bf16_face"))
    make_synthetic_person(pose, "SYNTH01", num_scenes=8, frames_per_scene=T, seed=3)
    make_synthetic_person(face, "SYNTH01", num_scenes=7, frames_per_scene=TF, seed=4)
    return {"pose": pose, "face": face}


@pytest.mark.parametrize("fmt,cached", [("pose", False), ("pose", True), ("face", True)],
                         ids=["pose_raw", "pose_cached", "face_cached"])
def test_bf16_train_then_generate(people, tmp_path, fmt, cached):
    """``train()`` at the JAX package's bf16 point (``dtype`` and
    ``frontend_dtype`` bf16, flash attention, hash dropout) for two steps,
    then ``generate`` of the save dir: the sidecar records both dtypes in
    the JAX format, parameters stay f32, and generate samples in bf16 with
    the frontend forced to f32."""
    from audio2photoreal_tpu_torch.apps import generate, train_diffusion
    from audio2photoreal_tpu_torch.core.config import DataConfig

    # the feature cache's crops are multiples of 3 frames: cached runs take the 129-frame person
    person, Tm = (people["face"], TF) if cached else (people["pose"], T)
    model = dict(latent_dim=64, ff_size=128, num_layers=1, num_heads=1, max_seq_length=Tm, flash_attention=True,
                 hash_dropout=True, dtype="bfloat16", frontend_dtype="bfloat16")
    if fmt == "face":
        model.update(data_format="face", nfeats=256, latent_dim=32, ff_size=64, cond_encoder_layers=1)
    run = str(tmp_path / "run")
    timings = {}
    state = train_diffusion.train(
        person, run, DenoiserConfig(**model), DiffusionConfig(),
        DataConfig(person="SYNTH01", data_format=fmt, max_seq_length=Tm, min_seq_length=90, batch_size=2),
        TrainConfig(num_steps=2, log_interval=1, save_interval=1000, seed=5), cache_audio_features=cached,
        device="cpu", timings=timings)
    assert state.step == 2 and len(timings["step_s"]) == 2 and ("cache_s" in timings) == cached
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert state.model.audio_model.feature_extractor.dtype == BF16
    saved = j_config.load_config(run)["denoiser"]  # the JAX package reads the sidecar
    assert (saved.dtype, saved.frontend_dtype) == ("bfloat16", "bfloat16")
    loaded = generate.load_model(run, "cpu")
    assert loaded.dtype == BF16 and loaded.audio_model.feature_extractor.dtype == torch.float32
    res = np.load(generate.generate(run, person, num_samples=1, timestep_respacing="ddim2", device="cpu",
                                    output_dir=str(tmp_path / "samples")), allow_pickle=True).item()
    assert res["motions"].shape == (1, 104 if fmt == "pose" else 256, 1, Tm)
    assert res["motions"].dtype == np.float32 and np.isfinite(res["motions"]).all()


def test_sampling_keeps_each_cast_until_its_parameter_changes():
    """Without autograd a bf16 model casts each weight (and the stacked
    cross K/V) once and reuses the cast, until the parameter changes in
    place: then the output is a fresh model's with the new weights."""
    cfg = DenoiserConfig(**{**POSE, "flash_attention": False, "dtype": "bfloat16"})
    model = FiLMDenoiser(cfg).eval()
    model.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.RandomState(7)
    cond = CondTokens(torch.from_numpy(rng.randn(2, 40, 64).astype(np.float32)),
                      torch.from_numpy(rng.randn(2, 5, 64).astype(np.float32)))
    x, t = torch.from_numpy(rng.randn(2, T, 104).astype(np.float32)), torch.tensor([5, 700])
    keep = torch.ones(2, dtype=torch.bool)
    with torch.no_grad():
        first = model.denoise(x, t, cond, keep)
        cached = model.layers[0].linear1.__dict__["_casts"]["weight"][1]
        assert torch.equal(model.denoise(x, t, cond, keep), first)
        assert model.layers[0].linear1.__dict__["_casts"]["weight"][1] is cached  # reused, not recast
        for p in model.parameters():
            p.mul_(0.9)
        changed = model.denoise(x, t, cond, keep)
    fresh = FiLMDenoiser(cfg).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(changed, fresh.denoise(x, t, cond, keep)) and not torch.equal(changed, first)
    # under autograd every cast is fresh, so the gradient reaches the f32 parameters
    model.denoise(x, t, cond, keep).float().square().mean().backward()
    assert model.layers[0].linear1.weight.grad is not None
