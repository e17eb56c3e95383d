"""Traffic of kind ``sample``: batch generation, the sequence of
``apps/generate.py:generate`` after its load, call after call.

A call takes ``clips`` clips of ``frames`` frames of audio (z-normalised
48 kHz stereo, drawn on the device from the run's seed and the call's
index) and runs, for a configuration with a guide, ``GuideKeyframer``
(nucleus sampling at ``top_p``, the VQ decode), for a face configuration
``lip_vertices``, then ``encode_conditioning``, ``cfg_model_fn_cached`` at
the configuration's guidance and ``ddim_sample_loop`` at ``respacing``; the
answer is the last step's x0 estimate, read back to the host.  Set-up
builds the models with the weights made from the seed and warms the shapes
up with one call at ``warmup_respacing``.  The window runs whole calls
until ``seconds`` have passed.

What the check reads is recorded on the way without a read-back: the
guide's logits at every token step (a hook on its output layer) and its
tokens, the keyframes, lip vertices and conditioning the call produced,
and at ``checked_steps`` DDIM steps of each call (drawn from the seed, the
last always among them) the model function's input and output and the
next step's input.  After the window, for ``checked_calls`` of the calls
(drawn from the seed), the reference (f32) works the same out again from
the call's audio, the served tokens and the program's DDIM state at each
checked step, and each served token has to lie in the nucleus of the
reference's logits at its step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, inputs
from portbench.counters import film as film_count

AUDIO_PER_FRAME = 1600
WARMUP_CALL = 2**31  # the warm-up call's index, never a window call's


def _models(cfg: dict, point: dict, seed: int, dev):
    from audio2photoreal_tpu_torch.apps.generate import GuideKeyframer
    from audio2photoreal_tpu_torch.core.config import DenoiserConfig, GuideConfig, VQConfig
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
    from audio2photoreal_tpu_torch.models.guide import GuideTransformer
    from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec

    with torch.device(dev):
        model = FiLMDenoiser(DenoiserConfig(**{**cfg["denoiser"], **point["denoiser"]}))
    inputs.load_weights(model, inputs.sub_seed(seed, 3), dev)
    keyframer = None
    if "guide" in cfg:
        keyframer = object.__new__(GuideKeyframer)  # the CLI's keyframer, its models made here, not loaded
        with torch.device(dev):
            keyframer.guide = GuideTransformer(GuideConfig(**cfg["guide"]))
            keyframer.codec = TemporalVertexCodec(VQConfig(**cfg["vq"]))
        inputs.load_weights(keyframer.guide, inputs.sub_seed(seed, 4), dev)
        inputs.load_weights(keyframer.codec, inputs.sub_seed(seed, 5), dev)
        keyframer.guide.eval(), keyframer.codec.eval()
    return model.eval(), keyframer


def call_audio(seed: int, call: int, clips: int, frames: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(seed, 10, call))
    return torch.randn((clips, frames * AUDIO_PER_FRAME, 2), generator=g, device=dev)


def checked_steps(seed: int, call: int, steps: int, count: int) -> set:
    """Model-function calls (0 = the first DDIM step) whose state the check
    reads: the last one and ``count - 1`` others drawn from the seed."""
    rng = np.random.RandomState(inputs.sub_seed(seed, 11, call) % 2**32)
    return {steps - 1, *rng.choice(steps - 1, count - 1, replace=False).tolist()}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> harness.Run:
    from audio2photoreal_tpu_torch.apps.generate import draw_noise
    from audio2photoreal_tpu_torch.diffusion import sampling
    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    tr, cfg = cell.traffic, cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    B, T = tr["clips"], tr["frames"]
    guidance, predict = cfg["sampling"]["guidance"], cfg["diffusion"]["predict"]
    model, keyframer = _models(cfg, tr["point"], seed, dev)
    pose = model.cfg.data_format == "pose"
    n_kf = -(-T // model.cfg.keyframe_step)
    spans = harness.Spans(trace, sync)
    records: list = []

    if keyframer is not None:
        logits: list = []
        keyframer.guide.final_layer.register_forward_hook(lambda mod, args, out: logits.append(out))
        tokens: list = []
        generate = keyframer.guide.generate
        keyframer.guide.generate = lambda *a, **k: tokens.append(generate(*a, **k)) or tokens[-1]

    def one_call(k: int, sched, checked=frozenset()):
        rec = {"call": k}
        audio = call_audio(seed, k, B, T, dev)
        g = torch.Generator(device=dev).manual_seed(inputs.sub_seed(seed, 12, k))
        kf = kv = lip = None
        if keyframer is not None:
            logits.clear(), tokens.clear()
            with spans("keyframer"):
                kf = keyframer(audio, n_kf, torch.Generator(device=dev).manual_seed(inputs.sub_seed(seed, 13, k)),
                               tr["top_p"])
                kv = torch.ones(kf.shape[:2], device=dev)
            rec.update(logits=torch.stack(logits, 1), tokens=tokens[0], keyframes=kf)
        with spans("encode"):
            if not pose:
                lip = model.lip_vertices(audio)
            cond = model.encode_conditioning(audio, kf, kv, lip_verts=lip)
        rec.update(lip=lip, cond=cond)
        xT = draw_noise((B, T, model.cfg.nfeats), g, dev)
        fn = cfg_model_fn_cached(model, cond, guidance)
        steps, calls = [], [0]

        def recorded(x, t):
            c = calls[0]
            calls[0] += 1
            if c - 1 in checked:
                steps[-1]["next"] = x.clone()
            out = fn(x, t)
            if c in checked:
                steps.append({"i": sched.num_timesteps - 1 - c, "x": x.clone(), "t": t.clone(), "out": out.clone()})
            return out

        with spans("ddim"):
            res = sampling.ddim_sample_loop(sched, predict, recorded, xT)
            answer = res.pred_xstart.cpu()
        if steps and steps[-1]["i"] == 0:
            steps[-1]["next"] = res.pred_xstart
        rec["steps"] = steps
        rec["finite"] = bool(torch.isfinite(answer).all())
        return rec

    warm = maybe_respaced("cosine", 1000, tr["warmup_respacing"])
    with torch.no_grad():
        one_call(WARMUP_CALL, warm)
    sync()
    spans.clear()
    setup_s = time.perf_counter() - t0

    sched = maybe_respaced("cosine", 1000, tr["respacing"])
    n_steps = sched.num_timesteps
    with torch.no_grad(), harness.profiled(trace) as prof:
        w0 = time.perf_counter()
        k = 0
        with spans("window", sync=False):
            while True:
                records.append(one_call(k, sched, checked_steps(seed, k, n_steps, tr["checked_steps"])))
                k += 1
                if time.perf_counter() - w0 >= seconds:
                    break
        wall = time.perf_counter() - w0
    summary = harness.reduce_trace(prof, spans.ranges) if prof is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    out = harness.Run(seconds=wall, setup_s=setup_s, attempted=k, failed=sum(not r["finite"] for r in records),
                      dtype=model.cfg.dtype, trace=summary)
    out.work = {"calls": k, "audio_s": k * B * T / 30.0, "ddim_steps": k * n_steps}
    out.spans = dict(spans.total)
    out.flops = film_count.sample_call_flops(model.cfg, keyframer, B, T, n_steps, scale=k)
    out.attention = [(kind, shape, k * count) for kind, shape, count in film_count.sample_attention(model.cfg, B, T,
                                                                                                    n_steps)]
    out.device = {"memory_peak_bytes": int(peak)}
    rng = np.random.RandomState(inputs.sub_seed(seed, 14) % 2**32)
    chosen = sorted(rng.choice(k, min(k, tr["checked_calls"]), replace=False).tolist())
    kept = [records[c] for c in chosen]
    del records, model, keyframer, one_call
    if cuda:
        torch.cuda.empty_cache()
    out.checks = check(cell, seed, kept, dev)
    return out


def reference_models(cell: harness.Cell, seed: int, dev):
    from portbench.reference import steps as ref
    from portbench.reference.config import DenoiserConfig, GuideConfig, VQConfig

    cfg = cell.config
    section = {**cfg["denoiser"], **cell.traffic["point"]["denoiser"], "dtype": "float32", "frontend_dtype": "float32"}
    weights = lambda sub: (lambda m: inputs.make_weights(m, inputs.sub_seed(seed, sub), dev))  # noqa: E731
    model = ref.build(ref.FiLMDenoiser, DenoiserConfig(**section), weights(3), dev)
    guide = codec = None
    if "guide" in cfg:
        guide = ref.build(ref.GuideTransformer, GuideConfig(**cfg["guide"]), weights(4), dev)
        codec = ref.build(ref.TemporalVertexCodec, VQConfig(**cfg["vq"]), weights(5), dev)
    return model, guide, codec


def reference_outputs(cell: harness.Cell, seed: int, records: list, dev, models, precision=None) -> list:
    """What the reference (or, with ``precision``, the control) computes for
    each checked call, in the shape ``program_outputs`` gives the program's."""
    from portbench.reference import steps as ref

    model, guide, codec = models
    tr, cfg = cell.traffic, cell.config
    st = ref.ddim_schedule(tr["respacing"], dev)
    out = []
    for r in records:
        audio = call_audio(seed, r["call"], tr["clips"], tr["frames"], dev)
        o, kf = {}, None
        if guide is not None:
            o["guide_logits"], kf = ref.keyframes(guide, codec, audio, r["tokens"], precision)
            o["keyframes"] = kf
        lip, cond = ref.encode(model, audio, kf, precision)
        if lip is not None:
            o["lip_vertices"] = lip
        o["conditioning"] = [t for t in cond if t is not None]
        pairs = ref.check_ddim(model, cond, cfg["sampling"]["guidance"], st, cfg["diffusion"]["predict"], r["steps"],
                               precision)
        o["denoiser"], o["ddim_update"] = [p[0] for p in pairs], [p[1] for p in pairs]
        out.append(o)
    return out


def program_outputs(records: list) -> list:
    out = []
    for r in records:
        o = {"conditioning": [t for t in r["cond"] if t is not None],
             "denoiser": [s["out"] for s in r["steps"]], "ddim_update": [s["next"] for s in r["steps"]]}
        if "logits" in r:
            o.update(guide_logits=r["logits"], keyframes=r["keyframes"])
        if r["lip"] is not None:
            o["lip_vertices"] = r["lip"]
        out.append(o)
    return out


def compare(got: list, want: list) -> dict:
    """Per stage, the largest gap over the checked calls (and steps), each
    over the reference's largest magnitude."""
    from portbench.reference.steps import rel

    numbers: dict = {}
    for g, w in zip(got, want):
        for k, wv in w.items():
            pairs = zip(g[k], wv) if isinstance(wv, list) else [(g[k], wv)]
            numbers[k] = max([numbers.get(k, 0.0)] + [rel(a, b) for a, b in pairs])
    return numbers


def tokens_outside(cell: harness.Cell, records: list, logits: list) -> dict:
    """``guide_tokens``: the share of the checked calls' served tokens that
    the nucleus at the traffic's ``top_p`` of ``logits`` (one [B, N, V] per
    call) leaves out; empty without a guide."""
    from portbench.reference.steps import outside_nucleus

    if not records or "tokens" not in records[0]:
        return {}
    shares = [outside_nucleus(lg, r["tokens"], cell.traffic["top_p"]) for r, lg in zip(records, logits)]
    return {"guide_tokens": max(shares)}


def numbers(cell: harness.Cell, seed: int, records: list, dev) -> dict:
    """The numbers the check compares: each stage's largest gap from the
    reference, and the served tokens against the reference's nucleus."""
    want = reference_outputs(cell, seed, records, dev, reference_models(cell, seed, dev))
    got = compare(program_outputs(records), want)
    got.update(tokens_outside(cell, records, [w["guide_logits"] for w in want if "guide_logits" in w]))
    return got


def check(cell: harness.Cell, seed: int, records: list, dev):
    got = numbers(cell, seed, records, dev)
    return [(k, got[k], limit) for k, limit in cell.limits.items()]
