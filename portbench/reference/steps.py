"""What the reference computes for a check: training steps, guided
denoiser outputs, DDIM updates, keyframes.

Everything runs in f32 (the caller turns TF32 off), or under
``precision.Products`` for the control.  The models are this package's
frozen copies, loaded with the state dict the benchmark made from the seed.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench.reference import rows
from portbench.reference.film_transformer import CondTokens, FiLMDenoiser
from portbench.reference.gaussian import model_prediction_to_x0, predict_eps_from_x0, q_sample
from portbench.reference.guide import GuideTransformer
from portbench.reference.losses import training_losses
from portbench.reference.precision import Products
from portbench.reference.respace import maybe_respaced
from portbench.reference.schedules import extract, make_schedule
from portbench.reference.vqvae import TemporalVertexCodec
from portbench.reference.data import Person, step_seed

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def build(cls, cfg, weights: Callable[[torch.nn.Module], Dict[str, torch.Tensor]], device) -> torch.nn.Module:
    """``cls(cfg)`` on ``device`` in eval mode with the state dict
    ``weights(module)`` makes for it."""
    with torch.device(device):
        model = cls(cfg)
    model.load_state_dict(weights(model), strict=True)
    return model.eval()


def leaf_norms(named) -> Dict[str, float]:
    """The L2 norm of each leaf: every tensor of ``named`` ((name, tensor)
    pairs), a packed attention projection (``in_proj_*``, rows q | k | v)
    split into its three projections, which the reference architecture
    holds apart."""
    out = {}
    for n, t in named:
        if n.rsplit(".", 1)[-1].startswith("in_proj_"):
            for part, chunk in zip("qkv", t.detach().chunk(3, dim=0)):
                out[f"{n}.{part}"] = float(chunk.norm())
        else:
            out[n] = float(t.detach().norm())
    return out


def _mode(precision: Optional[str]):
    return Products(precision) if precision else contextlib.nullcontext()


def train_steps(model: FiLMDenoiser, person: Person, *, seed: int, steps: int, batch: int, min_len: int,
                max_len: int, lr: float, cond_drop_prob: float, device, block_rows: int,
                precision: Optional[str] = None, drop_half: bool = False) -> dict:
    """``steps`` AdamW steps of the face trainer on cached features from the
    model's weights -> {"loss": [per step], "grad": {leaf: norm of step 1's
    gradient}, "change": {leaf: norm of the parameters' change}}.  Each
    step's draws (t, noise, guidance and dropout masks) come from
    generators seeded by (seed, step), the batch's rows in blocks of
    ``block_rows``.  ``drop_half`` computes the loss over the first half of
    the batch only (a fault, for the check's own test)."""
    sched = make_schedule().to_device(device)
    T = sched.num_timesteps
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = torch.optim.AdamW([p for _, p in named], lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0,
                            foreach=False)
    start = {n: p.detach().clone() for n, p in named}
    model.train()
    losses, grads = [], {}
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device) for k, v in person.face_batch(seed, i, batch, min_len, max_len).items()}
        s = step_seed(seed, i)
        x0 = b["motion"]
        B = x0.shape[0]
        used = B // 2 if drop_half else B
        noise = torch.randn(x0.shape, generator=torch.Generator(device=device).manual_seed(s), device=device)
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for r0 in range(0, used, block_rows):
            r1 = min(used, r0 + block_rows)
            gen = torch.Generator().manual_seed(s)
            t = torch.randint(0, T, (B,), generator=gen).to(device)
            with rows.block(r0, B), _mode(precision):
                xt = q_sample(sched, x0[r0:r1], t[r0:r1], noise[r0:r1])
                out = model(xt, t[r0:r1], None, cond_drop_prob=cond_drop_prob, generator=gen,
                            audio_features=b["audio_features"][r0:r1], lip_verts=b["lip_verts"][r0:r1])
                frames = torch.arange(x0.shape[1], device=device)
                valid = (frames[None] < b["lengths"][r0:r1].reshape(-1, 1)).float()[..., None]
                terms = training_losses(sched, "xstart", out, x0[r0:r1], xt, t[r0:r1], b["mask"][r0:r1, :, None],
                                        vel_mask=valid)
                loss = terms["loss"].sum() / used
                loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if i == 0:
            grads = leaf_norms((n, p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in named)
        opt.step()
    change = leaf_norms((n, p.detach() - start[n]) for n, p in named)
    return {"loss": losses, "grad": grads, "change": change}


def guided(model: FiLMDenoiser, cond: CondTokens, scale: float):
    """The classifier-free-guided model function: both branches stacked on
    the batch, the conditioning's step-invariant work done once."""
    B = cond.cond_tokens.shape[0]
    keep = torch.zeros(2 * B, dtype=torch.bool, device=cond.cond_tokens.device)
    keep[:B] = True
    both = CondTokens(torch.cat([cond.cond_tokens] * 2),
                      None if cond.pose_tokens is None else torch.cat([cond.pose_tokens] * 2))
    cache = model.build_cond_cache(both, keep)

    def fn(x, t):
        out = model.denoise_cached(torch.cat([x, x]), torch.cat([t, t]), cache)
        c, u = out[:B], out[B:]
        return u + scale * (c - u)

    return fn


def ddim_schedule(respacing: str, device):
    return maybe_respaced("cosine", 1000, respacing).to_device(device)


def ddim_step(st, predict: str, out: torch.Tensor, x: torch.Tensor, i: int):
    """DDIM (eta 0) from x at respaced index i given the model's output ->
    (x at i - 1, the x0 estimate)."""
    t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
    x0 = model_prediction_to_x0(st, predict, out, x, t)
    eps = predict_eps_from_x0(st, x, t, x0)
    abar_prev = extract(st.alphas_cumprod_prev, t, x.dim())
    return x0 * torch.sqrt(abar_prev) + torch.sqrt(1.0 - abar_prev) * eps, x0


@torch.no_grad()
def check_ddim(model: FiLMDenoiser, cond: CondTokens, scale: float, st, predict: str, records: list,
               precision: Optional[str] = None) -> list:
    """For each recorded step {"i", "x", "t", ["out"], "next"}: the guided
    output at the program's x and the DDIM update from it -> [(out, next)]."""
    with _mode(precision):
        fn = guided(model, cond, scale)
        result = []
        for r in records:
            out = fn(r["x"], r["t"])
            nxt, x0 = ddim_step(st, predict, out, r["x"], r["i"])
            result.append((out, x0 if r["i"] == 0 else nxt))
    return result


@torch.no_grad()
def encode(model: FiLMDenoiser, audio, keyframes=None, precision: Optional[str] = None):
    """-> (lip vertices (face) or None, conditioning tokens)."""
    with _mode(precision):
        lip = model.lip_vertices(audio) if model.cfg.data_format == "face" else None
        kv = None if keyframes is None else torch.ones(keyframes.shape[:2], device=keyframes.device)
        return lip, model.encode_conditioning(audio, keyframes, kv, lip_verts=lip)


@torch.no_grad()
def keyframes(guide_model: GuideTransformer, codec_model: TemporalVertexCodec, audio, tokens,
              precision: Optional[str] = None):
    """Teacher-forced logits over the served tokens [B, N] and the keyframes
    they decode to -> (logits [B, N, V], keyframes [B, N / depth, nfeats])."""
    with _mode(precision):
        cond = guide_model.encode_conditioning(audio)
        start = torch.full((tokens.shape[0], 1), guide_model.start_token, dtype=tokens.dtype, device=tokens.device)
        logits = guide_model.decode_logits(torch.cat([start, tokens[:, :-1]], dim=1), cond)
        depth = codec_model.cfg.depth
        kf = codec_model.decode(tokens.reshape(tokens.shape[0], -1, depth))
    return logits, kf


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute gap over the reference's largest magnitude."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


NUCLEUS_SLACK = 1e-3  # probability mass by which rounding may move a token across the nucleus's edge


def outside_nucleus(logits: torch.Tensor, tokens: torch.Tensor, top_p: float) -> float:
    """The share of the served tokens [B, N] that the nucleus at ``top_p``
    of the logits [B, N, V] leaves out.  Nucleus sampling keeps a token
    while the probability of the tokens more likely than it sums to under
    ``top_p``; a token counts as outside where that sum reaches ``top_p`` +
    ``NUCLEUS_SLACK``."""
    probs = torch.softmax(logits.double(), dim=-1)
    p_token = probs.gather(-1, tokens[..., None].long())
    above = torch.where(probs > p_token, probs, torch.zeros_like(probs)).sum(-1)
    return float((above >= top_p + NUCLEUS_SLACK).double().mean())


def leaf_gap(got: Dict[str, float], want: Dict[str, float], skip=()) -> float:
    """The worst leaf's gap of norms, over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    med = float(np.median([want[n] for n in want if n not in skip]))
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in want if n not in skip)
