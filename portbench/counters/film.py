"""Model FLOPs of the FiLM denoiser and the guide's decode, and the shapes
of their attention launches, from a configuration and the traffic's sizes.

``cfg`` is a ``DenoiserConfig`` (or any object with its fields).  A train
step is the face trainer's on cached features: the forward (encode, the
conditioning's cache, the denoiser), and the backward with no recompute.
A sampling call is the generate sequence: keyframes (a configuration with
a guide), lip vertices (face), the encode, the guided conditioning cache
for both branches, and every DDIM step over both branches' rows.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.counters import frontend
from portbench.counters.frontend import Count

FLASH_MIN_LEN = 128  # the attention the package sends to its kernels: both axes at least this long


def tokens(frames: int) -> int:
    return frontend.feature_frames(frames * 1600 // 3)


def _pose(cfg) -> bool:
    return cfg.data_format == "pose"


def _keyframes(cfg, T: int) -> int:
    return -(-T // cfg.keyframe_step)


def _cond_dim(cfg) -> int:
    return cfg.cond_feature_dim + (0 if _pose(cfg) else cfg.lip_dim)


def encode(c: Count, cfg, B: int, T: int) -> None:
    """The projections and (face) the rotary cond encoder over frozen features."""
    D, Ta = cfg.latent_dim, tokens(T)
    c.lin(B * Ta, _cond_dim(cfg), D, grad_in=False)
    if _pose(cfg):
        c.lin(B * _keyframes(cfg, T), cfg.key_feature_dim, D, grad_in=False)
        return
    for _ in range(cfg.cond_encoder_layers):
        c.lin(B * Ta, D, 2 * D)
        c.lin(B * Ta, D, D)
        c.attn(B, cfg.num_heads, Ta, Ta, D // cfg.num_heads)
        c.lin(B * Ta, D, D)
        c.lin(B * Ta, D, cfg.ff_size)
        c.lin(B * Ta, cfg.ff_size, D)


def cond_cache(c: Count, cfg, R: int, T: int) -> None:
    D, L, Ta = cfg.latent_dim, cfg.num_layers, tokens(T)
    c.lin(R, D, D)
    c.lin(R, D, D)
    c.lin(R * Ta, D, L * D)
    c.lin(R * Ta, D, L * D)


def denoise(c: Count, cfg, R: int, T: int) -> None:
    """One denoiser pass over R rows of T frames."""
    D, L, H, ff, nf = cfg.latent_dim, cfg.num_layers, cfg.num_heads, cfg.ff_size, cfg.nfeats
    Ta, Kf = tokens(T), _keyframes(cfg, T)
    c.lin(R * T, nf, D, grad_in=False)
    c.lin(R, D, 4 * D, grad_in=False)
    c.lin(R, 4 * D, D)
    c.lin(R, 4 * D, 2 * D)
    c.lin(R * 2, D, L * D)
    c.lin(R * 2, D, L * D)
    for _ in range(L):
        for _ in range(4 if _pose(cfg) else 3):
            c.lin(R, D, 2 * D)
        c.lin(R * T, D, 2 * D)
        c.lin(R * T, D, D)
        c.attn(R, H, T, T, D // H)
        c.lin(R * T, D, D)
        c.lin(R * T, D, D)
        c.attn(R, H, T, Ta + 2, D // H)
        c.lin(R * T, D, D)
        if _pose(cfg):
            c.lin(R * Kf, D, D)
            c.lin(R * Kf, D, D)
            c.lin(R * T, D, D)
            c.attn(R, H, T, Kf, D // H)
            c.lin(R * T, D, D)
        c.lin(R * T, D, ff)
        c.lin(R * T, ff, D)
    c.lin(R * T, D, nf)
    if _pose(cfg):
        t = T + cfg.postnet_receptive_field - 1
        mid = max(256, nf)
        for cin, cout, d in ((nf, mid, 1), (mid, nf, 2), (nf, nf, 3), (nf, nf, 1), (nf, nf, 2), (nf, nf, 3)):
            t -= 2 * d
            c.conv(R, cin, 3, cout, t)
        c.conv(R, nf, 1, nf, t)


def train_step_flops(cfg, B: int, T: int) -> float:
    """Forward and backward of one face train step on cached features."""
    c = Count()
    encode(c, cfg, B, T)
    cond_cache(c, cfg, B, T)
    denoise(c, cfg, B, T)
    return c.fwd + c.bwd


def guide_call(c: Count, gcfg, vcfg, B: int, T: int, n_keyframes: int) -> None:
    """``GuideKeyframer``: the guide's encode, its cached decode of
    keyframes x depth tokens, the VQ decode."""
    D, ff = gcfg.latent_dim, gcfg.ff_size
    t = guide_prenet_tokens = frontend.guide_prenet(c, B, frontend.wav2vec_features(c, B, T * 1600))
    c.lin(B * t, gcfg.cond_feature_dim, D)
    c.lin(B, D, D)
    c.lin(B, D, D)
    steps = n_keyframes * vcfg.depth
    for _ in range(gcfg.num_layers):
        c.lin(B * guide_prenet_tokens, D, D)
        c.lin(B * guide_prenet_tokens, D, D)
    for _ in range(steps):
        for _ in range(gcfg.num_layers):
            for _ in range(3):
                c.lin(B, D, 2 * D)
            c.lin(B, D, D)
            c.lin(B, D, D)
            c.lin(B, D, D)
            c.attn(B, gcfg.num_heads, 1, steps + 1, D // gcfg.num_heads)
            c.lin(B, D, D)
            c.lin(B, D, D)
            c.attn(B, gcfg.num_heads, 1, t, D // gcfg.num_heads)
            c.lin(B, D, D)
            c.lin(B, D, ff)
            c.lin(B, ff, D)
        c.lin(B, D, gcfg.tokens)
    frontend.vq_decode(c, B, n_keyframes, vcfg.emb_width, vcfg.nfeats)


def sample_call_flops(cfg, keyframer, B: int, T: int, n_steps: int, scale: int = 1) -> Dict[str, float]:
    """Model FLOPs of ``scale`` sampling calls of B clips, by part."""
    parts = {}
    if keyframer is not None:
        c = Count()
        guide_call(c, keyframer.guide.cfg, keyframer.codec.cfg, B, T, _keyframes(cfg, T))
        parts["keyframer"] = c.fwd
    c = Count()
    if not _pose(cfg):
        frontend.lip_vertices(c, B, T)
    frontend.wav2vec_features(c, B, T * 1600)
    encode(c, cfg, B, T)
    cond_cache(c, cfg, 2 * B, T)
    parts["encode"] = c.fwd
    c = Count()
    denoise(c, cfg, 2 * B, T)
    parts["ddim"] = c.fwd * n_steps
    return {k: v * scale for k, v in parts.items()}


def _attn_launches(cfg, R: int, T: int) -> List[Tuple[str, dict, int]]:
    """The denoiser's attentions that go to the kernels in one pass over R rows."""
    H, Dh, Ta = cfg.num_heads, cfg.latent_dim // cfg.num_heads, tokens(T)
    out = []
    for tq, tk in ((T, T), (T, Ta + 2)):
        if cfg.flash_attention and min(tq, tk) >= FLASH_MIN_LEN:
            out.append(({"B": R, "H": H, "Tq": tq, "Tk": tk, "Dh": Dh}, cfg.num_layers))
    return out


def _encoder_launches(cfg, B: int, T: int):
    H, Dh, Ta = cfg.num_heads, cfg.latent_dim // cfg.num_heads, tokens(T)
    if _pose(cfg) or not cfg.flash_attention or Ta < FLASH_MIN_LEN:
        return []
    return [({"B": B, "H": H, "Tq": Ta, "Tk": Ta, "Dh": Dh}, cfg.cond_encoder_layers)]


def face_train_shapes(cfg, B: int, T: int) -> List[Tuple[str, dict, int]]:
    """(fwd | bwd, shape, launches) of the attention kernels in one train step."""
    shapes = _attn_launches(cfg, B, T) + _encoder_launches(cfg, B, T)
    return [(kind, {**s, "lse": kind == "fwd"}, n) for s, n in shapes for kind in ("fwd", "bwd")]


def sample_attention(cfg, B: int, T: int, n_steps: int) -> List[Tuple[str, dict, int]]:
    """(fwd, shape, launches) of the attention kernels in one sampling call."""
    out = [("fwd", s, n) for s, n in _encoder_launches(cfg, B, T)]
    return out + [("fwd", s, n * n_steps) for s, n in _attn_launches(cfg, 2 * B, T)]
