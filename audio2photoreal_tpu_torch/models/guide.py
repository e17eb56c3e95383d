"""Autoregressive guide transformer: audio -> residual-VQ pose tokens.

Counterpart of ``audio2photoreal_tpu/models/guide.py`` (reference:
model/guide.py:26-222): a token embedding with one extra start token, the
frozen wav2vec frontend, a dilated valid-conv audio pre-net (each block of 6
convs shortens the sequence by 24), a FiLM decoder stack conditioned on the
pooled audio, causal self-attention, and nucleus (top-p) sampling.

The audio is encoded once per ``generate``.  The cached decode runs one
token per step through ``FiLMDecoderLayer.step`` against a preallocated
[layers, B, L, D] K/V cache and cross-attention K/V projected once; the
uncached decode re-runs the whole token buffer under a causal mask.  Both
are host loops of small launches; neither reads the device until the end.

The Gumbel noise of each step's draw comes from ``draw_gumbel`` (so a test
can hand in JAX's noise), drawn in the nucleus' sorted order as
``jax.random.categorical`` draws it.  The guide computes in f32, as the JAX
guide does whatever ``GuideConfig.dtype`` says; its frozen frontend runs in
``GuideConfig.frontend_dtype`` (bf16 convs with f32 sums and norms, or f32).

Module names follow the reference's state dict (``pre_audio.{3i}`` convs and
``pre_audio.36``, ``non_attn_cond_projection.{0,1,3}``,
``seqTransDecoder.stack.{i}``), which ``convert.guide_state_dict_from_jax``
produces and ``train/convert.py:convert_guide`` reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.core.config import GuideConfig
from audio2photoreal_tpu_torch.models.audio_encoder import Wav2VecFeatureExtractor
from audio2photoreal_tpu_torch.models.blocks import Dropout, FiLMDecoderLayer
from audio2photoreal_tpu_torch.models.film_transformer import DecoderStack
from audio2photoreal_tpu_torch.ops.attention import causal_bias
from audio2photoreal_tpu_torch.ops.rotary import RotaryTable, make_rotary_table
from audio2photoreal_tpu_torch.parallel import sharding

NULL_EMBED_LEN = 2048  # rows of null_cond_embed, sliced to the cond length (JAX guide.py:92)


class GuideCond(NamedTuple):
    cond_tokens: torch.Tensor  # [B, Tc, D] normed audio memory
    cond_hidden: torch.Tensor  # [B, D] pooled FiLM vector


class AudioPreNet(nn.Sequential):
    """Dilated k=3 valid convs over the audio features, each followed by a
    leaky ReLU (0.2) and dropout, then a 1x1 conv (guide.py:84-116): the
    reference's Sequential, a conv at every third index, the 1x1 last."""

    def __init__(self, channels: int, num_blocks: int = 2, dropout: float = 0.2):
        c = channels
        mods = []
        for _ in range(num_blocks):
            for cin, cout, d in [(c, max(256, c), 1), (max(256, c), max(256, c), 2), (max(128, c), max(128, c), 3),
                                 (max(128, c), c, 1), (c, c, 2), (c, c, 3)]:
                mods += [nn.Conv1d(cin, cout, 3, dilation=d), nn.LeakyReLU(0.2), Dropout(dropout)]
        mods.append(nn.Conv1d(c, c, 1))
        super().__init__(*mods)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x.transpose(1, 2)  # [B, C, T]
        for i in range(0, len(self) - 1, 3):
            h = self[i + 2](F.leaky_relu(self[i](h), 0.2), generator)
        return self[len(self) - 1](h).transpose(1, 2)


def draw_gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def nucleus_probs(logits: torch.Tensor, top_p: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's shifted-nucleus construction (guide.py:203-218) ->
    (sorted_idx, keep, kept), all in sorted order: probabilities sorted
    descending (a stable ascending sort flipped, so among equal ones the
    higher index comes first, as JAX's ``sort(...)[:, ::-1]``), a token kept
    while the sum of the ones before it is below ``top_p`` (the first always
    is), the kept ones renormalised."""
    probs = torch.softmax(logits, dim=-1)
    asc, idx = torch.sort(probs, dim=-1, stable=True)
    sorted_probs, sorted_idx = asc.flip(-1), idx.flip(-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    shifted = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
    keep = shifted < top_p
    kept = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    return sorted_idx, keep, kept / kept.sum(dim=-1, keepdim=True)


def nucleus_sample(logits: torch.Tensor, top_p: float, gumbel: torch.Tensor) -> torch.Tensor:
    """[B, V] logits -> [B] tokens: the argmax of ``gumbel`` + log(kept +
    1e-12) in sorted order, mapped back through the sort, which is what
    ``jax.random.categorical`` computes for the same noise."""
    sorted_idx, _, kept = nucleus_probs(logits, top_p)
    choice = torch.argmax(gumbel + torch.log(kept + 1e-12), dim=-1)
    return sorted_idx.gather(-1, choice[:, None])[:, 0]


class GuideTransformer(nn.Module):
    def __init__(self, cfg: GuideConfig):
        super().__init__()
        c = self.cfg = cfg
        D = c.latent_dim
        self.token_embedding = nn.Embedding(c.tokens + 1, D)
        # frozen, in its config's frontend dtype; the guide itself computes in f32, as the JAX guide does
        self.audio_model = Wav2VecFeatureExtractor(compute_dtype=c.frontend_dtype).requires_grad_(False)
        self.pre_audio = AudioPreNet(c.cond_feature_dim)
        self.cond_projection = nn.Linear(c.cond_feature_dim, D)
        self.non_attn_cond_projection = nn.Sequential(
            nn.LayerNorm(D, eps=1e-5), nn.Linear(D, D), nn.SiLU(), nn.Linear(D, D)
        )
        self.norm_cond = nn.LayerNorm(D, eps=1e-5)
        self.null_cond_embed = nn.Parameter(torch.zeros(1, NULL_EMBED_LEN, D))
        self.null_cond_hidden = nn.Parameter(torch.zeros(1, D))
        self.seqTransDecoder = DecoderStack(
            FiLMDecoderLayer(D, c.num_heads, c.ff_size, dropout=c.dropout) for _ in range(c.num_layers)
        )
        self.final_layer = nn.Linear(D, c.tokens)
        rot = make_rotary_table(D, 4096)
        self.register_buffer("rotary_cos", rot.cos, persistent=False)
        self.register_buffer("rotary_sin", rot.sin, persistent=False)

    @property
    def start_token(self) -> int:
        return self.cfg.tokens  # vocab = tokens + 1 (guide.py:43-45, 196)

    @property
    def layers(self):
        return self.seqTransDecoder.stack

    @property
    def rotary(self) -> RotaryTable:
        return RotaryTable(self.rotary_cos, self.rotary_sin)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """A reference checkpoint's null_cond_embed has as many rows as its
        clips' wav2vec frames (1998 for 600 frames, guide.py:38,55): zero-pad
        it to ``NULL_EMBED_LEN`` rows, as ``convert_guide`` pads it; only the
        first cond-length rows are ever read."""
        key = prefix + "null_cond_embed"
        null = state_dict.get(key)
        if null is not None and null.shape[1] < NULL_EMBED_LEN:
            state_dict[key] = F.pad(null, (0, 0, 0, NULL_EMBED_LEN - null.shape[1]))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init from ``generator``: weights N(0, 1/fan_in), biases 0,
        norms identity, null embeddings N(0, 1)."""
        for name, p in self.named_parameters():
            if name.startswith("null_"):
                p.normal_(0.0, 1.0, generator=generator)
            elif p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    # ------------------------------------------------------------------ #

    def encode_conditioning(
        self,
        audio: Optional[torch.Tensor],  # [B, S, 2] raw 48 kHz
        keep_mask: Optional[torch.Tensor] = None,  # [B] bool, False -> null conditioning
        generator: Optional[torch.Generator] = None,  # pre-net dropout (training)
        audio_features: Optional[torch.Tensor] = None,  # [B, Ta, 1024] precomputed
    ) -> GuideCond:
        """``audio_features`` (``data/feature_cache.py``) stand in for the
        frozen frontend's output: given ``audio_model(audio)`` the result is
        the raw-audio path's, exactly."""
        if audio_features is not None:
            feats = audio_features.detach()
        else:
            with torch.no_grad():
                feats = self.audio_model(audio)
        cond = self.cond_projection(self.pre_audio(feats, generator))
        if keep_mask is not None:
            cond = torch.where(keep_mask[:, None, None], cond, self.null_cond_embed[:, : cond.shape[1]])
        hidden = self.non_attn_cond_projection(cond.mean(dim=-2))
        if keep_mask is not None:
            hidden = torch.where(keep_mask[:, None], hidden, self.null_cond_hidden)
        return GuideCond(self.norm_cond(cond), hidden)

    def decode_logits(self, tokens: torch.Tensor, cond: GuideCond,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced, causal: tokens [B, L] -> logits [B, L, tokens]."""
        x = self.token_embedding(tokens)
        L = tokens.shape[1]
        bias = causal_bias(L, L, tokens.device)
        for layer in self.layers:
            x = layer(x, cond.cond_hidden, rotary=self.rotary, generator=generator, memory=cond.cond_tokens,
                      self_bias=bias)
        return self.final_layer(x)

    def forward(self, tokens: torch.Tensor, audio: Optional[torch.Tensor], cond_drop_prob: float = 0.0,
                generator: Optional[torch.Generator] = None,
                audio_features: Optional[torch.Tensor] = None,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced training forward -> [B, L, tokens] logits; each
        clip's conditioning is dropped with ``cond_drop_prob`` (a draw from
        ``generator``, a CPU generator), or where ``keep_mask`` [B] is False
        when one is given (tests).  ``audio_features`` as in
        ``encode_conditioning``."""
        keep = keep_mask
        if keep is None and cond_drop_prob > 0.0:
            u = sharding.draw_global(lambda s: torch.rand(s, generator=generator), (tokens.shape[0],))
            keep = (u >= cond_drop_prob).to(tokens.device)
        cond = self.encode_conditioning(audio, keep, generator, audio_features)
        return self.decode_logits(tokens, cond, generator)

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def generate(
        self,
        audio: torch.Tensor,  # [B, S, 2]
        num_tokens: int,  # keyframes x vq_depth
        generator: Optional[torch.Generator] = None,  # on audio's device: the Gumbel noise
        top_p: float = 0.94,
        use_cache: bool = True,
    ) -> torch.Tensor:
        """Nucleus-sampling decode (reference: guide.py:174-222) -> [B,
        num_tokens] tokens.  With ``use_cache`` each step runs one token
        against the cached self-attention K/V; without, it re-runs the whole
        buffer.  Runs in eval mode."""
        if self.training:
            raise RuntimeError("GuideTransformer.generate runs in eval mode: call .eval() first")
        B, dev, V = audio.shape[0], audio.device, self.cfg.tokens
        cond = self.encode_conditioning(audio)
        buf = torch.full((B, num_tokens + 1), self.start_token, dtype=torch.long, device=dev)
        if not use_cache:
            for i in range(num_tokens):
                gumbel = draw_gumbel((B, V), generator, dev)
                logits = self.decode_logits(buf, cond)[:, i]  # position i predicts token i + 1
                buf[:, i + 1] = nucleus_sample(logits, top_p, gumbel)
            return buf[:, 1:]

        L, D = num_tokens + 1, self.cfg.latent_dim
        rot = self.rotary
        cross = [layer.precompute_cross(cond.cond_tokens, rot) for layer in self.layers]
        ks = torch.zeros((len(self.layers), B, L, D), device=dev)
        vs = torch.zeros_like(ks)
        for i in range(num_tokens):
            gumbel = draw_gumbel((B, V), generator, dev)
            x = self.token_embedding(buf[:, i : i + 1])  # [B, 1, D]
            for l, layer in enumerate(self.layers):
                x = layer.step(x, i, ks[l], vs[l], *cross[l], cond.cond_hidden, rot)
            buf[:, i + 1] = nucleus_sample(self.final_layer(x[:, 0]), top_p, gumbel)
        return buf[:, 1:]
