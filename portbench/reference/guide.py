"""The guide transformer (audio -> residual-VQ pose tokens), in plain
PyTorch: a frozen copy of the measured package's module with the same
parameter names.  ``decode_logits`` is the teacher-forced causal forward
over a token sequence: the logits that a cached decode of the same tokens
must give at every position.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import GuideConfig
from portbench.reference.audio_encoder import Wav2VecFeatureExtractor
from portbench.reference.blocks import Dropout, FiLMDecoderLayer
from portbench.reference.film_transformer import DecoderStack
from portbench.reference.attention import causal_bias
from portbench.reference.rotary import RotaryTable, make_rotary_table

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
