"""The frozen audio -> lip-vertex regressor of the face denoiser.

Counterpart of ``audio2photoreal_tpu/models/lip_regressor.py`` (reference:
Audio2LipRegressionTransformer, model/diffusion.py:37-79): a wav2vec_large
encoder feeding a 2-encoder / 4-decoder RegressionTransformer
(transformer_modules.py:560-628) at width 512, 4 heads, feed-forward 1024
with ReLU, whose decoder queries are a zero sequence plus positions,
projected to 338 x 3 lip vertex offsets.  The standard per-position sin/cos
(``absolute_pos_encoding``) is added to the wav2vec memory and to the
queries.  Its attentions are plain (no flash): the decoder's 120 queries are
below the kernel's 128 gate, as in the JAX layers, which never take flash.

State-dict names are the reference's (``audio_encoder.wav2vec_model.*``,
``regression_model.transformer_{encoder,decoder}.{i}.*``,
``project_output``), which ``train/convert.py:convert_lip_regressor`` reads.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.audio_encoder import Wav2VecEncoder
from portbench.reference.blocks import FeedForward, MultiHeadAttention
from portbench.reference.embeddings import absolute_pos_encoding


def _named(name: str, module: nn.Module) -> nn.Module:
    """A holder that puts ``module`` under ``name`` (the reference wraps each
    attention in a module of its own: ``self_attn.self_attn.*``)."""
    holder = nn.Module()
    setattr(holder, name, module)
    return holder


class EncoderLayer(nn.Module):
    """TransformerEncoderLayer (transformer_modules.py:450-472): pre-norm
    self-attention, pre-norm ReLU feed-forward."""

    def __init__(self, dim: int, heads: int, ff_size: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = _named("self_attn", MultiHeadAttention(dim, heads))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.feedforward = FeedForward(dim, ff_size, activation=nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn.self_attn(h, h, h)
        return x + self.feedforward(self.norm2(x))


class DecoderLayer(nn.Module):
    """TransformerDecoderLayer (transformer_modules.py:475-511): pre-norm
    self-attention, cross-attention to the memory, ReLU feed-forward."""

    def __init__(self, dim: int, heads: int, ff_size: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = _named("self_attn", MultiHeadAttention(dim, heads))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = _named("cross_attn", MultiHeadAttention(dim, heads))
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.feedforward = FeedForward(dim, ff_size, activation=nn.ReLU())

    def forward(self, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn.self_attn(h, h, h)
        h = self.norm2(x)
        x = x + self.cross_attn.cross_attn(h, mem, mem)
        return x + self.feedforward(self.norm3(x))


class LipRegressor(nn.Module):
    """[B, T, 1600] mono 48 kHz frames -> [B, T, n_vertices, 3]."""

    def __init__(self, n_vertices: int = 338, dim: int = 512, heads: int = 4, enc_layers: int = 2,
                 dec_layers: int = 4, ff_size: int = 1024):
        super().__init__()
        self.n_vertices, self.dim = n_vertices, dim
        self.audio_encoder = Wav2VecEncoder()
        self.regression_model = nn.Module()
        self.regression_model.transformer_encoder = nn.ModuleList(
            EncoderLayer(dim, heads, ff_size) for _ in range(enc_layers))
        self.regression_model.transformer_decoder = nn.ModuleList(
            DecoderLayer(dim, heads, ff_size) for _ in range(dec_layers))
        self.project_output = nn.Linear(dim, n_vertices * 3)

    def forward(self, audio_frames: torch.Tensor) -> torch.Tensor:
        B, T, _ = audio_frames.shape
        dev = audio_frames.device
        cond = self.audio_encoder(audio_frames)  # [B, Tw, 512]
        mem = cond + absolute_pos_encoding(cond.shape[1], self.dim, device=dev)[None]
        for layer in self.regression_model.transformer_encoder:
            mem = layer(mem)
        # zero decoder queries plus positions (transformer_modules.py:595-599)
        x = absolute_pos_encoding(T, self.dim, device=dev)[None].expand(B, T, self.dim)
        for layer in self.regression_model.transformer_decoder:
            x = layer(x, mem)
        return self.project_output(x).reshape(B, T, self.n_vertices, 3)
