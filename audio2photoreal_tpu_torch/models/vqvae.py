"""Residual VQ-VAE over 1 fps pose keyframes, inference half.

Counterpart of ``audio2photoreal_tpu/models/vqvae.py`` (reference:
model/vqvae.py:395-550): a causal dilated conv encoder and decoder
(receptive field 8, one left pad of 7 at the input, vqvae.py:403-414,
432-464) around a residual stack of nearest-code quantizers.

The codebooks are buffers under the reference's names
(``quantizer.layers.{d}._codebook.{embed, embed_avg, cluster_size}``), where
the JAX package threads them through its steps as a ``VQState``; the convs
keep the reference's ``encoder.enc.{0,2,4,6,8}`` / ``decoder.dec.{...}``
indices.  ``convert.vqvae_state_dict_from_jax`` makes a state_dict from JAX
params and a ``VQState``.

What only the VQ trainer needs is not ported yet (ROADMAP queue 1, item 6):
k-means init, the EMA codebook update, dead-code expiry and the training
branch of ``residual_quantize`` (commitment loss, straight-through).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.core.config import VQConfig


def _quantize_one(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices, x [N, dim], embed [codes, dim] -> [N] (the JAX
    package's squared distance, term for term)."""
    d2 = (x**2).sum(-1, keepdim=True) - 2 * (x @ embed.T) + (embed**2).sum(-1)[None]
    return d2.argmin(dim=-1)


def rvq_encode(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """[N, dim] -> codes [N, depth]; ``embed`` [depth, codes, dim] (vqvae.py:365-380)."""
    residual, codes = x, []
    for book in embed:
        c = _quantize_one(book, residual)
        residual = residual - book[c]
        codes.append(c)
    return torch.stack(codes, dim=-1)


def rvq_decode(codes: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """codes [..., depth] -> [..., dim], the sum of each depth's code (vqvae.py:382-392)."""
    out = embed[0][codes[..., 0]]
    for d in range(1, embed.shape[0]):
        out = out + embed[d][codes[..., d]]
    return out


def residual_quantize(x: torch.Tensor, embed: torch.Tensor, train: bool = False):
    """-> (quantized [N, dim], codes [N, depth], commit_loss []): the JAX
    package's ``residual_quantize`` at ``train=False``, where the commitment
    loss is 0 and the state is unchanged."""
    if train:
        raise NotImplementedError("VQ training (k-means, EMA, dead-code expiry): see ROADMAP queue 1, item 6")
    codes = rvq_encode(x, embed)
    return rvq_decode(codes, embed), codes, torch.zeros((), dtype=x.dtype, device=x.device)


def perplexity(codes: torch.Tensor, num_codes: int) -> torch.Tensor:
    """Codebook usage perplexity (vqvae.py:523-534)."""
    prob = torch.bincount(codes.reshape(-1), minlength=num_codes).float() / codes.numel()
    return torch.exp(-(prob * torch.log(prob + 1e-7)).sum())


class _Codebook(nn.Module):
    """The holder of one depth's ``_codebook`` buffers."""

    def __init__(self, codes: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codes, dim))
        self.register_buffer("embed_avg", torch.zeros(codes, dim))
        self.register_buffer("cluster_size", torch.zeros(codes))


class _CodebookLayer(nn.Module):
    def __init__(self, codes: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(codes, dim)


class ResidualQuantizer(nn.Module):
    """``layers.{d}._codebook``: the reference's ResidualVectorQuantization names."""

    def __init__(self, depth: int, codes: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(_CodebookLayer(codes, dim) for _ in range(depth))

    @property
    def embed(self) -> torch.Tensor:
        """[depth, codes, dim]."""
        return torch.stack([l._codebook.embed for l in self.layers])


class _CausalConvStack(nn.Module):
    """Convs of (cin, cout, kernel, dilation) behind ONE left pad of
    (receptive_field - 1) at the input, valid after it, leaky ReLU 0.2
    between them: the output is as long as the input (vqvae.py:403-414).
    The Sequential is stored as ``seq_name`` (``enc`` / ``dec``), convs at
    even indices, as the reference stores them."""

    def __init__(self, specs: Sequence[Tuple[int, int, int, int]], receptive_field: int, seq_name: str):
        super().__init__()
        self.receptive_field, self.seq_name = receptive_field, seq_name
        mods = []
        for i, (cin, cout, k, d) in enumerate(specs):
            if i:
                mods.append(nn.LeakyReLU(0.2))
            mods.append(nn.Conv1d(cin, cout, k, dilation=d))
        self.add_module(seq_name, nn.Sequential(*mods))

    @property
    def convs(self):
        return getattr(self, self.seq_name)[::2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, cin] -> [B, T, cout]
        h = F.pad(x.transpose(1, 2), (self.receptive_field - 1, 0))
        convs = self.convs
        for i, conv in enumerate(convs):
            h = conv(h)
            if i < len(convs) - 1:
                h = F.leaky_relu(h, 0.2)
        return h.transpose(1, 2)


class CodecOutput(NamedTuple):
    recon: torch.Tensor  # [B, T, nfeats]
    commit_loss: torch.Tensor  # []
    perplexity: torch.Tensor  # [] of the last depth's codes
    codes: torch.Tensor  # [B, T, depth]


class TemporalVertexCodec(nn.Module):
    """Encoder / residual quantizer / decoder (vqvae.py:466-550)."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        c = self.cfg = cfg
        L = c.emb_width
        self.encoder = _CausalConvStack(
            ((c.nfeats, L, 1, 1), (L, L, 2, 1), (L, L, 2, 2), (L, L, 2, 3), (L, L, 2, 1)), 8, "enc")
        self.decoder = _CausalConvStack(
            ((L, L, 2, 1), (L, L, 2, 2), (L, L, 2, 3), (L, L, 2, 1), (L, c.nfeats, 1, 1)), 8, "dec")
        self.quantizer = ResidualQuantizer(c.depth, c.code_dim, L)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init from ``generator``, as the JAX package initialises with
        ``kmeans_init=False``: conv weights lecun-normal, biases 0, codebooks
        he-uniform over [depth, codes, dim] (fan-in codes x depth), the EMA
        sums equal to them and the cluster sizes 0."""
        for conv in (*self.encoder.convs, *self.decoder.convs):
            conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=generator)
            conv.bias.zero_()
        c = self.cfg
        limit = (6.0 / (c.code_dim * c.depth)) ** 0.5
        embed = torch.rand((c.depth, c.code_dim, c.emb_width), generator=generator) * (2 * limit) - limit
        for layer, e in zip(self.quantizer.layers, embed):
            layer._codebook.embed.copy_(e)
            layer._codebook.embed_avg.copy_(e)
            layer._codebook.cluster_size.zero_()

    def encode(self, motion: torch.Tensor) -> torch.Tensor:
        """[B, T, nfeats] -> codes [B, T, depth]."""
        B, T, _ = motion.shape
        z = self.encoder(motion)
        return rvq_encode(z.reshape(B * T, -1), self.quantizer.embed).reshape(B, T, -1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, depth] -> [B, T, nfeats]."""
        return self.decoder(rvq_decode(codes, self.quantizer.embed))

    def forward(self, motion: torch.Tensor, train: bool = False) -> CodecOutput:
        B, T, _ = motion.shape
        z = self.encoder(motion).reshape(B * T, -1)
        q, codes, commit = residual_quantize(z, self.quantizer.embed, train)
        recon = self.decoder(q.reshape(B, T, -1))
        return CodecOutput(recon, commit, perplexity(codes[:, -1], self.cfg.code_dim), codes.reshape(B, T, -1))
