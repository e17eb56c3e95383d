"""The residual VQ codec's decoder, in plain PyTorch: a frozen copy of the
measured package's codec with the same state-dict names (the encoder and
the codebooks' training updates are left out: the benchmark only decodes).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import VQConfig


def rvq_decode(codes: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """codes [..., depth] -> [..., dim], the sum of each depth's code (vqvae.py:382-392)."""
    out = embed[0][codes[..., 0]]
    for d in range(1, embed.shape[0]):
        out = out + embed[d][codes[..., d]]
    return out


class _Codebook(nn.Module):
    """The holder of one depth's ``_codebook`` buffers; ``inited`` is the
    reference's [1] float flag."""

    def __init__(self, codes: int, dim: int, inited: bool):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codes, dim))
        self.register_buffer("embed_avg", torch.zeros(codes, dim))
        self.register_buffer("cluster_size", torch.zeros(codes))
        self.register_buffer("inited", torch.full((1,), float(inited)))


class _CodebookLayer(nn.Module):
    def __init__(self, codes: int, dim: int, inited: bool):
        super().__init__()
        self._codebook = _Codebook(codes, dim, inited)


class ResidualQuantizer(nn.Module):
    """``layers.{d}._codebook``: the reference's ResidualVectorQuantization names."""

    def __init__(self, depth: int, codes: int, dim: int, inited: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(_CodebookLayer(codes, dim, inited) for _ in range(depth))

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
        self.quantizer = ResidualQuantizer(c.depth, c.code_dim, L, inited=not c.kmeans_init)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, depth] -> [B, T, nfeats]."""
        return self.decoder(rvq_decode(codes, self.quantizer.embed))
