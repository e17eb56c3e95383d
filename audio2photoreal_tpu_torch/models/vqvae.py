"""Residual VQ-VAE over 1 fps pose keyframes, with EMA codebooks.

Counterpart of ``audio2photoreal_tpu/models/vqvae.py`` (reference:
model/vqvae.py:41-550): a causal dilated conv encoder and decoder
(receptive field 8, one left pad of 7 at the input, vqvae.py:403-414,
432-464) around a residual stack of EMA codebooks with k-means init on the
first training batch, dead-code expiry, a straight-through estimator and a
commitment loss (vqvae.py:96-392).

The codebooks are buffers under the reference's names
(``quantizer.layers.{d}._codebook.{embed, embed_avg, cluster_size,
inited}``), where the JAX package threads them through its steps as a
``VQState`` (one ``inited`` flag there, one a codebook here); a training
forward rewrites them in place, under ``no_grad``.  A state dict without the
``inited`` flags (written before the port had them, or converted by the
JAX package's ``convert_vqvae``, which marks every codebook inited) loads
as inited.  The convs keep the reference's ``encoder.enc.{0,2,4,6,8}`` /
``decoder.dec.{...}`` indices.  ``convert.vqvae_state_dict_from_jax`` makes
a state_dict from JAX params and a ``VQState``.

Every random row a training forward draws (k-means' initial means,
dead-code replacements) comes from ``draw_rows``, so a test can hand in
JAX's indices.  Under a data-parallel step (``parallel/sharding.py``) the
codebooks are those of the global batch: the EMA's counts and sums are
summed over the ranks, and the k-means init and the dead-code rows run on
the ranks' rows gathered in rank order, from the same generator on every
rank, so every rank makes the same codebooks.  (A mean of per-rank k-means
results, the JAX package's ``pmean_state`` read literally, is not the
global k-means its sharded step computes.)  The perplexity counts the
global batch's codes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.core.config import VQConfig
from audio2photoreal_tpu_torch.parallel.collectives import all_gather, psum, psum_tensors
from audio2photoreal_tpu_torch.parallel.mesh import DATA_AXIS
from audio2photoreal_tpu_torch.parallel.sharding import rows


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


def draw_rows(n_rows: int, num: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``num`` row indices uniform in [0, ``n_rows``), with replacement."""
    return torch.randint(0, n_rows, (num,), generator=generator, device=device)


def _sample_vectors(samples: torch.Tensor, num: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``num`` rows of ``samples``, with replacement (vqvae.py:62-70)."""
    return samples[draw_rows(samples.shape[0], num, generator, samples.device)]


def _onehot(codes: torch.Tensor, num_codes: int, dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(codes, num_codes).to(dtype)


@torch.no_grad()
def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration k-means (vqvae.py:73-94) -> (means [K, dim], the last
    iteration's bin counts [K]); a mean whose bin is empty stays where it
    was."""
    means = _sample_vectors(samples, num_clusters, generator)
    bins = torch.zeros(num_clusters, dtype=samples.dtype, device=samples.device)
    for _ in range(num_iters):
        d2 = (samples**2).sum(-1, keepdim=True) - 2 * samples @ means.T + (means**2).sum(-1)[None]
        onehot = _onehot(d2.argmin(dim=-1), num_clusters, samples.dtype)
        bins = onehot.sum(0)
        new_means = (onehot.T @ samples) / torch.clamp(bins, min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, bins


@torch.no_grad()
def _ema_layer_update(embed: torch.Tensor, embed_avg: torch.Tensor, cluster_size: torch.Tensor,
                      x: torch.Tensor, onehot: torch.Tensor, cfg: VQConfig,
                      generator: Optional[torch.Generator]):
    """One codebook's dead-code expiry, then its EMA (vqvae.py:157-224) ->
    (embed, embed_avg, cluster_size).  x [N, dim], onehot [N, codes]: this
    rank's rows under a data-parallel step, whose counts and sums are summed
    over the ranks and whose replacement rows are drawn from the gathered
    global rows."""
    counts, sums = psum_tensors([onehot.sum(0), onehot.T @ x], DATA_AXIS)
    # dead-code expiry BEFORE the EMA update, like the reference (:212-215)
    expired = cluster_size < cfg.threshold_ema_dead_code
    rows_all = all_gather(x, DATA_AXIS, tiled=True)
    embed = torch.where(expired[:, None], _sample_vectors(rows_all, embed.shape[0], generator), embed)
    cluster_size = cluster_size * cfg.decay + counts * (1 - cfg.decay)
    embed_avg = embed_avg * cfg.decay + sums * (1 - cfg.decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + 1e-5) / (n + cluster_size.shape[0] * 1e-5) * n
    embed = torch.where(expired[:, None], embed, embed_avg / smoothed[:, None])
    return embed, embed_avg, cluster_size


def residual_quantize(x: torch.Tensor, quantizer: "ResidualQuantizer", cfg: VQConfig, train: bool = False,
                      generator: Optional[torch.Generator] = None):
    """-> (quantized [N, dim], codes [N, depth], commit_loss []).  At
    ``train=False`` the commitment loss is 0 and the codebooks stay as they
    are.  At ``train=True`` (vqvae.py:122-195): k-means initialises each
    codebook not yet inited, on the true residual stream, depth by depth;
    each depth's codes come from its codebook as it was before this step;
    the codebooks then take their expiry and EMA update; the commitment loss
    is the mean of (sg(q) - r)^2 over depths; each layer's contribution
    passes its gradient straight through, and the residual carries none."""
    books = [layer._codebook for layer in quantizer.layers]
    if train:
        todo = torch.stack([cb.inited for cb in books]).flatten() == 0
        if todo.any():  # one read of the flags a step
            with torch.no_grad():
                residual = all_gather(x.detach(), DATA_AXIS, tiled=True)  # the global batch's rows
                for cb, init in zip(books, todo.tolist()):
                    if init:
                        means, bins = kmeans(residual, cfg.code_dim, cfg.kmeans_iters, generator)
                        cb.embed.copy_(means)
                        cb.embed_avg.copy_(means)
                        cb.cluster_size.copy_(bins)
                        cb.inited.fill_(1.0)
                    residual = residual - cb.embed[_quantize_one(cb.embed, residual)]

    residual = x
    quantized = torch.zeros_like(x)
    codes_list, updates = [], []
    commit = torch.zeros((), dtype=x.dtype, device=x.device)
    for cb in books:
        embed = cb.embed
        codes = _quantize_one(embed, residual.detach())
        q = embed[codes]
        if train:
            updates.append(_ema_layer_update(embed, cb.embed_avg, cb.cluster_size, residual.detach(),
                                             _onehot(codes, cfg.code_dim, x.dtype), cfg, generator))
            commit = commit + ((q.detach() - residual) ** 2).mean()
            # straight-through on each layer's contribution (vqvae.py:311)
            q = residual + (q - residual).detach()
        codes_list.append(codes)
        quantized = quantized + q
        residual = residual - q if train else residual - q.detach()
    if train:
        with torch.no_grad():
            for cb, (e, a, s) in zip(books, updates):
                cb.embed.copy_(e)
                cb.embed_avg.copy_(a)
                cb.cluster_size.copy_(s)
        commit = commit / len(books)
    return quantized, torch.stack(codes_list, dim=-1), commit


def perplexity(codes: torch.Tensor, num_codes: int) -> torch.Tensor:
    """Codebook usage perplexity (vqvae.py:523-534), of the global batch's
    codes under a data-parallel step."""
    n = rows(codes.shape[0])[1] * (codes.numel() // max(codes.shape[0], 1))
    prob = psum(torch.bincount(codes.reshape(-1), minlength=num_codes).float(), DATA_AXIS) / n
    return torch.exp(-(prob * torch.log(prob + 1e-7)).sum())


class _Codebook(nn.Module):
    """The holder of one depth's ``_codebook`` buffers; ``inited`` is the
    reference's [1] float flag."""

    def __init__(self, codes: int, dim: int, inited: bool):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codes, dim))
        self.register_buffer("embed_avg", torch.zeros(codes, dim))
        self.register_buffer("cluster_size", torch.zeros(codes))
        self.register_buffer("inited", torch.full((1,), float(inited)))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """A codebook saved without its flag (by PR 8-10 of the port, or from
        the JAX package's converted state, which is inited) loads as inited."""
        if prefix + "embed" in state_dict:
            state_dict.setdefault(prefix + "inited", torch.ones(1))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


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
        self.quantizer = ResidualQuantizer(c.depth, c.code_dim, L, inited=not c.kmeans_init)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init from ``generator``, as the JAX package initialises
        (``VQState.create``): conv weights lecun-normal, biases 0; with
        ``kmeans_init`` the codebooks 0 and not inited (the first training
        step runs k-means), else he-uniform over [depth, codes, dim] (fan-in
        codes x depth) and inited; the EMA sums equal to the codebooks and
        the cluster sizes 0."""
        for conv in (*self.encoder.convs, *self.decoder.convs):
            conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=generator)
            conv.bias.zero_()
        c = self.cfg
        limit = (6.0 / (c.code_dim * c.depth)) ** 0.5
        embed = torch.rand((c.depth, c.code_dim, c.emb_width), generator=generator) * (2 * limit) - limit
        if c.kmeans_init:
            embed.zero_()
        for layer, e in zip(self.quantizer.layers, embed):
            layer._codebook.embed.copy_(e)
            layer._codebook.embed_avg.copy_(e)
            layer._codebook.cluster_size.zero_()
            layer._codebook.inited.fill_(float(not c.kmeans_init))

    def encode(self, motion: torch.Tensor) -> torch.Tensor:
        """[B, T, nfeats] -> codes [B, T, depth]."""
        B, T, _ = motion.shape
        z = self.encoder(motion)
        return rvq_encode(z.reshape(B * T, -1), self.quantizer.embed).reshape(B, T, -1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, depth] -> [B, T, nfeats]."""
        return self.decoder(rvq_decode(codes, self.quantizer.embed))

    def forward(self, motion: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> CodecOutput:
        """With ``train`` the codebooks take this batch's k-means init (when
        not inited), expiry and EMA update in place, the draws from
        ``generator`` (on ``motion``'s device)."""
        B, T, _ = motion.shape
        z = self.encoder(motion).reshape(B * T, -1)
        q, codes, commit = residual_quantize(z, self.quantizer, self.cfg, train, generator)
        recon = self.decoder(q.reshape(B, T, -1))
        return CodecOutput(recon, commit, perplexity(codes[:, -1], self.cfg.code_dim), codes.reshape(B, T, -1))
