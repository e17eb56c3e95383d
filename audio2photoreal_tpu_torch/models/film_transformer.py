"""FiLM-transformer diffusion denoiser, pose branch.

Counterpart of ``audio2photoreal_tpu/models/film_transformer.py`` (reference:
model/diffusion.py:82-403) for ``data_format="pose"``:

- ``encode_conditioning`` runs the conditioning once per clip: frozen
  wav2vec features -> ``cond_projection``, and the 1 fps keyframes ->
  ``frame_cond_projection`` -> ``frame_norm_cond``.
- ``build_cond_cache`` does, once per clip, everything in a denoise step
  that does not depend on (x, t): the CFG keep-masked memory rows, their
  cross-attention K/V through all layers, the pooled FiLM vector and the
  keep-masked keyframe tokens.
- ``denoise_cached`` is the per-step body: time embedding, the two t-token
  rows of the memory, the decoder stack and the causal dilated conv post-net.
  ``denoise`` is the two in a row.
- ``forward`` is the training forward (film_transformer.py:496-526): encode,
  two independent classifier-free-guidance keep draws (audio, keyframes),
  denoise.  In training mode dropout runs at ``cfg.dropout`` in the decoder
  stack and at a fixed 0.2 in the post-net, drawing from the ``generator``
  handed in.  The wav2vec frontend is frozen: no gradient reaches it and the
  optimizer never sees it.

The face branch (lip regressor, rotary cond-encoder) is not ported yet.
Module names follow the reference's state dict, which
``convert.film_denoiser_state_dict_from_jax`` produces from JAX params.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.core.config import DenoiserConfig
from audio2photoreal_tpu_torch.models.audio_encoder import Wav2VecFeatureExtractor, feature_frames
from audio2photoreal_tpu_torch.models.blocks import Dropout, FiLMDecoderLayer
from audio2photoreal_tpu_torch.ops.convs import conv1d, valid_conv1d
from audio2photoreal_tpu_torch.ops.embeddings import sinusoidal_pos_emb
from audio2photoreal_tpu_torch.ops.rotary import RotaryTable, apply_rotary, make_rotary_table


class CondTokens(NamedTuple):
    """Precomputed conditioning, constant across denoising steps."""

    cond_tokens: torch.Tensor  # [B, Ta, D] projected audio tokens
    pose_tokens: Optional[torch.Tensor]  # [B, Tk, D] projected keyframes


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_pos_emb(t, self.dim)


class DecoderStack(nn.Module):
    """The reference's ``seqTransDecoder`` holder of the layer list."""

    def __init__(self, layers):
        super().__init__()
        self.stack = nn.ModuleList(layers)


class FiLMDenoiser(nn.Module):
    POSTNET_DROPOUT = 0.2  # fixed, whatever cfg.dropout (film_transformer.py:476-484)

    def __init__(self, cfg: DenoiserConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.data_format != "pose":
            raise NotImplementedError("face branch: see ROADMAP")
        if c.dtype != "float32" or c.frontend_dtype != "float32":
            raise NotImplementedError("bf16 compute: see ROADMAP")
        D, nf = c.latent_dim, c.nfeats
        self.audio_model = Wav2VecFeatureExtractor().requires_grad_(False)  # frozen
        self.input_projection = nn.Linear(nf, D)
        self.cond_projection = nn.Linear(c.cond_dim, D)
        self.norm_cond = nn.LayerNorm(D, eps=1e-5)
        # time embedding (reference: diffusion.py:120-132)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(D), nn.Linear(D, D * 4), nn.Mish())
        self.to_time_cond = nn.Sequential(nn.Linear(D * 4, D))
        self.to_time_tokens = nn.Sequential(nn.Linear(D * 4, D * 2))
        # pooled-cond FiLM path (diffusion.py:174-179)
        self.non_attn_cond_projection = nn.Sequential(
            nn.LayerNorm(D, eps=1e-5), nn.Linear(D, D), nn.SiLU(), nn.Linear(D, D)
        )
        self.emb_len = feature_frames(c.max_seq_length * 1600 // 3)
        self.null_cond_embed = nn.Parameter(torch.zeros(1, self.emb_len, D))
        self.null_cond_hidden = nn.Parameter(torch.zeros(1, D))
        self.null_pose_embed = nn.Parameter(
            torch.zeros(1, -(-c.max_seq_length // c.keyframe_step), D)
        )
        self.frame_cond_projection = nn.Linear(c.key_feature_dim, D)
        self.frame_norm_cond = nn.LayerNorm(D, eps=1e-5)
        # causal dilated conv post-net, receptive field 25 (diffusion.py:201-224)
        post = [(nf, max(256, nf), 1), (max(256, nf), nf, 2), (nf, nf, 3),
                (nf, nf, 1), (nf, nf, 2), (nf, nf, 3)]
        self.post_pose_layers = nn.ModuleList(
            nn.Conv1d(cin, cout, 3, dilation=d) for cin, cout, d in post
        )
        self.final_conv = nn.Conv1d(nf, nf, 1)
        self.post_drop = Dropout(self.POSTNET_DROPOUT, c.hash_dropout)
        self.seqTransDecoder = DecoderStack(
            FiLMDecoderLayer(D, c.num_heads, c.ff_size, use_cm=True, flash=c.flash_attention,
                             dropout=c.dropout, hash_dropout=c.hash_dropout)
            for _ in range(c.num_layers)
        )
        self.final_layer = nn.Linear(D, nf)
        # rotary table for the longest stream (audio tokens + 2 t-tokens)
        rot = make_rotary_table(D, max(self.emb_len + 2, c.max_seq_length) + 8)
        self.register_buffer("rotary_cos", rot.cos, persistent=False)
        self.register_buffer("rotary_sin", rot.sin, persistent=False)

    @property
    def layers(self):
        return self.seqTransDecoder.stack

    @property
    def rotary(self) -> Optional[RotaryTable]:
        return RotaryTable(self.rotary_cos, self.rotary_sin) if self.cfg.use_rotary else None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init from ``generator``, as the JAX package initialises:
        weights N(0, 1/fan_in), biases 0, norms identity, null embeddings N(0, 1)."""
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
    # conditioning (once per clip)
    # ------------------------------------------------------------------ #

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, S, 2] raw 48 kHz stereo -> [B, Ta, 1024] frozen wav2vec features
        (no graph: the role of the JAX package's stop_gradient)."""
        with torch.no_grad():
            return self.audio_model(audio)

    def encode_conditioning(
        self,
        audio: torch.Tensor,  # [B, S, 2]
        keyframes: torch.Tensor,  # [B, Tk, key_dim]
        keyframe_valid: Optional[torch.Tensor] = None,  # [B, Tk] 1 = valid
    ) -> CondTokens:
        cond_tokens = self.cond_projection(self.encode_audio(audio))
        kf = keyframes
        if keyframe_valid is not None:
            kf = kf * keyframe_valid[..., None]  # zero the unknown (diffusion.py:319-320)
        pose_tokens = self.frame_norm_cond(self.frame_cond_projection(kf))
        return CondTokens(cond_tokens, pose_tokens)

    # ------------------------------------------------------------------ #
    # per-step denoiser
    # ------------------------------------------------------------------ #

    def _stacked_cross_kv_weights(self):
        """All layers' cross-attn K (resp. V) projections as one [L*D, D]
        weight and [L*D] bias: one matmul projects the memory for every layer."""
        D = self.cfg.latent_dim
        ws = [l.multihead_attn.in_proj_weight for l in self.layers]
        bs = [l.multihead_attn.in_proj_bias for l in self.layers]
        kw = torch.cat([w[D : 2 * D] for w in ws])
        kb = torch.cat([b[D : 2 * D] for b in bs])
        vw = torch.cat([w[2 * D :] for w in ws])
        vb = torch.cat([b[2 * D :] for b in bs])
        return kw, kb, vw, vb

    def build_cond_cache(self, cond: CondTokens, keep_mask: torch.Tensor,
                         keep_mask_pose: Optional[torch.Tensor] = None) -> dict:
        """Everything in the denoise step that does not depend on (x, t).
        ``keep_mask_pose`` keeps the keyframe tokens (default: ``keep_mask``)."""
        if cond.pose_tokens is None:
            raise ValueError("the pose denoiser needs keyframe tokens")
        keep_e = keep_mask[:, None, None]
        n_cond = cond.cond_tokens.shape[1]
        cond_tokens = torch.where(keep_e, cond.cond_tokens, self.null_cond_embed[:, :n_cond])
        cond_hidden = self.non_attn_cond_projection(cond_tokens.mean(dim=-2))
        cond_hidden = torch.where(keep_mask[:, None], cond_hidden, self.null_cond_hidden)
        # LayerNorm is row-wise: the conditioning rows normed alone equal
        # their rows in norm_cond(concat([cond_tokens, t_tokens]))
        mem_cond = self.norm_cond(cond_tokens)
        rot = self.rotary
        mem_rot = apply_rotary(mem_cond, rot) if rot is not None else mem_cond
        kw, kb, vw, vb = self._stacked_cross_kv_weights()
        n_pose = cond.pose_tokens.shape[1]
        keep_p = keep_e if keep_mask_pose is None else keep_mask_pose[:, None, None]
        return {
            "ks": F.linear(mem_rot, kw, kb),  # [B, n_cond, L*D]
            "vs": F.linear(mem_cond, vw, vb),
            "cond_hidden": cond_hidden,
            "pose_tokens": torch.where(keep_p, cond.pose_tokens, self.null_pose_embed[:, :n_pose]),
            "n_cond": n_cond,
        }

    def denoise_cached(self, x: torch.Tensor, t: torch.Tensor, cache: dict,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, nfeats] at original-schedule timesteps t [B] -> model output.
        ``generator`` feeds the dropout draws in training mode."""
        D = self.cfg.latent_dim
        B = x.shape[0]
        h = self.input_projection(x)
        t_hidden = self.time_mlp(t)
        t_vec = self.to_time_cond(t_hidden) + cache["cond_hidden"]
        mem_t = self.norm_cond(self.to_time_tokens(t_hidden).reshape(B, 2, D))
        rot = self.rotary
        # the two t-token rows sit after the n_cond audio rows of the memory
        mem_t_rot = apply_rotary(mem_t, rot, cache["n_cond"]) if rot is not None else mem_t
        kw, kb, vw, vb = self._stacked_cross_kv_weights()
        ks = torch.cat([cache["ks"], F.linear(mem_t_rot, kw, kb)], dim=1)
        vs = torch.cat([cache["vs"], F.linear(mem_t, vw, vb)], dim=1)
        for i, layer in enumerate(self.layers):
            cross_kv = (ks[..., i * D : (i + 1) * D], vs[..., i * D : (i + 1) * D])
            h = layer(h, t_vec, cross_kv, cache["pose_tokens"], rotary=rot, generator=generator)
        return self._postnet(self.final_layer(h), generator)

    def denoise(
        self,
        x: torch.Tensor,  # [B, T, nfeats] noisy motion
        t: torch.Tensor,  # [B] original-schedule timesteps
        cond: CondTokens,
        keep_mask: torch.Tensor,  # [B] bool: False -> null conditioning (CFG)
        keep_mask_pose: Optional[torch.Tensor] = None,  # [B] bool for the keyframes
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return self.denoise_cached(x, t, self.build_cond_cache(cond, keep_mask, keep_mask_pose), generator)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, nfeats] noisy motion
        t: torch.Tensor,  # [B] timesteps
        audio: torch.Tensor,  # [B, S, 2] raw 48 kHz stereo
        keyframes: torch.Tensor,  # [B, Tk, key_dim]
        keyframe_valid: Optional[torch.Tensor] = None,
        cond_drop_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,  # CPU generator of this step's draws
    ) -> torch.Tensor:
        """The training forward: encode, classifier-free-guidance dropout of
        the audio and, independently, of the keyframes (diffusion.py:326,
        :367), denoise."""
        cond = self.encode_conditioning(audio, keyframes, keyframe_valid)
        B = x.shape[0]
        if cond_drop_prob > 0.0:
            u = torch.rand((2, B), generator=generator).to(x.device)
            keep, keep_pose = u[0] >= cond_drop_prob, u[1] >= cond_drop_prob
        else:
            keep = keep_pose = torch.ones((B,), dtype=torch.bool, device=x.device)
        return self.denoise(x, t, cond, keep, keep_pose, generator)

    def _postnet(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Causal dilated conv stack with averaged skip connections
        (reference: diffusion.py:214-224)."""
        out = F.pad(x, (0, 0, self.cfg.postnet_receptive_field - 1, 0))
        for conv in self.post_pose_layers:
            y = conv1d(out, conv.weight.permute(2, 1, 0), conv.bias,
                       dilation=conv.dilation[0], padding=(0, 0))
            y = self.post_drop(F.leaky_relu(y, negative_slope=0.2), generator)
            out = (out[:, -y.shape[1]:, :] + y) / 2.0 if out.shape[-1] == y.shape[-1] else y
        return valid_conv1d(out, self.final_conv.weight.permute(2, 1, 0), self.final_conv.bias)
