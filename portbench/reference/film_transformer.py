"""The FiLM-transformer diffusion denoiser, pose and face branches, in plain
PyTorch: a frozen copy of the measured package's module, with the same
parameter names, so one state dict loads into both.

- ``encode_conditioning``: frozen wav2vec features; pose -> projected audio
  tokens and keyframe tokens; face -> the frozen lip regressor's vertices
  concatenated to the features -> projection -> the rotary cond encoder.
- ``build_cond_cache`` + ``denoise_cached``: the per-step denoiser (the
  memory's cross-attention K/V projected per call here as there).
- ``forward``: the training forward with the guidance-dropout draws.

``cfg.dtype`` sets the compute dtype (f32 parameters, bf16 wide tensors
under "bfloat16", the pooled conditioning and time embedding in f32, f32
output).  Dropout draws come from the ``generator`` handed in, in the
order the measured package draws them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import DenoiserConfig
from portbench.reference.dtypes import default_policy
from portbench.reference.audio_encoder import Wav2VecFeatureExtractor, feature_frames
from portbench.reference.blocks import (
    Dropout,
    FiLMDecoderLayer,
    RotaryEncoderLayer,
    kept,
    layer_norm,
    linear,
)
from portbench.reference.lip_regressor import LipRegressor
from portbench.reference.convs import conv1d, valid_conv1d
from portbench.reference.embeddings import sinusoidal_pos_emb
from portbench.reference.rotary import RotaryTable, apply_rotary, make_rotary_table
from portbench.reference import rows as sharding


class CondTokens(NamedTuple):
    """Precomputed conditioning, constant across denoising steps."""

    cond_tokens: torch.Tensor  # [B, Ta, D] projected audio tokens
    pose_tokens: Optional[torch.Tensor]  # [B, Tk, D] projected keyframes (pose), None (face)


def _resize_nearest(x: torch.Tensor, n: int) -> torch.Tensor:
    """Nearest-exact resize of [B, T, C] along T to n (diffusion.py:309-311).
    The index is computed in f32 on the CPU, as the JAX package computes it:
    a CUDA division by a scalar multiplies by its reciprocal."""
    T = x.shape[1]
    idx = ((torch.arange(n, dtype=torch.float32) + 0.5) * T / n).to(torch.int64).clamp(0, T - 1)
    return x[:, idx.to(x.device)]


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
    LIP_CHUNK = 120  # frames per lip-regressor call (diffusion.py:295-313)

    def __init__(self, cfg: DenoiserConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.data_format not in ("pose", "face"):
            raise ValueError(f"data_format must be pose or face; got {c.data_format!r}")
        self.policy = default_policy(c.dtype)
        dt = self.dtype = self.policy.compute_dtype
        pose = c.data_format == "pose"
        D, nf = c.latent_dim, c.nfeats
        # frozen
        self.audio_model = Wav2VecFeatureExtractor(compute_dtype=c.frontend_dtype).requires_grad_(False)
        if not pose:
            self.lip_model = LipRegressor().requires_grad_(False)  # frozen, f32
            self.cond_encoder = nn.ModuleList(
                RotaryEncoderLayer(D, c.num_heads, c.ff_size, c.dropout, flash=c.flash_attention,
                                   hash_dropout=c.hash_dropout, dtype=dt)
                for _ in range(c.cond_encoder_layers)
            )
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
        if pose:
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
            FiLMDecoderLayer(D, c.num_heads, c.ff_size, use_cm=pose, flash=c.flash_attention,
                             dropout=c.dropout, hash_dropout=c.hash_dropout, dtype=dt)
            for _ in range(c.num_layers)
        )
        self.final_layer = nn.Linear(D, nf)
        # rotary table for the longest stream (audio tokens + 2 t-tokens)
        rot = make_rotary_table(D, max(self.emb_len + 2, c.max_seq_length) + 8)
        self.register_buffer("rotary_cos", rot.cos, persistent=False)
        self.register_buffer("rotary_sin", rot.sin, persistent=False)
        self.to(self.policy.param_dtype)  # parameters (and the optimizer state built on them) f32 under any policy

    def train(self, mode: bool = True) -> "FiLMDenoiser":
        """Training mode for everything but the frozen frontends, which stay
        in eval mode (the lip regressor's feed-forward dropout stays off, as
        the JAX package runs it)."""
        super().train(mode)
        self.audio_model.eval()
        if self.cfg.data_format == "face":
            self.lip_model.eval()
        return self

    @property
    def layers(self):
        return self.seqTransDecoder.stack

    @property
    def rotary(self) -> Optional[RotaryTable]:
        """The decoder's rotary table (None without ``use_rotary``); the
        face cond-encoder always rotates, as the JAX package does."""
        return RotaryTable(self.rotary_cos, self.rotary_sin) if self.cfg.use_rotary else None

    # ------------------------------------------------------------------ #
    # conditioning (once per clip)
    # ------------------------------------------------------------------ #

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, S, 2] raw 48 kHz stereo -> [B, Ta, 1024] frozen wav2vec features
        (no graph: the role of the JAX package's stop_gradient)."""
        with torch.no_grad():
            return self.audio_model(audio)

    def lip_vertices(self, audio: torch.Tensor) -> torch.Tensor:
        """Channel-0 audio [B, S, 2] -> [B, T, 1014] frozen lip vertices, one
        per 1600-sample frame: the frames in 120-frame chunks stacked into the
        batch, the last chunk at its true length (diffusion.py:295-313)."""
        B = audio.shape[0]
        frames = audio[..., 0].reshape(B, -1, 1600)
        n_full, rem = divmod(frames.shape[1], self.LIP_CHUNK)
        pieces = []
        with torch.no_grad():
            if n_full:
                stacked = frames[:, : n_full * self.LIP_CHUNK].reshape(B * n_full, self.LIP_CHUNK, 1600)
                pieces.append(self.lip_model(stacked).reshape(B, n_full * self.LIP_CHUNK, -1))
            if rem:
                pieces.append(self.lip_model(frames[:, n_full * self.LIP_CHUNK:]).reshape(B, rem, -1))
        return torch.cat(pieces, dim=1)

    def encode_lip(self, audio: torch.Tensor, n_cond: int) -> torch.Tensor:
        """[B, S, 2] -> [B, n_cond, 1014]: ``lip_vertices`` resized from T
        frames to the n_cond audio tokens (``_resize_nearest``)."""
        return _resize_nearest(self.lip_vertices(audio), n_cond)

    def encode_conditioning(
        self,
        audio: Optional[torch.Tensor],  # [B, S, 2]
        keyframes: Optional[torch.Tensor] = None,  # [B, Tk, key_dim] (pose)
        keyframe_valid: Optional[torch.Tensor] = None,  # [B, Tk] 1 = valid (pose)
        generator: Optional[torch.Generator] = None,  # cond-encoder dropout (face, training)
        lip_verts: Optional[torch.Tensor] = None,  # [B, T, 1014] ``lip_vertices(audio)`` (face)
        audio_features: Optional[torch.Tensor] = None,  # [B, Ta, 1024] ``encode_audio(audio)``
    ) -> CondTokens:
        """Per-clip conditioning.  ``audio_features`` and, for a face model,
        ``lip_verts`` stand in for the frozen frontends' outputs (the
        trainer's feature cache, ``data/feature_cache.py``): given
        ``encode_audio(audio)`` and ``lip_vertices(audio)`` the result is the
        raw-audio path's, exactly.  ``audio`` may then be None.  The frozen
        features reach the compute dtype before the lip gather and the
        concat (film_transformer.py:217-221)."""
        dt = self.dtype
        feats = (self.encode_audio(audio) if audio_features is None else audio_features.detach()).to(dt)
        if self.cfg.data_format == "face":
            lip = (self.lip_vertices(audio) if lip_verts is None else lip_verts.detach()).to(dt)
            feats = torch.cat([feats, _resize_nearest(lip, feats.shape[1])], dim=-1)
            cond_tokens = linear(self.cond_projection, feats, dt)
            rot = RotaryTable(self.rotary_cos, self.rotary_sin)
            for layer in self.cond_encoder:
                cond_tokens = layer(cond_tokens, rotary=rot, generator=generator)
            return CondTokens(cond_tokens, None)
        if keyframes is None:
            raise ValueError("the pose denoiser needs keyframes")
        cond_tokens = linear(self.cond_projection, feats, dt)
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
        weight and [L*D] bias in the compute dtype: one matmul projects the
        memory for every layer.  Kept across a sampling loop (``kept``)."""
        D = self.cfg.latent_dim
        ws = [l.multihead_attn.in_proj_weight for l in self.layers]
        bs = [l.multihead_attn.in_proj_bias for l in self.layers]
        return kept(self, "cross_kv", ws + bs, self.dtype, lambda: tuple(torch.cat(x).to(self.dtype) for x in (
            [w[D : 2 * D] for w in ws], [b[D : 2 * D] for b in bs], [w[2 * D :] for w in ws], [b[2 * D :] for b in bs])))

    def build_cond_cache(self, cond: CondTokens, keep_mask: torch.Tensor,
                         keep_mask_pose: Optional[torch.Tensor] = None) -> dict:
        """Everything in the denoise step that does not depend on (x, t).
        ``keep_mask_pose`` keeps the keyframe tokens (default: ``keep_mask``)."""
        pose = self.cfg.data_format == "pose"
        if pose and cond.pose_tokens is None:
            raise ValueError("the pose denoiser needs keyframe tokens")
        dt = self.dtype
        keep_e = keep_mask[:, None, None]
        n_cond = cond.cond_tokens.shape[1]
        cond_tokens = torch.where(keep_e, cond.cond_tokens.to(dt), self.null_cond_embed[:, :n_cond].to(dt))
        # the pooled path stays f32 (a ~2000-token mean in bf16 would lose precision)
        cond_hidden = self.non_attn_cond_projection(cond_tokens.float().mean(dim=-2))
        cond_hidden = torch.where(keep_mask[:, None], cond_hidden, self.null_cond_hidden)
        # LayerNorm is row-wise: the conditioning rows normed alone equal
        # their rows in norm_cond(concat([cond_tokens, t_tokens]))
        mem_cond = layer_norm(self.norm_cond, cond_tokens, dt)
        rot = self.rotary
        mem_rot = apply_rotary(mem_cond, rot) if rot is not None else mem_cond
        kw, kb, vw, vb = self._stacked_cross_kv_weights()
        pose_tokens = None
        if pose:
            n_pose = cond.pose_tokens.shape[1]
            keep_p = keep_e if keep_mask_pose is None else keep_mask_pose[:, None, None]
            pose_tokens = torch.where(keep_p, cond.pose_tokens.to(dt), self.null_pose_embed[:, :n_pose].to(dt))
        return {
            "ks": F.linear(mem_rot, kw, kb),  # [B, n_cond, L*D]
            "vs": F.linear(mem_cond, vw, vb),
            "cond_hidden": cond_hidden,
            "pose_tokens": pose_tokens,
            "n_cond": n_cond,
        }

    def denoise_cached(self, x: torch.Tensor, t: torch.Tensor, cache: dict,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, nfeats] at original-schedule timesteps t [B] -> model output.
        ``generator`` feeds the dropout draws in training mode."""
        D, dt = self.cfg.latent_dim, self.dtype
        B = x.shape[0]
        h = linear(self.input_projection, x, dt)
        t_hidden = self.time_mlp(t)  # the time embedding and t_vec in f32
        t_vec = self.to_time_cond(t_hidden) + cache["cond_hidden"]
        mem_t = layer_norm(self.norm_cond, self.to_time_tokens(t_hidden).reshape(B, 2, D).to(dt), dt)
        rot = self.rotary
        # the two t-token rows sit after the n_cond audio rows of the memory
        mem_t_rot = apply_rotary(mem_t, rot, cache["n_cond"]) if rot is not None else mem_t
        kw, kb, vw, vb = self._stacked_cross_kv_weights()
        ks = torch.cat([cache["ks"], F.linear(mem_t_rot, kw, kb)], dim=1)
        vs = torch.cat([cache["vs"], F.linear(mem_t, vw, vb)], dim=1)
        for i, layer in enumerate(self.layers):
            cross_kv = (ks[..., i * D : (i + 1) * D], vs[..., i * D : (i + 1) * D])
            h = layer(h, t_vec, cross_kv, cache["pose_tokens"], rotary=rot, generator=generator)
        out = self.final_layer(h.to(self.policy.output_dtype))  # the post-net and the output are f32
        return self._postnet(out, generator) if self.cfg.data_format == "pose" else out

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
        audio: Optional[torch.Tensor],  # [B, S, 2] raw 48 kHz stereo
        keyframes: Optional[torch.Tensor] = None,  # [B, Tk, key_dim] (pose)
        keyframe_valid: Optional[torch.Tensor] = None,
        cond_drop_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,  # CPU generator of this step's draws
        audio_features: Optional[torch.Tensor] = None,  # [B, Ta, 1024] precomputed
        lip_verts: Optional[torch.Tensor] = None,  # [B, T, 1014] precomputed (face)
    ) -> torch.Tensor:
        """The training forward: encode, classifier-free-guidance dropout of
        the audio and, independently, of the keyframes (diffusion.py:326,
        :367), denoise.  ``audio_features`` / ``lip_verts`` as in
        ``encode_conditioning``."""
        cond = self.encode_conditioning(audio, keyframes, keyframe_valid, generator, lip_verts, audio_features)
        B = x.shape[0]
        if cond_drop_prob > 0.0:
            # the global batch's draw under a data-parallel step, this rank's columns of it
            u = sharding.draw_global(lambda s: torch.rand(s, generator=generator), (2, B), dim=1).to(x.device)
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
