"""The drivable codec-avatar body model.

Counterpart of ``audio2photoreal_tpu/render/mesh_vae.py`` (reference:
visualize/ca_body/models/mesh_vae_drivable.py:72-500): (104-d lbs pose,
256-d face codes) → posed geometry + view-dependent 2k texture → rasterized
RGB.  Components and their state-dict names follow the reference:

- ``encoder``        BodyEncoder  ← Encoder (:376-455)
- ``encoder_face``   FaceEncoder  ← FaceEncoder (:637-719)
- ``decoder_face``   FaceDecoderFrontal (nn/face.py:18-85)
- ``decoder``        ConvDecoder  ← ConvDecoder (:456-635), its final
                     ``verts_conv`` / ``tex_conv`` as two convs (the JAX
                     package fuses them into one block-diagonal conv)
- ``decoder_view``   UNetViewDecoder (:721-739)
- ``shadow_net`` / ``pose_to_shadow`` / ``upscale_net`` (:95-252)
- ``cal`` / ``learn_blur`` / ``pixel_cal`` (:180-200), at ``n_cameras > 0``:
                     the training forward's per-camera calibration
                     (``render/calibration.py``)

Static per-person assets ride in ``RendererAssets`` as non-persistent
buffers: they move with ``.to(device)`` and stay out of the state_dict.
Inside ``render/layers.py:render_compute_dtype(torch.bfloat16)`` the model
renders in bf16 as the JAX package's does under its namesake: f32
parameters, bf16 activations between the layers, and type promotion for the
rest (the f32 assets promote what they touch, so the LBS geometry, the
raster's inputs and the display values stay f32; the texture chain casts
the assets to the texture's dtype first).
Tensors are NCHW; vertex arrays [B, V, 3].  ``forward(training=True)`` is
the training branch (:322-371): the GT-AO shadow drives the texture and the
pose shadow is exposed for its distillation, the calibration runs on the
texture and on the render, and the raster's inputs are detached, so the
texture's gradient reaches it through the bilinear sampler alone.  The
inference forward ignores the calibration modules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.kernels.display_pack import carrier_scalar, finalize_display
from audio2photoreal_tpu_torch.parallel import sharding
from audio2photoreal_tpu_torch.render.blocks import ConvBlock, ConvDownBlock, UpConvBlockDeep, UpscaleNet
from audio2photoreal_tpu_torch.render.calibration import CalV5, CameraPixelBias, LearnableBlur
from audio2photoreal_tpu_torch.render.face import FaceDecoderFrontal
from audio2photoreal_tpu_torch.render.geometry import GeometryModule, compute_view_cos, project_points
from audio2photoreal_tpu_torch.render.layers import Conv2dWNUB, LinearWN, reset_parameters, resize_bilinear, tile2d
from audio2photoreal_tpu_torch.render.lbs import LBSModule
from audio2photoreal_tpu_torch.render.rasterizer import render_mesh
from audio2photoreal_tpu_torch.render.seams import SeamSampler
from audio2photoreal_tpu_torch.render.shadow import PoseToShadow, ShadowUNet
from audio2photoreal_tpu_torch.render.unet import UNetWB


@dataclass(frozen=True)
class RendererConfig:
    """The JAX package's RendererConfig (renderer.json), less ``s2d_tail``
    (a TPU layout switch); a bundle that names it loads with it dropped
    (``render/assets.py:load_bundle_parts``)."""

    uv_size: int = 1024
    init_uv_size: int = 64
    upscale_size: int = 2048
    n_embs: int = 256
    n_face_embs: int = 256
    n_pose_dims: int = 98  # motion[6:] (mesh_vae_drivable.py:587)
    n_pose_enc_channels: int = 64
    n_embs_enc_channels: int = 64
    n_init_channels: int = 128
    n_min_channels: int = 16
    shadow_size: int = 256
    view_unet_ftrs: int = 8
    encoder_in_size: int = 512
    face_tex_size: int = 1024
    n_face_verts: int = 7306
    noise_std: float = 1.0  # the posterior sample's noise scale (training)
    image_height: int = 1024
    image_width: int = 667
    n_cameras: int = 0  # > 0: the training forward's per-camera calibration modules


class RendererAssets(nn.Module):
    """Static per-person assets; image-like arrays are [C, H, W]."""

    def __init__(self, geo: GeometryModule, lbs: LBSModule, seam: SeamSampler, seam_2k: SeamSampler,
                 tex_mean, tex_std: float, ao_mean, face_cond_mask, pose_cond_mask, body_cond_mask,
                 non_head_mask, face_tex_mask, frontal_view):
        super().__init__()
        self.geo, self.lbs, self.seam, self.seam_2k = geo, lbs, seam, seam_2k
        self.tex_std = float(tex_std)
        for name, value in dict(
            tex_mean=tex_mean, ao_mean=ao_mean, face_cond_mask=face_cond_mask,
            pose_cond_mask=pose_cond_mask, body_cond_mask=body_cond_mask,
            non_head_mask=non_head_mask, face_tex_mask=face_tex_mask, frontal_view=frontal_view,
        ).items():
            self.register_buffer(name, torch.as_tensor(np.asarray(value), dtype=torch.float32),
                                 persistent=False)


def draw_posterior_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The standard-normal draw of a posterior sample: the one place the
    encoders' training noise is drawn (tests replace it by JAX's draws)."""
    return torch.randn(shape, generator=generator, device=device)


def _posterior(mu: torch.Tensor, logvar: torch.Tensor, noise: Optional[torch.Tensor], noise_std: float):
    """mu + exp(logvar)·ε·noise_std (mesh_vae_drivable.py:441-447), or mu."""
    return mu if noise is None else mu + torch.exp(logvar) * noise * noise_std


class BodyEncoder(nn.Module):
    """Unposed-verts UV → body embedding (reference Encoder :376-455)."""

    def __init__(self, cfg: RendererConfig):
        super().__init__()
        S = cfg.encoder_in_size
        self.size, self.noise_std = S, cfg.noise_std
        self.verts_conv = ConvDownBlock(3, 8, S)
        plan = [16, 32, 32, 64, 128, 128]
        n_downs = int(math.log2(S // 4)) - 1  # verts_conv already halved once
        blocks, cin = [], 8
        for i, c in enumerate(plan[-n_downs:]):
            blocks.append(ConvDownBlock(cin, c, (S // 2) // 2**i))
            cin = c
        self.joint_conv_blocks = nn.ModuleList(blocks)
        self.mu = LinearWN(cin * 4 * 4, cfg.n_embs)
        self.logvar = LinearWN(cin * 4 * 4, cfg.n_embs)

    def forward(self, verts_unposed_uv: torch.Tensor, mask: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``noise``: ε of the posterior sample; None → the mean."""
        x = resize_bilinear(verts_unposed_uv, (self.size, self.size)) * mask[None]
        x = self.verts_conv(x)
        for blk in self.joint_conv_blocks:
            x = blk(x)
        x = x.flatten(1)
        mu, logvar = self.mu(x), 0.1 * self.logvar(x)
        return {"embs": _posterior(mu, logvar, noise, self.noise_std), "embs_mu": mu, "embs_logvar": logvar}


class FaceEncoder(nn.Module):
    """Face decoder outputs → body-space face embedding (:637-719)."""

    def __init__(self, cfg: RendererConfig):
        super().__init__()
        S = cfg.encoder_in_size
        self.size, self.noise_std = S, cfg.noise_std
        plan = [4, 8, 16, 32, 64, 128, 128]
        n_downs = int(math.log2(S // 4))
        blocks, cin = [], 3
        for i, c in enumerate(plan[-n_downs:]):
            blocks.append(ConvDownBlock(cin, c, S // 2**i))
            cin = c
        self.conv_blocks = nn.ModuleList(blocks)
        self.geommod = nn.Sequential(LinearWN(3 * cfg.n_face_verts, 256), nn.LeakyReLU(0.2))
        self.jointmod = nn.Sequential(LinearWN(cin * 4 * 4 + 256, 512), nn.LeakyReLU(0.2))
        self.mu = LinearWN(512, cfg.n_face_embs)
        self.logvar = LinearWN(512, cfg.n_face_embs)

    def forward(self, face_geom, face_tex, tex_cond_mask,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        B = face_geom.shape[0]
        tex = resize_bilinear(face_tex, (self.size, self.size))
        x = (tex / 255.0 - 0.5) * tex_cond_mask[None]
        for blk in self.conv_blocks:
            x = blk(x)
        geom_enc = self.geommod(face_geom.reshape(B, -1))
        joint = self.jointmod(torch.cat([x.flatten(1), geom_enc], dim=-1))
        mu, logvar = self.mu(joint), 0.1 * self.logvar(joint)
        return {"face_embs": _posterior(mu, logvar, noise, self.noise_std), "face_embs_mu": mu,
                "face_embs_logvar": logvar}


def _embs_plan(S0: int, enc_channels: int):
    n_ups = int(np.log2(S0 // 4))
    plan = [128, 128, 64][max(3 - (n_ups - 1), 0):] + [enc_channels]
    return plan[-n_ups:]


def _face_plan(S0: int, enc_channels: int):
    n_ups = int(np.log2(S0 // 8))
    return ([64, 64][max(2 - (n_ups - 1), 0):] + [enc_channels])[-n_ups:]


class ConvDecoder(nn.Module):
    """Pose + embeddings → geometry delta UV + mean texture (:456-635)."""

    def __init__(self, cfg: RendererConfig):
        super().__init__()
        c = cfg
        S0 = c.init_uv_size
        self.S0 = S0
        n_blocks = int(np.log2(c.uv_size // S0))
        sizes = [S0 * 2**s for s in range(n_blocks + 1)]
        n_channels = [max(c.n_init_channels // 2**b, c.n_min_channels) for b in range(n_blocks + 1)]
        self.local_pose_conv_block = ConvBlock(c.n_pose_dims, c.n_pose_enc_channels, S0, kernel_size=1, padding=0)
        self.embs_fc = nn.Sequential(LinearWN(c.n_embs, 4 * 4 * 128), nn.LeakyReLU(0.2))
        blocks, cin = [], 128
        for i, cc in enumerate(_embs_plan(S0, c.n_embs_enc_channels)):
            blocks.append(UpConvBlockDeep(cin, cc, 4 * 2 ** (i + 1)))
            cin = cc
        self.embs_conv_block = nn.ModuleList(blocks)
        self.face_embs_fc = nn.Sequential(LinearWN(c.n_face_embs, 4 * 4 * 32), nn.LeakyReLU(0.2))
        blocks, cin_f = [], 32
        for i, cc in enumerate(_face_plan(S0, c.n_embs_enc_channels)):
            blocks.append(UpConvBlockDeep(cin_f, cc, 4 * 2 ** (i + 1)))
            cin_f = cc
        self.face_embs_conv_block = nn.ModuleList(blocks)
        self.joint_conv_block = ConvBlock(c.n_pose_enc_channels + cin, c.n_init_channels, S0)
        self.conv_blocks = nn.ModuleList(
            UpConvBlockDeep(n_channels[b] * 2, n_channels[b + 1] * 2, sizes[b + 1], groups=2)
            for b in range(n_blocks)
        )
        half = n_channels[-1]
        self.verts_conv = Conv2dWNUB(half, 3, c.uv_size, c.uv_size, 3, 1, 1)
        self.tex_conv = Conv2dWNUB(half, 3, c.uv_size, c.uv_size, 3, 1, 1)

    def forward(self, motion, embs, face_embs, assets: RendererAssets) -> Dict[str, torch.Tensor]:
        S0, h2 = self.S0, self.S0 // 2
        pose = motion[:, 6:]
        non_head = (assets.body_cond_mask * (1.0 - assets.face_cond_mask)).clamp(0.0, 1.0)  # [1, S0, S0]
        pose_masked = tile2d(pose, S0) * assets.pose_cond_mask[None]
        pose_conv = self.local_pose_conv_block(pose_masked) * non_head[None]
        h = self.embs_fc(embs).reshape(-1, 128, 4, 4)
        for blk in self.embs_conv_block:
            h = blk(h)
        hf = self.face_embs_fc(face_embs).reshape(-1, 32, 4, 4)
        for blk in self.face_embs_conv_block:
            hf = blk(hf)
        # splice the face region into the lower-left quadrant (:602-606)
        region = (
            hf * assets.face_cond_mask[None, :, h2:, :h2]
            + h[:, :, h2:, :h2] * non_head[None, :, h2:, :h2]
        )
        embs_conv = h.clone()
        embs_conv[:, :, h2:, :h2] = region
        joint = self.joint_conv_block(torch.cat([pose_conv, embs_conv], dim=1))
        x = torch.cat([joint, joint], dim=1)  # 2 groups: verts + tex
        for blk in self.conv_blocks:
            x = blk(x)
        x = assets.seam.apply(x, 2)
        half = x.shape[1] // 2
        verts_uv_delta = self.verts_conv(x[:, :half])
        tex_mean_rec = self.tex_conv(x[:, half:])
        return {
            "geom_delta_rec": assets.geo.from_uv(verts_uv_delta),
            "geom_uv_delta_rec": verts_uv_delta,
            "tex_mean_rec": tex_mean_rec,
            "embs_conv": embs_conv,
            "pose_conv": pose_conv,
        }


class UNetViewDecoder(nn.Module):
    """View-cos conditioned texture residual (:721-739)."""

    def __init__(self, cfg: RendererConfig):
        super().__init__()
        self.unet = UNetWB(4, 3, cfg.uv_size, n_init_ftrs=cfg.view_unet_ftrs)

    def forward(self, geom_rec, tex_mean_rec, camera_pos, geo: GeometryModule) -> Dict[str, torch.Tensor]:
        view_cos = compute_view_cos(geom_rec, geo.faces, camera_pos).detach()
        cond = torch.cat([geo.to_uv(view_cos[..., None]), tex_mean_rec], dim=1)
        return {"tex_view_rec": self.unet(cond), "cond_view": cond}


class BodyAvatar(nn.Module):
    """The drivable avatar (reference AutoEncoder :276-373)."""

    CALIBRATION = ("cal", "learn_blur", "pixel_cal")  # built when n_cameras > 0

    def __init__(self, cfg: RendererConfig, assets: RendererAssets):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.assets = assets
        self.encoder = BodyEncoder(c)
        self.encoder_face = FaceEncoder(c)
        self.decoder_face = FaceDecoderFrontal(
            assets.frontal_view, n_latent=c.n_face_embs, n_vert_out=3 * c.n_face_verts,
            tex_size=c.face_tex_size,
        )
        self.decoder = ConvDecoder(c)
        self.decoder_view = UNetViewDecoder(c)
        # the AO-driven shadow of training (biases=False, as render_codes.py
        # builds it): its weights are in body_dec.ckpt; inference uses
        # pose_to_shadow
        self.shadow_net = ShadowUNet(c.upscale_size, c.shadow_size, assets.ao_mean, biases=False)
        self.pose_to_shadow = PoseToShadow(104, c.upscale_size)
        self.upscale_net = UpscaleNet(6, out_channels=3, n_ftrs=16, size=c.uv_size)
        if c.n_cameras > 0:
            self.cal = CalV5(c.n_cameras)
            self.learn_blur = LearnableBlur(c.n_cameras)
            self.pixel_cal = CameraPixelBias(c.n_cameras, c.image_height, c.image_width)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights from ``generator``; the calibration at identity."""
        reset_parameters(self, generator)
        for name in self.CALIBRATION:
            if hasattr(self, name):
                getattr(self, name).reset_parameters()

    # -- encode ---------------------------------------------------------- #

    def template_body_embs(self) -> torch.Tensor:
        """[1, n_embs] body embedding of the TEMPLATE geometry: what the
        per-frame body encode collapses to in the driving mode, where the
        geometry fed to encode() is the LBS-posed template that encode()
        unposes again (render_codes.py:107-114)."""
        a = self.assets
        return self.encoder(a.geo.to_uv(a.lbs.template_verts), a.non_head_mask)["embs"]

    def face_codes_to_body_embs(self, face_embs_hqlp: torch.Tensor) -> torch.Tensor:
        """HQLP face codes → body-space face embeddings via the frozen face
        decoder + face encoder (render_codes.py:107-114 +
        mesh_vae_drivable.py:265-267)."""
        face_dec = {k: v.detach() for k, v in self.decoder_face(face_embs_hqlp).items()}
        return self.encoder_face(face_dec["face_geom"], face_dec["face_tex"], self.assets.face_tex_mask)["face_embs"]

    def encode(self, geom, lbs_motion, face_embs_hqlp, posterior_noise: bool = False,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """(posed geometry, pose, HQLP face codes) → embeddings (:254-274).
        No gradient reaches the unposed vertices or the frozen face
        decoder's outputs.  ``posterior_noise``: the embeddings are posterior
        samples, the body's and the face's ε two independent draws from
        ``generator`` (as in the reference)."""
        a = self.assets
        verts_unposed = a.lbs.unpose(geom, lbs_motion).detach()
        face_dec = {k: v.detach() for k, v in self.decoder_face(face_embs_hqlp).items()}
        eps_body = eps_face = None
        if posterior_noise:
            B, dev = geom.shape[0], geom.device
            # under a data-parallel step, this rank's rows of the global batch's draws
            draw = lambda s: draw_posterior_noise(s, generator, dev)  # noqa: E731
            eps_body = sharding.draw_global(draw, (B, self.cfg.n_embs))
            eps_face = sharding.draw_global(draw, (B, self.cfg.n_face_embs))
        enc = self.encoder(a.geo.to_uv(verts_unposed), a.non_head_mask, eps_body)
        face_enc = self.encoder_face(face_dec["face_geom"], face_dec["face_tex"], a.face_tex_mask, eps_face)
        return {**enc, **face_enc, "face_dec_preds": face_dec}

    # -- decode ---------------------------------------------------------- #

    def upscale_tex(self, tex_mean_rec, tex_view_rec) -> torch.Tensor:
        """The first half of ``forward_tex``: seam fixups, then the 2k
        upscale with its pixel-shuffle residual; the raw texture before
        x std + mean."""
        x = torch.cat([tex_mean_rec, tex_view_rec], dim=1)
        tex = self.assets.seam.apply(tex_mean_rec + tex_view_rec, 1)
        S = self.cfg.upscale_size
        return resize_bilinear(tex, (S, S)) + self.upscale_net(x)

    def forward_tex(self, tex_mean_rec, tex_view_rec, shadow_map, shadow_seamed=None) -> torch.Tensor:
        """(:230-252): seam fixups → 2k upscale (+ pixel-shuffle residual) →
        ×std+mean → shadow multiply → seam fixups; ``shadow_seamed`` reuses
        a shadow whose seam pass is already done.  The display path runs the
        second half as ``finalize_display`` instead (``render_view``)."""
        a = self.assets
        tex = self.upscale_tex(tex_mean_rec, tex_view_rec)
        # x std + mean and x shadow in the texture's dtype, the f32 assets
        # cast to it first (mesh_vae.py:428-432)
        dt = tex.dtype
        tex = tex * carrier_scalar(a.tex_std, dt) + a.tex_mean[None].to(dt)
        if shadow_seamed is None:
            shadow_seamed = a.seam_2k.apply(shadow_map, 2)
        return a.seam_2k.apply(tex * shadow_seamed.to(dt), 2)

    def decode_frame(
        self,
        lbs_motion: torch.Tensor,  # [B, 104]
        geom: Optional[torch.Tensor] = None,  # [B, V, 3] posed (encode path)
        face_embs: Optional[torch.Tensor] = None,  # HQLP codes [B, 256]
        embs: Optional[torch.Tensor] = None,
        face_embs_body: Optional[torch.Tensor] = None,
        encode: bool = True,
        use_pose_shadow: bool = True,
        ao: Optional[torch.Tensor] = None,  # [B, 1, S, S] (use_pose_shadow=False)
        posterior_noise: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The VIEW-INDEPENDENT half of a frame: encode (or the face-code
        translation alone), ConvDecoder, LBS pose, the shadow (pose-driven,
        or from the AO map ``ao``, as the training branch takes it) and its
        seam pass.  Returns what ``render_view`` consumes."""
        preds: Dict[str, torch.Tensor] = {}
        if encode:
            enc = self.encode(geom, lbs_motion, face_embs, posterior_noise, generator)
            embs, face_embs_body = enc["embs"], enc["face_embs"]
            preds.update(enc)
        elif face_embs_body is None and face_embs is not None:
            face_embs_body = self.face_codes_to_body_embs(face_embs)
        dec = self.decoder(lbs_motion, embs, face_embs_body, self.assets)
        geom_rec = self.assets.lbs.pose(dec["geom_delta_rec"], lbs_motion)
        shadow = self.pose_to_shadow(lbs_motion) if use_pose_shadow else self.shadow_net(ao)
        shadow_seamed = self.assets.seam_2k.apply(shadow["shadow_map"], 2)
        preds.update(geom=geom_rec, shadow_seamed=shadow_seamed, **dec, **shadow)
        return preds

    def render_view(self, decoded: Dict[str, torch.Tensor], campos, K, Rt,
                    render_display: bool = True) -> Dict[str, torch.Tensor]:
        """The PER-CAMERA half of a frame: view-conditioned texture residual,
        texture finalisation, projection and rasterisation.  ``decoded``
        needs {geom, tex_mean_rec, shadow_seamed}."""
        a = self.assets
        geom_rec = decoded["geom"]
        dec_view = self.decoder_view(geom_rec, decoded["tex_mean_rec"], campos, a.geo)
        if render_display:
            # x std + mean, x shadow and the display transform in one pass
            # (the display_pack kernel on the card); the last seam pass runs
            # in display space
            tex = self.upscale_tex(decoded["tex_mean_rec"], dec_view["tex_view_rec"])
            texture, tex_rec = finalize_display(tex, decoded["shadow_seamed"], a.tex_mean, a.tex_std)
            texture = a.seam_2k.apply_display(texture, 2)
        else:
            tex_rec = texture = self.forward_tex(decoded["tex_mean_rec"], dec_view["tex_view_rec"], None,
                                                 shadow_seamed=decoded["shadow_seamed"])
        pix, depth = project_points(geom_rec, K, Rt)
        rgb, raster = render_mesh(pix, depth, a.geo.faces, a.geo.uv_coords, a.geo.uv_faces, texture,
                                  self.cfg.image_height, self.cfg.image_width, display=render_display)
        return {"rgb": rgb, "tex_rec": tex_rec, "depth": raster.depth, "pix_to_face": raster.face_index,
                **dec_view}

    def forward(
        self,
        lbs_motion: torch.Tensor,  # [B, 104]
        campos: torch.Tensor,  # [B, 3]
        geom: Optional[torch.Tensor] = None,
        face_embs: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        Rt: Optional[torch.Tensor] = None,
        embs: Optional[torch.Tensor] = None,
        face_embs_body: Optional[torch.Tensor] = None,
        encode: bool = True,
        render_display: bool = False,
        ao: Optional[torch.Tensor] = None,  # [B, 1, S, S] ambient occlusion (training)
        cam_idx: Optional[torch.Tensor] = None,  # [B] int: the training calibration's cameras
        training: bool = False,
        posterior_noise: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """One frame batch end to end: ``decode_frame`` then, with cameras,
        ``render_view``.  ``render_display=True`` is the video path (rgb in
        display [0, 255]); linear rgb is the default.  ``training=True``
        takes the training branch (``train_forward``), which encodes ``geom``
        and needs ``ao``."""
        if training:
            return self.train_forward(lbs_motion, campos, geom, face_embs, ao, K, Rt, cam_idx, posterior_noise,
                                      generator)
        preds = self.decode_frame(lbs_motion, geom, face_embs, embs, face_embs_body, encode)
        if K is not None and Rt is not None:
            view = self.render_view(preds, campos, K, Rt, render_display)
            preds.update(rgb=view["rgb"], tex_rec=view["tex_rec"], depth=view["depth"],
                         pix_to_face=view["pix_to_face"], tex_view_rec=view["tex_view_rec"],
                         cond_view=view["cond_view"])
        return preds

    def train_forward(self, lbs_motion, campos, geom, face_embs, ao, K=None, Rt=None, cam_idx=None,
                      posterior_noise: bool = False,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The training branch (mesh_vae_drivable.py:322-371): the encode of
        ``geom``; the GT-AO shadow of ``ao`` drives the texture and
        ``pose_shadow_map`` is the pose shadow for its distillation; with
        ``cam_idx`` (and n_cameras > 0) ``cal`` calibrates the texture and
        ``learn_blur`` / ``pixel_cal`` the linear render.  The projected
        vertices are detached before the raster: visibility is not
        differentiable, so the geometry trains through a loss on the
        vertices and the texture through the sampler."""
        a = self.assets
        preds = self.decode_frame(lbs_motion, geom, face_embs, use_pose_shadow=False, ao=ao,
                                  posterior_noise=posterior_noise, generator=generator)
        preds["pose_shadow_map"] = self.pose_to_shadow(lbs_motion)["shadow_map"]
        geom_rec = preds["geom"]
        dec_view = self.decoder_view(geom_rec, preds["tex_mean_rec"], campos, a.geo)
        tex_rec = self.forward_tex(preds["tex_mean_rec"], dec_view["tex_view_rec"], None,
                                   shadow_seamed=preds["shadow_seamed"])
        calibrate = self.cfg.n_cameras > 0 and cam_idx is not None
        if calibrate:
            tex_rec = self.cal(tex_rec, cam_idx)
        preds.update(tex_rec=tex_rec, **dec_view)
        if K is not None and Rt is not None:
            pix, depth = project_points(geom_rec, K, Rt)
            rgb, raster = render_mesh(pix.detach(), depth.detach(), a.geo.faces, a.geo.uv_coords, a.geo.uv_faces,
                                      tex_rec, self.cfg.image_height, self.cfg.image_width)
            if calibrate:
                img = self.learn_blur(rgb.permute(0, 3, 1, 2), cam_idx) + self.pixel_cal(cam_idx)
                rgb = img.permute(0, 2, 3, 1)
            preds.update(rgb=rgb, depth=raster.depth, pix_to_face=raster.face_index)
        return preds
