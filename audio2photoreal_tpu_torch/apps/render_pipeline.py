"""BodyRenderer: (pose, face codes) sequences → photoreal video.

Counterpart of ``audio2photoreal_tpu/apps/render_pipeline.py`` (reference:
visualize/render_codes.py):
- inputs are raw 256-d HQLP face codes; the per-frame geometry is the
  LBS-posed template (render_codes.py:107-114);
- every frame renders from the person's camera rig, the views side by side
  along width (render_codes.py:115-126);
- ``render_full_video`` takes the reference's data_block keys {audio,
  body_motion, face_motion[, gt_body, gt_face]} and ``render_gt``.

``render_sequence_multicam`` decodes each frame batch once
(``BodyAvatar.decode_frame``, the body encode hoisted to the template's
embedding) and runs one ``render_view`` per camera over it.  The avatar runs
on the card unless the caller passes ``device="cpu"``; with ``devices`` one
replica a device renders its share of every frame batch.  A trained bundle
(``apps/train_avatar.py``: ``n_cameras > 0``, the calibration in its
``model.pt``) renders with the inference forward, which has no use for the
calibration: its entries are left out.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.render.assets import Camera, load_bundle_parts
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererAssets, RendererConfig
from audio2photoreal_tpu_torch.render.video import write_video


class BodyRenderer:
    """render_codes.py BodyRenderer equivalent.  ``devices`` (the JAX
    package's ``mesh=``) puts one replica of the avatar on each device and
    splits every frame batch over them, ``frame_batch`` rounded up to a
    multiple of their count; the replicas launch one after another without
    waiting, and the frames come back in order."""

    def __init__(
        self,
        cfg: RendererConfig,
        assets: RendererAssets,
        state_dict: Mapping[str, torch.Tensor],
        cameras: Dict[str, Camera],
        frame_batch: int = 16,
        device: Optional[str] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = [torch.device(d) for d in devices] if devices else [resolve_device(device)]
        self.device = self.devices[0]
        self.cfg = cfg
        self.cameras = cameras
        n = len(self.devices)
        self.frame_batch = -(-frame_batch // n) * n  # every replica renders a non-empty share
        model = BodyAvatar(dataclasses.replace(cfg, n_cameras=0), assets)
        model.load_state_dict({k: v for k, v in state_dict.items()
                               if k.split(".")[0] not in BodyAvatar.CALIBRATION}, strict=True)
        self.replicas = [(model if i == 0 else copy.deepcopy(model)).to(d).eval() for i, d in enumerate(self.devices)]
        self.model = self.replicas[0]
        with torch.no_grad():
            self._template_embs = [r.template_body_embs() for r in self.replicas]  # [1, n_embs] each

    def _tensor(self, a: np.ndarray, B: int, device) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a, np.float32), device=device)
        return t[None].expand(B, *t.shape).contiguous()

    def _batches(self, pose: np.ndarray, face_codes: np.ndarray):
        """Frame batches of exactly ``frame_batch``, the tail padded with its
        last frame, each split into one (pose, face) share a replica (on the
        host)."""
        fb = self.frame_batch
        pad = (-len(pose)) % fb
        pose_p = np.concatenate([pose, np.repeat(pose[-1:], pad, 0)], 0).astype(np.float32)
        face_p = np.concatenate([face_codes, np.repeat(face_codes[-1:], pad, 0)], 0).astype(np.float32)
        share = fb // len(self.devices)
        for i in range(0, len(pose_p), fb):
            yield [(torch.from_numpy(pose_p[j : j + share]), torch.from_numpy(face_p[j : j + share]))
                   for j in range(i, i + fb, share)]

    def _render(self, pose: np.ndarray, face_codes: np.ndarray, render_share) -> np.ndarray:
        """``render_share(replica, index, pose, face)`` -> uint8 frames on the
        replica's device, for each share of each frame batch: every replica
        launched before the first result is read back."""
        frames = []
        for shares in self._batches(pose, face_codes):
            outs = [render_share(r, i, m.to(d), f.to(d))
                    for i, (r, d, (m, f)) in enumerate(zip(self.replicas, self.devices, shares))]
            frames.extend(o.cpu().numpy() for o in outs)
        return np.concatenate(frames, 0)[: len(pose)]

    @torch.no_grad()
    def render_sequence(self, pose: np.ndarray, face_codes: np.ndarray,
                        camera_name: Optional[str] = None) -> np.ndarray:
        """One camera, the full per-frame encode path → uint8 [T, H, W, 3]."""
        cam = self.cameras[camera_name or next(iter(self.cameras))]

        def share(model, _, m, f):
            B, dev = m.shape[0], m.device
            geom = model.assets.lbs.pose(None, m)
            rgb = model(m, self._tensor(cam.campos, B, dev), geom=geom, face_embs=f,
                        K=self._tensor(cam.K, B, dev), Rt=self._tensor(cam.Rt, B, dev), render_display=True)["rgb"]
            return rgb.to(torch.uint8)

        return self._render(pose, face_codes, share)

    @torch.no_grad()
    def render_sequence_multicam(self, pose: np.ndarray, face_codes: np.ndarray) -> np.ndarray:
        """All rig cameras side by side along width → uint8 [T, H, n·W, 3]:
        one decode per frame batch, one render_view per camera."""
        cams = list(self.cameras.values())

        def share(model, i, m, f):
            B, dev = m.shape[0], m.device
            decoded = model.decode_frame(m, face_embs=f, embs=self._template_embs[i].expand(B, -1), encode=False)
            views = [
                model.render_view(decoded, self._tensor(c.campos, B, dev), self._tensor(c.K, B, dev),
                                  self._tensor(c.Rt, B, dev), render_display=True)["rgb"]
                for c in cams
            ]
            return torch.cat(views, dim=2).to(torch.uint8)

        return self._render(pose, face_codes, share)

    def render_full_video(self, data_block: Dict[str, np.ndarray], out_path: str, audio_sr: int = 48_000,
                          fps: int = 30, render_gt: bool = False) -> str:
        """Reference data_block contract (render_codes.py:129-163): {audio,
        body_motion [T, 104], face_motion [T, 256]}, plus {gt_body, gt_face}
        for ``render_gt``.  Writes ``<out_path>_pred.mp4`` (or ``_gt``) and
        returns the path written (``.npz`` without ffmpeg)."""
        if render_gt:
            pose, face = data_block["gt_body"], data_block["gt_face"]
        else:
            pose, face = data_block["body_motion"], data_block["face_motion"]
        frames = self.render_sequence_multicam(np.asarray(pose), np.asarray(face))
        audio = data_block.get("audio")
        if audio is not None:
            audio = np.asarray(audio)
            if audio.ndim == 2 and audio.shape[0] < audio.shape[1]:
                audio = audio.T  # the reference passes [2, S]
        base = out_path[:-4] if out_path.endswith(".mp4") else out_path
        return write_video(f"{base}_{'gt' if render_gt else 'pred'}.mp4", list(frames), fps=fps,
                           audio=audio, audio_sr=audio_sr)


def load_body_renderer(renderer_dir: str, frame_batch: int = 8, device: Optional[str] = None,
                       devices: Optional[Sequence[Union[str, torch.device]]] = None) -> BodyRenderer:
    """Load a renderer bundle (``render/assets.py``: renderer.json +
    model.pt + cameras.npz [+ assets.json | static_assets.pt]) onto
    ``device`` (default: the card; without one this raises), or one replica
    on each of ``devices``.  The weights are ``model.pt``'s, which the
    avatar trainer rewrites at each save."""
    dev = None if devices else resolve_device(device)
    cfg, assets, sd, cameras = load_bundle_parts(renderer_dir)
    return BodyRenderer(cfg, assets, sd, cameras, frame_batch=frame_batch, device=dev, devices=devices)
