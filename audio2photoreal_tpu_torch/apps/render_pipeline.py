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
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.render.assets import Camera, load_bundle_parts
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererAssets, RendererConfig
from audio2photoreal_tpu_torch.render.video import write_video


class BodyRenderer:
    """render_codes.py BodyRenderer equivalent."""

    def __init__(
        self,
        cfg: RendererConfig,
        assets: RendererAssets,
        state_dict: Mapping[str, torch.Tensor],
        cameras: Dict[str, Camera],
        frame_batch: int = 16,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cameras = cameras
        self.frame_batch = frame_batch
        self.model = BodyAvatar(cfg, assets)
        self.model.load_state_dict(state_dict, strict=True)
        self.model = self.model.to(self.device).eval()
        with torch.no_grad():
            self._template_embs = self.model.template_body_embs()  # [1, n_embs]

    def _tensor(self, a: np.ndarray, B: int) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        return t[None].expand(B, *t.shape).contiguous()

    def _batches(self, pose: np.ndarray, face_codes: np.ndarray):
        """Frame batches of exactly ``frame_batch``, the tail padded with its
        last frame."""
        fb = self.frame_batch
        pad = (-len(pose)) % fb
        pose_p = np.concatenate([pose, np.repeat(pose[-1:], pad, 0)], 0).astype(np.float32)
        face_p = np.concatenate([face_codes, np.repeat(face_codes[-1:], pad, 0)], 0).astype(np.float32)
        for i in range(0, len(pose_p), fb):
            yield (torch.from_numpy(pose_p[i : i + fb]).to(self.device),
                   torch.from_numpy(face_p[i : i + fb]).to(self.device))

    @torch.no_grad()
    def render_sequence(self, pose: np.ndarray, face_codes: np.ndarray,
                        camera_name: Optional[str] = None) -> np.ndarray:
        """One camera, the full per-frame encode path → uint8 [T, H, W, 3]."""
        cam = self.cameras[camera_name or next(iter(self.cameras))]
        frames = []
        for m, f in self._batches(pose, face_codes):
            B = m.shape[0]
            geom = self.model.assets.lbs.pose(None, m)
            rgb = self.model(m, self._tensor(cam.campos, B), geom=geom, face_embs=f,
                             K=self._tensor(cam.K, B), Rt=self._tensor(cam.Rt, B),
                             render_display=True)["rgb"]
            frames.append(rgb.to(torch.uint8).cpu().numpy())
        return np.concatenate(frames, 0)[: len(pose)]

    @torch.no_grad()
    def render_sequence_multicam(self, pose: np.ndarray, face_codes: np.ndarray) -> np.ndarray:
        """All rig cameras side by side along width → uint8 [T, H, n·W, 3]:
        one decode per frame batch, one render_view per camera."""
        cams = list(self.cameras.values())
        frames = []
        for m, f in self._batches(pose, face_codes):
            B = m.shape[0]
            decoded = self.model.decode_frame(
                m, face_embs=f, embs=self._template_embs.expand(B, -1), encode=False)
            views = [
                self.model.render_view(decoded, self._tensor(c.campos, B), self._tensor(c.K, B),
                                       self._tensor(c.Rt, B), render_display=True)["rgb"]
                for c in cams
            ]
            frames.append(torch.cat(views, dim=2).to(torch.uint8).cpu().numpy())
        return np.concatenate(frames, 0)[: len(pose)]

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


def load_body_renderer(renderer_dir: str, frame_batch: int = 8, device: Optional[str] = None) -> BodyRenderer:
    """Load a renderer bundle (``render/assets.py``: renderer.json +
    model.pt + cameras.npz [+ assets.json]) onto ``device`` (default: the
    card; without one this raises)."""
    dev = resolve_device(device)
    cfg, assets, sd, cameras = load_bundle_parts(renderer_dir)
    return BodyRenderer(cfg, assets, sd, cameras, frame_batch=frame_batch, device=dev)
