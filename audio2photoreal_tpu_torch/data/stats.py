"""Per-person normalization statistics.

Contract of the reference's ``data_stats.pth`` (data_loaders/data.py:100-110):
keys {pose,code,audio}_{mean,std} plus *_std_flat scalars; pose/code use the
per-dim mean with a FLAT (scalar) std, audio uses per-channel mean + flat std.
Loader accepts either the torch .pth file or an .npz with the same keys.
A numpy copy of ``audio2photoreal_tpu/data/stats.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class DataStats:
    pose_mean: np.ndarray  # [104]
    pose_std: np.ndarray  # scalar (flat) — reference normalizes with std_flat
    code_mean: np.ndarray  # [256]
    code_std: np.ndarray  # scalar
    audio_mean: np.ndarray  # [2]
    audio_std: np.ndarray  # scalar

    @classmethod
    def load(cls, path: str) -> "DataStats":
        if path.endswith(".pth") or path.endswith(".pt"):
            import torch

            d = {k: np.asarray(v) for k, v in torch.load(path, map_location="cpu", weights_only=False).items()}
        else:
            d = dict(np.load(path))
        return cls(
            pose_mean=d["pose_mean"].astype(np.float32),
            pose_std=d["pose_std_flat"].astype(np.float32),
            code_mean=d["code_mean"].astype(np.float32),
            code_std=d["code_std_flat"].astype(np.float32),
            audio_mean=d["audio_mean"].astype(np.float32),
            audio_std=d["audio_std_flat"].astype(np.float32),
        )

    def save_npz(self, path: str) -> None:
        np.savez(
            path,
            pose_mean=self.pose_mean,
            pose_std_flat=self.pose_std,
            pose_std=self.pose_mean * 0 + self.pose_std,
            code_mean=self.code_mean,
            code_std_flat=self.code_std,
            code_std=self.code_mean * 0 + self.code_std,
            audio_mean=self.audio_mean,
            audio_std_flat=self.audio_std,
            audio_std=self.audio_mean * 0 + self.audio_std,
        )

    @classmethod
    def compute(cls, poses, codes, audios) -> "DataStats":
        """From lists of [T,104] / [T,256] / [S,2] arrays (data.py builds these
        offline; kept for the synthetic fixture + new-person onboarding)."""
        pose_cat = np.concatenate(poses, 0)
        code_cat = np.concatenate(codes, 0)
        audio_cat = np.concatenate(audios, 0)
        return cls(
            pose_mean=pose_cat.mean(0).astype(np.float32),
            pose_std=np.asarray(pose_cat.std(), np.float32),
            code_mean=code_cat.mean(0).astype(np.float32),
            code_std=np.asarray(code_cat.std(), np.float32),
            audio_mean=audio_cat.mean(0).astype(np.float32),
            audio_std=np.asarray(audio_cat.std(), np.float32),
        )

    # --- z-norm / inverse, matching Social.{_normalize,inv_transform}
    # (data.py:71-98) ---

    def norm_pose(self, x):
        return (x - self.pose_mean) / (self.pose_std + 1e-8)

    def inv_pose(self, x):
        return x * (self.pose_std + 1e-8) + self.pose_mean

    def norm_code(self, x):
        return (x - self.code_mean) / (self.code_std + 1e-8)

    def inv_code(self, x):
        return x * (self.code_std + 1e-8) + self.code_mean

    def norm_audio(self, x):
        return (x - self.audio_mean) / (self.audio_std + 1e-8)

    def inv_audio(self, x):
        return x * (self.audio_std + 1e-8) + self.audio_mean
