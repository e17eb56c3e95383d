"""Dataset layer: the reference's directory contract → fixed-shape batches.

Reference behavior reproduced (data_loaders/get_data.py + data.py):
- scene files ``scene*_body_pose.npy`` [T,104], ``*_face_expression.npy``
  [T,256], ``*_missing_face_frames.npy`` (indices), ``*_audio.wav``
  2ch 48 kHz with len == 1600·T (get_data.py:55-98),
- root-angle wrapping for capture-1/2 persons (get_data.py:74-77),
- splits: train = all but last 6, val = next 2, test = last 4 (data.py:52-54),
- z-norm from per-person stats; face codes zeroed at missing frames
  (data.py:251-252),
- val / test: fixed-size chunking (data.py:112-144); the train split's
  random sub-windows (data.py:173-218) are ``data/loader.py``'s,
- 1 fps keyframes = motion[::30] (data.py:146-150).

Every batch has static shapes: motion is always padded to ``max_seq_length``
with an explicit [B, T] validity mask, as in the JAX package
(``audio2photoreal_tpu/data/dataset.py``), of which this is a numpy copy.
"""

from __future__ import annotations

import glob
import os
import wave
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from audio2photoreal_tpu_torch.core.config import AUDIO_PER_FRAME, DataConfig
from audio2photoreal_tpu_torch.data.stats import DataStats


def read_wav(path: str) -> np.ndarray:
    """[S, channels] float32 in [-1, 1] (torchaudio.load equivalent)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    return x.reshape(n, ch)


def write_wav(path: str, audio: np.ndarray, sr: int = 48_000) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[1] if audio.ndim == 2 else 1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


def _wrap_root_angle(pose: np.ndarray) -> np.ndarray:
    """Keep the root rotation continuous by wrapping negatives
    (get_data.py:74-77)."""
    pose = pose.copy()
    root = pose[:, 3]
    root = np.where(root < 0, root + 2 * np.pi, root)
    pose[:, 3] = root
    return pose


@dataclass
class Scene:
    name: str
    pose: np.ndarray  # [T, 104]
    face: np.ndarray  # [T, 256]
    audio: np.ndarray  # [1600·T, 2]
    missing: np.ndarray  # [T] bool, True where face tracking FAILED


def load_local_data(
    data_root: str,
    person: str,
    audio_per_frame: int = AUDIO_PER_FRAME,
    flip_person: bool = False,
) -> List[Scene]:
    """Scan one person directory into scenes (get_data.py:46-129).

    ``flip_person`` swaps the speaker channel convention like the reference's
    two-person conversations (get_data.py:83-88,110-122)."""
    pdir = os.path.join(data_root, person)
    scenes = []
    for pose_path in sorted(glob.glob(os.path.join(pdir, "*_body_pose.npy"))):
        base = pose_path[: -len("_body_pose.npy")]
        pose = np.load(pose_path).astype(np.float32)
        face = np.load(base + "_face_expression.npy").astype(np.float32)
        T = min(len(pose), len(face))
        pose, face = pose[:T], face[:T]
        if person in ("PXB184", "RLW104"):  # capture-1/2 root wrap (get_data.py:74-77)
            pose = _wrap_root_angle(pose)
        missing = np.zeros(T, bool)
        mpath = base + "_missing_face_frames.npy"
        if os.path.exists(mpath):
            idx = np.load(mpath).astype(int)
            missing[idx[idx < T]] = True
        audio = read_wav(base + "_audio.wav")[: T * audio_per_frame]
        assert len(audio) == T * audio_per_frame, (
            f"audio/motion length mismatch in {base}: {len(audio)} != {T * audio_per_frame}"
        )  # (get_data.py:90-92)
        if flip_person:
            audio = audio[:, ::-1]
        scenes.append(Scene(os.path.basename(base), pose, face, audio, missing))
    return scenes


def split_scenes(scenes: List[Scene], split: str, num_val: int = 2, num_test: int = 4):
    """train = all-but-6, val = 2, test = last 4 (data.py:52-54)."""
    n_hold = num_val + num_test
    if split == "train":
        return scenes[: max(len(scenes) - n_hold, 0)]
    if split == "val":
        return scenes[len(scenes) - n_hold : len(scenes) - num_test]
    if split == "test":
        return scenes[len(scenes) - num_test :]
    raise ValueError(split)


class SocialDataset:
    """Fixed-shape examples over the scenes of one split; the val and test
    splits are chunked deterministically (the trainer's random windows are
    ``data/loader.py:FastLoader``'s).

    Examples (all float32 unless noted; B is the stack of ``get_chunk``s):
      motion      [B, Tmax, C]   z-normed pose (104) or face codes (256)
      mask        [B, Tmax]      1 where the frame is valid AND non-missing
      lengths     [B] int32
      audio       [B, 1600·Tmax, 2]  z-normed raw audio
      keyframes   [B, Kmax, 104] z-normed 1 fps pose keyframes (pose mode)
      keyframe_valid [B, Kmax]
    """

    def __init__(
        self,
        scenes: List[Scene],
        stats: DataStats,
        cfg: DataConfig,
        split: str = "train",
    ):
        self.cfg = cfg
        self.stats = stats
        self.split = split
        self.scenes = split_scenes(scenes, split, cfg.num_val_seqs, cfg.num_test_seqs)
        if not self.scenes:
            raise ValueError(f"no scenes for split {split}")
        self.apf = cfg.audio_per_frame
        self.step = cfg.add_frame_cond and 30 or None
        self.Tmax = cfg.max_seq_length
        self.Kmax = -(-self.Tmax // 30)
        # test split is chunked deterministically (data.py:112-144)
        if split in ("test", "val"):
            self.chunks = []
            for si, sc in enumerate(self.scenes):
                for start in range(0, len(sc.pose) - self.Tmax + 1, self.Tmax):
                    self.chunks.append((si, start, self.Tmax))
        else:
            self.chunks = None

    def __len__(self) -> int:
        return len(self.chunks) if self.chunks is not None else len(self.scenes)

    def _make_example(self, scene: Scene, start: int, L: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        Tmax, apf = self.Tmax, self.apf
        pose = scene.pose[start : start + L]
        face = scene.face[start : start + L]
        missing = scene.missing[start : start + L]
        audio = scene.audio[start * apf : (start + L) * apf]

        if cfg.data_format == "pose":
            motion = self.stats.norm_pose(pose)
        else:
            motion = self.stats.norm_code(face)
            motion = np.where(missing[:, None], 0.0, motion)  # (data.py:251-252)
        audio_n = self.stats.norm_audio(audio)

        out_motion = np.zeros((Tmax, motion.shape[1]), np.float32)
        out_motion[:L] = motion
        out_mask = np.zeros((Tmax,), np.float32)
        out_mask[:L] = 1.0
        if cfg.data_format == "face":
            out_mask[:L] = (~missing).astype(np.float32)
        out_audio = np.zeros((Tmax * apf, 2), np.float32)
        out_audio[: L * apf] = audio_n

        ex = {
            "motion": out_motion,
            "mask": out_mask,
            "lengths": np.int32(L),
            "audio": out_audio,
        }
        if cfg.data_format == "pose":
            kf = self.stats.norm_pose(pose[:: 30])
            out_kf = np.zeros((self.Kmax, kf.shape[1]), np.float32)
            out_kf[: len(kf)] = kf
            kv = np.zeros((self.Kmax,), np.float32)
            kv[: len(kf)] = 1.0
            ex["keyframes"] = out_kf
            ex["keyframe_valid"] = kv
        return ex

    def get_chunk(self, i: int) -> Dict[str, np.ndarray]:
        assert self.chunks is not None, "chunked access is for val/test splits"
        si, start, L = self.chunks[i]
        return self._make_example(self.scenes[si], start, L)
