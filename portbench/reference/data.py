"""The trainer's batches, worked out again from the raw files.

A person directory holds per scene ``<scene>_body_pose.npy`` [T, 104],
``<scene>_face_expression.npy`` [T, 256], ``<scene>_missing_face_frames.npy``
and ``<scene>_audio.wav`` (2 channels, 48 kHz, 1600 samples a frame), and
``data_stats.npz``.  The train split is every scene but the last
``num_val + num_test`` in name order.  Batch ``i`` of a run seeded ``seed``
draws its windows from ``RandomState(SeedSequence([seed, i]))``: per row a
scene, a length in [min, max], a start (a face window redrawn up to ten
times while all of it is missing), both rounded to the 3-frame grid of the
feature cache; face codes are z-normalised and zeroed at missing frames.

The frozen frontends' features are computed here from the wav with the
reference's own modules: the wav2vec features of a scene in windows of
2000 tokens (masked moments over the real signal), the lip vertices of
channel 0 in chunks of 120 frames, and the responses to silence that pad a
short window.
"""

from __future__ import annotations

import glob
import os
import wave
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.audio_encoder import feature_frames

FRAME_QUANTUM, TOKENS_PER_QUANTUM, HOP_16K, RECEPTIVE_FIELD_16K = 3, 10, 160, 465
SEG_TOKENS, SILENCE_TOKENS, LIP_CHUNK = 2000, 8, 120


def step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        n, ch, width, raw = w.getnframes(), w.getnchannels(), w.getsampwidth(), w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"{path}: expected 16-bit samples")
    return (np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0).reshape(n, ch)


def tokens_for_frames(n_frames: int) -> int:
    return feature_frames(n_frames * 1600 // 3)


def quantize_window(start: int, length: int, n_frames: int, min_length: int):
    q = FRAME_QUANTUM
    length = max((min(length, n_frames) // q) * q, (min(min_length, n_frames) // q) * q, q)
    start = min((start // q) * q, ((n_frames - length) // q) * q)
    return max(start, 0), length


class Person:
    """The train split of a person directory, with the reference's features."""

    def __init__(self, person_dir: str, num_val: int = 2, num_test: int = 4):
        bases = sorted(p[: -len("_body_pose.npy")] for p in glob.glob(os.path.join(person_dir, "*_body_pose.npy")))
        self.bases = bases[: max(len(bases) - num_val - num_test, 0)]
        stats = dict(np.load(os.path.join(person_dir, "data_stats.npz")))
        self.code_mean = stats["code_mean"].astype(np.float32)
        self.code_std = float(stats["code_std_flat"])
        self.audio_mean = stats["audio_mean"].astype(np.float32)
        self.audio_std = float(stats["audio_std_flat"])
        self.codes, self.missing, self.audio = [], [], []
        for base in self.bases:
            face = np.load(base + "_face_expression.npy").astype(np.float32)
            frames = min(face.shape[0], np.load(base + "_body_pose.npy", mmap_mode="r").shape[0])
            miss = np.zeros(frames, bool)
            idx = np.load(base + "_missing_face_frames.npy").astype(int)
            miss[idx[idx < frames]] = True
            self.codes.append((face[:frames] - self.code_mean) / (self.code_std + 1e-8))
            self.missing.append(miss)
            wav = read_wav(base + "_audio.wav")[: frames * 1600]
            self.audio.append(((wav - self.audio_mean) / (self.audio_std + 1e-8)).astype(np.float32))
        self.features: List[np.ndarray] = []
        self.lips: List[np.ndarray] = []

    @torch.no_grad()
    def compute_features(self, audio_model, lip_model, device) -> None:
        """The wav2vec features and lip vertices of every scene, and the
        silence responses, through the reference's frozen modules."""
        def frontend(x: np.ndarray, n_valid: int) -> np.ndarray:
            return audio_model(torch.from_numpy(x).to(device)[None], n_valid)[0].cpu().numpy()

        def lip(chunk: np.ndarray) -> np.ndarray:
            v = lip_model(torch.from_numpy(chunk).to(device)[None])
            return v.reshape(v.shape[1], -1).cpu().numpy()

        w_sil = ((SILENCE_TOKENS - 1) * HOP_16K + RECEPTIVE_FIELD_16K) * 3
        self.silence = frontend(np.zeros((w_sil, 2), np.float32), w_sil)[SILENCE_TOKENS // 2]
        self.lip_silence = lip(np.zeros((LIP_CHUNK, 1600), np.float32))[LIP_CHUNK // 2]
        w48 = ((SEG_TOKENS - 1) * HOP_16K + RECEPTIVE_FIELD_16K) * 3
        for audio in self.audio:
            S = audio.shape[0]
            total = feature_frames(S // 3)
            feats = np.empty((total, self.silence.shape[0]), np.float32)
            for lo in range(0, total, SEG_TOKENS):
                win = audio[lo * HOP_16K * 3 : lo * HOP_16K * 3 + w48]
                hi = min(lo + SEG_TOKENS, total)
                feats[lo:hi] = frontend(np.ascontiguousarray(win), win.shape[0])[: hi - lo]
            self.features.append(feats)
            T = S // 1600
            frames = audio[: T * 1600, 0].reshape(T, 1600)
            verts = []
            for c in range(0, T, LIP_CHUNK):
                chunk = frames[c : c + LIP_CHUNK]
                verts.append(lip(np.pad(chunk, ((0, LIP_CHUNK - chunk.shape[0]), (0, 0))))[: chunk.shape[0]])
            self.lips.append(np.concatenate(verts))

    def face_batch(self, seed: int, step: int, batch: int, min_len: int, max_len: int) -> Dict[str, np.ndarray]:
        """Batch ``step`` of a face run on cached features, as numpy."""
        rng = np.random.RandomState(step_seed(seed, step))
        Ta = tokens_for_frames(max_len)
        out = {"motion": np.zeros((batch, max_len, 256), np.float32), "mask": np.zeros((batch, max_len), np.float32),
               "lengths": np.zeros((batch,), np.int32),
               "audio_features": np.empty((batch, Ta, self.silence.shape[0]), np.float32),
               "lip_verts": np.empty((batch, max_len, self.lip_silence.shape[0]), np.float32)}
        for b in range(batch):
            si = rng.randint(len(self.bases))
            missing, frames = self.missing[si], self.missing[si].shape[0]
            L = min(int(rng.randint(min_len, max_len + 1)), frames)
            start = int(rng.randint(0, max(frames - L, 0) + 1))
            for _ in range(10):
                if not missing[start : start + L].all():
                    break
                start = int(rng.randint(0, max(frames - L, 0) + 1))
            start, L = quantize_window(start, L, frames, min_len)
            miss = missing[start : start + L]
            out["motion"][b, :L] = np.where(miss[:, None], 0.0, self.codes[si][start : start + L])
            out["mask"][b, :L] = (~miss).astype(np.float32)
            out["lengths"][b] = L
            off, n = (start // FRAME_QUANTUM) * TOKENS_PER_QUANTUM, tokens_for_frames(L)
            out["audio_features"][b, :n] = self.features[si][off : off + n]
            out["audio_features"][b, n:] = self.silence
            w = self.lips[si][start : start + L]
            out["lip_verts"][b, : w.shape[0]] = w
            out["lip_verts"][b, w.shape[0] :] = self.lip_silence
        return out
