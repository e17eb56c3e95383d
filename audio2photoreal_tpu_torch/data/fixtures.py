"""Synthetic "person" fixture matching the reference dataset contract.

Generates scene files exactly as §2.3 of SURVEY.md describes them
(reference: README.md:140-151, data_loaders/get_data.py:55-98):
``scene*_body_pose.npy`` [T,104], ``*_face_expression.npy`` [T,256],
``*_missing_face_frames.npy`` indices, ``*_audio.wav`` 2ch 48 kHz with
1600 samples/frame, plus stats.  Used by unit/integration tests and the
end-to-end smoke pipeline (no real capture data ships with the reference
either — its download scripts are external).

A numpy copy of ``audio2photoreal_tpu/data/fixtures.py``: the same seed
writes byte-identical files.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from audio2photoreal_tpu_torch.data.dataset import Scene, write_wav
from audio2photoreal_tpu_torch.data.stats import DataStats


def make_synthetic_scene(rng: np.random.RandomState, T: int, name: str) -> Scene:
    t = np.arange(T, dtype=np.float32)
    # smooth pseudo-motion: mixture of sines per channel
    freqs = rng.uniform(0.01, 0.1, (3, 104)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (3, 104)).astype(np.float32)
    amps = rng.uniform(0.1, 1.0, (3, 104)).astype(np.float32)
    pose = sum(a * np.sin(2 * np.pi * f * t[:, None] + p) for f, p, a in zip(freqs, phases, amps))
    pose = pose.astype(np.float32) + rng.randn(104).astype(np.float32)

    face = rng.randn(T, 256).astype(np.float32) * 0.5
    face += np.sin(2 * np.pi * 0.05 * t)[:, None]

    S = T * 1600
    ts = np.arange(S, dtype=np.float32) / 48_000.0
    audio = np.stack(
        [
            0.1 * np.sin(2 * np.pi * 220.0 * ts) + 0.01 * rng.randn(S),
            0.1 * np.sin(2 * np.pi * 330.0 * ts) + 0.01 * rng.randn(S),
        ],
        axis=1,
    ).astype(np.float32)

    missing = np.zeros(T, bool)
    n_missing = rng.randint(0, max(T // 20, 1) + 1)
    if n_missing:
        missing[rng.choice(T, n_missing, replace=False)] = True
    return Scene(name, pose, face, audio, missing)


def make_synthetic_person(
    out_dir: str,
    person: str = "SYNTH01",
    num_scenes: int = 8,
    frames_per_scene: int = 64,
    seed: int = 0,
) -> str:
    """Write a full synthetic person directory; returns its path."""
    rng = np.random.RandomState(seed)
    pdir = os.path.join(out_dir, person)
    os.makedirs(pdir, exist_ok=True)
    scenes: List[Scene] = []
    for i in range(num_scenes):
        sc = make_synthetic_scene(rng, frames_per_scene, f"scene{i:02d}")
        scenes.append(sc)
        base = os.path.join(pdir, sc.name)
        np.save(base + "_body_pose.npy", sc.pose)
        np.save(base + "_face_expression.npy", sc.face)
        np.save(base + "_missing_face_frames.npy", np.where(sc.missing)[0])
        write_wav(base + "_audio.wav", sc.audio)
    stats = DataStats.compute(
        [s.pose for s in scenes], [s.face for s in scenes], [s.audio for s in scenes]
    )
    stats.save_npz(os.path.join(pdir, "data_stats.npz"))
    return pdir
