"""The benchmark's inputs, made from ``--seed``: weights, a synthetic
person on disk, and per-call seeds.

Weights: one normal draw on the device for every floating entry of a
module's state dict, laid out in the order of the entries' names, then
scaled per entry: a null embedding N(0, 1), a weight of two or more axes
N(0, 1/fan_in), a bias 0, any other vector (norm scales, flags, counts) 1.
The program and the reference load the same dict by name.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

SEED_MASK = 2**63 - 1


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of the run seeded ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, *path]).generate_state(2, np.uint64)[0]) & SEED_MASK


def make_weights(module: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    sd = module.state_dict()
    names = sorted(n for n, t in sd.items() if t.is_floating_point())
    total = sum(sd[n].numel() for n in names)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for n in names:
        t = sd[n]
        v = flat[off : off + t.numel()].view(t.shape)
        off += t.numel()
        leaf = n.rsplit(".", 1)[-1]
        if leaf.startswith("null_"):
            out[n] = v
        elif t.dim() >= 2:
            out[n] = v.mul_(t[0].numel() ** -0.5)
        elif leaf.endswith("bias"):
            out[n] = v.zero_()
        else:
            out[n] = v.fill_(1.0)
    for n, t in sd.items():
        if n not in out:
            out[n] = t.clone()
    return out


def load_weights(module: torch.nn.Module, seed: int, device) -> None:
    module.load_state_dict(make_weights(module, seed, device), strict=True)


def write_person(root: str, seed: int, train_scenes: int, held_out: int, frames: int,
                 person: str = "SYNTH01") -> str:
    """A person directory in the capture layout: per scene body pose [T,
    104], face codes [T, 256], missing face frames, 2-channel 48 kHz 16-bit
    audio (1600 samples a frame), and ``data_stats.npz``.  The held-out
    scenes, last in name order, are 30 frames long: the trainer never reads
    them."""
    import wave

    rng = np.random.RandomState(sub_seed(seed, 1) % 2**32)
    pdir = os.path.join(root, person)
    os.makedirs(pdir, exist_ok=True)
    poses, codes, audios = [], [], []
    for i in range(train_scenes + held_out):
        T = frames if i < train_scenes else 30
        t = np.arange(T, dtype=np.float32)[:, None]
        f, ph, a = (rng.uniform(lo, hi, (3, 104)).astype(np.float32) for lo, hi in ((0.01, 0.1), (0, 2 * np.pi), (0.1, 1)))
        pose = sum(a[k] * np.sin(2 * np.pi * f[k] * t + ph[k]) for k in range(3)) + rng.randn(104).astype(np.float32)
        face = (rng.randn(T, 256) * 0.5 + np.sin(2 * np.pi * 0.05 * t)).astype(np.float32)
        s = np.arange(T * 1600, dtype=np.float32)[:, None] / 48_000.0
        tone = np.sin(2 * np.pi * np.array([220.0, 330.0], np.float32) * s)
        audio = (0.1 * tone + 0.01 * rng.randn(T * 1600, 2)).astype(np.float32)
        missing = rng.choice(T, rng.randint(0, T // 20 + 1), replace=False)
        base = os.path.join(pdir, f"scene{i:03d}")
        np.save(base + "_body_pose.npy", pose.astype(np.float32))
        np.save(base + "_face_expression.npy", face)
        np.save(base + "_missing_face_frames.npy", np.sort(missing))
        with wave.open(base + "_audio.wav", "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(48_000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
        poses.append(pose)
        codes.append(face)
        audios.append(audio)
    pose_cat, code_cat, audio_cat = (np.concatenate(x) for x in (poses, codes, audios))
    np.savez(os.path.join(pdir, "data_stats.npz"),
             pose_mean=pose_cat.mean(0).astype(np.float32), pose_std_flat=np.float32(pose_cat.std()),
             code_mean=code_cat.mean(0).astype(np.float32), code_std_flat=np.float32(code_cat.std()),
             audio_mean=audio_cat.mean(0).astype(np.float32), audio_std_flat=np.float32(audio_cat.std()))
    return pdir
