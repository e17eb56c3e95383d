"""Video output: frames → .mp4 with audio mux.

Counterpart of ``audio2photoreal_tpu/render/video.py`` (reference:
visualize/render_codes.py:31-48,129-163): ``ffmpeg`` as a host subprocess,
frames streamed over stdin as rawvideo.  Without ``ffmpeg`` on the PATH the
frames go to an ``.npz`` beside the requested path instead.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Iterable, Optional

import numpy as np


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def write_video(
    path: str,
    frames: Iterable[np.ndarray],  # each [H, W, 3] uint8
    fps: int = 30,
    audio: Optional[np.ndarray] = None,  # [S] or [S, C] float in [-1, 1]
    audio_sr: int = 48_000,
) -> str:
    """Write an H.264 mp4 and return its path; without ffmpeg, write
    ``<path stem>.npz`` (frames, fps) and return that path."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    H, W = frames[0].shape[:2]

    if not have_ffmpeg():
        alt = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(alt, frames=np.stack(frames), fps=fps)
        return alt

    audio_args = []
    tmp_wav = None
    if audio is not None:
        from audio2photoreal_tpu_torch.data.dataset import write_wav

        tmp_wav = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
        tmp_wav.close()
        write_wav(tmp_wav.name, audio if audio.ndim == 2 else audio[:, None], audio_sr)
        audio_args = ["-i", tmp_wav.name, "-map", "0:v", "-map", "1:a", "-c:a", "aac", "-shortest"]

    cmd = [
        "ffmpeg", "-y", "-loglevel", "error",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{W}x{H}", "-r", str(fps),
        "-i", "pipe:0",
        *audio_args,
        "-c:v", "libx264", "-pix_fmt", "yuv420p", "-crf", "18",
        path,
    ]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    try:
        for f in frames:
            proc.stdin.write(np.ascontiguousarray(f, np.uint8).tobytes())
        proc.stdin.close()
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if tmp_wav is not None:
            os.unlink(tmp_wav.name)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed with {proc.returncode}")
    return path
