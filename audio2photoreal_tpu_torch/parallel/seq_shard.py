"""The vq-wav2vec frontend with its time axis sharded over processes.

Counterpart of ``audio2photoreal_tpu/parallel/seq_shard.py``.  The valid
conv stack has a receptive field of 465 samples and a hop of 160, so the
signal cuts into n overlapping windows, window i covering exactly the
receptive fields of output frames [i·m, (i + 1)·m): each window's conv
outputs are the unsharded extractor's.  Process i of the ``seq`` axis (a
``parallel/mesh.py`` mesh of ``MeshSpec((-1,), ("seq",))``) runs window i
with a ``SeqShardCtx``, so each layer's group norm sums de-duplicated masked
moments over the processes (``models/audio_encoder.py:GroupNormAll``) and
normalises with the global statistics; the windows' frames are then
gathered along time.  The last window runs on to the end of the signal, so
the moments count every frame the unsharded extractor counts, at any
length; the result equals the unsharded extractor's up to the order of the
moment sums, and no process holds more than its window's feature maps:
clips longer than one device's memory.

Every process is handed the whole [B, S] signal.  Without a group, or with
a mesh on another axis, it runs the one-window case, which is the unsharded
extractor.  As in the JAX package, no app binds it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from audio2photoreal_tpu_torch.models.audio_encoder import VQ_WAV2VEC_SPEC, SeqShardCtx
from audio2photoreal_tpu_torch.parallel import collectives, sharding
from audio2photoreal_tpu_torch.parallel.mesh import SEQ_AXIS, DataMesh

FRAME_HOP = 160


def receptive_field(spec=VQ_WAV2VEC_SPEC) -> int:
    rf, jump = 1, 1
    for _, k, s in spec:
        rf = rf + (k - 1) * jump
        jump *= s
    return rf  # 465 for the wav2vec stack


def _frames(n_samples: int, n_chunks: int):
    """(output frames of the whole signal, frames a window owns)."""
    n_out = max((n_samples - receptive_field()) // FRAME_HOP + 1, 0)
    return n_out, -(-n_out // n_chunks)


def chunked_windows(wav: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """[B, S] → [B, n, W] overlapping windows that tile the output exactly:
    m = ceil(N_out / n) output frames a window, W = (m − 1)·160 + 465
    samples; the tail is zero-padded (as a zero-padded unsharded signal)."""
    B, S = wav.shape
    _, m = _frames(S, n_chunks)
    W = (m - 1) * FRAME_HOP + receptive_field()
    need = (n_chunks - 1) * m * FRAME_HOP + W
    wav = F.pad(wav, (0, max(need - S, 0)))
    starts = torch.arange(n_chunks, device=wav.device) * (m * FRAME_HOP)
    return wav[:, starts[:, None] + torch.arange(W, device=wav.device)[None]]


def seq_sharded_extract(
    extract_fn: Callable,  # (win [B, W], seq_ctx) -> [B, m, C]
    wav: torch.Tensor,  # [B, S], the same on every process
    mesh: Optional[DataMesh],
    axis: str = SEQ_AXIS,
) -> torch.Tensor:
    """The extractor with time sharded over ``mesh``'s ``axis`` → [B,
    N_out, C]: this process runs its window, its group norms' moments summed
    over the axis, and the windows' frames are all-gathered in order."""
    n, index = (mesh.size, mesh.index) if mesh is not None and mesh.axis == axis else (1, 0)
    n_out, m = _frames(wav.shape[1], n)
    win = chunked_windows(wav, n)[:, index]
    if index == n - 1:
        # the last window runs on to the end of the signal: the unsharded
        # extractor's group norms count the frames of the samples past the
        # last output frame's receptive field too (the JAX package's equal
        # windows leave them out, so its moments miss them at such lengths)
        win = torch.cat([win, wav[:, index * m * FRAME_HOP + win.shape[1]:]], dim=1)
    ctx = SeqShardCtx(axis_name=axis, win_index=index, n_windows=n, frames_per_window=m, orig_len=wav.shape[1])
    with sharding.bind(mesh if n > 1 else None):
        feats = extract_fn(win, ctx)[:, :m]  # [B, m, C]
        parts = collectives.all_gather(feats.contiguous(), axis)  # [n, B, m, C]
    return parts.permute(1, 0, 2, 3).reshape(wav.shape[0], n * m, -1)[:, :n_out]
