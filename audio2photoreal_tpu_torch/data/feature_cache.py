"""Precomputed frozen-frontend features: the trainer's conditioning cache.

Counterpart of ``audio2photoreal_tpu/data/feature_cache.py``.  The wav2vec
frontend (both denoisers, the guide) and the face denoiser's lip regressor
are frozen, so their outputs are computed once per scene and the loader
hands out windows of them in place of raw audio:

- Crops are quantised to 3 frames = 4800 samples at 48 kHz = 1600 at 16 kHz
  = 10 feature hops (hop 160), so a crop's tokens are a contiguous slice of
  its scene's token stream.
- The extractor's group norm spans the whole input, so a scene runs in
  windows of ``seg_tokens`` tokens (2000 by default, about 600 frames) whose
  convolution windows tile the stream exactly, with masked moments over the
  real signal (``Wav2VecFeatureExtractor(audio, n_valid)``): the span of the
  600-frame chunks that inference sees.  A scene's last window ends with
  the scene (the JAX package's ``build_audio_feature_cache`` zero-pads it
  to the others' shape, which its masked moments make no difference to); a short all-zero window defines
  the silence response that pads a crop (every token of an all-zero window
  is the same).
- Face models also cache the lip regressor's vertices per frame from
  channel 0, 120 frames a call (the last chunk zero-padded), and the model
  resizes a crop's vertices to its tokens (``FiLMDenoiser(...,
  lip_verts=)``).

``make_frontend_apply`` / ``make_lip_apply`` wrap the port's frozen modules:
they run under ``torch.no_grad()`` on the module's device and return numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from audio2photoreal_tpu_torch.data.dataset import read_wav
from audio2photoreal_tpu_torch.models.audio_encoder import feature_frames

FRAME_QUANTUM = 3  # crop starts and lengths round to 3 frames = 10 feature hops
TOKENS_PER_QUANTUM = 10
FRAME_HOP_16K = 160
SILENCE_TOKENS = 8  # the all-zero window whose middle token is the silence response
RECEPTIVE_FIELD_16K = 465


def tokens_for_frames(n_frames: int) -> int:
    """Feature tokens of an ``n_frames`` crop (a multiple of 3 frames)."""
    assert n_frames % FRAME_QUANTUM == 0, n_frames
    return feature_frames(n_frames * 1600 // 3)


def quantize_window(start: int, length: int, n_frames: int, min_length: int):
    """(start, length) rounded to the 3-frame grid, inside the scene and at
    or above the (also rounded) minimum length."""
    q = FRAME_QUANTUM
    length = max((min(length, n_frames) // q) * q, (min(min_length, n_frames) // q) * q, q)
    start = min((start // q) * q, ((n_frames - length) // q) * q)
    return max(start, 0), length


@dataclass
class AudioFeatureCache:
    """Per-scene frozen conditioning: ``features[i]`` [tokens_i, 1024],
    ``silence`` [1024] for padding; for a face model ``lip[i]`` [T_i, 1014]
    and ``lip_silence`` [1014]."""

    features: List[np.ndarray]
    silence: np.ndarray
    lip: Optional[List[np.ndarray]] = None
    lip_silence: Optional[np.ndarray] = None

    @property
    def dim(self) -> int:
        return int(self.silence.shape[-1])

    def window(self, scene_i: int, start_frame: int, n_frames: int, out_tokens: int) -> np.ndarray:
        """A crop's tokens, silence-padded to [out_tokens, 1024] f32."""
        assert start_frame % FRAME_QUANTUM == 0 and n_frames % FRAME_QUANTUM == 0
        off = (start_frame // FRAME_QUANTUM) * TOKENS_PER_QUANTUM
        n = tokens_for_frames(n_frames)
        f = self.features[scene_i]
        assert off + n <= f.shape[0], (off, n, f.shape)
        out = np.empty((out_tokens, f.shape[1]), np.float32)
        out[:n] = f[off : off + n]
        out[n:] = self.silence
        return out

    def lip_window(self, scene_i: int, start_frame: int, n_frames: int, out_frames: int) -> np.ndarray:
        """A crop's lip vertices, silence-padded to [out_frames, 1014] f32."""
        assert self.lip is not None, "the cache was built without lip vertices"
        v = self.lip[scene_i]
        out = np.empty((out_frames, v.shape[1]), np.float32)
        w = v[start_frame : start_frame + n_frames]
        out[: w.shape[0]] = w
        out[w.shape[0] :] = self.lip_silence
        return out

    def nbytes(self) -> int:
        n = sum(f.nbytes for f in self.features)
        if self.lip is not None:
            n += sum(v.nbytes for v in self.lip)
        return n


def _segment_windows_48k(n_samples_48k: int, seg_tokens: int):
    """(total tokens, segments, window samples at 48 kHz, tokens a segment):
    segment i owns tokens [i m, (i + 1) m) and reads the 16 kHz samples
    [i m 160, (i m + m - 1) 160 + 465), three times as many at 48 kHz (the
    resampler is a 3:1 polyphase decimator)."""
    m = seg_tokens
    total_tokens = feature_frames(n_samples_48k // 3)
    w48 = ((m - 1) * FRAME_HOP_16K + RECEPTIVE_FIELD_16K) * 3
    n_seg = max(-(-total_tokens // m), 1)
    return total_tokens, n_seg, w48, m


def build_audio_feature_cache(
    frontend_apply: Callable[[np.ndarray, int], np.ndarray],
    scene_audios: Sequence[np.ndarray],  # per scene [S, 2] raw 48 kHz, not normalised
    norm_audio: Callable[[np.ndarray], np.ndarray],
    *,
    seg_tokens: int = 2000,
    dtype=np.float32,
    lip_apply: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    lip_chunk: int = 120,
    verbose: bool = True,
) -> AudioFeatureCache:
    """Run the frozen frontends over every scene once.

    ``frontend_apply(audio [1, W, 2], n_valid) -> [1, T, 1024]`` is called on
    one window shape; ``lip_apply(frames [1, lip_chunk, 1600]) -> [1,
    lip_chunk, 1014]``, when given, builds the face models' lip cache."""
    feats: List[np.ndarray] = []
    lips: Optional[List[np.ndarray]] = [] if lip_apply is not None else None

    # the silence response: valid convs without bias on a constant signal, moments over the whole window
    _, _, w48, m = _segment_windows_48k(seg_tokens * FRAME_HOP_16K * 3 + 2000, seg_tokens)
    _, _, w_sil, _ = _segment_windows_48k(0, SILENCE_TOKENS)
    silence = np.asarray(frontend_apply(np.zeros((1, w_sil, 2), np.float32), w_sil))[0, SILENCE_TOKENS // 2]
    silence = silence.astype(np.float32)
    lip_silence = None
    if lip_apply is not None:
        lv = np.asarray(lip_apply(np.zeros((1, lip_chunk, 1600), np.float32)))
        lip_silence = lv[0, lip_chunk // 2].astype(np.float32)

    for si, raw in enumerate(scene_audios):
        audio = norm_audio(np.asarray(raw, np.float32))
        S = audio.shape[0]
        total_tokens, n_seg, _, _ = _segment_windows_48k(S, seg_tokens)
        scene = np.empty((total_tokens, silence.shape[0]), dtype)
        for i in range(n_seg):
            s0 = i * m * FRAME_HOP_16K * 3
            win = audio[s0 : s0 + w48]  # the last one ends with the scene
            out = np.asarray(frontend_apply(win[None], win.shape[0]))[0]
            lo, hi = i * m, min((i + 1) * m, total_tokens)
            scene[lo:hi] = out[: hi - lo]
        feats.append(scene)

        if lips is not None:
            T = S // 1600
            n_chunks = -(-T // lip_chunk)
            verts = np.empty((n_chunks * lip_chunk, lip_silence.shape[0]), dtype)
            # channel 0, as the model takes it (FiLMDenoiser.lip_vertices); the
            # JAX builder reshapes both channels here, which raises
            frames = audio[: T * 1600, 0].reshape(T, 1600)
            for c in range(n_chunks):
                chunk = frames[c * lip_chunk : (c + 1) * lip_chunk]
                if chunk.shape[0] < lip_chunk:
                    chunk = np.pad(chunk, ((0, lip_chunk - chunk.shape[0]), (0, 0)))
                verts[c * lip_chunk : (c + 1) * lip_chunk] = np.asarray(lip_apply(chunk[None]))[0]
            lips.append(verts[:T])
        if verbose:
            print(f"feature_cache: scene {si + 1}/{len(scene_audios)}: {total_tokens} tokens", flush=True)

    cache = AudioFeatureCache(feats, silence, lips, lip_silence)
    if verbose:
        print(f"feature_cache: {cache.nbytes() / 1e6:.1f} MB host RAM", flush=True)
    return cache


def build_cache_for_index(
    index,  # data/loader.SceneIndex: the cache's scene order is the loader's
    norm_audio: Callable[[np.ndarray], np.ndarray],
    frontend_apply: Callable,
    lip_apply: Optional[Callable] = None,
    *,
    dtype=np.float32,
    seg_tokens: int = 2000,
    verbose: bool = True,
) -> AudioFeatureCache:
    """The cache over a ``SceneIndex``'s scenes; each wav is read once, here."""
    audios = [np.asarray(read_wav(base + "_audio.wav")[: frames * 1600], np.float32)
              for base, frames in index.entries]
    return build_audio_feature_cache(frontend_apply, audios, norm_audio, seg_tokens=seg_tokens, dtype=dtype,
                                     lip_apply=lip_apply, verbose=verbose)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_frontend_apply(frontend: torch.nn.Module) -> Callable:
    """(audio [1, W, 2] numpy, n_valid) -> [1, T, 1024] numpy through a frozen
    ``Wav2VecFeatureExtractor`` on its own device."""
    dev = _device_of(frontend)

    def apply(audio: np.ndarray, n_valid: int) -> np.ndarray:
        with torch.no_grad():
            return frontend(torch.from_numpy(np.ascontiguousarray(audio)).to(dev), n_valid).cpu().numpy()

    return apply


def make_lip_apply(lip_model: torch.nn.Module) -> Callable:
    """frames [1, chunk, 1600] numpy (channel 0) -> [1, chunk, 1014] numpy
    through a frozen ``LipRegressor`` on its own device."""
    dev = _device_of(lip_model)

    def apply(frames: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            v = lip_model(torch.from_numpy(np.ascontiguousarray(frames)).to(dev))
            return v.reshape(v.shape[0], v.shape[1], -1).cpu().numpy()

    return apply
