"""The trainer's batch loader: windowed native reads and background prefetch.

Counterpart of ``audio2photoreal_tpu/data/loader.py``.  ``FastLoader`` reads
exactly the requested rows of each scene's ``.npy`` files and samples of its
wav, z-normalised in the same loop by the ``fastdata`` extension
(``data/native.py`` builds it from ``native/fastdata.c``), or by numpy when
asked to or when the extension cannot be built.  It samples as
``SocialDataset`` does on the train split: the capture-1/2 root-angle wrap,
a face window redrawn while it is entirely missing, face codes and mask
zeroed at missing frames, random lengths zero-padded with masks.  With a
feature cache (``data/feature_cache.py``) a batch carries
``audio_features`` (and for face ``lip_verts``) in place of ``audio``, and
crops are quantised to the cache's 3-frame grid.

Each batch is drawn from the ``np.random.RandomState`` handed to
``sample_batch``; ``make_train_iterator`` hands batch i the state seeded by
``step_seed(seed, i)``, so a run resumed at step i takes the batches an
uninterrupted one takes.  ``prefetch`` assembles them in a worker thread,
a few steps ahead of the loop.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from audio2photoreal_tpu_torch.core.config import DataConfig
from audio2photoreal_tpu_torch.data import native
from audio2photoreal_tpu_torch.data.dataset import _wrap_root_angle, read_wav
from audio2photoreal_tpu_torch.data.feature_cache import quantize_window, tokens_for_frames
from audio2photoreal_tpu_torch.data.stats import DataStats

READERS = ("auto", "fastdata", "numpy")


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s batch and generators."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def _npy_rows(path: str) -> int:
    """Row count from the npy header alone."""
    with open(path, "rb") as f:
        f.seek(8)
        hlen = int.from_bytes(f.read(2), "little")
        hdr = f.read(hlen).decode("latin1")
    shape = hdr.split("'shape': (")[1].split(")")[0]
    return int(shape.split(",")[0])


class SceneIndex:
    """Per-scene base paths, lengths and missing-face-frame masks of one
    split (train = all but the last ``num_val + num_test`` scenes)."""

    def __init__(self, data_root: str, person: str, split: str = "train", num_val: int = 2,
                 num_test: int = 4):
        pdir = os.path.join(data_root, person)
        entries: List[Tuple[str, int]] = []
        for pose_path in sorted(glob.glob(os.path.join(pdir, "*_body_pose.npy"))):
            base = pose_path[: -len("_body_pose.npy")]
            frames = _npy_rows(pose_path)
            face_path = base + "_face_expression.npy"
            if os.path.exists(face_path):
                frames = min(frames, _npy_rows(face_path))
            entries.append((base, frames))
        if not entries:
            raise FileNotFoundError(f"no scenes under {pdir}")
        n_hold = num_val + num_test
        if split == "train":
            entries = entries[: max(len(entries) - n_hold, 0)]
        elif split == "val":
            entries = entries[len(entries) - n_hold : len(entries) - num_test]
        elif split == "test":
            entries = entries[len(entries) - num_test :]
        elif split != "all":
            raise ValueError(f"unknown split {split!r}")
        if not entries:
            raise ValueError(f"no scenes for split {split}")
        self.entries = entries
        self.missing: List[np.ndarray] = []
        for base, frames in self.entries:
            mpath = base + "_missing_face_frames.npy"
            miss = np.zeros(frames, bool)
            if os.path.exists(mpath):
                idx = np.load(mpath).astype(int)
                miss[idx[idx < frames]] = True
            self.missing.append(miss)


class FastLoader:
    """Random-window batches of one split (pose or face), raw or cached.

    ``reader``: ``"fastdata"`` reads through the C extension and raises with
    gcc's output when it cannot be built; ``"numpy"`` reads with numpy;
    ``"auto"`` takes fastdata when it builds, else numpy.  ``self.reader``
    says which one runs."""

    def __init__(self, index: SceneIndex, stats: DataStats, cfg: DataConfig, feature_cache=None,
                 reader: str = "auto", audio: bool = True):
        if cfg.data_format not in ("pose", "face"):
            raise ValueError(f"data_format must be pose or face; got {cfg.data_format!r}")
        if reader not in READERS:
            raise ValueError(f"reader must be one of {READERS}; got {reader!r}")
        self.index, self.stats, self.cfg = index, stats, cfg
        self.feature_cache = feature_cache
        self.audio = audio and feature_cache is None  # raw audio in each batch (the VQ trainer reads none)
        self.fastdata = None
        if reader != "numpy":
            try:
                self.fastdata = native.fastdata()
            except RuntimeError:
                if reader == "fastdata":
                    raise
        self.reader = "numpy" if self.fastdata is None else "fastdata"
        self.inv_pose = 1.0 / float(stats.pose_std + 1e-8)
        self.inv_audio = 1.0 / float(stats.audio_std + 1e-8)
        self.inv_code = 1.0 / float(stats.code_std + 1e-8)
        # capture-1/2 persons wrap the root angle before the z-norm
        self.wrap_root = cfg.person in ("PXB184", "RLW104")
        self.nfeats = 104 if cfg.data_format == "pose" else 256

    def _read_rows(self, path: str, start: int, L: int, mean, inv: float, wrap: bool) -> np.ndarray:
        if self.fastdata is not None:
            # the wrap runs inside the C z-norm (column 3)
            buf, cols = self.fastdata.read_npy_rows(path, start, L)
            out = self.fastdata.normalize_rows(buf, np.asarray(mean, np.float32).tobytes(), inv, 3 if wrap else -1)
            return np.frombuffer(out, np.float32).reshape(L, cols)
        raw = np.asarray(np.load(path, mmap_mode="r")[start : start + L], np.float32)
        if wrap:
            raw = _wrap_root_angle(raw)
        return ((raw - mean) * inv).astype(np.float32)

    def _read_window(self, base: str, start: int, L: int, with_audio: bool):
        cfg, apf = self.cfg, self.cfg.audio_per_frame
        if cfg.data_format == "pose":
            motion = self._read_rows(base + "_body_pose.npy", start, L, self.stats.pose_mean, self.inv_pose,
                                     self.wrap_root)
        else:
            motion = self._read_rows(base + "_face_expression.npy", start, L, self.stats.code_mean,
                                     self.inv_code, False)
        audio = None
        if with_audio and self.fastdata is not None:
            abuf, ch = self.fastdata.read_wav_window(base + "_audio.wav", start * apf, L * apf)
            audio = np.frombuffer(self.fastdata.normalize_rows(
                abuf, np.asarray(self.stats.audio_mean, np.float32).tobytes(), self.inv_audio), np.float32
            ).reshape(L * apf, ch)
        elif with_audio:
            audio = self.stats.norm_audio(read_wav(base + "_audio.wav")[start * apf : (start + L) * apf]
                                          ).astype(np.float32)
        # 1 fps keyframes from the same window (pose)
        keyframes = motion[::30] if cfg.data_format == "pose" else None
        return motion, audio, keyframes

    def sample_batch(self, batch_size: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """One batch, its draws from ``rng``."""
        cfg, cache = self.cfg, self.feature_cache
        Tmax, apf, face = cfg.max_seq_length, cfg.audio_per_frame, cfg.data_format == "face"
        Kmax = -(-Tmax // 30)
        out = {
            "motion": np.zeros((batch_size, Tmax, self.nfeats), np.float32),
            "mask": np.zeros((batch_size, Tmax), np.float32),
            "lengths": np.zeros((batch_size,), np.int32),
        }
        Ta = None
        if self.audio:
            out["audio"] = np.zeros((batch_size, Tmax * apf, 2), np.float32)
        elif cache is not None:
            Ta = tokens_for_frames(Tmax)
            out["audio_features"] = np.empty((batch_size, Ta, cache.dim), np.float32)
            if face:
                out["lip_verts"] = np.empty((batch_size, Tmax, 1014), np.float32)
        if not face:
            out["keyframes"] = np.zeros((batch_size, Kmax, 104), np.float32)
            out["keyframe_valid"] = np.zeros((batch_size, Kmax), np.float32)
        for b in range(batch_size):
            si = rng.randint(len(self.index.entries))
            base, frames = self.index.entries[si]
            missing = self.index.missing[si]
            L = min(int(rng.randint(cfg.min_seq_length, cfg.max_seq_length + 1)), frames)
            start = int(rng.randint(0, max(frames - L, 0) + 1))
            if face:  # redraw the start while the window is entirely missing
                for _ in range(10):
                    if not missing[start : start + L].all():
                        break
                    start = int(rng.randint(0, max(frames - L, 0) + 1))
            if cache is not None:
                start, L = quantize_window(start, L, frames, cfg.min_seq_length)
            motion, audio, kf = self._read_window(base, start, L, with_audio=self.audio)
            miss_w = missing[start : start + L]
            if face:  # codes zeroed at missing frames, and the mask with them
                motion = np.where(miss_w[:, None], 0.0, motion)
                out["mask"][b, :L] = (~miss_w).astype(np.float32)
            else:
                out["mask"][b, :L] = 1.0
            out["motion"][b, :L] = motion
            out["lengths"][b] = L
            if self.audio:
                out["audio"][b, : L * apf] = audio
            elif cache is not None:
                out["audio_features"][b] = cache.window(si, start, L, Ta)
                if face:
                    out["lip_verts"][b] = cache.lip_window(si, start, L, Tmax)
            if kf is not None:
                out["keyframes"][b, : len(kf)] = kf
                out["keyframe_valid"][b, : len(kf)] = 1.0
        return out


_END = object()


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


def prefetch(batches: Iterable, depth: int = 2) -> Iterator:
    """``batches`` run in a daemon thread up to ``depth`` items ahead; the
    items come out in order, the worker's exception is raised in the
    consumer, and closing the generator (or leaving the loop) stops the
    worker at its next item."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
        except Exception as e:  # noqa: BLE001 - raised in the consumer
            put(_Raised(e))
            return
        put(_END)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        stop.set()
        t.join()


def make_train_iterator(
    data_root: str,
    stats: DataStats,
    cfg: DataConfig,
    seed: int = 0,
    start_step: int = 0,
    num_steps: Optional[int] = None,
    prefetch_depth: int = 2,
    feature_cache=None,
    reader: str = "auto",
    transform: Optional[Callable[[Dict[str, np.ndarray]], Dict]] = None,
    audio: bool = True,
):
    """(prefetched batches of steps ``start_step`` .. ``num_steps`` - 1 (no
    end when None), the ``FastLoader``) over the train split's
    ``SceneIndex``, which raises when the person has no train scenes; a
    ``feature_cache`` must be built over that same index; without one and
    with ``audio=False`` a batch carries no audio (and its draws are those
    of the batch with audio).  Batch i is drawn from
    ``RandomState(step_seed(seed, i))`` and passed through ``transform``
    (for example a copy into pinned memory) in the worker."""
    index = SceneIndex(data_root, cfg.person, "train", cfg.num_val_seqs, cfg.num_test_seqs)
    loader = FastLoader(index, stats, cfg, feature_cache=feature_cache, reader=reader, audio=audio)

    def batches():
        i = start_step
        while num_steps is None or i < num_steps:
            b = loader.sample_batch(cfg.batch_size, np.random.RandomState(step_seed(seed, i)))
            yield b if transform is None else transform(b)
            i += 1

    return prefetch(batches(), depth=prefetch_depth), loader
