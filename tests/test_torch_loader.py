"""The port's batch loader (audio2photoreal_tpu_torch/data/loader.py and the
host build of native/fastdata.c, data/native.py) against the JAX package's
``data/loader.py``, on the CPU.

Both loaders sample from a ``np.random.RandomState`` of the same seed; their
batches must be equal byte for byte, for pose and face, raw and cached (the
cached case hands both the same cache arrays), for both of the port's
readers: its fastdata build against the JAX loader running the same
extension, and its numpy reads against the JAX loader's numpy reads.  The
person is PXB184, so the root-angle wrap runs, and scene 0 of the train
split has a long missing stretch, so face windows are redrawn.
"""

import os
import threading

import numpy as np
import pytest

from audio2photoreal_tpu.core.config import DataConfig as JDataConfig
from audio2photoreal_tpu.data import feature_cache as j_cache
from audio2photoreal_tpu.data import loader as j_loader
from audio2photoreal_tpu.data.stats import DataStats as JDataStats
from audio2photoreal_tpu_torch.core.config import DataConfig
from audio2photoreal_tpu_torch.data import feature_cache, loader, native
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.data.stats import DataStats

PERSON = "PXB184"
FRAMES = 90
DATA = dict(person=PERSON, max_seq_length=60, min_seq_length=6, num_val_seqs=1, num_test_seqs=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader"))
    pdir = make_synthetic_person(root, PERSON, num_scenes=5, frames_per_scene=FRAMES, seed=2)
    # frames 0-69 of scene 0 missing: short face windows there are redrawn
    np.save(os.path.join(pdir, "scene00_missing_face_frames.npy"), np.arange(70))
    return root


@pytest.fixture(scope="module")
def stats(root):
    return os.path.join(root, PERSON, "data_stats.npz")


def _caches(index):
    """The same random cache arrays, once for each package."""
    rng = np.random.RandomState(7)
    feats = [rng.randn(feature_cache.tokens_for_frames(frames), 1024).astype(np.float32)
             for _, frames in index.entries]
    lips = [rng.randn(frames, 1014).astype(np.float32) for _, frames in index.entries]
    sil, lip_sil = rng.randn(1024).astype(np.float32), rng.randn(1014).astype(np.float32)
    return (feature_cache.AudioFeatureCache(feats, sil, lips, lip_sil),
            j_cache.AudioFeatureCache(feats, sil, lips, lip_sil))


@pytest.mark.parametrize("reader", ["fastdata", "numpy"])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("data_format", ["pose", "face"])
def test_batches_equal_jax_loader(root, stats, monkeypatch, data_format, cached, reader):
    if reader == "fastdata":  # the JAX loader runs the same extension
        monkeypatch.setattr(j_loader, "fastdata", native.fastdata(), raising=False)
    monkeypatch.setattr(j_loader, "HAVE_FASTDATA", reader == "fastdata")
    cfg = dict(DATA, data_format=data_format)
    index = loader.SceneIndex(root, PERSON, "train", 1, 1)
    jindex = j_loader.SceneIndex(root, PERSON, "train", 1, 1)
    assert index.entries == jindex.entries and len(index.entries) == 3
    for a, b in zip(index.missing, jindex.missing):
        np.testing.assert_array_equal(a, b)
    cache, jcache = _caches(index) if cached else (None, None)
    pl = loader.FastLoader(index, DataStats.load(stats), DataConfig(**cfg), feature_cache=cache, reader=reader)
    jl = j_loader.FastLoader(jindex, JDataStats.load(stats), JDataConfig(**cfg), seed=11, feature_cache=jcache)
    assert pl.reader == reader
    rng = np.random.RandomState(11)
    for _ in range(2):  # consecutive batches from one stream
        want, got = jl.sample_batch(6), pl.sample_batch(6, rng)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
    if cached:
        assert int(got["lengths"].max()) % feature_cache.FRAME_QUANTUM == 0
        assert ("lip_verts" in got) == (data_format == "face") and "audio" not in got
    if data_format == "face":
        assert (got["mask"].sum(1) > 0).all()  # no window entirely missing


def test_readers_agree(root, stats):
    """The fastdata and numpy reads give the same motion; the audio differs
    by the z-norm's rounding only (a multiply by 1/std against a division)."""
    index = loader.SceneIndex(root, PERSON, "train", 1, 1)
    cfg = DataConfig(**DATA, data_format="pose")
    a = loader.FastLoader(index, DataStats.load(stats), cfg, reader="fastdata").sample_batch(4, np.random.RandomState(3))
    b = loader.FastLoader(index, DataStats.load(stats), cfg, reader="numpy").sample_batch(4, np.random.RandomState(3))
    for k in ("motion", "mask", "lengths", "keyframes", "keyframe_valid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["audio"], b["audio"], rtol=1e-6, atol=1e-6)


def test_fastdata_build_failure(tmp_path, monkeypatch, root, stats):
    """``reader="fastdata"`` raises with gcc's stderr when the build fails;
    ``"auto"`` then reads with numpy.  The build lands under its own hashed
    name in the build directory."""
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().name.startswith("fastdata-")
    bad = tmp_path / "fastdata.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.fastdata.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="gcc failed for fastdata"):
            native.fastdata()
        index = loader.SceneIndex(root, PERSON, "train", 1, 1)
        cfg = DataConfig(**DATA, data_format="pose")
        with pytest.raises(RuntimeError, match="error"):
            loader.FastLoader(index, DataStats.load(stats), cfg, reader="fastdata")
        assert loader.FastLoader(index, DataStats.load(stats), cfg, reader="auto").reader == "numpy"
        with pytest.raises(ValueError, match="reader"):
            loader.FastLoader(index, DataStats.load(stats), cfg, reader="c")
    finally:
        native.fastdata.cache_clear()


def test_prefetch_order_end_error_and_close():
    assert list(loader.prefetch(iter(range(9)), depth=2)) == list(range(9))

    def failing():
        yield 1
        raise KeyError("worker")

    it = loader.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="worker"):
        next(it)
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = loader.prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # stops and joins the worker: it produces at most depth + 2 more
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())
    assert len(produced) <= 3 + 2 + 1


def test_train_iterator_resumes_and_ends(root, stats):
    """Batch i comes from ``step_seed(seed, i)``: started at step 2 the
    iterator yields the batches an iterator started at 0 yields from its
    third on, and it ends at ``num_steps``.  When the scenes do not index
    it raises, with a cache or without."""
    st = DataStats.load(stats)
    cfg = DataConfig(**{**DATA, "batch_size": 2}, data_format="face")
    full, ld = loader.make_train_iterator(root, st, cfg, seed=5, num_steps=4, reader="numpy")
    full = list(full)
    resumed, _ = loader.make_train_iterator(root, st, cfg, seed=5, start_step=2, num_steps=4, reader="numpy")
    resumed = list(resumed)
    assert len(full) == 4 and len(resumed) == 2 and ld.reader == "numpy"
    for a, b in zip(full[2:], resumed):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(full[0]["motion"], full[1]["motion"])
    want = ld.sample_batch(2, np.random.RandomState(loader.step_seed(5, 3)))
    np.testing.assert_array_equal(full[3]["motion"], want["motion"])
    cache, _ = _caches(loader.SceneIndex(root, PERSON, "train", 1, 1))
    for fc in (cache, None):
        with pytest.raises(FileNotFoundError):
            loader.make_train_iterator(root, st, DataConfig(**{**DATA, "person": "NOBODY"}), feature_cache=fc)


@pytest.mark.parametrize("reader", ["fastdata", "numpy"])
def test_batches_without_audio_are_the_batches_less_their_audio(root, stats, reader):
    """``audio=False`` (the VQ trainer's batches): the same windows, keyframes
    and masks as with audio, drawn from the same generator, and no audio."""
    cfg = DataConfig(data_format="pose", batch_size=4, **DATA)
    index = loader.SceneIndex(root, PERSON, "train", cfg.num_val_seqs, cfg.num_test_seqs)
    st = DataStats.load(stats)
    want = loader.FastLoader(index, st, cfg, reader=reader).sample_batch(4, np.random.RandomState(7))
    got = loader.FastLoader(index, st, cfg, reader=reader, audio=False).sample_batch(4, np.random.RandomState(7))
    assert "audio" in want and sorted(got) == sorted(k for k in want if k != "audio")
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
