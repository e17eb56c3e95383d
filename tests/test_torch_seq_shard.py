"""The sequence-sharded vq-wav2vec frontend (``parallel/seq_shard.py``)
against the unsharded extractor and the JAX package, on the CPU.

The windows and the receptive field are held to the JAX package's; the
ownership masks are checked in one process (every layer's frames counted
once over the windows, their masked moments the whole signal's).  Then two
gloo ranks (``tests/torch_seq_shard_ranks.py``, which imports torch and the
port only), spawned once for the module and joined through a ``file://``
store under the test's temporary directory, run ``seq_sharded_extract`` on
the full-width extractor at the JAX package's lengths (``tests/
test_seq_shard.py``); their outputs are held to the port's unsharded
extractor within 1e-5 of scale (only the order of the moment sums differs)
and to JAX's unsharded ``ConvFeatureExtractor`` on the same weights within
2e-5 of scale; the bf16 extractor sharded over the two ranks to JAX's bf16
extractor sharded over two devices, compiled with excess precision off, by
the accuracy-ratio bar of ``tests/test_torch_bf16.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_seq_shard_ranks as ranks_mod  # tests/torch_seq_shard_ranks.py
from audio2photoreal_tpu.models.audio_encoder import ConvFeatureExtractor as JExtractor
from audio2photoreal_tpu.parallel import MeshSpec as JMeshSpec
from audio2photoreal_tpu.parallel import create_mesh as j_create_mesh
from audio2photoreal_tpu.parallel import seq_shard as j_seq_shard
from audio2photoreal_tpu.train.convert import convert_wav2vec_extractor
from audio2photoreal_tpu_torch.models.audio_encoder import VQ_WAV2VEC_SPEC, SeqShardCtx
from audio2photoreal_tpu_torch.parallel import seq_shard
from audio2photoreal_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from test_torch_bf16 import _ratio, _run
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

RANKS = 2
REL_PORT, REL_JAX = 1e-5, 2e-5
HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_seq_shard_ranks.py")
ROOT = os.path.dirname(os.path.dirname(HELPER))


def _scaled(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel} of {scale:.3g}"


def test_receptive_field():
    assert seq_shard.receptive_field() == j_seq_shard.receptive_field() == 465


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("S", [160 * 64 + 465, 160 * 61 + 465 + 37])
def test_chunked_windows_match_jax(n, S):
    wav = np.random.RandomState(0).randn(2, S).astype(np.float32)
    want = np.asarray(j_seq_shard.chunked_windows(jnp.asarray(wav), n))
    got = seq_shard.chunked_windows(torch.from_numpy(wav), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("S", [160 * 320 + 465, 160 * 301 + 465 + 37])
def test_ownership_masks_count_every_frame_once(n, S):
    """In one process, with no group: over the windows (the last one run on
    to the signal's end, as ``seq_sharded_extract`` runs it), each layer's
    owned frames are the whole signal's frames exactly once, so their
    masked count and first and second central moments summed over the
    windows equal the unsharded group norm's."""
    n_out, m = seq_shard._frames(S, n)
    W = seq_shard.chunked_windows(torch.zeros(1, S), n).shape[-1]
    lengths = [W] * (n - 1) + [max(W, S - (n - 1) * m * 160)]  # samples of each window
    total_jump = int(np.prod([s for _, _, s in VQ_WAV2VEC_SPEC]))
    rng = np.random.RandomState(1)
    rf, jump, t_all = 1, 1, S
    for _, k, s in VQ_WAV2VEC_SPEC:
        rf, jump, t_all = rf + (k - 1) * jump, jump * s, (t_all - k) // s + 1
        lengths = [(t - k) // s + 1 for t in lengths]
        x = rng.randn(4, t_all)  # a layer's map of the whole signal, [C, T]
        step = m * total_jump // jump  # a window's first frame, in this layer's frames
        idx, cnt, s1, windows = [], 0, 0.0, []
        for r, t_win in enumerate(lengths):
            own = SeqShardCtx("seq", r, n, m, S).owned(t_win, rf, jump, total_jump).numpy()
            g = r * step + np.arange(t_win)
            xw = np.where(g < t_all, x[:, np.minimum(g, t_all - 1)], 0.0)  # the window's frames, its padding 0
            idx.extend(g[own])
            cnt += int(own.sum()) * x.shape[0]
            s1 += (xw * own).sum()
            windows.append((xw, own))
        assert sorted(idx) == list(range(t_all)), (rf, jump)
        assert cnt == x.size
        mean = s1 / cnt
        s2 = sum((((xw - mean) ** 2) * own).sum() for xw, own in windows)
        np.testing.assert_allclose([mean, s2 / cnt], [x.mean(), x.var()], rtol=1e-10)
    assert t_all == n_out


def test_one_process_is_the_unsharded_extractor():
    """Without a group (one window, the whole signal) the sharded call is
    the extractor, up to the order of the moment sums (its norms take the
    masked sums); a ``seq`` mesh of one process resolves to that axis."""
    mesh = create_mesh(MeshSpec((-1,), ("seq",)), "cpu")
    assert (mesh.size, mesh.index, mesh.axis) == (1, 0, "seq")
    fe = ranks_mod.extractor()
    wav = torch.from_numpy(ranks_mod.signal("f32_ragged"))
    with torch.no_grad():
        got = seq_shard.seq_sharded_extract(lambda w, ctx: fe(w, ctx), wav, mesh)
        want = fe(wav)
    _scaled(got, want, REL_PORT, "one window")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(each rank's outputs, the 1-process outputs); the ranks run while this
    process computes its own."""
    d = tmp_path_factory.mktemp("seq_shard")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, HELPER, str(r), str(RANKS), f"file://{d / 'store'}",
                               str(d / f"rank{r}.pt")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    try:
        single = ranks_mod.run(None)
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(RANKS)], single


@pytest.fixture(scope="module")
def jax_params():
    sd = {f"fe.{k}": v.numpy() for k, v in ranks_mod.extractor().state_dict().items()}
    return {"params": convert_wav2vec_extractor(sd, "fe")}


@pytest.mark.parametrize("case", ["f32", "f32_ragged"])
def test_two_ranks_match_the_unsharded_extractor_and_jax(sharded, jax_params, case):
    ranks, single = sharded
    B, S, _, _ = ranks_mod.CASES[case]
    n_out = (S - 465) // 160 + 1
    for r, out in enumerate(ranks):
        assert out[case].shape == (B, n_out, 512) and out[case].dtype == torch.float32
        _scaled(out[case], single[case], REL_PORT, f"{case} rank {r} vs 1 process")
    assert torch.equal(ranks[0][case], ranks[1][case])
    want = jax.jit(JExtractor().apply)(jax_params, jnp.asarray(ranks_mod.signal(case)))
    _scaled(ranks[0][case], want, REL_JAX, f"{case} vs JAX")


def test_two_ranks_in_bf16_match_jax_strict(sharded, jax_params):
    """The bf16 extractor (bf16 convs, f32 moments) sharded over the two
    ranks against JAX's, sharded over two devices, by the ratio bar."""
    ranks, _ = sharded
    wav = jnp.asarray(ranks_mod.signal("bf16"))
    mesh = j_create_mesh(JMeshSpec((RANKS,), ("seq",)), jax.devices()[:RANKS])

    def extract(dtype):
        fe = JExtractor(compute_dtype=dtype)
        return lambda p, w: j_seq_shard.seq_sharded_extract(lambda win, ctx: fe.apply(p, win, ctx), w, mesh)

    want32 = _run(extract("float32"), jax_params, wav)
    want16 = _run(extract("bfloat16"), jax_params, wav, strict=True)
    got = ranks[0]["bf16"]
    assert got.dtype == torch.float32 and torch.equal(got, ranks[1]["bf16"])
    _ratio(got, want16, want32, "bf16 sharded frontend")
