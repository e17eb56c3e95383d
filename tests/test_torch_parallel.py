"""The port's data-parallel layer (audio2photoreal_tpu_torch/parallel) against
the JAX package's parallel/, on the CPU.

The helpers are held to the JAX ones (``MeshSpec.resolve``,
``local_batch_size``, ``slice_for_process``, ``per_process_seed``, the
trainer flags, ``initialize`` as a no-op without a launcher), as
``tests/test_distributed.py`` and ``tests/test_parallel.py`` hold those.  The
collectives are identities outside a bound step, and inside a 1-process
gloo group they reduce.  Rank r's dropout masks, the attention kernels'
(through ``MultiHeadAttention``'s seed) and ``hash_drop_mult``'s (through
``Dropout``), are bit-equal to its rows of JAX's global masks
(``flash.py:hash_mask_mult``, ``blocks.py:hash_drop_mult``); a Bernoulli
draw and the guidance-dropout draw under a binding are the global draw's
rows.  The 2-device CPU ``BodyRenderer`` renders the 1-device frames within
1 count (JAX's ``test_meshed_renderer_matches_single_device`` bar).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.parallel import distributed as j_dist
from audio2photoreal_tpu.parallel.mesh import MeshSpec as JMeshSpec
from audio2photoreal_tpu_torch import parallel
from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
from audio2photoreal_tpu_torch.kernels.flash_attn import dropout_mask, hash_bits, resolve_block_q, shard_seed
from audio2photoreal_tpu_torch.models import blocks
from audio2photoreal_tpu_torch.parallel import collectives, distributed, sharding
from audio2photoreal_tpu_torch.parallel.mesh import DataMesh, MeshSpec, create_mesh, data_mesh
from audio2photoreal_tpu_torch.render.assets import Camera, make_synthetic_assets
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

CPU = torch.device("cpu")


def _mesh(rank, size=2):
    return DataMesh(size, rank, CPU)


# ------------------------------------------------------------ helpers -- #


@pytest.mark.parametrize("shape,axes,n", [((-1,), ("data",), 8), ((2, -1), ("data", "model"), 8),
                                          ((3,), ("data",), 8), ((-1,), ("data",), 1), ((4, 2), ("data", "seq"), 8)])
def test_mesh_spec_resolves_as_jax(shape, axes, n):
    try:
        want = JMeshSpec(shape, axes).resolve(n)
    except ValueError:
        with pytest.raises(ValueError):
            MeshSpec(shape, axes).resolve(n)
        return
    assert MeshSpec(shape, axes).resolve(n) == want


def test_batch_helpers_match_jax():
    for g in (64, 6, 1):
        for pc in (1, 2, 3, 4):
            try:
                want = j_dist.local_batch_size(g, process_count=pc)
            except ValueError:
                with pytest.raises(ValueError):
                    distributed.local_batch_size(g, process_count=pc)
                continue
            assert distributed.local_batch_size(g, process_count=pc) == want
    for n in (16, 17, 3, 1, 0):
        for pc in (1, 2, 5, 8):
            for pi in range(pc):
                assert distributed.slice_for_process(n, pi, pc) == j_dist.slice_for_process(n, pi, pc)
    for seed in (0, 10, 2**31 - 5):
        for pi in range(6):
            assert distributed.per_process_seed(seed, pi) == j_dist.per_process_seed(seed, pi)
    # one process: the trivial slice, the unfolded seed
    assert distributed.local_batch_size(64) == 64 and distributed.slice_for_process(5) == slice(0, 5)
    assert distributed.per_process_seed(10) == 10 and distributed.is_coordinator()


@pytest.mark.parametrize("argv", [[], ["--distributed"],
                                  ["--coordinator_address", "localhost:1234", "--num_processes", "2",
                                   "--process_id", "1"]])
def test_distributed_flags_parse_as_jax(argv):
    jp, p = argparse.ArgumentParser(), argparse.ArgumentParser()
    j_dist.add_distributed_args(jp)
    distributed.add_distributed_args(p)
    want, got = vars(jp.parse_args(argv)), vars(p.parse_args(argv))
    assert {k: got[k] for k in want} == want
    assert got["dist_backend"] is None


def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    for var in distributed.LAUNCHER_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize_from_args(argparse.Namespace(distributed=True, coordinator_address=None)) is False
    assert distributed.initialize_from_args(argparse.Namespace()) is False
    assert not tdist.is_initialized()
    assert distributed.process_counts() == (0, 1) and distributed.is_coordinator()
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("localhost:1234")


def test_meshes_one_process_and_their_refusals(monkeypatch):
    m = data_mesh(6, "cpu")
    assert (m.size, m.index, m.device, m.rows(6)) == (1, 0, CPU, (0, 6))
    monkeypatch.setattr(distributed, "process_counts", lambda: (1, 3))
    with pytest.raises(ValueError, match="only the 'data' axis"):
        create_mesh(MeshSpec((1, -1), ("data", "model")), "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        data_mesh(64, "cpu")
    m = data_mesh(6, "cpu")
    assert (m.size, m.index, m.rows(2)) == (3, 1, (2, 6))
    assert parallel.batch_sharding(m, 6) == slice(2, 4)
    got = parallel.shard_batch(m, {"x": np.arange(12).reshape(6, 2)})["x"]
    np.testing.assert_array_equal(got.numpy(), np.arange(12).reshape(6, 2)[2:4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()


# -------------------------------------------------------- collectives -- #


def test_collectives_are_identities_unbound():
    x = torch.arange(4.0)
    assert collectives.psum(x, "data") is x and collectives.pmean(x, "data") is x
    assert collectives.all_gather(x, "data").shape == (1, 4)
    assert collectives.all_gather(x, "data", tiled=True) is x
    with sharding.bind(_mesh(0)):  # bound, but no process group: still the identity
        assert collectives.psum(x, "data") is x
        assert collectives.psum_tensors([x, x[:2]], "data")[1] is not None


def test_collectives_reduce_in_a_one_process_group(tmp_path):
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        x = torch.arange(4.0)
        assert collectives.psum(x, "data") is x  # unbound: the identity, group or not
        with sharding.bind(data_mesh(4, "cpu")):
            np.testing.assert_array_equal(collectives.psum(x, "data").numpy(), x.numpy())
            np.testing.assert_array_equal(collectives.pmean(x, "data").numpy(), x.numpy())
            assert collectives.all_gather(x, "data").shape == (1, 4)
            a, b = collectives.psum_tensors([x, 2 * x[:2]], "data")
            np.testing.assert_array_equal(b.numpy(), [0.0, 2.0])
        lin = torch.nn.Linear(2, 2)
        before = [p.detach().clone() for p in lin.parameters()]
        parallel.replicated(lin)  # one process: nothing to broadcast
        assert all(torch.equal(p, q) for p, q in zip(lin.parameters(), before))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------- draws and masks by rank -- #


def test_shard_seed_replays_the_offset_hash():
    rng = np.random.RandomState(0)
    for _ in range(20):
        seed, bo, ro = int(rng.randint(0, 2**32)), int(rng.randint(0, 10**6)), int(rng.randint(0, 10**9))
        b, r, c = torch.randint(0, 1000, (50,)), torch.randint(0, 2**20, (50,)), torch.randint(0, 4000, (50,))
        assert torch.equal(hash_bits(shard_seed(seed, bo, ro), b, r, c), hash_bits(seed, b + bo, r + ro, c))


@pytest.mark.parametrize("dim", [0, 1])
def test_draw_global_is_the_global_draw_sliced(dim):
    shape = (3, 6) if dim == 1 else (6, 3)
    g = torch.Generator().manual_seed(5)
    want = torch.rand(shape, generator=g)
    after = torch.rand((), generator=g)
    local = list(shape)
    local[dim] = 2
    for r in range(3):
        g = torch.Generator().manual_seed(5)
        with sharding.bind(DataMesh(3, r, CPU)):
            got = sharding.draw_global(lambda s: torch.rand(s, generator=g), local, dim=dim)
        assert torch.equal(got, want.narrow(dim, 2 * r, 2))
        assert torch.equal(torch.rand((), generator=g), after)  # the generator moved as the global draw's


def _jax_global_attention_mask(seed, B, H, Tq, Tk, rate, bq):
    nj = -(-Tq // bq)
    out = np.zeros((B, H, Tq, Tk), np.float32)
    for b in range(B):
        for h in range(H):
            for j in range(nj):
                rows = min(bq, Tq - j * bq)
                blk = np.asarray(j_flash.hash_mask_mult(jnp.uint32(seed), (b * H + h) * nj + j, (bq, Tk), rate))
                out[b, h, j * bq:j * bq + rows] = blk[:rows]
    return out


def test_rank_attention_dropout_mask_is_its_slice_of_jax_global(monkeypatch):
    B, H, Tq, Tk, D, rate, seed = 4, 2, 400, 3000, 16, 0.25, 987654321
    bq = resolve_block_q(Tq, Tk)
    assert -(-Tq // bq) == 2  # two q-blocks a head
    want = _jax_global_attention_mask(seed, B, H, Tq, Tk, rate, bq)
    attn = blocks.MultiHeadAttention(D, H, flash=True, dropout=rate).train()
    seen = []
    monkeypatch.setattr(blocks, "draw_seed", lambda g, high=blocks.INT32_MAX: seed)
    monkeypatch.setattr(blocks, "flash_attention", lambda q, k, v, kv, causal, r, s: seen.append(s) or q)
    for r in range(2):
        with sharding.bind(_mesh(r)):
            attn(torch.zeros(B // 2, Tq, D), torch.zeros(B // 2, Tk, D), torch.zeros(B // 2, Tk, D))
        got = dropout_mask(B // 2, H, Tq, Tk, rate, seen[-1]).numpy()
        np.testing.assert_array_equal(got, want[2 * r:2 * r + 2])
    assert seen[0] == seed  # rank 0's rows start the global batch: its seed is the drawn one


@pytest.mark.parametrize("shape", [(4, 7, 5), (6, 3)])
def test_rank_hash_dropout_is_its_slice_of_jax_global(monkeypatch, shape):
    rate, seed = 0.3, 3141592653
    monkeypatch.setattr(j_blocks, "_key_to_seed", lambda key: jnp.uint32(seed))
    want = np.asarray(j_blocks.hash_drop_mult(jax.random.PRNGKey(0), shape, rate, jnp.float32))
    monkeypatch.setattr(blocks, "draw_seed", lambda g, high=blocks.INT32_MAX: seed)
    drop = blocks.Dropout(rate, hash_dropout=True).train()
    n = shape[0] // 2
    for r in range(2):
        with sharding.bind(_mesh(r)):
            got = drop(torch.ones((n,) + shape[1:])).numpy()
        np.testing.assert_array_equal(got, want[n * r:n * (r + 1)])


def test_rank_bernoulli_dropout_is_its_slice_of_the_global_draw():
    """A permuted input: the global mask is drawn in the input's memory
    order, as ``empty_like`` of the global input would lay it out."""
    drop = blocks.Dropout(0.5).train()
    x = torch.ones(4, 5, 6).permute(0, 2, 1)  # [4, 6, 5], dims 1 and 2 swapped in memory
    want = drop(x, torch.Generator().manual_seed(3))
    for r in range(2):
        with sharding.bind(_mesh(r)):
            got = drop(x[2 * r:2 * r + 2], torch.Generator().manual_seed(3))
        assert torch.equal(got, want[2 * r:2 * r + 2])


# ------------------------------------------------------------ render -- #

TINY = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_face_embs=256, n_pose_enc_channels=8,
            n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32, view_unet_ftrs=4,
            encoder_in_size=64, face_tex_size=64, n_face_verts=64, image_height=48, image_width=32)
CAMS = {"cam0": dict(campos=np.array([0.0, -3.0, 1.0], np.float32),
                     K=np.array([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]], np.float32),
                     Rt=np.array([[1, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32)),
        "cam1": dict(campos=np.array([0.5, -3.0, 1.0], np.float32),
                     K=np.array([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]], np.float32),
                     Rt=np.array([[1, 0, 0, -0.5], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32))}


@pytest.fixture(scope="module")
def renderers():
    cfg = RendererConfig(**TINY)
    assets = make_synthetic_assets(cfg)
    m = BodyAvatar(cfg, assets)
    m.reset_parameters(torch.Generator().manual_seed(0))
    sd, cams = m.state_dict(), {n: Camera(**c) for n, c in CAMS.items()}
    single = BodyRenderer(cfg, assets, sd, cams, frame_batch=3, device="cpu")
    two = BodyRenderer(cfg, assets, sd, cams, frame_batch=3, devices=["cpu", "cpu"])
    return single, two


@pytest.mark.parametrize("method", ["render_sequence_multicam", "render_sequence"])
def test_two_device_renderer_matches_one_device(renderers, method):
    single, two = renderers
    assert two.frame_batch == 4 and len(two.replicas) == 2 and two.replicas[0] is not two.replicas[1]
    rng = np.random.RandomState(0)
    T = 10  # 3 frame batches of 4, the last padded
    pose = (rng.randn(T, 104) * 0.05).astype(np.float32)
    face = (rng.randn(T, 256) * 0.05).astype(np.float32)
    want, got = getattr(single, method)(pose, face), getattr(two, method)(pose, face)
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[0] == T
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    with pytest.raises(ValueError, match="not both"):
        BodyRenderer(two.cfg, two.model.assets, two.model.state_dict(), two.cameras, device="cpu", devices=["cpu"])
