"""The port's numpy layers (config, data, diffusion tables) and its DDIM loop
against the JAX package: configs and fixture files are byte-identical,
tables equal, and the DDIM loop with a fixed model function agrees to f32
rounding (2e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.data.dataset import SocialDataset as JDataset
from audio2photoreal_tpu.data.dataset import load_local_data as j_load
from audio2photoreal_tpu.data.fixtures import make_synthetic_person as j_person
from audio2photoreal_tpu.diffusion import respace as j_respace
from audio2photoreal_tpu.diffusion import sampling as j_sampling
from audio2photoreal_tpu_torch.core import config
from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.diffusion import respace, sampling
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)


def test_config_json_round_trips_between_packages(tmp_path):
    cfgs = dict(denoiser=config.DenoiserConfig(latent_dim=32, flash_attention=True),
                diffusion=config.DiffusionConfig(steps=50), data=config.DataConfig(person="X"),
                train=config.TrainConfig(mesh_shape=(2, -1)))
    config.save_config(str(tmp_path / "a"), **cfgs)
    j_config.save_config(str(tmp_path / "b"), **{k: getattr(j_config, type(v).__name__)(
        **{f: getattr(v, f) for f in v.__dataclass_fields__}) for k, v in cfgs.items()})
    assert (tmp_path / "a" / "config.json").read_bytes() == (tmp_path / "b" / "config.json").read_bytes()
    back = config.load_config(str(tmp_path / "b"))
    assert back == cfgs
    assert j_config.load_config(str(tmp_path / "a"))["denoiser"].latent_dim == 32


def test_synthetic_person_files_are_byte_identical(tmp_path):
    a = make_synthetic_person(str(tmp_path / "a"), num_scenes=3, frames_per_scene=40, seed=4)
    b = j_person(str(tmp_path / "b"), num_scenes=3, frames_per_scene=40, seed=4)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 3 * 4 + 1
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def _split_chunks_match(tmp_path, data_format):
    make_synthetic_person(str(tmp_path), "P", num_scenes=7, frames_per_scene=50, seed=1)
    stats_path = str(tmp_path / "P" / "data_stats.npz")
    from audio2photoreal_tpu.data.stats import DataStats as JStats
    from audio2photoreal_tpu_torch.data.stats import DataStats

    dc = dict(person="P", max_seq_length=24, min_seq_length=20, data_format=data_format)
    ours = SocialDataset(load_local_data(str(tmp_path), "P"), DataStats.load(stats_path),
                         config.DataConfig(**dc), "test")
    theirs = JDataset(j_load(str(tmp_path), "P"), JStats.load(stats_path),
                      j_config.DataConfig(**dc), "test")
    assert len(ours) == len(theirs) == 8
    for i in (0, 7):
        a, b = ours.get_chunk(i), theirs.get_chunk(i)
        assert a.keys() == b.keys()
        # a face chunk carries no keyframes: its codes are the motion
        assert ("keyframes" in a) == (data_format == "pose")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_test_split_chunks_match(tmp_path):
    _split_chunks_match(tmp_path, "pose")


def test_face_split_chunks_match(tmp_path):
    _split_chunks_match(tmp_path, "face")


@pytest.mark.parametrize("spacing", ["ddim5", "ddim50", "10,15,20", ""])
def test_respaced_schedule_tables_equal(spacing):
    ours = respace.maybe_respaced("cosine", 1000, spacing)
    theirs = j_respace.maybe_respaced("cosine", 1000, spacing)
    assert ours._fields == theirs._fields
    for name, a, b in zip(ours._fields, ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("predict", ["xstart", "eps", "v"])
def test_ddim_loop_matches_jax(predict):
    """A fixed nonlinear model_fn of (x, t): the loop's arithmetic alone."""
    rng = np.random.RandomState(2)
    x_T = rng.randn(3, 7, 5).astype(np.float32)
    w = rng.randn(5, 5).astype(np.float32) * 0.3
    s_ours = respace.maybe_respaced("cosine", 1000, "ddim10")
    s_theirs = j_respace.maybe_respaced("cosine", 1000, "ddim10")

    def fn_ours(x, t):
        return torch.tanh(x @ torch.from_numpy(w)) + (t.float() / 1000.0)[:, None, None]

    def fn_theirs(x, t):
        return jnp.tanh(x @ jnp.asarray(w)) + (t.astype(jnp.float32) / 1000.0)[:, None, None]

    got = sampling.ddim_sample_loop(s_ours, predict, fn_ours, torch.from_numpy(x_T))
    want = j_sampling.ddim_sample_loop(s_theirs, predict, fn_theirs, jnp.asarray(x_T),
                                       jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.pred_xstart.numpy(), np.asarray(want.pred_xstart), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(want.sample), atol=2e-5, rtol=2e-5)


def test_ddim_loop_draws_step_noise_only_with_eta():
    s = respace.maybe_respaced("cosine", 1000, "ddim4")
    x_T = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))

    def fn(x, t):
        return 0.5 * x

    a = sampling.ddim_sample_loop(s, "xstart", fn, x_T)
    b = sampling.ddim_sample_loop(s, "xstart", fn, x_T, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.sample, b.sample)
    c = sampling.ddim_sample_loop(s, "xstart", fn, x_T, eta=1.0,
                                  generator=torch.Generator().manual_seed(1))
    d = sampling.ddim_sample_loop(s, "xstart", fn, x_T, eta=1.0,
                                  generator=torch.Generator().manual_seed(1))
    assert torch.equal(c.sample, d.sample) and not torch.equal(a.sample, c.sample)
