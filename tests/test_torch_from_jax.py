"""``tools/torch_from_jax.py``: save dirs written by the JAX package, turned
into the port's layout, sample and render as the originals do, on the CPU.

The JAX dirs are tests/test_torch_generate.py's tiny pose denoiser, guide
and VQ (orbax ``ckpt/`` + ``config.json``), a trainer-layout denoiser dir
whose ``ckpt/`` holds ``{"state": {"params", "ema_params", "step"}}``, and a
renderer bundle of tests/test_torch_render.py's tiny avatar on the
synthetic person.  Bars: the slice's 1e-4 on DDIM-10 ``results.npy``
(tokens equal, keyframes within 2e-5 of their scale, as in
test_torch_generate.py), and the render's one count on at least 99.9% of
the covered pixels.  Converted trees are deleted once read.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps import generate as j_generate
from audio2photoreal_tpu.apps.render_pipeline import Camera as JCamera
from audio2photoreal_tpu.render import assets as j_assets
from audio2photoreal_tpu.train import checkpoints as j_checkpoints
from audio2photoreal_tpu_torch.apps import generate
from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
from audio2photoreal_tpu_torch.core.config import TrainConfig
from audio2photoreal_tpu_torch.models import guide
from audio2photoreal_tpu_torch.train import checkpoints
from audio2photoreal_tpu_torch.train.state import TrainState
from test_torch_generate import GUIDE, TOL, guide_dirs, slice_setup  # noqa: F401  (module fixtures)
from test_torch_render import CAMS, avatar  # noqa: F401  (a module fixture)
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_from_jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _drop_slice_dir(slice_setup):  # noqa: F811
    yield
    shutil.rmtree(slice_setup["root"])  # this module's person and pose dirs


def _fixed_noise(monkeypatch, x_T):
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(x_T, dtype))
    monkeypatch.setattr(generate, "draw_noise", lambda shape, g, device: torch.from_numpy(x_T))


def test_detect_kind(slice_setup, guide_dirs, tmp_path):  # noqa: F811
    d = guide_dirs
    assert torch_from_jax.detect_kind(slice_setup["j_dir"]) == "denoiser"
    assert torch_from_jax.detect_kind(d["j_guide"]) == "guide"
    assert torch_from_jax.detect_kind(d["j_vq"]) == "vq"
    (tmp_path / "config.json").write_text('{"train": {}}')
    with pytest.raises(ValueError, match="neither renderer.json"):
        torch_from_jax.detect_kind(str(tmp_path))
    with pytest.raises(ValueError, match="differ"):
        torch_from_jax.convert_dir(d["j_vq"], d["j_vq"])


def test_converted_pose_guide_and_vq_generate_as_jax(slice_setup, guide_dirs, monkeypatch, tmp_path):  # noqa: F811
    """The three JAX dirs through the CLI, then the port's generate with guide
    keyframes on the converted dirs against the JAX generate on the
    originals, with JAX's x_T and Gumbel noise."""
    s, d = slice_setup, guide_dirs
    out = {k: str(tmp_path / k) for k in ("pose", "guide", "vq")}
    for k, src in (("pose", s["j_dir"]), ("guide", d["j_guide"]), ("vq", d["j_vq"])):
        torch_from_jax.main([src, out[k]])
        assert sorted(os.listdir(out[k])) == ["config.json", generate.MODEL_FILE]
    # the same state_dicts as the tests' direct conversions
    for k, ref in (("pose", s["p_dir"]), ("guide", d["p_guide"]), ("vq", d["p_vq"])):
        got, want = (torch.load(f"{p}/{generate.MODEL_FILE}", weights_only=True) for p in (out[k], ref))
        assert sorted(got) == sorted(want)
        for n in want:
            assert torch.equal(got[n], want[n]), (k, n)

    _fixed_noise(monkeypatch, s["x_T"])
    seen = {}
    j_call = j_generate.GuideKeyframer.__call__

    def j_spy(self, audio, num_keyframes, key, top_p=0.94):
        seen["key"], seen["n"] = key, num_keyframes * self.vcfg.depth
        return j_call(self, audio, num_keyframes, key, top_p)

    monkeypatch.setattr(j_generate.GuideKeyframer, "__call__", j_spy)
    kw = dict(num_samples=2, guidance_param=2.0, timestep_respacing="ddim10", top_p=0.9)
    want = np.load(j_generate.generate(s["j_dir"], s["root"], guide_path=d["j_guide"], vq_path=d["j_vq"],
                                       output_dir=str(tmp_path / "j"), **kw), allow_pickle=True).item()
    key, noise = seen["key"], []
    for _ in range(seen["n"]):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.gumbel(sub, (2, GUIDE["tokens"]))))
    it = iter(noise)
    monkeypatch.setattr(guide, "draw_gumbel", lambda shape, g, device: torch.from_numpy(next(it)))
    got = np.load(generate.generate(out["pose"], s["root"], guide_path=out["guide"], vq_path=out["vq"],
                                    output_dir=str(tmp_path / "p"), device="cpu", **kw), allow_pickle=True).item()
    assert sorted(got) == sorted(want) == ["audio", "gt", "keyframes", "lengths", "motions"]
    scale = np.abs(want["keyframes"]).max()
    np.testing.assert_allclose(got["keyframes"], want["keyframes"], atol=2e-5 * scale, rtol=0)
    np.testing.assert_allclose(got["motions"], want["motions"], **TOL)
    for k in ("gt", "audio", "lengths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    shutil.rmtree(tmp_path)  # three converted dirs, two of them with a frozen frontend


@pytest.fixture(scope="module")
def ema_dirs(slice_setup, tmp_path_factory):  # noqa: F811
    """A trainer-layout JAX dir (``{"state": ...}``, EMA kept) and its conversion."""
    s = slice_setup
    root = str(tmp_path_factory.mktemp("ema"))
    rng = np.random.RandomState(12)
    ema = jax.tree_util.tree_map(lambda x: x + 0.05 * rng.randn(*x.shape).astype(np.float32), s["params"])
    j_dir = f"{root}/jax_ema"
    shutil.copytree(s["j_dir"], j_dir, ignore=shutil.ignore_patterns("ckpt"))
    j_checkpoints.save(f"{j_dir}/ckpt", 7, {"state": {"params": s["params"], "ema_params": ema,
                                                      "step": np.int32(7)}}, block=True)
    p_dir = torch_from_jax.convert_dir(j_dir, f"{root}/port_ema")
    yield dict(j_dir=j_dir, p_dir=p_dir)
    shutil.rmtree(root)


def test_converted_ema_is_what_use_ema_samples(slice_setup, ema_dirs, monkeypatch, tmp_path):  # noqa: F811
    s, e = slice_setup, ema_dirs
    assert checkpoints.steps(f"{e['p_dir']}/{generate.CKPT_DIR}") == [7]
    _fixed_noise(monkeypatch, s["x_T"])
    kw = dict(num_samples=2, guidance_param=2.0, timestep_respacing="ddim10")
    want = np.load(j_generate.generate(e["j_dir"], s["root"], use_ema=True, output_dir=str(tmp_path / "j"), **kw),
                   allow_pickle=True).item()
    got = np.load(generate.generate(e["p_dir"], s["root"], use_ema=True, output_dir=str(tmp_path / "p"),
                                    device="cpu", **kw), allow_pickle=True).item()
    np.testing.assert_allclose(got["motions"], want["motions"], **TOL)
    raw = np.load(generate.generate(e["p_dir"], s["root"], output_dir=str(tmp_path / "raw"), device="cpu", **kw),
                  allow_pickle=True).item()
    assert not np.allclose(raw["motions"], got["motions"], atol=1e-3)  # the EMA, not model.pt's parameters
    shutil.rmtree(tmp_path)


def test_a_port_trainer_does_not_resume_from_a_converted_dir(ema_dirs):
    model = generate.load_model(ema_dirs["p_dir"], "cpu")
    state = TrainState(model, TrainConfig(ema_decay=0.999))
    with pytest.raises(ValueError, match="no optimizer state"):
        checkpoints.try_resume(f"{ema_dirs['p_dir']}/{generate.CKPT_DIR}", state)


def test_converted_renderer_bundle_renders_as_jax(avatar, tmp_path):  # noqa: F811
    a = avatar
    src = j_assets.save_renderer_bundle(str(tmp_path / "jax"), a["jcfg"], a["params"],
                                        {n: JCamera(**c) for n, c in CAMS.items()})
    j_checkpoints.wait_all()
    out = torch_from_jax.convert_dir(src, str(tmp_path / "port"))
    assert sorted(os.listdir(out)) == ["assets.json", "cameras.npz", generate.MODEL_FILE, "renderer.json"]
    got_sd = torch.load(f"{out}/{generate.MODEL_FILE}", weights_only=True)
    assert sorted(got_sd) == sorted(a["sd"]) and all(torch.equal(got_sd[n], a["sd"][n]) for n in a["sd"])
    rng = np.random.RandomState(2)
    T = 4
    pose = (rng.randn(T, 104) * 0.05).astype(np.float32)
    face = (rng.randn(T, 256) * 0.05).astype(np.float32)
    want = j_assets.load_renderer_bundle(src, frame_batch=4).render_sequence_multicam(pose, face)
    got = load_body_renderer(out, frame_batch=4, device="cpu").render_sequence_multicam(pose, face)
    assert got.dtype == np.uint8 and got.shape == want.shape == (T, 48, 2 * 32, 3)
    covered = np.any(want != want[:, :1, :1], axis=-1)  # the corners are background
    assert 0.05 < covered.mean() < 0.95
    near = np.abs(got.astype(int) - want.astype(int)).max(axis=-1) <= 1
    assert near[covered].mean() >= 0.999, near[covered].mean()
    shutil.rmtree(tmp_path)
