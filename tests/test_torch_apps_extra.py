"""The port's eval metrics, debug visualisation and ground-truth annotation
render (``apps/eval_metrics.py``, ``render/viz.py``, ``apps/render_anno.py``)
against the JAX package's, on the CPU.

``eval_metrics`` and ``viz`` are the port's own copies of numpy code: their
outputs equal JAX's exactly, ``viz`` for numpy input and for torch tensors
(f32 and bf16) alike.  ``render_anno`` without a renderer writes the same
``anno_NNNN.npz`` files as JAX's; with a renderer bundle it hands the
renderer each chunk's pose and the scene's own face codes of those frames
(the reference's render_anno.py:41-48; JAX's renders zeros).
"""

import os
import sys

import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps import eval_metrics as j_eval
from audio2photoreal_tpu.apps import render_anno as j_render_anno
from audio2photoreal_tpu.render import viz as j_viz
from audio2photoreal_tpu_torch.apps import eval_metrics, render_anno
from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
from audio2photoreal_tpu_torch.data.dataset import load_local_data
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
from audio2photoreal_tpu_torch.render import viz
from audio2photoreal_tpu_torch.render.assets import Camera, make_synthetic_assets, save_renderer_bundle
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

RENDER_TINY = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_face_embs=256,
                   n_pose_enc_channels=8, n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4,
                   shadow_size=32, view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
                   image_height=48, image_width=32)


def test_eval_metrics_equal_jax():
    rng = np.random.RandomState(0)
    pred = rng.randn(3, 2, 104, 40).astype(np.float32)
    gt = rng.randn(3, 2, 104, 40).astype(np.float32)
    assert eval_metrics.evaluate_results(pred, gt) == j_eval.evaluate_results(pred, gt)
    mu, cov = eval_metrics.activation_statistics(pred.reshape(-1, 104))
    np.testing.assert_array_equal(eval_metrics._sqrtm_psd(cov), j_eval._sqrtm_psd(cov))
    assert eval_metrics.frechet_distance(mu, cov, mu + 1, cov) == j_eval.frechet_distance(mu, cov, mu + 1, cov)


def test_eval_metrics_cli_equals_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(1)
    path = str(tmp_path / "results.npy")
    np.save(path, {"motions": rng.randn(4, 104, 1, 30).astype(np.float32),
                   "gt": rng.randn(4, 104, 1, 30).astype(np.float32)})
    argv = ["eval_metrics", "--results", path, "--num_samples", "2", "--seq_len", "30"]
    out = []
    for main in (j_eval.main, eval_metrics.main):
        monkeypatch.setattr(sys, "argv", argv)
        main()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[1].startswith("cross_var ")


@pytest.mark.parametrize("kind", ["numpy", "torch", "torch_bf16"])
def test_viz_equals_jax(kind):
    rng = np.random.RandomState(2)

    def arr(*shape, scale=1.0):
        a = (rng.rand(*shape) * scale).astype(np.float32)
        if kind == "numpy":
            return a, a
        t = torch.from_numpy(a)
        if kind == "torch_bf16":
            t = t.to(torch.bfloat16)
            a = t.float().numpy()
        return t, a

    x, xn = arr(3, 16, 12)
    k, kn = arr(2, 3, 2, scale=10.0)
    imgs, imgs_n = arr(5, 3, 16, 16, scale=255.0)
    small, small_n = arr(5, 1, 8, 8, scale=255.0)
    cases = [
        ("tensor2rgb", (x,), (xn,), {}), ("tensor2rgb", (x,), (xn,), dict(x_min=0.2, x_max=0.8)),
        ("tensor2rgbjet", (x[0],), (xn[0],), {}), ("tensor2image", (x,), (xn,), {}),
        ("tensor2image", (x[:1],), (xn[:1],), dict(mode="jet", label="tex")), ("tensor2image", (x[0],), (xn[0],), {}),
        ("feature2rgb", (x,), (xn,), {}), ("feature2rgb", (x,), (xn,), dict(scale=2)),
        ("kpts2delta", (k, (6, 5)), (kn, (6, 5)), {}), ("kpts2heatmap", (k, (6, 5)), (kn, (6, 5)), dict(sigma=2)),
        ("make_image_grid", (imgs,), (imgs_n,), {}),
        ("make_image_grid", ({"rgb": imgs, "depth": small},), ({"rgb": imgs_n, "depth": small_n},),
         dict(scale_factor=0.5)),
        ("make_image_grid_batched", ({"a": imgs, "b": small},), ({"a": imgs_n, "b": small_n},),
         dict(max_row_height=12)),
    ]
    for name, args, args_n, kw in cases:
        got, want = getattr(viz, name)(*args, **kw), getattr(j_viz, name)(*args_n, **kw)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    u8 = [np.full((8, 6, 3), 9, np.uint8), np.full((4, 10, 3), 200, np.uint8)]
    for got, want in zip(viz.resize_to_match(u8), j_viz.resize_to_match(u8)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(viz.add_label_centered(u8[0].repeat(4, 0).repeat(4, 1), "ab"),
                                  j_viz.add_label_centered(u8[0].repeat(4, 0).repeat(4, 1), "ab"))
    np.testing.assert_array_equal(viz.get_color_map(), j_viz.get_color_map())


def test_viz_imports_no_pil_at_module_level():
    """The card's machine lists no PIL: only the functions that draw text
    or resize import it."""
    import ast

    tree = ast.parse(open(viz.__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(str(m).split(".")[0] == "PIL" for m in names), names


@pytest.fixture(scope="module")
def anno_person(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("anno"))
    make_synthetic_person(root, "SYNTH01", num_scenes=7, frames_per_scene=90, seed=5)
    return root


def test_render_anno_npz_equals_jax(anno_person, tmp_path, monkeypatch):
    outs = {}
    for side, main in (("jax", j_render_anno.main), ("port", None)):
        out = str(tmp_path / side)
        argv = ["--data_root", anno_person, "--person", "SYNTH01", "--save_dir", out, "--max_seq_length", "40"]
        if main is None:
            render_anno.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["render_anno"] + argv)
            main()
        outs[side] = out
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) == 8  # 4 test scenes x 2 chunks of 40
    for n in names:
        a, b = np.load(os.path.join(outs["jax"], n)), np.load(os.path.join(outs["port"], n))
        assert sorted(a.files) == sorted(b.files) == ["audio", "pose"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{n}:{k}")


def test_render_anno_renders_the_scenes_face_codes(anno_person, tmp_path, monkeypatch):
    cfg = RendererConfig(**RENDER_TINY)
    avatar = BodyAvatar(cfg, make_synthetic_assets(cfg, seed=0))
    bundle = save_renderer_bundle(str(tmp_path / "bundle"), cfg, avatar.state_dict(),
                                  {"cam": Camera(campos=np.zeros(3, np.float32), K=np.eye(3, dtype=np.float32),
                                                 Rt=np.eye(3, 4, dtype=np.float32))})
    blocks = []

    def spy(self, block, out_path, **kw):
        blocks.append((block, out_path, list(self.cameras), self.device.type))
        return out_path + "_pred.mp4"

    monkeypatch.setattr(BodyRenderer, "render_full_video", spy)
    out = str(tmp_path / "out")
    render_anno.main(["--data_root", anno_person, "--person", "SYNTH01", "--save_dir", out, "--max_seq_length", "40",
                      "--body_ckpt", bundle, "--device", "cpu"])
    scenes = load_local_data(anno_person, "SYNTH01")[-4:]  # the test split
    assert len(blocks) == 8
    for i, (block, out_path, cams, device) in enumerate(blocks):
        scene, start = scenes[i // 2], 40 * (i % 2)
        assert cams == ["default"] and device == "cpu" and out_path.endswith(f"anno_{i:04d}")
        np.testing.assert_array_equal(block["face_motion"], scene.face[start : start + 40])
        assert block["body_motion"].shape == (40, 104) and block["face_motion"].any()
    cam = render_anno.anno_camera()
    np.testing.assert_array_equal(cam.Rt, np.array([[1, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32))
