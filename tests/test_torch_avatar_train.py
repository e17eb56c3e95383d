"""The avatar trainer of the port (render/calibration.py, BodyAvatar's
training forward, train/loops.py:avatar_train_step, apps/train_avatar.py)
against the JAX package's, on the CPU.

The tiny renderer config of ``tests/test_avatar_train.py`` (UV 64, image
48 x 32, three cameras).  JAX parameters are numpy fills of the shapes
``jax.eval_shape`` gives for the training init (the init itself takes a
minute here); they reach the port through
``convert.body_avatar_state_dict_from_jax`` and JAX gradients come back the
same way.  The posterior noise is JAX's: ``mesh_vae.draw_posterior_noise``
answers with ``jax.random.normal`` under the step's noise key, which the
JAX package hands both encoders (ROADMAP queue 3).

Bars: the calibration modules' outputs and input gradients within 1e-6;
the training forward within 2e-5 of each output's scale; one step's loss
parts within 1e-5 relative, every gradient within 1e-4 of its largest
element, parameters after AdamW within 2 lr (a first AdamW step moves a
parameter by about lr times the sign of its gradient).
"""

import json
import os
from typing import Any

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.render import calibration as j_cal
from audio2photoreal_tpu.render.assets import make_synthetic_assets as j_make_assets
from audio2photoreal_tpu.render.mesh_vae import BodyAvatar as JAvatar
from audio2photoreal_tpu.render.mesh_vae import RendererConfig as JRendererConfig
from audio2photoreal_tpu.train import loops as j_loops
from audio2photoreal_tpu.train import state as j_state
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import train_avatar
from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
from audio2photoreal_tpu_torch.core.config import TrainConfig
from audio2photoreal_tpu_torch.render import calibration, mesh_vae
from audio2photoreal_tpu_torch.render.assets import Camera, make_synthetic_assets, save_renderer_bundle
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from audio2photoreal_tpu_torch.train.loops import avatar_train_step
from audio2photoreal_tpu_torch.train.state import TrainState
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

TINY = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=16, n_face_embs=16, n_pose_enc_channels=8,
            n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32, view_unet_ftrs=4,
            encoder_in_size=64, face_tex_size=64, n_face_verts=64, image_height=48, image_width=32, n_cameras=3)
B = 2
LR = 2e-3
K = np.array([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]], np.float32)
RT = np.array([[1, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32)
CAMPOS = np.array([0.0, -3.0, 1.0], np.float32)
FORWARD_KEYS = ("rgb", "tex_rec", "shadow_map", "pose_shadow_map", "geom", "embs", "face_embs")
LOSS_PARTS = ("loss_rgb", "loss_geom", "loss_kl", "loss_shadow", "loss_blur_reg")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy() if x.dim() == 4 else _np(x)


def _scaled(got, want, rel, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(float(np.abs(want).max()), 1e-30)
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


# --------------------------------------------------------------------- #
# calibration modules
# --------------------------------------------------------------------- #

CAMS = np.array([2, 0, 1], np.int64)


def _module_case(name, rng):
    """-> (jax fn of an NHWC image, port fn of an NCHW image, its params)."""
    n, H, W = 3, 16, 24
    cam = jnp.asarray(CAMS)
    tcam = torch.from_numpy(CAMS)
    if name.startswith("blur"):
        size, sigma = {"blur3": (3, 1.0), "blur5": (5, 1.0), "blur7": (7, 2.0)}[name]
        return (lambda x: j_cal.gaussian_blur(x, size, sigma)), (lambda x: calibration.gaussian_blur(x, size, sigma))
    if name in ("CalV3", "CalV5"):
        w, b = (1 + 0.2 * rng.randn(n, 3)).astype(np.float32), (0.3 * rng.randn(n, 3)).astype(np.float32)
        jm, pm = getattr(j_cal, name)(n_cameras=n), getattr(calibration, name)(n)
        pm.load_state_dict({"weight": _t(w), "bias": _t(b)})
        return (lambda x: jm.apply({"params": {"weight": w, "bias": b}}, x, cam)), (lambda x: pm(x, tcam))
    if name == "LearnableBlur":
        logits = rng.randn(n, 3).astype(np.float32)
        jm, pm = j_cal.LearnableBlur(n_cameras=n), calibration.LearnableBlur(n)
        pm.load_state_dict({"weights": _t(logits)})
        return (lambda x: jm.apply({"params": {"weights": logits}}, x, cam)), (lambda x: pm(x, tcam))
    assert name == "CameraPixelBias"  # its input is the bias: the image is the bias table
    jm, pm = j_cal.CameraPixelBias(n_cameras=n, height=H * 8, width=W * 8), calibration.CameraPixelBias(n, H * 8, W * 8)

    return ((lambda bias: jm.apply({"params": {"bias": bias}}, cam)),
            (lambda bias: torch.func.functional_call(pm, {"bias": bias}, (tcam,))))


@pytest.mark.parametrize("name", ["blur3", "blur5", "blur7", "CalV3", "CalV5", "LearnableBlur", "CameraPixelBias"])
def test_calibration_module_matches_jax(name):
    rng = np.random.RandomState(0)
    jfn, pfn = _module_case(name, rng)
    x = rng.randn(3, 16, 24, 3 if name != "CameraPixelBias" else 1).astype(np.float32)
    want = jfn(jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = pfn(xt)
    _scaled(_nhwc(got), want, 1e-6, "output")
    cot = rng.randn(*want.shape).astype(np.float32)
    jgrad = jax.grad(lambda v: (jfn(v) * cot).sum())(jnp.asarray(x))
    (got * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    _scaled(_nhwc(xt.grad), jgrad, 1e-6, "input gradient")


def test_calv5_pins_the_identity_camera():
    """The identity camera's rows get a zero gradient (and AdamW leaves
    them); the reg of LearnableBlur is JAX's."""
    m = calibration.CalV5(3)
    img = torch.randn(3, 3, 8, 8)
    (m(img, torch.tensor([0, 1, 0])) ** 2).sum().backward()
    assert not m.weight.grad[0].any() and not m.bias.grad[0].any()
    assert m.weight.grad[1].abs().min() > 0
    logits = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    lb = calibration.LearnableBlur(3)
    lb.load_state_dict({"weights": _t(logits)})
    np.testing.assert_allclose(_np(lb.reg(torch.from_numpy(CAMS))),
                               np.asarray(j_cal.LearnableBlur.reg({"weights": logits}, jnp.asarray(CAMS))),
                               rtol=1e-6)


# --------------------------------------------------------------------- #
# the training forward and one step
# --------------------------------------------------------------------- #


def _fill(path, s, rng):
    name, module = path[-1].key, path[-2].key if len(path) > 1 else ""
    if name == "v":
        return rng.randn(*s.shape).astype(np.float32)
    if name == "g" or (module == "cal" and name == "weight"):
        return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
    if module == "learn_blur":
        return rng.randn(*s.shape).astype(np.float32)
    return (0.1 * rng.randn(*s.shape)).astype(np.float32)


@flax.struct.dataclass
class _Grab:
    """A stand-in train state: the JAX step hands it the gradients."""

    params: Any
    step: Any

    def apply_gradients(self, grads):
        return self.replace(params=grads)


def _batch(assets, rng):
    """A frame batch whose geometry is the template posed with a random
    offset: the posed template alone would unpose to rounding noise, the
    body encoder's input."""
    motion = (rng.randn(B, 104) * 0.1).astype(np.float32)
    offset = (0.02 * rng.randn(*assets.lbs.template_verts.shape)).astype(np.float32)
    with torch.no_grad():
        geom = assets.lbs.pose(torch.from_numpy(offset), torch.from_numpy(motion)).numpy()
    return {
        "motion": motion,
        "geom": geom,
        "face_embs": rng.randn(B, 16).astype(np.float32),
        "ao": rng.rand(B, 32, 32, 1).astype(np.float32),
        "campos": np.tile(CAMPOS, (B, 1)),
        "K": np.tile(K, (B, 1, 1)),
        "Rt": np.tile(RT, (B, 1, 1)),
        "image": (rng.rand(B, 48, 32, 3) * 100).astype(np.float32),
        "cam_idx": np.array([0, 2], np.int32),  # the identity camera among them
    }


def _port_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out["ao"] = out["ao"].permute(0, 3, 1, 2)
    out["cam_idx"] = out["cam_idx"].long()
    return out


def _inject_noise(monkeypatch, key):
    """The port's posterior draws answered by JAX's for ``key``."""
    drawn = []

    def draw(shape, generator, device):
        drawn.append(tuple(shape))
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))  # a copy: JAX owns its buffer

    monkeypatch.setattr(mesh_vae, "draw_posterior_noise", draw)
    return drawn


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JRendererConfig(**TINY), RendererConfig(**TINY)
    ja = j_make_assets(jcfg)
    jm = JAvatar(jcfg, ja)
    rng = np.random.RandomState(0)
    batch = _batch(make_synthetic_assets(cfg), rng)  # the JAX package's assets for the same seed
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch["motion"], batch["campos"], geom=batch["geom"], face_embs=batch["face_embs"],
        K=batch["K"], Rt=batch["Rt"], ao=batch["ao"], training=True, cam_idx=batch["cam_idx"]))
    params = jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params, batch=batch)


def _port_model(s):
    pm = BodyAvatar(s["cfg"], make_synthetic_assets(s["cfg"]))
    pm.load_state_dict(convert.body_avatar_state_dict_from_jax(s["params"], s["cfg"]), strict=True)
    return pm


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's step (gradients, loss parts, params after AdamW) and its
    training forward under the step's noise key."""
    s, b = setup, setup["batch"]
    rng = jax.random.PRNGKey(7)
    k_noise = jax.random.fold_in(jax.random.fold_in(rng, 0), 1)  # make_avatar_train_step's key at step 0
    fn = j_loops.make_avatar_train_step(s["jm"])

    @jax.jit  # one compile for both
    def run(p, bb):
        preds = s["jm"].apply(p, bb["motion"], bb["campos"], geom=bb["geom"], face_embs=bb["face_embs"],
                              K=bb["K"], Rt=bb["Rt"], ao=bb["ao"], training=True, cam_idx=bb["cam_idx"],
                              noise_key=k_noise)
        return fn(_Grab(p, jnp.zeros((), jnp.int32)), bb, rng), preds

    (grab, metrics), preds = run(s["params"], b)
    after = jax.jit(lambda p, g: j_state.create_train_state(p, j_config.TrainConfig(lr=LR)).apply_gradients(g).params)
    return dict(k_noise=k_noise, grads=grab.params, metrics={k: float(v) for k, v in metrics.items()},
                preds=preds, after=after(s["params"], grab.params))


def test_training_forward_matches_jax(setup, jax_step, monkeypatch):
    drawn = _inject_noise(monkeypatch, jax_step["k_noise"])
    pb = _port_batch(setup["batch"])
    with torch.no_grad():
        got = _port_model(setup)(pb["motion"], pb["campos"], geom=pb["geom"], face_embs=pb["face_embs"],
                                 K=pb["K"], Rt=pb["Rt"], ao=pb["ao"], cam_idx=pb["cam_idx"], training=True,
                                 posterior_noise=True)
    assert drawn == [(B, 16), (B, 16)]  # body, then face: two draws
    want = jax_step["preds"]
    cov = got["pix_to_face"].numpy() >= 0
    np.testing.assert_array_equal(cov, np.asarray(want["pix_to_face"]) >= 0)
    assert 0.05 < cov.mean() < 0.9
    for k in FORWARD_KEYS:
        _scaled(got[k] if k == "rgb" else _nhwc(got[k]), want[k], 2e-5, k)  # rgb is [B, H, W, 3]
    assert not np.allclose(_np(got["embs"]), _np(got["embs_mu"]))  # the noise was applied


def test_decode_frame_with_the_ao_shadow_matches_jax(setup):
    """The inference half driven by the AO map (``use_pose_shadow=False``,
    the training forward's own path)."""
    s, b = setup, setup["batch"]
    want = jax.jit(lambda p: s["jm"].apply(p, b["motion"], geom=b["geom"], face_embs=b["face_embs"], ao=b["ao"],
                                           use_pose_shadow=False, method=JAvatar.decode_frame))(s["params"])
    pb = _port_batch(b)
    with torch.no_grad():
        got = _port_model(s).decode_frame(pb["motion"], pb["geom"], pb["face_embs"], use_pose_shadow=False,
                                          ao=pb["ao"])
    for k in ("shadow_map", "shadow_seamed", "geom", "tex_mean_rec"):
        _scaled(_nhwc(got[k]), want[k], 2e-5, k)


@pytest.fixture(scope="module")
def port_step(setup, jax_step):
    mp = pytest.MonkeyPatch()
    try:
        _inject_noise(mp, jax_step["k_noise"])
        model = _port_model(setup)
        state = TrainState(model, TrainConfig(lr=LR))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = avatar_train_step(state, _port_batch(setup["batch"]))
    finally:
        mp.undo()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in model.named_parameters()}
    return dict(model=model, state=state, metrics=metrics, grads=grads, before=before)


def test_avatar_step_losses_match_jax(jax_step, port_step):
    got, want = port_step["metrics"], jax_step["metrics"]
    assert got["skipped_nonfinite"] == 0.0
    for k in ("loss", "grad_norm", *LOSS_PARTS):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert want["loss_rgb"] > 1.0 and want["loss_kl"] > 0 and want["loss_shadow"] > 0


def test_avatar_step_gradients_match_jax(setup, jax_step, port_step):
    want = convert.body_avatar_state_dict_from_jax(jax_step["grads"], setup["cfg"])
    got = port_step["grads"]
    assert set(got) == set(want)
    for n in sorted(want):
        w = want[n].numpy()
        err = float(np.abs(got[n].numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), f"{n}: {err} vs largest {np.abs(w).max()}"
    assert not got["decoder_face.encmod.0.weight_v"].any()  # the frozen face decoder
    assert got["cal.weight"][2].abs().min() > 0 and got["learn_blur.weights"].abs().max() > 0


def test_avatar_step_params_after_adamw_match_jax(setup, jax_step, port_step):
    want = convert.body_avatar_state_dict_from_jax(jax_step["after"], setup["cfg"])
    model = port_step["model"]
    moved = 0
    for n, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want[n].numpy())
        assert d.max() <= 2 * LR, f"{n}: {d.max()}"
        moved += int((d > 1e-6).sum())
    assert moved <= 1e-3 * sum(p.numel() for p in model.parameters())


def test_avatar_step_leaves_the_identity_camera(port_step):
    model, before = port_step["model"], port_step["before"]
    for n in ("cal.weight", "cal.bias"):
        assert torch.equal(getattr(model.cal, n.split(".")[1])[0], before[n][0]), n
        assert not torch.equal(getattr(model.cal, n.split(".")[1])[2], before[n][2]), n


def test_nonfinite_image_leaves_the_state(setup, monkeypatch):
    model = _port_model(setup)
    state = TrainState(model, TrainConfig(lr=LR))
    batch = _port_batch(setup["batch"])
    batch["image"][0, 0, 0, 0] = float("nan")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = avatar_train_step(state, batch, torch.Generator().manual_seed(0))
    assert metrics["skipped_nonfinite"] == 1.0 and not np.isfinite(metrics["loss"])
    assert state.step == 0 and not state.optimizer.state
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #


def _write_frames(data_dir, cfg, assets, n_files=2, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    for i in range(n_files):
        motion = (rng.randn(B, 104) * 0.1).astype(np.float32)
        with torch.no_grad():
            geom = assets.lbs.pose(None, torch.from_numpy(motion)).numpy()
        np.savez(os.path.join(data_dir, f"batch_{i:03d}.npz"), motion=motion, geom=geom,
                 face_embs=rng.randn(B, cfg.n_face_embs).astype(np.float32),
                 ao=rng.rand(B, cfg.shadow_size, cfg.shadow_size, 1).astype(np.float32),
                 campos=np.tile(CAMPOS, (B, 1)), K=np.tile(K, (B, 1, 1)), Rt=np.tile(RT, (B, 1, 1)),
                 image=(rng.rand(B, cfg.image_height, cfg.image_width, 3) * 100).astype(np.float32),
                 cam_idx=np.array([i, i + 1], np.int32) % max(cfg.n_cameras, 1))


def _bundle(path, cfg, seed=0):
    assets = make_synthetic_assets(cfg)
    model = BodyAvatar(cfg, assets)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    inference = {k: v for k, v in model.state_dict().items() if k.split(".")[0] not in BodyAvatar.CALIBRATION}
    cams = {"cam0": Camera(campos=CAMPOS, K=K, Rt=RT)}
    return save_renderer_bundle(path, cfg, inference, cams), assets


def _render(bundle):
    rng = np.random.RandomState(5)
    r = load_body_renderer(bundle, frame_batch=1, device="cpu")
    return r.render_sequence_multicam((rng.randn(1, 104) * 0.1).astype(np.float32),
                                      (rng.randn(1, 16) * 0.1).astype(np.float32))


def test_train_avatar_resumes_and_the_bundle_renders_the_trained_weights(tmp_path):
    cfg = RendererConfig(**TINY)
    bundle, assets = _bundle(str(tmp_path / "renderer"), cfg)
    data = str(tmp_path / "frames")
    _write_frames(data, cfg, assets)
    untrained = _render(bundle)
    timings = {}
    state = train_avatar.train(bundle, data, num_steps=2, lr=LR, save_interval=1, device="cpu", timings=timings)
    assert state.step == 2 and len(timings["step_s"]) == 2
    two = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = train_avatar.train(bundle, data, num_steps=3, lr=LR, save_interval=1, device="cpu")
    assert state.step == 3
    assert sorted(os.listdir(os.path.join(bundle, "ckpt"))) == [f"step_{s:08d}.pt" for s in (1, 2, 3)]
    with open(os.path.join(bundle, "train_log", "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1, 2] and all(np.isfinite(r["loss"]) for r in rows)
    saved = torch.load(os.path.join(bundle, "model.pt"), weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in state.model.state_dict().items())
    assert any(not torch.equal(saved[k], two[k]) for k in two)  # the resumed step moved it
    assert not torch.equal(saved["cal.weight"], torch.ones_like(saved["cal.weight"]))
    trained = _render(bundle)
    assert trained.shape == untrained.shape == (1, 48, 32, 3)
    assert not np.array_equal(trained, untrained)


def test_train_avatar_refuses_an_inference_only_bundle(tmp_path):
    cfg = RendererConfig(**dict(TINY, n_cameras=0))
    bundle, assets = _bundle(str(tmp_path / "renderer"), cfg)
    _write_frames(str(tmp_path / "frames"), cfg, assets, n_files=1)
    with pytest.raises(SystemExit, match="n_cameras=0"):
        train_avatar.train(bundle, str(tmp_path / "frames"), num_steps=1, device="cpu")
