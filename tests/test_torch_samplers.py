"""The samplers, the guidance helpers, ``timestep_embedding`` and the color
and geometry helpers of the port against the JAX package's, on the CPU.

The samplers run a fixed toy model, out = tanh(x W + t / 1000), written in
both frameworks, on the same x_T; the ancestral sampler draws JAX's step
noise (``sampling.draw_step_noise`` answered with JAX's ``jax.random.normal``
under the keys its scan splits).  Tolerances, of the output's scale: the
sampling loops 1e-4, the repo's bar for sampled slices (PLMS at order 4
weighs eps by up to 59/24 a step: f32 rounding in another order reaches
2.4e-5 after 10 steps); single steps and helpers 1e-5 or tighter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.diffusion import gaussian as j_gaussian
from audio2photoreal_tpu.diffusion import respace as j_respace
from audio2photoreal_tpu.diffusion import sampling as j_sampling
from audio2photoreal_tpu.ops import embeddings as j_embeddings
from audio2photoreal_tpu.render import color as j_color
from audio2photoreal_tpu.render import geometry as j_geometry
from audio2photoreal_tpu_torch.diffusion import gaussian, respace, sampling
from audio2photoreal_tpu_torch.ops import embeddings
from audio2photoreal_tpu_torch.render import color, geometry
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

B, T, C = 2, 6, 5
REL = 1e-5
LOOP_REL = 1e-4
W = np.random.RandomState(0).randn(C, C).astype(np.float32) * 0.5


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())), rtol=0)


def _j_model(x, t):
    return jnp.tanh(x @ jnp.asarray(W) + t.astype(jnp.float32)[:, None, None] / 1000.0)


def _p_model(x, t):
    return torch.tanh(x @ torch.from_numpy(W) + t.to(torch.float32)[:, None, None] / 1000.0)


def _x_T(seed=1):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _scheds(spacing):
    return j_respace.maybe_respaced("cosine", 1000, spacing), respace.maybe_respaced("cosine", 1000, spacing)


@pytest.mark.parametrize("predict", ["xstart", "eps"])
def test_ddim_reverse_step_matches_jax(predict):
    js, ps = _scheds("ddim10")
    x = _x_T()
    t = np.array([0, 7])
    out = np.random.RandomState(2).randn(B, T, C).astype(np.float32)
    want = j_sampling.ddim_reverse_step(js, predict, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
    got = sampling.ddim_reverse_step(ps.to_device("cpu"), predict, torch.from_numpy(out), torch.from_numpy(x),
                                     torch.from_numpy(t))
    _close(got, want)


@pytest.mark.parametrize("var_type", ["fixed_small", "fixed_large"])
def test_p_sample_loop_matches_jax_with_its_noise(var_type, monkeypatch):
    js, ps = _scheds("10")
    x_T, key = _x_T(), jax.random.PRNGKey(3)
    want = j_sampling.p_sample_loop(js, "xstart", var_type, _j_model, jnp.asarray(x_T), key)
    noise, k = [], key
    for _ in range(js.num_timesteps - 1):  # the scan's draws; its last (t = 0) is multiplied by 0
        k, sub = jax.random.split(k)
        noise.append(np.array(jax.random.normal(sub, x_T.shape, jnp.float32)))
    it = iter(noise)
    monkeypatch.setattr(sampling, "draw_step_noise", lambda shape, g, device: torch.from_numpy(next(it)))
    got = sampling.p_sample_loop(ps, "xstart", var_type, _p_model, torch.from_numpy(x_T))
    assert next(it, None) is None
    _close(got.sample, want.sample, LOOP_REL)
    _close(got.pred_xstart, want.pred_xstart, LOOP_REL)


@pytest.mark.parametrize("steps,order", [(2, 2), (10, 1), (10, 2), (10, 3), (10, 4)])
def test_plms_sample_loop_matches_jax(steps, order):
    """2 steps (the warm-up step, then one Adams-Bashforth step; neither
    package builds a 1-step schedule) and 10 at each order."""
    js, ps = _scheds(str(steps))
    x_T = _x_T(4)
    want = j_sampling.plms_sample_loop(js, "xstart", _j_model, jnp.asarray(x_T), order=order)
    got = sampling.plms_sample_loop(ps, "xstart", _p_model, torch.from_numpy(x_T), order=order)
    _close(got.sample, want.sample, LOOP_REL)
    _close(got.pred_xstart, want.pred_xstart, LOOP_REL)


def test_samplers_registry():
    assert sorted(sampling.SAMPLERS) == sorted(j_sampling.SAMPLERS)
    assert sampling.SAMPLERS["ancestral"] is sampling.p_sample_loop
    with pytest.raises(ValueError, match="order"):
        sampling.plms_sample_loop(_scheds("10")[1], "xstart", _p_model, torch.zeros(B, T, C), order=5)


def test_condition_mean_and_score_match_jax():
    js, ps = _scheds("ddim10")
    rng = np.random.RandomState(5)
    mean, var, grad, x, x0 = (rng.randn(B, T, C).astype(np.float32) for _ in range(5))
    t = np.array([1, 9])
    _close(gaussian.condition_mean(*map(torch.from_numpy, (mean, var, grad))),
           j_gaussian.condition_mean(*map(jnp.asarray, (mean, var, grad))))
    _close(gaussian.condition_score(ps.to_device("cpu"), *map(torch.from_numpy, (x, t, x0, grad))),
           j_gaussian.condition_score(js, *map(jnp.asarray, (x, t, x0, grad))))


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 3, 250, 999])
    _close(embeddings.timestep_embedding(torch.from_numpy(t), dim),
           j_embeddings.timestep_embedding(jnp.asarray(t), dim), rel=1e-6)


# ------------------------------------------------------------ helpers -- #


def test_color_helpers_match_jax():
    rng = np.random.RandomState(6)
    img = rng.rand(2, 8, 9, 3).astype(np.float32)
    chw = img.transpose(0, 3, 1, 2).copy()
    u8 = (rng.rand(2, 8, 9, 3) * 256).astype(np.uint8)
    u8[0, 0, 0] = 255
    cases = [
        ("linear2color_corr", (img,), {}), ("linear2color_corr", (chw,), {"dim": 1}),
        ("linear2color_corr_inv", (img,), {}), ("srgb2linear", (img,), {}),
        ("mapped2linear", (img,), {"dc_offset": (0.01, 0.02, 0.0), "gamma": 2.2,
                                   "ccm": ((0.9, 0.1, 0), (0, 1, 0), (0.05, 0, 0.95))}),
        ("mapped2linear", (u8,), {}), ("mapped2linear", (chw,), {"dim": 1}), ("mapped2srgb", (img,), {}),
        ("scale_diff_image", (img - 0.5,), {}), ("scale_diff_image", ((img - 0.5) * 300,), {}),
        ("smoothstep", (0.2, 0.7, img), {}), ("smootherstep", (0.2, 0.7, img), {}),
    ]
    for name, args, kw in cases:
        want = getattr(j_color, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
        got = getattr(color, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
        _close(got, want, rel=1e-6)


@pytest.mark.parametrize("shape", [(2, 12, 11), (2, 12, 11, 1)])
@pytest.mark.parametrize("dtype", [np.bool_, np.float32, np.int32])
def test_dilate_and_erode_match_jax(shape, dtype):
    x = (np.random.RandomState(7).rand(*shape) > 0.7).astype(dtype)
    for name in ("dilate", "erode"):
        want = np.asarray(getattr(j_color, name)(jnp.asarray(x), 3))
        got = getattr(color, name)(torch.from_numpy(x), 3).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_geometry_helpers_match_jax():
    rng = np.random.RandomState(8)
    verts = rng.randn(2, 10, 3).astype(np.float32)
    faces = rng.randint(0, 10, (7, 3))
    for normalize in (True, False):
        _close(geometry.face_normals(torch.from_numpy(verts), torch.from_numpy(faces), normalize),
               j_geometry.face_normals(jnp.asarray(verts), jnp.asarray(faces), normalize), rel=1e-6)
    p = (rng.randn(2, 9, 3) + [0, 0, 4]).astype(np.float32)
    Rt = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1)), rng.randn(2, 3, 3, 1).astype(np.float32)
                         * 0.1], -1)
    K = np.tile(np.array([[50.0, 0, 16], [0, 60.0, 12], [0, 0, 1]], np.float32), (2, 3, 1, 1))
    for normalize in (False, True):
        got = geometry.project_points_multi(*map(torch.from_numpy, (p, Rt, K)), normalize=normalize, size=(24, 32))
        want = j_geometry.project_points_multi(*map(jnp.asarray, (p, Rt, K)), normalize=normalize, size=(24, 32))
        for g, w in zip(got, want):
            _close(g, w, rel=1e-6)
    depth = (rng.rand(2, 6, 7) + 1.0).astype(np.float32)
    focal = np.tile(np.diag([30.0, 32.0]).astype(np.float32), (2, 1, 1))
    princpt = np.array([[3.0, 2.5], [3.5, 3.0]], np.float32)
    args_t, args_j = map(torch.from_numpy, (depth, focal, princpt)), list(map(jnp.asarray, (depth, focal, princpt)))
    args_t = list(args_t)
    _close(geometry.depth2xyz(*args_t), j_geometry.depth2xyz(*args_j), rel=1e-6)
    _close(geometry.depth2normals(*args_t), j_geometry.depth2normals(*args_j), rel=1e-5)
    xyz = rng.randn(2, 5, 6, 3).astype(np.float32)
    _close(geometry.xyz2normals(torch.from_numpy(xyz)), j_geometry.xyz2normals(jnp.asarray(xyz)), rel=1e-5)
