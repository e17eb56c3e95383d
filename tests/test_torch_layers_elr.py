"""The ELR layer family, port vs JAX package, on the CPU:
``gaussian_kernel``, ``LinearELR``, ``Conv2dELR`` (plain, untied bias,
grouped, box-filtered, transposed, transposed with output padding and the
box filter), ``blur_downsample`` and ``concat_pyramid``.

Inputs are made with numpy from a seed; JAX parameters come from
``jax.eval_shape`` of the module's init filled with numpy draws and reach
the port through ``convert``.  The JAX modules are NHWC, the port's NCHW:
inputs go in transposed and outputs come back transposed.  Bars: 1e-6 for
the Gaussian kernel, 2e-5 of the output's largest magnitude for the rest.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio2photoreal_tpu.render import layers_elr as j_elr
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.render import layers_elr
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

TOL = 2e-5


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _fill(shapes, seed):
    """Weights N(0, 1) (the layers scale them at run time), biases N(0, 0.3)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.randn(*s.shape) * (1.0 if p[-1].key == "weight" else 0.3)).astype(np.float32), shapes)


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("ksize,std", [(3, None), (5, None), (7, None), (7, 1.5), (1, 1.0)])
def test_gaussian_kernel_matches_jax(ksize, std):
    got, want = layers_elr.gaussian_kernel(ksize, std), j_elr.gaussian_kernel(ksize, std)
    assert got.dtype == np.float32 and got.shape == (ksize, ksize)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-6


LINEAR_CASES = {
    "default": dict(),
    "gain_lr": dict(gain=1.3, lr_mul=0.5),
    "bias_lr": dict(lr_mul=0.7, bias_lr_mul=2.0),
    "no_bias": dict(use_bias=False, lr_mul=0.3),
}


@pytest.mark.parametrize("case", list(LINEAR_CASES))
def test_linear_elr_matches_jax(case):
    kw = LINEAR_CASES[case]
    jm = j_elr.LinearELR(7, **kw)
    x = np.random.RandomState(1).randn(4, 3, 12).astype(np.float32)
    params = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 2)
    pkw = {k: v for k, v in kw.items() if k != "use_bias"}
    pm = layers_elr.LinearELR(12, 7, bias=kw.get("use_bias", True), **pkw)
    pm.load_state_dict(convert.linear_elr_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, jm.apply(params, jnp.asarray(x)), what=case)


# (Cin, H, W, Conv2dELR keywords) per case
CONV_CASES = {
    "plain": (6, 10, 10, dict(features=8, kernel_size=3, padding=1, lr_mul=0.7)),
    "strided": (6, 11, 9, dict(features=8, kernel_size=3, stride=2, padding=1, gain=1.0)),
    "untied": (6, 10, 10, dict(features=8, kernel_size=3, padding=1, untied=True, height=10, width=10,
                               lr_mul=0.7, bias_lr_mul=1.5)),
    "grouped": (6, 9, 9, dict(features=4, kernel_size=3, padding=1, groups=2)),
    "box": (6, 10, 10, dict(features=8, kernel_size=3, padding=1, fuse_box_filter=True)),
    "box_strided": (6, 12, 12, dict(features=8, kernel_size=3, stride=2, padding=1, fuse_box_filter=True)),
    "no_bias": (6, 8, 8, dict(features=5, kernel_size=1, use_bias=False)),
    "transposed": (6, 8, 8, dict(features=8, kernel_size=4, stride=2, padding=1, transpose=True)),
    "transposed_untied": (6, 8, 8, dict(features=8, kernel_size=4, stride=2, padding=1, transpose=True,
                                        untied=True, height=16, width=16)),
    "transposed_op_box": (6, 7, 7, dict(features=8, kernel_size=3, stride=2, padding=1, output_padding=1,
                                        transpose=True, fuse_box_filter=True)),
}


def _port_conv(cin, kw):
    pkw = {k: v for k, v in kw.items() if k not in ("features", "use_bias")}
    return layers_elr.Conv2dELR(cin, kw["features"], bias=kw.get("use_bias", True), **pkw)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_elr_matches_jax(case):
    cin, H, W, kw = CONV_CASES[case]
    jm = j_elr.Conv2dELR(**kw)
    x = np.random.RandomState(3).randn(2, cin, H, W).astype(np.float32)
    params = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), _nhwc(x))), 4)
    pm = _port_conv(cin, kw)
    pm.load_state_dict(convert.conv2d_elr_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    want = _nchw(jm.apply(params, _nhwc(x)))
    _close(got, want, what=case)
    if kw.get("transpose"):  # torch's conv_transpose2d size, with the box filter's extra tap
        k = kw["kernel_size"] + kw.get("fuse_box_filter", False)
        assert got.shape[-1] == (W - 1) * kw["stride"] - 2 * kw["padding"] + k + kw.get("output_padding", 0)


def test_conv2d_elr_reset_parameters():
    pm = layers_elr.Conv2dELR(8, 16, 3, untied=True, height=4, width=4, lr_mul=0.5)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    assert pm.bias.shape == (16, 4, 4) and not pm.bias.any()
    assert abs(float(pm.weight.detach().std()) - 2.0) < 0.15  # N(0, 1 / lr_mul^2)
    t = layers_elr.Conv2dELR(8, 6, 4, stride=2, padding=1, groups=2, transpose=True)
    assert t.weight.shape == (8, 3, 4, 4)
    assert t(torch.zeros(1, 8, 5, 5)).shape == (1, 6, 10, 10)


@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero", "refl", "repl"])
@pytest.mark.parametrize("filt_size,stride,pad_off", [(3, 2, 0), (4, 2, 0), (5, 2, 1), (2, 1, 0), (1, 2, 0),
                                                     (1, 3, 1)])
def test_blur_downsample_matches_jax(pad_type, filt_size, stride, pad_off):
    x = np.random.RandomState(filt_size).randn(2, 5, 13, 12).astype(np.float32)
    want = _nchw(j_elr.blur_downsample(_nhwc(x), filt_size, stride, pad_type, pad_off))
    got = layers_elr.blur_downsample(torch.from_numpy(x), filt_size, stride, pad_type, pad_off)
    _close(got, want, what=f"{pad_type} {filt_size} {stride} {pad_off}")


# concat_pyramid: an upsampling branch of three layers.  Each layer is an
# ELR conv's keywords (UP doubles the size, SAME keeps it) or None for a leaky
# ReLU.  A conv's input channels are its predecessor's output plus y's
# channels where a pyramid level is concatenated.
UP = dict(kernel_size=4, stride=2, padding=1, transpose=True)
SAME = dict(kernel_size=3, padding=1)
PYRAMID_CASES = {  # (every_other, transposed): (x's size, the three layers' convs or None for the act)
    (True, True): (4, [UP, None, UP]),
    (True, False): (8, [UP, None, SAME]),
    (False, True): (2, [UP, UP, UP]),
    (False, False): (4, [UP, UP, SAME]),
}
CX, CY, FEAT, YSIZE = 4, 2, 6, 16


def _act_j(h):
    return fnn.leaky_relu(h, negative_slope=0.2)


class _Branch(fnn.Module):
    every_other: bool
    transposed: bool
    convs: tuple

    @fnn.compact
    def __call__(self, x, y):
        layers = []
        for i, kw in enumerate(self.convs):
            if kw is None:
                layers.append(_act_j)
                continue
            conv = j_elr.Conv2dELR(FEAT, name=f"c{i}", **kw)
            last = i == len(self.convs) - 1
            layers.append(conv if last or self.every_other else (lambda h, c=conv: _act_j(c(h))))
        return j_elr.concat_pyramid(layers, x, y, every_other=self.every_other, transposed=self.transposed)


@pytest.mark.parametrize("every_other,transposed", list(PYRAMID_CASES), ids=lambda v: str(v))
def test_concat_pyramid_matches_jax(every_other, transposed):
    size, convs = PYRAMID_CASES[every_other, transposed]
    rng = np.random.RandomState(5)
    x = rng.randn(2, CX, size, size).astype(np.float32)
    y = rng.randn(2, CY, YSIZE, YSIZE).astype(np.float32)
    jm = _Branch(every_other, transposed, tuple(convs))
    params = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), _nhwc(x), _nhwc(y))), 6)
    want = _nchw(jm.apply(params, _nhwc(x), _nhwc(y)))
    layers, cin = [], CX
    for i, kw in enumerate(convs):
        if kw is None:
            layers.append(lambda h: F.leaky_relu(h, 0.2))
            continue
        concat = every_other is False or i % 2 == 0
        conv = layers_elr.Conv2dELR(cin + CY * concat, FEAT, **kw)
        conv.load_state_dict(convert.conv2d_elr_state_dict_from_jax(params["params"][f"c{i}"]), strict=True)
        last = i == len(convs) - 1
        layers.append(conv if last or every_other else (lambda h, c=conv: F.leaky_relu(c(h), 0.2)))
        cin = FEAT
    with torch.no_grad():
        got = layers_elr.concat_pyramid(layers, torch.from_numpy(x), torch.from_numpy(y), every_other=every_other,
                                        transposed=transposed)
    assert got.shape == (2, FEAT, YSIZE, YSIZE)
    _close(got, want, what=f"every_other={every_other} transposed={transposed}")


def test_concat_pyramid_levels_with_kstd():
    """The pyramid's levels themselves (identity layers record them): a 5-tap
    kernel with its own std, every layer concatenating."""
    y = np.random.RandomState(7).randn(1, 3, 16, 16).astype(np.float32)
    seen_p, seen_j = [], []

    def rec_p(h):  # records the level, hands on an empty map of the next level's size
        seen_p.append(h[:, -3:].clone())
        return h.new_zeros(h.shape[0], 0, 2 * h.shape[2], 2 * h.shape[3])

    def rec_j(h):
        seen_j.append(np.asarray(h[..., -3:]))
        return jnp.zeros((h.shape[0], 2 * h.shape[1], 2 * h.shape[2], 0))

    x = np.zeros((1, 0, 4, 4), np.float32)
    layers_elr.concat_pyramid([rec_p] * 3, torch.from_numpy(x), torch.from_numpy(y), every_other=False, ksize=5,
                              kstd=0.8, transposed=False)
    j_elr.concat_pyramid([rec_j] * 3, _nhwc(x), _nhwc(y), every_other=False, ksize=5, kstd=0.8, transposed=False)
    assert [tuple(s.shape[-2:]) for s in seen_p] == [(4, 4), (8, 8), (16, 16)]
    for got, want in zip(seen_p, seen_j):
        _close(got, _nchw(want), what="pyramid level")
