"""The port's attention kernel wrapper (kernels/flash_attn.py) against the JAX
Pallas kernel (ops/pallas/flash.py), which runs in interpret mode on the CPU.

On the CPU the wrapper takes its plain PyTorch version; the CUDA kernel itself
is checked on the card by tests/test_torch_cuda.py and by chip_smoke.py.  Inputs are made with numpy and fed to both sides;
f32 tolerance 2e-5.  Fully masked query rows are not compared: the Pallas
kernel's 128-key padding carries -1e9 too, so such rows average over padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.ops.pallas.flash import flash_attention as jax_flash
from audio2photoreal_tpu_torch.kernels import build, flash_attn, launch_counts
from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_reference


def _qkv(B=2, H=2, Tq=13, Tk=37, Dh=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, Dh).astype(np.float32) for T in (Tq, Tk, Tk)]


def _both(q, k, v, kv_valid=None, causal=False):
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                     kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
                     causal=causal, block_q=8, interpret=True)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid),
                          causal=causal)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("Tq,Tk,Dh", [(13, 37, 16), (24, 24, 64), (5, 130, 8)])
def test_unmasked_matches_pallas(Tq, Tk, Dh):
    got, want = _both(*_qkv(Tq=Tq, Tk=Tk, Dh=Dh, seed=Tq))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_kv_valid_matches_pallas():
    q, k, v = _qkv(Tk=40, seed=1)
    kv_valid = (np.arange(40)[None] < np.array([[17], [40]])).astype(np.float32)
    got, want = _both(q, k, v, kv_valid)
    np.testing.assert_allclose(got, want, atol=2e-5)
    # masked keys must not leak
    k[0, :, 17:], v[0, :, 17:] = 123.0, -55.0
    got2, _ = _both(q, k, v, kv_valid)
    np.testing.assert_allclose(got2, got, atol=2e-5)


@pytest.mark.parametrize("Tq,Tk", [(12, 30), (24, 24)])
def test_causal_matches_pallas(Tq, Tk):
    got, want = _both(*_qkv(Tq=Tq, Tk=Tk, seed=3), causal=True)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_kv_valid_and_causal_matches_pallas():
    q, k, v = _qkv(Tq=11, Tk=29, seed=4)
    # causal offset 18: row 0 sees keys 0..18, all valid in both batch rows
    kv_valid = (np.arange(29)[None] < np.array([[21], [29]])).astype(np.float32)
    got, want = _both(q, k, v, kv_valid, causal=True)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_cpu_path_launches_no_kernel():
    launch_counts.clear()
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    out = flash_attention(q, k, v, causal=True)
    assert launch_counts[flash_attn.NAME] == 0
    torch.testing.assert_close(out, flash_attention_reference(q, k, v, causal=True), rtol=0, atol=0)


def test_bf16_cpu_path_keeps_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(Tq=16, Tk=32))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = flash_attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_valid=torch.ones(2, 5))
    with pytest.raises(ValueError):  # no kernel and no plain fallback off the CPU
        flash_attention(*(x.to("meta") for x in (q, k, v)))


def test_library_path_follows_the_sources(tmp_path, monkeypatch):
    a = build.library_path(flash_attn.NAME, flash_attn.SOURCES)
    assert a.parent == build.BUILD_DIR and a.name.startswith(f"lib{flash_attn.NAME}-")
    src = tmp_path / "flash_attn_fwd.cu"
    src.write_bytes((build.CSRC / "flash_attn_fwd.cu").read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path(flash_attn.NAME, flash_attn.SOURCES) != a

