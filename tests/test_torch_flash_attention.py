"""The port's attention wrappers (kernels/flash_attn.py) against the JAX
Pallas kernels (ops/pallas/flash.py), which run in interpret mode on the CPU.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
themselves are checked on the card by tests/test_torch_cuda.py and by
chip_smoke.py.  Inputs are made with numpy and fed to both sides; f32
tolerance 2e-5 without dropout.  With the replayed hash dropout the bar is
the JAX package's own for its kernels against an explicit-mask oracle
(tests/test_flash_attention.py:121-163): 3e-5 on outputs, 5e-5 on gradients.
The dropout mask itself must agree bit for bit.  Fully masked query rows are
not compared: the Pallas kernel's 128-key padding carries -1e9 too, so such
rows average over padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.ops.pallas.flash import flash_attention as jax_flash
from audio2photoreal_tpu_torch.kernels import build, flash_attn, launch_counts
from audio2photoreal_tpu_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)


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
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attention(q, k, v, dropout_rate=1.0)
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



# ------------------------------------------------ the replayed dropout -- #


@pytest.mark.parametrize("seed", [0, 23, 2**31 - 2, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("block", [0, 7, 2**31, 2**32 - 3])
def test_hash_mask_matches_jax_bit_for_bit(seed, block):
    """Seeds past int32 and block ids that wrap the uint32 sums; three rates
    read the bits at three thresholds."""
    rows, cols = torch.arange(40)[:, None], torch.arange(300)[None]
    for rate in (0.1, 0.5, 0.9):
        want = np.asarray(j_flash.hash_mask_mult(jnp.uint32(seed), jnp.uint32(block), (40, 300), rate))
        got = flash_attn.hash_mask_mult(seed, block, rows, cols, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_resolve_block_q_matches_jax():
    shapes = [(600, 600), (600, 2000), (128, 130), (160, 2000), (2000, 2000), (13, 37), (1, 1), (599, 2001),
              (300, 8000), (1998, 1998)]
    got = {s: flash_attn.resolve_block_q(*s) for s in shapes}
    assert got[(600, 600)] == 600 and got[(600, 2000)] == 304
    for (Tq, Tk), bq in got.items():
        assert bq == j_flash._resolve(True, None, Tq, Tk)[1], (Tq, Tk)
    for block_q in (8, 16, 100, 1024):
        assert flash_attn.resolve_block_q(77, 203, block_q) == j_flash._resolve(True, block_q, 77, 203)[1]


DROP_CASES = [  # (Tq, Tk, kv_valid lengths, causal, block_q): nj >= 2 in all but the auto case
    (40, 150, (120, 150), False, None),
    (40, 150, (150, 150), True, 16),
    (24, 200, (170, 200), True, 8),
]


@pytest.mark.parametrize("Tq,Tk,lengths,causal,block_q", DROP_CASES)
def test_dropout_forward_and_grads_match_jax_hash_kernel(Tq, Tk, lengths, causal, block_q):
    B, H, Dh, rate, seed = 2, 2, 16, 0.3, 77
    q, k, v = _qkv(B, H, Tq, Tk, Dh, seed=Tq + Tk)
    g = np.random.RandomState(1).randn(B, H, Tq, Dh).astype(np.float32)
    kv_valid = (np.arange(Tk)[None] < np.array(lengths)[:, None]).astype(np.float32)
    if block_q is not None:
        assert -(-Tq // flash_attn.resolve_block_q(Tq, Tk, block_q)) >= 2

    def jfn(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(kv_valid), jnp.array([seed], jnp.int32), causal, rate, block_q,
                         True, "hash")

    want, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = flash_attention(qt, kt, vt, torch.from_numpy(kv_valid), causal, rate, seed, block_q)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5)
    for name, a, b in zip("qkv", (qt, kt, vt), want_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=5e-5, err_msg=f"d{name}")


def test_bwd_reference_matches_autograd_of_explicit_mask_attention():
    """The plain backward's formulas against torch autograd of the einsum
    attention with the same explicit mask, within 1e-5 (f32, same products
    in another order)."""
    B, H, Tq, Tk, Dh, rate, seed, block_q = 2, 3, 33, 70, 16, 0.4, 5, 16
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(B, H, Tq, Tk, Dh, seed=2))
    g = torch.from_numpy(np.random.RandomState(3).randn(B, H, Tq, Dh).astype(np.float32))
    kv_valid = torch.from_numpy((np.arange(Tk)[None] < np.array([[60], [70]])).astype(np.float32))
    mask = flash_attn.dropout_mask(B, H, Tq, Tk, rate, seed, block_q)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / Dh**0.5
    logits = logits + torch.where(kv_valid[:, None, None] > 0, 0.0, -1e9)
    logits = torch.where(torch.arange(Tk)[None] <= torch.arange(Tq)[:, None] + Tk - Tq, logits, -1e9)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1) * mask, v)
    out.backward(g)
    got = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), g, kv_valid, True, rate, seed, block_q)
    for name, a, b in zip("qkv", got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=f"d{name}")
    fwd = flash_attention_reference(q.detach(), k.detach(), v.detach(), kv_valid, True, rate, seed, block_q)
    torch.testing.assert_close(fwd, out.detach(), atol=1e-5, rtol=0)


def test_zero_rate_is_no_dropout_and_seed_moves_the_mask():
    q, k, v = (torch.from_numpy(x) for x in _qkv(Tq=20, Tk=50))
    torch.testing.assert_close(flash_attention(q, k, v, None, False, 0.0, 9), flash_attention(q, k, v),
                               atol=0, rtol=0)
    a, b = (flash_attention(q, k, v, None, False, 0.5, s) for s in (1, 2))
    assert not torch.equal(a, b)
    m = flash_attn.dropout_mask(2, 2, 20, 50, 0.5, 1)
    assert abs((m > 0).float().mean().item() - 0.5) < 0.05 and set(m.unique().tolist()) == {0.0, 2.0}


def _emulate_kernels(q, k, v, do, kv_valid, causal, rate, seed, block_q, tile=64):
    """The CUDA kernels' decomposition, in torch: the forward's online
    softmax over 64-key tiles with its log-sum-exp; the backward's delta =
    dO . O, dK/dV per 64-key tile over every 64-row q tile, dQ per q tile
    over every key tile, P recomputed as exp(S - lse) and the mask read per
    element by global row (attn_common.cuh)."""
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    scale = 1.0 / Dh**0.5
    bias = torch.zeros(B, 1, Tq, Tk)
    if kv_valid is not None:
        bias = bias + torch.where(kv_valid[:, None, None] > 0, 0.0, -1e9)
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, k) + bias
    if causal:
        logits = torch.where(torch.arange(Tk)[None] > torch.arange(Tq)[:, None] + Tk - Tq, -1e9, logits)
    mult = flash_attn.dropout_mask(B, H, Tq, Tk, rate, seed, block_q) if rate > 0 else torch.ones(B, H, Tq, Tk)
    m = torch.full((B, H, Tq, 1), -float("inf"))
    l = torch.zeros(B, H, Tq, 1)
    acc = torch.zeros(B, H, Tq, Dh)
    for k0 in range(0, Tk, tile):
        s = logits[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + (p * mult[..., k0:k0 + tile]) @ v[:, :, k0:k0 + tile]
        m = m_new
    out, lse = acc / l, m + torch.log(l)
    delta = (do * out).sum(-1, keepdim=True)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Tk, tile):  # dK/dV kernel: one block per key tile
        ks = slice(k0, k0 + tile)
        for q0 in range(0, Tq, tile):
            qs = slice(q0, q0 + tile)
            p = torch.exp(logits[:, :, qs, ks] - lse[:, :, qs])
            mm = mult[:, :, qs, ks]
            dp = do[:, :, qs] @ v[:, :, ks].transpose(-1, -2)
            ds = p * (dp * mm - delta[:, :, qs])
            dv[:, :, ks] += (p * mm).transpose(-1, -2) @ do[:, :, qs]
            dk[:, :, ks] += ds.transpose(-1, -2) @ (q[:, :, qs] * scale)
    for q0 in range(0, Tq, tile):  # dQ kernel: one block per q tile
        qs = slice(q0, q0 + tile)
        for k0 in range(0, Tk, tile):
            ks = slice(k0, k0 + tile)
            p = torch.exp(logits[:, :, qs, ks] - lse[:, :, qs])
            dp = do[:, :, qs] @ v[:, :, ks].transpose(-1, -2)
            dq[:, :, qs] += (p * (dp * mult[:, :, qs, ks] - delta[:, :, qs])) @ k[:, :, ks]
    return out, dq * scale, dk, dv


@pytest.mark.parametrize("Tq,Tk,causal,rate,block_q", [(150, 200, True, 0.3, 16), (70, 130, False, 0.1, None),
                                                       (64, 64, False, 0.0, None)])
def test_kernel_decomposition_matches_plain(Tq, Tk, causal, rate, block_q):
    """The tiling the CUDA kernels use (ragged tiles, q-block numbering that
    does not follow the 64-row tiles) gives the plain versions' results."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(2, 2, Tq, Tk, 16, seed=4) + [
        np.random.RandomState(6).randn(2, 2, Tq, 16).astype(np.float32)])
    kv_valid = torch.from_numpy((np.arange(Tk)[None] < np.array([[Tk - 30], [Tk]])).astype(np.float32))
    out, *grads = _emulate_kernels(q, k, v, do, kv_valid, causal, rate, 11, block_q)
    torch.testing.assert_close(out, flash_attention_reference(q, k, v, kv_valid, causal, rate, 11, block_q),
                               atol=1e-5, rtol=0)
    want = flash_attention_bwd_reference(q, k, v, do, kv_valid, causal, rate, 11, block_q)
    for name, a, b in zip("qkv", grads, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=f"d{name}")


def test_autograd_on_the_cpu_launches_no_kernel():
    launch_counts.clear()
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(Tq=16, Tk=32))
    flash_attention(q, k, v, None, False, 0.2, 3).sum().backward()
    assert launch_counts[flash_attn.NAME] == launch_counts[flash_attn.BWD_NAME] == 0
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))
