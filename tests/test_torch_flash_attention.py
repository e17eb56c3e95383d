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
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)


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


def _bf16_forward_hash(seed, block, n_rows, Tk, rate, BK=128):
    """The bf16 forward kernel's dropout sequence (flash_attn_fwd_bf16.cu),
    in numpy uint32: each row's term, plus a column base per key tile k0 and
    quad lane t, (k0 + 2t) * C_col, then the constant (8j + e) * C_col of
    element (j, e), JAX's mix, and the keep test folded into the multiplier
    (p * mult if kept, else 0), as [n_rows, Tk] multipliers of p = 1."""
    u = np.uint32
    c_col = u(668265263)
    mult = np.float32(flash_attn._keep_scale(rate))
    out = np.full((n_rows, Tk), -1.0, np.float32)
    with np.errstate(over="ignore"):
        rows = np.arange(n_rows, dtype=u)
        row_term = u(seed) * u(2654435761) + u(block) * u(40503) + rows * u(3266489917)
        for k0 in range(0, Tk, BK):
            for t in range(4):
                rb = row_term + u(k0 + 2 * t) * c_col
                for j in range(BK // 8):
                    for e in range(2):
                        col = k0 + 8 * j + 2 * t + e
                        if col >= Tk:
                            continue
                        h = rb + u(8 * j + e) * c_col
                        h = (h ^ (h >> u(13))) * u(2654435761)
                        h = (h ^ (h >> u(17))) * u(668265263)
                        keep = (h ^ (h >> u(16))) >= u(int(rate * 2**32))
                        out[:, col] = np.where(keep, np.float32(1.0) * mult, np.float32(0.0))
    assert (out >= 0).all()  # every column written once
    return out


@pytest.mark.parametrize("seed", [0, 23, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("block", [0, 7, 2**31, 2**32 - 3])
def test_bf16_forward_hash_sequence_matches_jax_bit_for_bit(seed, block):
    """The bf16 forward steps the hash's column term from a base per key tile
    and folds the keep test into the multiplier: that sequence, over three key
    tiles (the last one partial) and sums that wrap uint32, gives JAX's
    hash_mask_mult bit for bit at three rates."""
    for rate in (0.1, 0.5, 0.9):
        want = np.asarray(j_flash.hash_mask_mult(jnp.uint32(seed), jnp.uint32(block), (40, 300), rate))
        np.testing.assert_array_equal(_bf16_forward_hash(seed, block, 40, 300, rate), want)


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
    (50, 50, (50, 37), False, 16),  # self-attention with a ragged last q-block (50 = 3 x 16 + 2)
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits; ties away from zero),
    as cvt.rna.tf32.f32 and the kernels' integer rounding give it: add half
    a TF32 ulp to the bits and clear the 13 low ones."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32).reshape(x.shape)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it for f32 inputs: each operand split as
    big = tf32(x), small = tf32(x - big), the products small*big + big*small
    first, then big*big (attn_common.cuh)."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product: what a single pass would keep."""
    return tf32_round(a) @ tf32_round(b)


def _emulate_forward(q, k, v, logit, mult, mm, tile, split):
    """The forward kernel's decomposition: the key tiles shared out among
    ``split`` cluster blocks, each an online softmax over its tiles (P.V on
    the dropped probabilities, the row sum on the undropped ones), the
    partials combined in rank order as the cluster combines them; (out,
    lse).  ``logit(s, qs, ks)`` applies the scale and masks to a tile."""
    Tq, Tk = q.shape[2], k.shape[2]
    n_kt = -(-Tk // tile)
    qs = slice(0, Tq)
    parts = []
    for rank in range(split):
        m = torch.full(q.shape[:3] + (1,), -float("inf"))
        l = torch.zeros(q.shape[:3] + (1,))
        acc = torch.zeros(q.shape)
        for kt in range(rank * n_kt // split, (rank + 1) * n_kt // split):
            ks = slice(kt * tile, (kt + 1) * tile)
            s = logit(mm(q, k[:, :, ks].transpose(-1, -2)), qs, ks)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm(p * mult[..., ks], v[:, :, ks])
            m = m_new
        parts.append((m, l, acc))
    mmax = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = sum(l * torch.exp(m - mmax) for m, l, _ in parts)
    out = sum(acc * (torch.exp(m - mmax) / lsum) for m, _, acc in parts)
    return out, mmax + torch.log(lsum)


def _emulate_kernels(q, k, v, do, kv_valid, causal, rate, seed, block_q, tile=64, mm=torch.matmul, split=1):
    """The CUDA kernels' decomposition, in torch, with the products formed
    by ``mm`` (exact f32, or the tensor cores' 3xTF32): the forward as
    ``_emulate_forward``; the backward's delta = dO . O, then per key tile,
    over every q tile, the transposed tiles S^T = K Q^T and dP^T = V dO^T
    with P recomputed as exp(S - lse) and the mask read per element by
    global row (attn_common.cuh), dK and dV accumulated, and the key tile's
    dQ partial dS K; dQ the partials' sum in key-tile order."""
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    scale = 1.0 / Dh**0.5
    valid_bias = torch.zeros(B, 1, 1, Tk)
    if kv_valid is not None:
        valid_bias = torch.where(kv_valid[:, None, None] > 0, 0.0, -1e9)
    masked = torch.arange(Tk)[None] > torch.arange(Tq)[:, None] + Tk - Tq

    def logit(s, qs, ks):  # scale, kv_valid adds -1e9, the causal rule replaces the logit with it
        x = s * scale + valid_bias[..., ks]
        return torch.where(masked[qs, ks], -1e9, x) if causal else x

    T = lambda x: x.transpose(-1, -2)  # noqa: E731
    mult = flash_attn.dropout_mask(B, H, Tq, Tk, rate, seed, block_q) if rate > 0 else torch.ones(B, H, Tq, Tk)
    out, lse = _emulate_forward(q, k, v, logit, mult, mm, tile, split)
    delta = (do * out).sum(-1, keepdim=True)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dq_part = torch.zeros((-(-Tk // tile),) + q.shape)  # one dQ partial per key tile
    for kb, k0 in enumerate(range(0, Tk, tile)):  # one block per key tile, on the transposed tiles
        ks = slice(k0, k0 + tile)
        for q0 in range(0, Tq, tile):
            qs = slice(q0, q0 + tile)
            p = torch.exp(logit(T(mm(k[:, :, ks], T(q[:, :, qs]))), qs, ks) - lse[:, :, qs])
            mk = mult[:, :, qs, ks]
            ds = p * (T(mm(v[:, :, ks], T(do[:, :, qs]))) * mk - delta[:, :, qs])
            dv[:, :, ks] += mm(T(p * mk), do[:, :, qs])
            dk[:, :, ks] += mm(T(ds), q[:, :, qs])
            dq_part[kb, :, :, qs] = mm(ds, k[:, :, ks])
    dq = dq_part[0]
    for part in dq_part[1:]:  # the dQ kernel: the partials' sum in key-tile order
        dq = dq + part
    return out, dq * scale, dk * scale, dv


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


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest():
    x = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32) * 100)
    r = tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()
    # a tie (exactly half a TF32 ulp) goes away from zero
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert tf32_round(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


EMU_CASES = [  # (Tq, Tk, causal, rate, block_q, tile, split): ragged tiles, masks, dropout, every split
    (150, 200, True, 0.3, 16, 32, 2),
    (70, 130, False, 0.1, None, 64, 4),
    (64, 96, False, 0.0, None, 32, 1),
]


@pytest.mark.parametrize("Tq,Tk,causal,rate,block_q,tile,split", EMU_CASES)
def test_tensor_core_emulation_matches_plain_and_pallas(Tq, Tk, causal, rate, block_q, tile, split):
    """3xTF32 products and the cluster's split-KV combine give the plain
    versions' results at the card's bars (outputs 1e-5, gradients 2e-5 of
    their largest element) and the JAX Pallas kernel's in interpret mode at
    this file's bars (2e-5 without dropout; 3e-5 / 5e-5 with it)."""
    B, H, Dh, seed = 2, 2, 16, 11
    q, k, v = _qkv(B, H, Tq, Tk, Dh, seed=Tq)
    do = np.random.RandomState(6).randn(B, H, Tq, Dh).astype(np.float32)
    kv_valid = (np.arange(Tk)[None] < np.array([[Tk - 30], [Tk]])).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, do, kv_valid)]
    out, *grads = _emulate_kernels(*t, causal, rate, seed, block_q, tile, mm_tf32x3, split)
    torch.testing.assert_close(out, flash_attention_reference(t[0], t[1], t[2], t[4], causal, rate, seed, block_q),
                               atol=1e-5, rtol=0)
    want = flash_attention_bwd_reference(*t[:4], t[4], causal, rate, seed, block_q)
    scale = max(w.abs().max().item() for w in want)
    for name, a, b in zip("qkv", grads, want):
        torch.testing.assert_close(a, b, atol=2e-5 * scale, rtol=0, msg=f"d{name}")

    def jfn(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(kv_valid), jnp.array([seed], jnp.int32), causal, rate, block_q,
                         True, "hash")

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    out_tol, grad_tol = (3e-5, 5e-5) if rate > 0 else (2e-5, 2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=out_tol)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=grad_tol, err_msg=f"d{name}")


def test_3xtf32_holds_f32_accuracy_at_the_face_shape():
    """One head at the face denoiser's cross-attention (Tq 600, Tk 2000, Dh
    128), the kernel's tiling (32-key tiles, split 4) against float64:
    3xTF32 products stay well under the 1e-5 bar; one TF32 product does
    not, which is why the kernels take three."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 600, 2000, 128, seed=9))
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 128**0.5, -1) @ v.double()
    logit = lambda s, qs, ks: s / 128**0.5  # noqa: E731
    ones = torch.ones(1, 1, 600, 2000)
    x3 = _emulate_forward(q, k, v, logit, ones, mm_tf32x3, 32, 4)[0]
    x1 = _emulate_forward(q, k, v, logit, ones, mm_tf32, 32, 4)[0]
    err3, err1 = ((x.double() - exact).abs().max().item() for x in (x3, x1))
    assert err3 < 1e-6 < 1e-5 < err1, (err3, err1)


def test_flash_attention_takes_the_models_strided_views_on_the_cpu():
    """The head-split views of [B, T, H*Dh] projections (models/blocks.py:
    _split), q alone and k, v as slices of one stacked projection, give the
    contiguous inputs' result exactly."""
    rng = np.random.RandomState(2)
    B, H, Dh, Tq, Tk = 2, 3, 16, 20, 45
    split = lambda x: x.unflatten(-1, (H, -1)).transpose(1, 2)  # noqa: E731
    q = split(torch.from_numpy(rng.randn(B, Tq, H * Dh).astype(np.float32)))
    kv = torch.from_numpy(rng.randn(B, Tk, 2 * H * Dh).astype(np.float32))
    k, v = split(kv[..., : H * Dh]), split(kv[..., H * Dh :])
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True),
                               atol=0, rtol=0)


def test_autograd_on_the_cpu_launches_no_kernel():
    launch_counts.clear()
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(Tq=16, Tk=32))
    flash_attention(q, k, v, None, False, 0.2, 3).sum().backward()
    assert launch_counts[flash_attn.NAME] == launch_counts[flash_attn.BWD_NAME] == 0
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))


# ------------------------------------- the bf16 backward's decomposition -- #

LOG2E = np.float32(1.4426950408889634)
NEG_BIAS2 = np.float32(-1e9) * LOG2E  # csrc/flash_attn_bwd_bf16.cu: the masked logit in base 2


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _pad_rows(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """x [B, H, T, ...] with rows T..rows-1 set to ``value`` (TMA's zero fill,
    or the padded planes' entries)."""
    pad = torch.full((*x.shape[:2], rows - x.shape[2], *x.shape[3:]), value, dtype=x.dtype)
    return torch.cat([x, pad], 2)


def _emulate_bf16_backward(q, k, v, do, out, lse, kv_valid, causal, rate, seed, block_q,
                           kb=128, qb=64, bq=128, bk=64):
    """The bf16 backward kernels' decomposition (csrc/flash_attn_bwd_bf16.cu)
    in f32 torch on bf16 inputs, with its tiles: the rows' planes (lse times
    log2 e, D = dO . O, the dropout's row terms; a padded q row gets lse =
    +inf and D = 0); the key-stationary kernel, per block of ``kb`` keys over
    the q tiles of ``qb`` rows in order: S^T = K Q^T and dP^T = V dO^T, P^T =
    2^(S^T scale log2 e + key bias - lse2) (a missing key's bias -inf, a
    kv_valid-masked one's -1e9 log2 e; causal replaces the logit with the
    latter; a row whose every key is masked takes the forward's uniform
    1/Tk), dV += bf16(P o M)^T dO and dK += bf16(dS^T) Q; the
    query-stationary kernel, per block of ``bq`` rows over the key tiles of
    ``bk`` in order: S and dP again and dQ += bf16(dS) K, the sum over the
    key tiles kept in f32 and scaled once.  Returns f32 (dq, dk, dv) before
    their final rounding to bf16."""
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    scale2 = np.float32(1.0 / Dh**0.5) * LOG2E
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    rows = -(-Tq // (qb * bq)) * qb * bq  # a multiple of both q tiles
    keys = -(-Tk // (kb * bk)) * kb * bk
    lse2 = _pad_rows(lse * LOG2E, rows, float("inf"))
    delta = _pad_rows((dof * out.float()).sum(-1), rows)
    Q, dO = _pad_rows(qf, rows), _pad_rows(dof, rows)
    K, V = _pad_rows(kf, keys), _pad_rows(vf, keys)
    mult = torch.ones(B, H, Tq, Tk)
    if rate > 0:
        mult = flash_attn.dropout_mask(B, H, Tq, Tk, rate, seed, block_q)
    mult = _pad_rows(mult, rows, 1.0)
    mult = torch.cat([mult, torch.ones(B, H, rows, keys - Tk)], 3)
    bias = torch.zeros(B, keys)
    if kv_valid is not None:
        bias[:, :Tk] = torch.where(kv_valid > 0, 0.0, float(NEG_BIAS2))
    bias[:, Tk:] = -float("inf")
    masked = torch.arange(keys)[None] > torch.arange(rows)[:, None] + Tk - Tq  # [rows, keys]
    T = lambda x: x.transpose(-1, -2)  # noqa: E731

    def probs(s, qs, ks):  # s [B, H, q rows, keys]
        x = s * scale2 + bias[:, None, None, ks]
        if causal:
            x = torch.where(masked[qs, ks], float(NEG_BIAS2), x)
        # a row whose every key is masked: the forward's uniform average
        full = lse2[:, :, qs, None] < NEG_BIAS2 / 2
        return torch.where(full, (torch.arange(keys)[ks] < Tk).float() / Tk, torch.exp2(x - lse2[:, :, qs, None]))

    dk, dv = torch.zeros(B, H, keys, Dh), torch.zeros(B, H, keys, Dh)
    for k0 in range(0, keys, kb):  # the key-stationary kernel
        ks = slice(k0, k0 + kb)
        for q0 in range(0, -(-Tq // qb) * qb, qb):
            qs = slice(q0, q0 + qb)
            pt = T(probs(T(K[:, :, ks] @ T(Q[:, :, qs])), qs, ks))
            mt = T(mult[:, :, qs, ks])
            dpt = V[:, :, ks] @ T(dO[:, :, qs])
            dv[:, :, ks] += _bf16_round(pt * mt) @ dO[:, :, qs]
            dk[:, :, ks] += _bf16_round(pt * (dpt * mt - delta[:, :, None, qs])) @ Q[:, :, qs]
    dq = torch.zeros(B, H, rows, Dh)
    for q0 in range(0, Tq, bq):  # the query-stationary kernel
        qs = slice(q0, q0 + bq)
        acc = torch.zeros(B, H, bq, Dh)
        for k0 in range(0, -(-Tk // bk) * bk, bk):
            ks = slice(k0, k0 + bk)
            p = probs(Q[:, :, qs] @ T(K[:, :, ks]), qs, ks)
            dp = dO[:, :, qs] @ T(V[:, :, ks])
            acc = acc + _bf16_round(p * (dp * mult[:, :, qs, ks] - delta[:, :, qs, None])) @ K[:, :, ks]
        dq[:, :, qs] = acc
    s = np.float32(1.0 / Dh**0.5)
    return dq[:, :, :Tq] * s, dk[:, :, :Tk] * s, dv[:, :, :Tk]


# (Tq, Tk, kv_valid lengths, causal, rate, block_q, tiles kb, qb, bq, bk); every
# row keeps a key (the module's head note: fully masked rows are not compared)
BF16_BWD_CASES = [
    (70, 150, (120, 150), False, 0.1, None, (128, 64, 128, 64)),  # the kernels' tiles, ragged
    (70, 150, (150, 150), True, 0.0, 16, (32, 16, 32, 16)),  # many small tiles: the order of every sum
    (130, 150, (150, 141), True, 0.1, 16, (32, 16, 32, 16)),  # both masks on every tile edge
    (64, 96, (96, 96), False, 0.0, None, (32, 32, 64, 32)),  # tiles that divide the shape
]


@pytest.mark.parametrize("Tq,Tk,lengths,causal,rate,block_q,tiles", BF16_BWD_CASES)
def test_bf16_backward_decomposition_matches_plain_and_pallas(Tq, Tk, lengths, causal, rate, block_q, tiles):
    """The bf16 backward kernels' tiling and rounding points (the emulation
    above: key-stationary dK/dV, query-stationary dQ summed over the key
    tiles in order, P o M and dS rounded to bf16 before their products, D
    from the bf16 output) against the plain version, which rounds at the
    same points but forms D as rowsum(P o dP), and against the JAX Pallas
    backward in interpret mode on the same bf16 inputs, which also rounds
    dO / rowsum to bf16: each gradient, rounded to bf16, within 1e-2 of the
    largest plain or JAX gradient (the bf16 kernels' bar on the card,
    chip_smoke.py BF16_TOL, and tests/test_torch_bf16.py ATTN_REL)."""
    B, H, Dh, seed = 2, 2, 16, 31
    rng = np.random.RandomState(Tq + Tk)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, T, Dh).astype(np.float32)).to(torch.bfloat16)
                   for T in (Tq, Tk, Tk, Tq))
    kv_valid = torch.from_numpy((np.arange(Tk)[None] < np.array(lengths)[:, None]).astype(np.float32))
    out = flash_attention_reference(q, k, v, kv_valid, causal, rate, seed, block_q)
    logits = (q.float() @ k.float().transpose(-1, -2)) / Dh**0.5 + torch.where(kv_valid > 0, 0.0, -1e9)[:, None, None]
    if causal:
        logits = torch.where(torch.arange(Tk)[None] > torch.arange(Tq)[:, None] + Tk - Tq, -1e9, logits)
    lse = torch.logsumexp(logits, -1)
    got = [_bf16_round(x) for x in _emulate_bf16_backward(q, k, v, do, out, lse, kv_valid, causal, rate, seed,
                                                          block_q, *tiles)]
    want = flash_attention_bwd_reference(q, k, v, do, kv_valid, causal, rate, seed, block_q)
    scale = max(w.float().abs().max().item() for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a - w.float()).abs().max().item()
        assert err <= 1e-2 * scale, f"{name}: {err} > 1e-2 x {scale} (plain)"

    def jfn(q_, k_, v_):
        return jax_flash(q_, k_, v_, jnp.asarray(kv_valid.numpy()), jnp.array([seed], jnp.int32), causal, rate,
                         block_q, True, "hash")

    jb = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v, do)]
    _, vjp = jax.vjp(jfn, *jb[:3])
    jgrads = [np.asarray(x.astype(jnp.float32)) for x in vjp(jb[3])]
    jscale = max(np.abs(x).max() for x in jgrads)
    for name, a, w in zip(("dq", "dk", "dv"), got, jgrads):
        err = np.abs(a.numpy() - w).max()
        assert err <= 1e-2 * jscale, f"{name}: {err} > 1e-2 x {jscale} (Pallas)"
