"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without a CUDA device.  This file imports no JAX,
so it also runs where JAX is not installed, without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances with TF32 off: attention f32 1e-5 for unit-normal inputs, bf16
2e-2; attention gradients f32 2e-5 and bf16 2e-2 of the largest plain
element; the bf16 kernels at the model's shapes 1e-2 of the largest plain
output and gradient; the dropout mask exactly; the rasterizer's face ids and coverage
exactly, depth / UV / barycentrics 1e-5; rendered uint8 frames within one
count; the display kernel's tex_rec bit for bit and its 8-bit values exact
on >= 99.99% of the channel texels and never more than one count off; a
full-width face denoise step within 1e-3 of the CPU's; the full-width guide's
teacher-forced logits within 1e-5 of their largest magnitude of the CPU's,
its cached decode token for token equal to its uncached one; one avatar
train step's loss parts within 1e-5 relative of the CPU's, its gradients
within 1e-4 of their largest element; the modules without a kernel of
their own (AudioTcn, Wav2VecDownsampler, the ELR layers) within 2e-5 of
their output's scale of the CPU's, their gradients within 1e-4.
"""

import pytest
import torch

from audio2photoreal_tpu_torch.core.config import DenoiserConfig
from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, launch_counts, raster
from audio2photoreal_tpu_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from audio2photoreal_tpu_torch.models.film_transformer import CondTokens, FiLMDenoiser
from audio2photoreal_tpu_torch.render.geometry import project_points
from chip_smoke import crowded_tile_arrays
import raster_emulation  # tests/raster_emulation.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,masked", [
    (2, 4, 600, 2000, 64, False), (2, 4, 600, 600, 128, False), (2, 3, 77, 203, 128, True),
    (1, 1, 1, 1, 64, False),
])
def test_kernel_matches_plain(cuda, dtype, tol, B, H, Tq, Tk, Dh, masked):
    g = torch.Generator(device=cuda).manual_seed(Tq + Tk)
    q, k, v = (torch.randn((B, H, T, Dh), generator=g, device=cuda).to(dtype) for T in (Tq, Tk, Tk))
    kv_valid = None
    if masked:  # row 0 of the causal mask sees keys 0..126, all valid
        kv_valid = (torch.arange(Tk, device=cuda)[None] < torch.tensor([[150], [Tk]], device=cuda)).float()
    name = flash_attn.BF16_NAME if dtype == torch.bfloat16 else flash_attn.NAME
    before = launch_counts[name]
    got = flash_attention(q, k, v, kv_valid, causal=masked)
    assert launch_counts[name] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_reference(q, k, v, kv_valid, causal=masked)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=cuda)
    x = torch.randn(1, 2, 64, 8, device=cuda).transpose(2, 3)  # Dh axis not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(x, x, x)
    x = torch.randn(1, 2, 8, 68, device=cuda)[..., 1:65]  # rows off 16 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())


def _split_heads(x, H):
    """[B, T, H*Dh] -> the model's strided [B, H, T, Dh] view (blocks.py:_split)."""
    return x.unflatten(-1, (H, -1)).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,masked", [
    (4, 4, 600, 2000, 128, False), (4, 4, 600, 600, 64, False), (2, 3, 77, 203, 64, True),
])
def test_kernel_takes_the_models_strided_views(cuda, dtype, tol, B, H, Tq, Tk, Dh, masked):
    """q from its own projection, k and v as slices of one stacked [B, Tk,
    2*H*Dh] projection, as the denoiser's cross-attention hands them over; the
    output is the [B, H, Tq, Dh] view of [B, Tq, H, Dh] storage."""
    g = torch.Generator(device=cuda).manual_seed(Tq + Dh)
    q = _split_heads(torch.randn((B, Tq, H * Dh), generator=g, device=cuda).to(dtype), H)
    kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device=cuda).to(dtype)
    k, v = _split_heads(kv[..., : H * Dh], H), _split_heads(kv[..., H * Dh :], H)
    kv_valid = None
    if masked:
        kv_valid = (torch.arange(Tk, device=cuda)[None] < torch.tensor([[150], [Tk]], device=cuda)).float()
    got = flash_attention(q, k, v, kv_valid, causal=masked)
    assert got.shape == (B, H, Tq, Dh) and got.transpose(1, 2).is_contiguous()
    want = flash_attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), kv_valid, causal=masked)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,masked,rate", [
    (4, 4, 600, 2000, 128, False, 0.0), (4, 4, 600, 600, 64, False, 0.3), (2, 3, 77, 203, 128, True, 0.3),
])
def test_kernel_split_across_a_cluster_matches_plain(cuda, dtype, tol, B, H, Tq, Tk, Dh, masked, rate):
    """Every cluster split (1-4 blocks sharing a q tile's keys, combined
    through distributed shared memory) gives the plain version's output and
    log-sum-exp."""
    q, k, v, _, kv_valid = _attn_case(cuda, B, H, Tq, Tk, Dh, masked, dtype)
    want = flash_attention_reference(q, k, v, kv_valid, masked, rate, 7)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / Dh**0.5
    if masked:
        logits = logits + flash_attn._bias(q, k, kv_valid, True)
    want_lse = torch.logsumexp(logits, -1)
    assert 1 <= flash_attn.fwd_split(B, H, Tq, Tk, Dh, dtype) <= 4
    for split in (1, 2, 3, 4):
        got, lse = flash_attn._launch_fwd(q, k, v, kv_valid, masked, rate, 7, None, True, split=split)
        assert (got.float() - want.float()).abs().max().item() <= tol, split
        assert (lse - want_lse).abs().max().item() <= 1e-5 * max(1.0, want_lse.abs().max().item()), split


@pytest.mark.cuda
def test_denoiser_kernel_path_matches_plain_path(cuda):
    """Full-width pose denoise step: attention through the kernel (gate open,
    Tq 600, Tk 2000) against the same model with the plain attention."""
    cfg = DenoiserConfig(flash_attention=True)
    model = FiLMDenoiser(cfg).to(cuda).eval()
    model.reset_parameters(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    B, D = 2, cfg.latent_dim
    cond = CondTokens(torch.randn(B, 1998, D, generator=g, device=cuda),
                      torch.randn(B, 20, D, generator=g, device=cuda))
    x = torch.randn(B, cfg.max_seq_length, cfg.nfeats, generator=g, device=cuda)
    t = torch.tensor([999, 10], device=cuda)
    keep = torch.tensor([True, False], device=cuda)
    with torch.no_grad():
        before = launch_counts[flash_attn.NAME]
        got = model.denoise(x, t, cond, keep)
        assert launch_counts[flash_attn.NAME] - before == 2 * cfg.num_layers
        for layer in model.layers:
            layer.self_attn.flash = layer.multihead_attn.flash = False
        want = model.denoise(x, t, cond, keep)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


# ------------------------------------- attention backward and dropout -- #

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # outputs, as the forward's test
# gradients, kernel vs plain, relative to the largest |plain| gradient: f32
# 2e-5 (both accumulate in f32, in another order), bf16 2e-2 (bf16 inputs and
# outputs; the plain version rounds P o M to bf16 before its products)
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_case(cuda, B, H, Tq, Tk, Dh, masked, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + Tq + Tk)
    q, k, v, do = (torch.randn((B, H, T, Dh), generator=g, device=cuda).to(dtype) for T in (Tq, Tk, Tk, Tq))
    kv_valid = None
    if masked:  # causal row 0 sees keys 0..Tk-Tq, all valid in every batch row
        lengths = torch.tensor([Tk - 20 * (B - 1 - b) for b in range(B)], device=cuda)
        kv_valid = (torch.arange(Tk, device=cuda)[None] < lengths[:, None]).float()
    return q, k, v, do, kv_valid


def _kernel_grads(q, k, v, do, kv_valid, causal, rate, seed, block_q=None):
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qg, kg, vg, kv_valid, causal, rate, seed, block_q)
    out.backward(do)
    return out.detach(), qg.grad, kg.grad, vg.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,masked,rate,block_q", [
    (2, 4, 600, 2000, 64, False, 0.1, None), (2, 4, 600, 600, 64, False, 0.1, None),
    (2, 2, 600, 2000, 128, False, 0.3, None), (2, 3, 77, 203, 64, True, 0.3, 16),
    (2, 3, 77, 203, 128, True, 0.0, None), (1, 1, 1, 1, 64, False, 0.5, None),
])
def test_backward_kernel_matches_plain(cuda, dtype, B, H, Tq, Tk, Dh, masked, rate, block_q):
    q, k, v, do, kv_valid = _attn_case(cuda, B, H, Tq, Tk, Dh, masked, dtype)
    names = ((flash_attn.BF16_NAME, flash_attn.BF16_BWD_NAME) if dtype == torch.bfloat16
             else (flash_attn.NAME, flash_attn.BWD_NAME))
    before = [launch_counts[n] for n in names]
    out, *grads = _kernel_grads(q, k, v, do, kv_valid, masked, rate, 1234, block_q)
    assert [launch_counts[n] for n in names] == [before[0] + 1, before[1] + 1]
    want_out = flash_attention_reference(q, k, v, kv_valid, masked, rate, 1234, block_q)
    want = flash_attention_bwd_reference(q, k, v, do, kv_valid, masked, rate, 1234, block_q)
    assert (out.float() - want_out.float()).abs().max().item() <= TOL[dtype]
    # the scale of this call's gradients (dq is exactly 0 where a row sees one key)
    scale = max(b.float().abs().max().item() for b in want)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * scale, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,masked,rate", [
    (4, 4, 600, 2000, 64, False, 0.1), (2, 4, 600, 2000, 128, False, 0.1), (2, 3, 77, 203, 64, True, 0.3),
])
def test_backward_takes_the_models_strided_views(cuda, dtype, B, H, Tq, Tk, Dh, masked, rate):
    """Gradients through the kernels when q, k and v are the head-split views
    of [B, T, H*Dh] projections, as the model trains them."""
    q, k, v, do, kv_valid = _attn_case(cuda, B, H, Tq, Tk, Dh, masked, dtype)
    leaves = [x.transpose(1, 2).contiguous().flatten(2).requires_grad_() for x in (q, k, v)]  # [B, T, H*Dh]
    out = flash_attention(*(_split_heads(x, H) for x in leaves), kv_valid, masked, rate, 55)
    out.backward(do)
    want = flash_attention_bwd_reference(q, k, v, do, kv_valid, masked, rate, 55)
    scale = max(b.float().abs().max().item() for b in want)
    for name, leaf, b in zip(("dq", "dk", "dv"), leaves, want):
        a = _split_heads(leaf.grad, H)
        assert (a.float() - b.float()).abs().max().item() <= GRAD_TOL[dtype] * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk,block_q", [(600, 2000, None), (600, 600, None), (77, 203, 16)])
def test_dropout_mask_is_exact(cuda, Tq, Tk, block_q):
    """With v one-hot on a window of 64 keys, the kernel's output is P o M
    on that window element by element, so its zeros are the mask's zeros."""
    B, H, Dh, rate, seed = 2, 2, 64, 0.5, 2**31 - 7
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k = (torch.randn((B, H, T, Dh), generator=g, device=cuda) for T in (Tq, Tk))
    mask = flash_attn.dropout_mask(B, H, Tq, Tk, rate, seed, block_q, cuda)
    for k0 in sorted({0, max(0, Tk // 2 - 32), max(0, Tk - Dh)}):
        n = min(Dh, Tk - k0)
        v = torch.zeros(B, H, Tk, Dh, device=cuda)
        v[:, :, k0:k0 + n, :n] = torch.eye(n, device=cuda)
        got = flash_attention(q, k, v, None, False, rate, seed, block_q)[..., :n]
        assert torch.equal(got == 0, mask[..., k0:k0 + n] == 0)
        want = flash_attention_reference(q, k, v, None, False, rate, seed, block_q)[..., :n]
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_is_deterministic(cuda, dtype):
    q, k, v, do, kv_valid = _attn_case(cuda, 4, 4, 600, 2000, 64, False, dtype)
    first = _kernel_grads(q, k, v, do, kv_valid, False, 0.1, 99)
    second = _kernel_grads(q, k, v, do, kv_valid, False, 0.1, 99)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 64, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="need the forward.s out"):
        flash_attn.flash_attention_bwd(q, q, q, None, None, q)
    with pytest.raises(ValueError, match="float32"):
        flash_attn.flash_attention_bwd(q, q, q, q, lse.double(), q)
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attn.flash_attention_bwd(q, q, q, q, lse, q, dropout_rate=1.0)


def _uniform_row_reference(q, k, v, do, kv_valid):
    """The forward and its softmax backward in float64 where a row whose keys
    are all masked takes the uniform average over the Tk keys (P = 1/Tk), as
    the forward's -1e9 gives it: O = P V, dV = P^T dO, dS = P o (dO V^T - D)
    with D = rowsum(dO o O), dQ = scale dS K, dK = scale dS^T Q."""
    qd, kd, vd, gd = (x.double() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    valid = (kv_valid > 0)[:, None, None, :]
    p = torch.softmax((qd @ kd.transpose(-1, -2) * scale).masked_fill(~valid, float("-inf")), -1)
    p = torch.where(valid.any(-1, keepdim=True), p, torch.full_like(p, 1.0 / k.shape[2]))
    o = p @ vd
    ds = p * (gd @ vd.transpose(-1, -2) - (gd * o).sum(-1, keepdim=True))
    return o, ds @ kd * scale, ds.transpose(-1, -2) @ qd * scale, p.transpose(-1, -2) @ gd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_of_a_fully_masked_row_is_the_uniform_averages(cuda, dtype):
    """Batch element 0's keys are all masked by kv_valid: the forward
    averages each of its rows over the Tk keys, and both backward kernels
    give that average's gradients (P = 1/Tk on those rows), not exp(x - lse)
    of a lse that f32 holds only to 64 there."""
    B, H, Tq, Tk, Dh = 2, 2, 77, 203, 64
    q, k, v, do, _ = _attn_case(cuda, B, H, Tq, Tk, Dh, False, dtype)
    kv_valid = torch.ones(B, Tk, device=cuda)
    kv_valid[0] = 0.0
    kv_valid[1, 150:] = 0.0
    out, *grads = _kernel_grads(q, k, v, do, kv_valid, False, 0.0, 0)
    want_out, *want = _uniform_row_reference(q, k, v, do, kv_valid)
    assert (out.double() - want_out).abs().max().item() <= TOL[dtype]
    scale = max(w.abs().max().item() for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        err = (a.double() - w).abs().max().item()
        assert err <= GRAD_TOL[dtype] * scale, (name, err)


# ------------------------------------- the bf16 kernels at the model shapes -- #

BF16_REL = 1e-2  # of the largest plain output / gradient


def _bf16_views(cuda, B, H, Tq, Tk, Dh, seed):
    """bf16 q, k, v as the model hands them over: q and k the two halves of
    one fused [B, T, 2*H*Dh] self-attention projection when Tq == Tk (time
    stride 2*H*Dh), else q from its own projection and k, v slices of one
    stacked [B, Tk, 2*H*Dh] projection; dO contiguous."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf16 = torch.bfloat16
    if Tq == Tk:
        qk = torch.randn((B, Tq, 2 * H * Dh), generator=g, device=cuda).to(bf16)
        q, k = _split_heads(qk[..., : H * Dh], H), _split_heads(qk[..., H * Dh:], H)
        v = _split_heads(torch.randn((B, Tk, H * Dh), generator=g, device=cuda).to(bf16), H)
    else:
        q = _split_heads(torch.randn((B, Tq, H * Dh), generator=g, device=cuda).to(bf16), H)
        kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device=cuda).to(bf16)
        k, v = _split_heads(kv[..., : H * Dh], H), _split_heads(kv[..., H * Dh:], H)
    do = torch.randn((B, H, Tq, Dh), generator=g, device=cuda).to(bf16)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,masked,rate", [
    (4, 4, 600, 2000, 64, False, 0.0), (4, 4, 600, 600, 128, False, 0.0),  # generate
    (1, 4, 1998, 1998, 128, False, 0.0),  # the face cond-encoder
    (8, 4, 600, 2000, 64, False, 0.1), (8, 4, 600, 600, 128, False, 0.1),  # train
    (2, 4, 1998, 1998, 128, False, 0.1),
    (2, 3, 77, 203, 64, True, 0.3), (2, 3, 77, 203, 128, True, 0.0),  # kv_valid and causal, ragged
    (3, 2, 130, 517, 128, False, 0.1), (3, 2, 517, 130, 64, False, 0.0),  # ragged Tq and Tk
])
def test_bf16_kernels_match_plain_at_the_model_shapes(cuda, B, H, Tq, Tk, Dh, masked, rate):
    """The bf16 forward (wgmma, TMA) and backward (warp-specialised wgmma, TMA)
    through autograd against the plain versions, which round where the TPU
    kernel rounds; the bf16 kernels launch, the f32 ones do not; a rerun of
    both is bit-identical."""
    q, k, v, do = _bf16_views(cuda, B, H, Tq, Tk, Dh, Tq + Tk + Dh)
    kv_valid = None
    if masked:
        kv_valid = (torch.arange(Tk, device=cuda)[None] < torch.tensor([[150], [Tk]], device=cuda)).float()
    args = (kv_valid, masked, rate, 4321)
    before = {n: launch_counts[n] for n in (flash_attn.NAME, flash_attn.BWD_NAME, flash_attn.BF16_NAME,
                                            flash_attn.BF16_BWD_NAME)}

    def run():
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = flash_attention(qg, kg, vg, *args)
        return (out, *torch.autograd.grad(out, (qg, kg, vg), do))

    first, second = run(), run()
    assert [launch_counts[n] - c for n, c in before.items()] == [0, 0, 2, 2]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    want_out = flash_attention_reference(q, k, v, *args)
    want = flash_attention_bwd_reference(q, k, v, do, *args)
    scale = want_out.float().abs().max().item()
    assert first[0].dtype == torch.bfloat16 and (first[0].float() - want_out.float()).abs().max().item() <= (
        BF16_REL * scale)
    gscale = max(w.float().abs().max().item() for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), first[1:], want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        assert (a.float() - w.float()).abs().max().item() <= BF16_REL * gscale, name


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,Dh,block_q", [(4, 600, 2000, 64, None), (2, 1998, 1998, 128, None),
                                                (2, 77, 203, 128, 16)])
def test_bf16_dropout_mask_is_exact(cuda, B, Tq, Tk, Dh, block_q):
    """At rate 0.5 with q = 0 every probability is 1/Tk and v_j the one-hot
    of column j mod Dh, so output (i, c) is 2/Tk times the kept keys of class
    c: a count that bf16 holds far inside one key's share 2/Tk, which one
    wrong mask element would move it by."""
    H, rate, seed = 2, 0.5, 2**31 - 9
    q = torch.zeros((B, H, Tq, Dh), dtype=torch.bfloat16, device=cuda)
    onehot = torch.nn.functional.one_hot(torch.arange(Tk, device=cuda) % Dh, Dh).to(torch.bfloat16)
    v = onehot.expand(B, H, Tk, Dh).contiguous()
    got = flash_attention(q, q[:, :, :1].expand(B, H, Tk, Dh).contiguous(), v, None, False, rate, seed, block_q)
    mask = flash_attn.dropout_mask(B, H, Tq, Tk, rate, seed, block_q, cuda)
    want = torch.matmul(mask, onehot.float()) / Tk
    assert (got.float() - want).abs().max().item() <= 0.4 * 2.0 / Tk


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,Dh,mask,rate", [
    (2, 2, 1, 37, 64, None, 0.0), (2, 2, 1, 2000, 128, "kv_valid", 0.1),  # one q row
    (2, 4, 600, 37, 128, "causal", 0.0),  # rows 0..562 see no key: each averages all 37
    (2, 4, 600, 600, 64, "kv_valid+causal", 0.1), (2, 3, 1998, 37, 64, "kv_valid", 0.0),
    (1, 4, 1998, 1998, 128, None, 0.1), (2, 2, 1998, 2000, 64, "kv_valid", 0.1),
    (1, 1, 600, 2000, 64, None, 0.0), (1, 1, 600, 600, 128, None, 0.1),  # fewer tiles than SMs
    (64, 4, 600, 600, 64, None, 0.1), (64, 4, 600, 2000, 128, None, 0.0),  # many waves
])
def test_bf16_forward_edges_of_its_tiles_and_schedule(cuda, B, H, Tq, Tk, Dh, mask, rate):
    """The bf16 forward on the model's strided views at q and key counts off
    its tiles, partly masked rows, causal rows, dropout, grids below one wave
    and many waves: the output within 2e-2 of the largest plain element and
    its log-sum-exp within 1e-5 of the plain one, both bit-identical on a
    rerun; the backward, fed that log-sum-exp, within the file's bar."""
    q, k, v, do = _bf16_views(cuda, B, H, Tq, Tk, Dh, B + Tq + Tk + Dh)
    kv_valid = None
    if mask and "kv_valid" in mask:  # the first key stays valid, so no causal row loses every key
        lengths = torch.tensor([max(1, Tk * (b + 1) // (B + 1)) for b in range(B)], device=cuda)
        kv_valid = (torch.arange(Tk, device=cuda)[None] < lengths[:, None]).float()
    causal = bool(mask and "causal" in mask)
    args = (kv_valid, causal, rate, 97)
    first, second = (flash_attn._launch_fwd(q, k, v, *args, None, True) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    want = flash_attention_reference(q, k, v, *args)
    scale = want.float().abs().max().item()
    assert (first[0].float() - want.float()).abs().max().item() <= 2e-2 * scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / Dh**0.5
    bias = flash_attn._bias(q, k, kv_valid, causal)
    want_lse = torch.logsumexp(logits if bias is None else logits + bias, -1)
    seen = want_lse > -1e8  # rows with a visible key; the others sit at the -1e9 of their average
    assert ((first[1] - want_lse)[seen].abs().max().item()
            <= 1e-5 * max(1.0, want_lse[seen].abs().max().item()))
    assert (first[1][~seen] < -1e8).all()
    del logits, want_lse
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad(flash_attention(qg, kg, vg, *args), (qg, kg, vg), do)
    want_grads = flash_attention_bwd_reference(q, k, v, do, *args)
    gscale = max(w.float().abs().max().item() for w in want_grads)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert (a.float() - w.float()).abs().max().item() <= GRAD_TOL[torch.bfloat16] * gscale, name


@pytest.mark.cuda
def test_bf16_denoiser_step_on_the_card(cuda):
    """A full-width bf16 pose denoiser (f32 weights) on the card: one
    denoise step through the bf16 kernels no less accurate than the CPU's
    bf16 step against the CPU's f32 one (1.5x its error + 1e-3 of scale),
    and a backward pass whose gradients reach the f32 parameters."""
    import copy
    import dataclasses

    cfg = DenoiserConfig(flash_attention=True)
    f32 = FiLMDenoiser(cfg).eval()
    f32.reset_parameters(torch.Generator().manual_seed(0))
    cpu16 = FiLMDenoiser(dataclasses.replace(cfg, dtype="bfloat16")).eval()
    cpu16.load_state_dict(f32.state_dict())
    card16 = copy.deepcopy(cpu16).to(cuda)
    g = torch.Generator().manual_seed(1)
    B, D = 2, cfg.latent_dim
    cond = CondTokens(torch.randn(B, 1998, D, generator=g), torch.randn(B, 20, D, generator=g))
    x = torch.randn(B, cfg.max_seq_length, cfg.nfeats, generator=g)
    t, keep = torch.tensor([999, 10]), torch.tensor([True, False])
    before = launch_counts[flash_attn.BF16_NAME]
    with torch.no_grad():
        card = card16.denoise(x.to(cuda), t.to(cuda), CondTokens(*(c.to(cuda) for c in cond)), keep.to(cuda)).cpu()
        want16 = cpu16.denoise(x, t, cond, keep)
        want32 = f32.denoise(x, t, cond, keep)
    assert launch_counts[flash_attn.BF16_NAME] - before == 2 * cfg.num_layers
    scale = want32.abs().max().item()
    e_card, e_cpu = (card - want32).abs().max().item(), (want16 - want32).abs().max().item()
    assert card.dtype == torch.float32 and e_card <= 1.5 * e_cpu + 1e-3 * scale, (e_card, e_cpu, scale)
    card16.train()
    card16.denoise(x.to(cuda), t.to(cuda), CondTokens(*(c.to(cuda) for c in cond)), keep.to(cuda)).square().mean().backward()
    # (the keyframe projection and the frozen frontend take no part in a denoise step)
    grads = {n: p.grad for n, p in card16.named_parameters() if p.grad is not None}
    assert all(f"seqTransDecoder.stack.{i}.linear1.weight" in grads for i in range(cfg.num_layers))
    assert all(gr.dtype == torch.float32 and torch.isfinite(gr).all() for gr in grads.values())


# ------------------------------------------------------------- raster -- #

RASTER_TOL = 1e-5  # depth / UV / barycentrics; face ids and coverage exactly


def _raster_equal(got, want):
    assert torch.equal(got.face_index, want.face_index)
    cov = want.face_index >= 0
    assert torch.isinf(got.depth[~cov]).all()
    assert (got.depth[cov] - want.depth[cov]).abs().max().item() <= RASTER_TOL
    for name in ("uv", "barys"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a - b).abs().max().item() <= RASTER_TOL


def _posed_mesh(mesh_density):
    """The synthetic body at ``mesh_density`` posed by 4 random poses and seen
    by the synthetic rig's 2 cameras: [8, V] projected vertices at 1024x667."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import numpy as np

    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    assets = make_synthetic_assets(RendererConfig(uv_size=256, upscale_size=512),
                                   mesh_density=mesh_density).to("cuda")
    rng = np.random.RandomState(0)
    verts = assets.lbs.pose(None, torch.from_numpy((rng.randn(4, 104) * 0.3).astype(np.float32)).to("cuda"))
    pix, dep = [], []
    for cam in synthetic_rig((0.0, 0.0, 1.0), 1024, 667).values():
        K, Rt = (torch.from_numpy(a).to("cuda") for a in (cam.K, cam.Rt))
        p, d = project_points(verts, K.expand(4, 3, 3), Rt.expand(4, 3, 4))
        pix.append(p)
        dep.append(d)
    geo = assets.geo
    return dict(pix=torch.stack(pix, 1).flatten(0, 1).contiguous(), dep=torch.stack(dep, 1).flatten(0, 1).contiguous(),
                faces=geo.faces, face_uv=geo.uv_coords[geo.uv_faces].contiguous(), H=1024, W=667)


@pytest.fixture(scope="module")
def mesh10():
    """The mesh_density=10 synthetic body: 9,322 faces, the render's mesh."""
    return _posed_mesh(10)


@pytest.fixture(scope="module")
def mesh30():
    """The mesh_density=30 synthetic body: 85,562 faces."""
    m = _posed_mesh(30)
    assert m["faces"].shape[0] == 85_562
    return m


def _crowded_case(cuda):
    """chip_smoke's crowded tile on the card: 2,000 faces in one tile, a face
    over every tile, corners at +-1e30, faces off screen."""
    pix, dep, faces, face_uv, H, W = crowded_tile_arrays()
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return t(pix), t(dep), t(faces), H, W, t(face_uv)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_barys", [True, False])
def test_raster_kernel_matches_plain_at_the_full_image(cuda, mesh10, emit_barys):
    m = mesh10
    args = (m["pix"][:2], m["dep"][:2], m["faces"], m["H"], m["W"], m["face_uv"], emit_barys)
    before = launch_counts[raster.NAME]
    got = raster.rasterize_cuda(*args)
    assert launch_counts[raster.NAME] == before + 1
    want = raster.rasterize_reference(*args)
    _raster_equal(got, want)
    assert 0.02 < (want.face_index >= 0).float().mean().item() < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,n_faces", [(61, 77, 300), (1, 1, 5), (17, 300, 64), (1024, 667, 2000)])
def test_raster_kernel_matches_plain_on_ragged_random_meshes(cuda, H, W, n_faces):
    import numpy as np

    rng = np.random.RandomState(H + W)
    pix = (rng.rand(2, 40, 2) * [W + 20, H + 20] - 10).astype(np.float32)
    dep = (rng.rand(2, 40) * 4 + 0.5).astype(np.float32)
    pix[:, 33] = pix[:, 30]  # face 15 sits where faces 10 and 20 do: exact ties
    dep[:, 33] = dep[:, 30]
    faces = rng.randint(0, 30, (n_faces, 3))
    faces[min(10, n_faces - 1)] = faces[min(20, n_faces - 1)] = [30, 31, 32]
    faces[min(15, n_faces - 1)] = [33, 31, 32]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    face_uv = t(rng.rand(n_faces, 3, 2).astype(np.float32))
    args = (t(pix), t(dep), t(faces.astype(np.int64)), H, W, face_uv, True)
    _raster_equal(raster.rasterize_cuda(*args), raster.rasterize_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 24, 32])
def test_raster_kernel_runs_large_frame_batches(cuda, mesh10, B):
    """The TPU kernel faults at frame batch 24 and 32; here every frame of a
    batch of B equals the batch-8 result for its pose."""
    m = mesh10
    ref = raster.rasterize_cuda(m["pix"], m["dep"], m["faces"], m["H"], m["W"], m["face_uv"], False)
    idx = torch.arange(B, device=cuda) % 8
    got = raster.rasterize_cuda(m["pix"][idx], m["dep"][idx], m["faces"], m["H"], m["W"], m["face_uv"], False)
    torch.cuda.synchronize()
    for k in ("face_index", "depth", "uv"):
        assert torch.equal(getattr(got, k), getattr(ref, k)[idx])


@pytest.mark.cuda
def test_raster_kernel_matches_plain_on_a_crowded_tile(cuda):
    pix, dep, faces, H, W, face_uv = _crowded_case(cuda)
    args = (pix, dep, faces, H, W, face_uv, True)
    got, buf = raster._launch(*args)
    _raster_equal(got, raster.rasterize_reference(*args))
    B, F = pix.shape[0], faces.shape[0]
    scratch = raster.scratch_views(buf, B, F, H, W)
    g = raster.layout(B, F, H, W)
    tile = g.ntx + 1  # tile (1, 1)
    assert (scratch.end - scratch.start)[:, tile].min().item() >= 2000 > 4 * g.stage
    assert (got.face_index[:, 16:32, 16:32] >= 0).all()


@pytest.mark.cuda
def test_raster_kernel_matches_plain_on_the_dense_mesh(cuda, mesh30):
    """85,562 faces (mesh_density=30) at frame batch 2."""
    m = mesh30
    args = (m["pix"][:2], m["dep"][:2], m["faces"], m["H"], m["W"], m["face_uv"], False)
    got = raster.rasterize_cuda(*args)
    want = raster.rasterize_reference(*args)
    _raster_equal(got, want)
    assert 0.02 < (want.face_index >= 0).float().mean().item() < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crowded", "mesh10", "mesh30"])
def test_raster_kernel_reruns_are_bit_identical(cuda, case, request):
    if case == "crowded":
        pix, dep, faces, H, W, face_uv = _crowded_case(cuda)
    else:
        m = request.getfixturevalue(case)
        pix, dep, faces, H, W, face_uv = m["pix"], m["dep"], m["faces"], m["H"], m["W"], m["face_uv"]
    first = raster.rasterize_cuda(pix, dep, faces, H, W, face_uv, True)
    for _ in range(3):
        again = raster.rasterize_cuda(pix, dep, faces, H, W, face_uv, True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crowded", "mesh10"])
def test_raster_kernel_lists_faces_by_their_tile_ranges(cuda, case, request):
    """The setup's records and rectangles, each tile's list and each coarse
    bin's list equal the numpy emulation's (tests/raster_emulation.py, which
    the CPU tests hold to the plain version); lists in any order."""
    import numpy as np

    if case == "crowded":
        pix, dep, faces, H, W, face_uv = _crowded_case(cuda)
    else:
        m = request.getfixturevalue(case)
        pix, dep, faces, H, W, face_uv = m["pix"][:2], m["dep"][:2], m["faces"], m["H"], m["W"], m["face_uv"]
    B, F = pix.shape[0], faces.shape[0]
    _, buf = raster._launch(pix, dep, faces, H, W, face_uv, False)
    got = raster.Scratch(*(a.cpu().numpy() for a in raster.scratch_views(buf, B, F, H, W)))
    rec, rect, tiles, bins = raster_emulation.emulate_setup(
        *(a.cpu().numpy() for a in (pix, dep, faces, face_uv)), H, W)
    live = rect[..., 0] <= rect[..., 1]
    np.testing.assert_array_equal(got.rect, rect)
    np.testing.assert_array_equal(got.rec[live], rec[live])
    for b in range(B):
        for t, want in enumerate(tiles[b]):
            assert got.tile_count[b, t] == got.end[b, t] - got.start[b, t] == len(want)
            assert sorted(got.tile_list[got.start[b, t]:got.end[b, t]]) == want
        for k, want in enumerate(bins[b]):
            assert sorted(got.bin_list[b, k, :got.bin_count[b, k]]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H,W", [(8, 85_562, 1024, 667), (2, 2005, 48, 48), (1, 5, 1, 1), (2, 300, 61, 77),
                                     (3, 64, 17, 300), (1, 10, 4000, 4000)])
def test_raster_layout_matches_the_emulation(cuda, B, F, H, W):
    """The library's constants, tile grid, coarse bins and scratch offsets
    (csrc/raster.cu owns them) are the ones the CPU emulation models."""
    g = raster.layout(B, F, H, W)
    e = raster_emulation
    assert (g.tile, g.small_tiles, g.stage, g.max_bins) == (e.TILE, e.SMALL_TILES, e.STAGE, e.MAX_BINS)
    assert tuple(g[4:9]) == tuple(e.layout(H, W)) and g.nbins <= g.max_bins
    assert g.offsets == e.scratch_offsets(B, F, H, W)
    assert raster.library().raster_scratch_bytes(B, F, H, W) == g.offsets[-1]


@pytest.mark.cuda
def test_raster_kernel_rejects_what_it_does_not_take(cuda):
    pix = torch.rand(1, 3, 2, device=cuda)
    dep = torch.ones(1, 3, device=cuda)
    faces = torch.tensor([[0, 1, 2]], device=cuda)
    with pytest.raises(ValueError, match="float32"):
        raster.rasterize_cuda(pix.double(), dep, faces, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        raster.rasterize_cuda(pix.cpu(), dep.cpu(), faces.cpu(), 4, 4)


@pytest.mark.cuda
def test_body_renderer_card_matches_cpu(cuda):
    """A small avatar through render_sequence_multicam on the card (raster
    kernel) and on the CPU (plain version): uint8 within one count."""
    import numpy as np

    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer, Camera
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets
    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig

    cfg = RendererConfig(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_pose_enc_channels=8,
                         n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32,
                         view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
                         image_height=96, image_width=64)
    assets = make_synthetic_assets(cfg)
    model = BodyAvatar(cfg, assets)
    model.reset_parameters(torch.Generator().manual_seed(0))
    K = np.array([[80.0, 0, 32], [0, 80.0, 48], [0, 0, 1]], np.float32)
    cams = {n: Camera(campos=np.array([dx, -3.0, 1.0], np.float32), K=K,
                      Rt=np.array([[1, 0, 0, -dx], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32))
            for n, dx in (("cam0", 0.0), ("cam1", 0.5))}
    rng = np.random.RandomState(1)
    pose = (rng.randn(5, 104) * 0.1).astype(np.float32)
    face = (rng.randn(5, 256) * 0.1).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        before = launch_counts[raster.NAME]
        out[dev] = BodyRenderer(cfg, assets, model.state_dict(), cams, frame_batch=4,
                                device=dev).render_sequence_multicam(pose, face)
        if dev == "cuda":
            assert launch_counts[raster.NAME] - before == 2 * 2  # 2 frame batches x 2 cameras
    diff = np.abs(out["cuda"].astype(int) - out["cpu"].astype(int))
    either = out["cuda"].any(-1) | out["cpu"].any(-1)
    assert (diff.max(-1) <= 1)[either].mean() >= 0.999
    assert (out["cuda"].any(-1) == out["cpu"].any(-1)).mean() >= 0.999


@pytest.mark.cuda
def test_avatar_train_step_card_matches_cpu(cuda):
    """One avatar train step at a small config (three cameras, 96 x 64
    image), card (raster kernel) against CPU (plain versions), by
    chip_smoke's ``avatar_step_parity``: loss parts 1e-5 relative, every
    gradient 1e-4 of its largest element, params within 2 lr, the identity
    camera unmoved, the card's raster equal to the plain version's."""
    import numpy as np

    from audio2photoreal_tpu_torch.apps.render_pipeline import Camera
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig
    from chip_smoke import _avatar_frames, _avatar_model, avatar_step_parity

    cfg = RendererConfig(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=32, n_pose_enc_channels=8,
                         n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32,
                         view_unet_ftrs=4, encoder_in_size=64, face_tex_size=64, n_face_verts=64,
                         image_height=96, image_width=64, n_cameras=3)
    assets = make_synthetic_assets(cfg)
    K = np.array([[80.0, 0, 32], [0, 80.0, 48], [0, 0, 1]], np.float32)
    cams = {n: Camera(campos=np.array([dx, -3.0, 1.0], np.float32), K=K,
                      Rt=np.array([[1, 0, 0, -dx], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32))
            for n, dx in (("cam0", 0.0), ("cam1", 0.5), ("cam2", -0.5))}
    rng = np.random.RandomState(0)
    batch = _avatar_frames(assets, cams, [0, 2, 1], rng, cfg)
    noise = [rng.randn(3, n).astype(np.float32) for n in (cfg.n_embs, cfg.n_face_embs)]
    res = avatar_step_parity(_avatar_model(cfg, assets, 0), batch, noise, 1e-3)
    assert all(res["checks"].values()), res
    assert 0.05 < res["numbers"]["raster_coverage"] < 0.9


# --------------------------------------------------------- display pass -- #


def _display_inputs(cuda, B, H, W, seed=0):
    """The render's ranges: a raw texture of N(0, 0.3), shadow in [0, 1], a
    mean up to 200, std 35 (the JAX package's own test of its kernel)."""
    g = torch.Generator(device=cuda).manual_seed(seed + H * W)
    tex = torch.randn((B, 3, H, W), generator=g, device=cuda) * 0.3
    shadow = torch.rand((B, 1, H, W), generator=g, device=cuda)
    mean = torch.rand((3, H, W), generator=g, device=cuda) * 200.0
    return tex, shadow, mean, 35.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(2, 512, 512), (3, 200, 2048), (2, 61, 77), (8, 2048, 2048)])
def test_display_kernel_matches_plain(cuda, B, H, W):
    """Planar and packed modes; H 200 and 61 are no multiple of a 64-row
    tile, and 61 x 77 texels take the kernel's one-texel path."""
    args = _display_inputs(cuda, B, H, W)
    want, want_rec = display_pack.finalize_display_reference(*args)
    before = launch_counts[display_pack.NAME]
    got, rec = display_pack.finalize_display(*args)
    packed = display_pack.finalize_display_packed(*args)
    assert launch_counts[display_pack.NAME] - before == 2
    assert torch.equal(rec, want_rec)
    diff = (got - want).abs()
    assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.9999
    assert packed.dtype == torch.int32 and packed.shape == (B, H, W)
    assert torch.equal(packed, display_pack.pack_rgb8(got))
    got2, none = display_pack.finalize_display(*args, with_tex_rec=False)
    assert none is None and torch.equal(got2, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(2, 512, 512), (3, 200, 2047), (8, 2048, 2048)])
def test_display_kernel_bf16_matches_plain(cuda, B, H, W):
    """The bf16 instantiation: a bf16 texture and shadow (an f32 shadow is
    cast), tex_rec in bf16 bit for bit with the plain bf16 chain, the
    display values by the f32 kernel's bar; counted as its own kernel."""
    tex, shadow, mean, std = _display_inputs(cuda, B, H, W)
    args = (tex.to(torch.bfloat16), shadow.to(torch.bfloat16), mean, std)
    want, want_rec = display_pack.finalize_display_reference(*args)
    before = {k: launch_counts[k] for k in (display_pack.NAME, display_pack.BF16_NAME)}
    got, rec = display_pack.finalize_display(*args)
    got_f32_shadow, _ = display_pack.finalize_display(args[0], shadow, mean, std)
    packed = display_pack.finalize_display_packed(*args)
    assert launch_counts[display_pack.BF16_NAME] - before[display_pack.BF16_NAME] == 3
    assert launch_counts[display_pack.NAME] == before[display_pack.NAME]
    assert rec.dtype == torch.bfloat16 and got.dtype == torch.float32 and torch.equal(rec, want_rec)
    diff = (got - want).abs()
    assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.9999
    assert torch.equal(got_f32_shadow, got) and torch.equal(packed, display_pack.pack_rgb8(got))


@pytest.mark.cuda
def test_display_kernel_rejects_what_it_does_not_take(cuda):
    tex, shadow, mean, std = _display_inputs(cuda, 1, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        display_pack.finalize_display(tex.double(), shadow.double(), mean.double(), std)
    with pytest.raises(ValueError, match="shadow"):
        display_pack.finalize_display(tex, shadow[:, :, :4], mean, std)
    with pytest.raises(ValueError, match="different devices"):
        display_pack.finalize_display(tex, shadow, mean.cpu(), std)


@pytest.mark.cuda
def test_face_denoiser_step_card_matches_cpu(cuda):
    """The face model at full width (latent 512, 8 layers, 4 heads: Dh 128),
    encode on 20 s of audio (lip regressor, rotary cond-encoder at 1998
    tokens through the kernel) and one cached CFG step, card vs CPU."""
    import copy

    import numpy as np

    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    cfg = DenoiserConfig(data_format="face", nfeats=256, latent_dim=512, ff_size=1024, num_layers=8,
                         num_heads=4, flash_attention=True)
    cpu = FiLMDenoiser(cfg).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(1)
    audio = rng.randn(1, cfg.max_seq_length * 1600, 2).astype(np.float32)
    x = rng.randn(1, cfg.max_seq_length, cfg.nfeats).astype(np.float32)
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        before = launch_counts[flash_attn.NAME]
        with torch.no_grad():
            cond = model.encode_conditioning(torch.from_numpy(audio).to(dev))
            fn = cfg_model_fn_cached(model, cond, 10.0)
            out[dev] = fn(torch.from_numpy(x).to(dev), torch.tensor([999], device=dev)).cpu()
        if dev == "cuda":  # the cond-encoder's 2 self-attentions, then 8 layers x 2
            assert launch_counts[flash_attn.NAME] - before == cfg.cond_encoder_layers + 2 * cfg.num_layers
    assert torch.isfinite(out["cuda"]).all()
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-3


@pytest.fixture(scope="module")
def full_guide():
    """``GuideConfig()`` (latent 512, 6 layers, 4 heads, 1024 tokens) with
    random weights, on the CPU, and 20 s of audio for 2 clips."""
    import numpy as np

    from audio2photoreal_tpu_torch.core.config import GuideConfig
    from audio2photoreal_tpu_torch.models.guide import GuideTransformer

    model = GuideTransformer(GuideConfig()).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    audio = np.random.RandomState(2).randn(2, 600 * 1600, 2).astype(np.float32)
    return model, torch.from_numpy(audio)


@pytest.mark.cuda
def test_guide_logits_card_match_cpu(cuda, full_guide):
    import copy

    cpu, audio = full_guide
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, cpu.cfg.tokens + 1, (2, 81), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = cpu.decode_logits(tokens, cpu.encode_conditioning(audio))
        got = card.decode_logits(tokens.to(cuda), card.encode_conditioning(audio.to(cuda))).cpu()
    assert got.shape == (2, 81, 1024) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_guide_cached_generate_equals_uncached_on_the_card(cuda, full_guide):
    import copy

    card = copy.deepcopy(full_guide[0]).to(cuda)
    audio = full_guide[1].to(cuda)
    out = {}
    for use_cache in (True, False):
        g = torch.Generator(device=cuda).manual_seed(4)
        out[use_cache] = card.generate(audio, 80, g, 0.94, use_cache).cpu()
    assert out[True].shape == (2, 80) and int(out[True].min()) >= 0 and int(out[True].max()) < 1024
    assert torch.equal(out[True], out[False])


@pytest.mark.cuda
def test_guide_keyframer_on_the_card(cuda, full_guide, tmp_path):
    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, GuideKeyframer
    from audio2photoreal_tpu_torch.core.config import GuideConfig, VQConfig, save_config
    from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec

    codec = TemporalVertexCodec(VQConfig(kmeans_init=False))
    codec.reset_parameters(torch.Generator().manual_seed(1))
    for name, model, section in (("guide", full_guide[0], dict(guide=GuideConfig())),
                                 ("vq", codec, dict(vq=codec.cfg))):
        save_config(str(tmp_path / name), **section)
        torch.save(model.state_dict(), str(tmp_path / name / MODEL_FILE))
    keyframer = GuideKeyframer(str(tmp_path / "guide"), str(tmp_path / "vq"), cuda)
    kf = keyframer(full_guide[1].to(cuda), 20, torch.Generator(device=cuda).manual_seed(5))
    assert kf.shape == (2, 20, 104) and kf.device.type == "cuda" and torch.isfinite(kf).all()


def _module_case(what):
    """(module, fn(module, *inputs), inputs, grads) of the modules without a
    kernel of their own, at small sizes, from seed 0."""
    import numpy as np

    from audio2photoreal_tpu_torch.models import audio_encoder
    from audio2photoreal_tpu_torch.render import layers_elr

    rng = np.random.RandomState(0)
    g = torch.Generator().manual_seed(0)
    frames = (rng.randn(2, 8, 1600) * 0.1).astype(np.float32)
    img = rng.randn(2, 8, 32, 32).astype(np.float32)
    if what.startswith("audio_tcn"):
        m = audio_encoder.AudioTcn(16)
        m.reset_parameters(g)
        return (m.train() if what == "audio_tcn_train" else m.eval()), (lambda m, a: m(a)), (frames,), \
            what == "audio_tcn_train"
    if what == "downsampler":
        m = audio_encoder.Wav2VecDownsampler(24, 20)
        m.reset_parameters(g)
        return m, (lambda m, a: m(a, 30)), (rng.randn(2, 100, 20).astype(np.float32),), True
    if what == "conv_untied":
        m = layers_elr.Conv2dELR(8, 6, 3, padding=1, untied=True, height=32, width=32, lr_mul=0.5)
        m.bias.data.normal_(generator=g)
        return m, (lambda m, a: m(a)), (img,), True
    if what == "conv_transposed_box":
        m = layers_elr.Conv2dELR(8, 6, 3, stride=2, padding=1, output_padding=1, transpose=True,
                                 fuse_box_filter=True)
        return m, (lambda m, a: m(a)), (img,), True
    if what == "blur":
        return torch.nn.Identity(), (lambda m, a: layers_elr.blur_downsample(a, 4, 2, "replicate")), (img,), False
    convs = torch.nn.ModuleList(layers_elr.Conv2dELR(8 + 2, 8, 4, stride=2, padding=1, transpose=True)
                                for _ in range(3))
    return convs, (lambda m, a, b: layers_elr.concat_pyramid(list(m), a, b, every_other=False, transposed=True)), \
        (img[:, :, :8, :8].copy(), rng.randn(2, 2, 64, 64).astype(np.float32)), True


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["audio_tcn", "audio_tcn_train", "downsampler", "conv_untied",
                                  "conv_transposed_box", "blur", "pyramid"])
def test_modules_without_a_kernel_match_the_cpu(cuda, what):
    """AudioTcn, Wav2VecDownsampler and the ELR layers on the card against the
    CPU (chip_smoke.py's tcn_elr_parity at small sizes): outputs within 2e-5
    of their scale, gradients of sum(out * R) within 1e-4 of each tensor's
    largest element; the TCN's dropout on the same keep masks."""
    import copy

    import numpy as np

    from audio2photoreal_tpu_torch.models import audio_encoder

    module, fn, inputs, grads = _module_case(what)
    masks, real = [], audio_encoder.draw_keep
    rng = np.random.RandomState(1)

    def keep(shape, generator, device):
        if len(masks) < 6:
            masks.append(torch.from_numpy(rng.rand(*shape) < audio_encoder.TCN_KEEP))
        keep.n += 1
        return masks[(keep.n - 1) % 6].to(device)

    keep.n = 0
    audio_encoder.draw_keep = keep
    out = {}
    try:
        for dev in (cuda, torch.device("cpu")):
            m = copy.deepcopy(module).to(dev)
            y = fn(m, *(torch.from_numpy(a).to(dev) for a in inputs))
            if grads:
                r = torch.from_numpy(np.random.RandomState(2).randn(*y.shape).astype(np.float32)).to(dev)
                (y * r).sum().backward()
            out[dev.type] = (y.detach().cpu(), {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None})
    finally:
        audio_encoder.draw_keep = real
    (gy, gg), (cy, cg) = out["cuda"], out["cpu"]
    assert torch.isfinite(gy).all() and (gy - cy).abs().max() <= 2e-5 * cy.abs().max()
    assert sorted(gg) == sorted(cg) and (not grads or cg)
    for n in cg:
        assert (gg[n] - cg[n]).abs().max() <= 1e-4 * cg[n].abs().max(), n
    assert keep.n == (12 if what == "audio_tcn_train" else 0)
