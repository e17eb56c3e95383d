"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without a CUDA device.  This file imports no JAX,
so it also runs where JAX is not installed, without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances with TF32 off: f32 1e-5 for unit-normal inputs, bf16 2e-2.
"""

import pytest
import torch

from audio2photoreal_tpu_torch.core.config import DenoiserConfig
from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_reference
from audio2photoreal_tpu_torch.models.film_transformer import CondTokens, FiLMDenoiser


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
    before = launch_counts[flash_attn.NAME]
    got = flash_attention(q, k, v, kv_valid, causal=masked)
    assert launch_counts[flash_attn.NAME] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_reference(q, k, v, kv_valid, causal=masked)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())


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
