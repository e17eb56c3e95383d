"""The FLOP counters against ``torch.utils.flop_counter.FlopCounterMode`` at
small shapes on the CPU, forward and backward, so ``mfu.*`` and
``*_roofline.*`` rest on a checked count."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs
from portbench.counters import attention, film, frontend
from portbench.reference import steps as ref
from portbench.reference.config import DenoiserConfig
from portbench.reference.hashmask import attention as plain_attention

T = 60  # frames: 198 audio tokens


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _model(cls, cfg):
    return ref.build(cls, cfg, lambda m: inputs.make_weights(m, 1, "cpu"), "cpu")


def _denoiser(fmt: str) -> DenoiserConfig:
    return DenoiserConfig(data_format=fmt, nfeats=256 if fmt == "face" else 104, latent_dim=32, ff_size=64,
                          num_layers=2, num_heads=2, max_seq_length=T, cond_encoder_layers=1, flash_attention=True)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_attention(kind):
    s = {"B": 2, "H": 3, "Tq": 20, "Tk": 36, "Dh": 8}
    q = torch.randn(2, 3, 20, 8, requires_grad=True)
    k, v = (torch.randn(2, 3, 36, 8, requires_grad=True) for _ in range(2))
    out = plain_attention(q, k, v, 0.1, 7)
    if kind == "fwd":
        assert _counted(lambda: plain_attention(q, k, v, 0.1, 7)) == attention.model_flops("fwd", s)
    else:
        assert _counted(lambda: out.sum().backward()) == attention.model_flops("bwd", s)
    assert attention.kernel_flops("bwd", s) == 1.25 * attention.model_flops("bwd", s)


def test_face_train_step():
    cfg = _denoiser("face")
    model = _model(ref.FiLMDenoiser, cfg).train()
    B = 3
    x = torch.randn(B, T, 256)
    t = torch.randint(0, 1000, (B,))
    feats = torch.randn(B, film.tokens(T), 1024)
    lip = torch.randn(B, T, 1014)

    def step():
        out = model(x, t, None, cond_drop_prob=0.2, generator=torch.Generator().manual_seed(1),
                    audio_features=feats, lip_verts=lip)
        out.square().mean().backward()

    assert _counted(step) == film.train_step_flops(cfg, B, T)


@pytest.mark.parametrize("fmt", ["face", "pose"])
def test_denoise_pass_and_encode(fmt):
    cfg = _denoiser(fmt)
    model = _model(ref.FiLMDenoiser, cfg)
    B = 2
    audio = torch.randn(B, T * 1600, 2)
    kf = torch.randn(B, T // 30, 104) if fmt == "pose" else None
    with torch.no_grad():
        lip, cond = ref.encode(model, audio, kf)
        fn = ref.guided(model, cond, 2.0)
        x, tt = torch.randn(B, T, cfg.nfeats), torch.full((B,), 10)
        c = frontend.Count()
        film.denoise(c, cfg, 2 * B, T)
        assert _counted(lambda: fn(x, tt)) == c.fwd
        whole = film.sample_call_flops(cfg, None, B, T, 1)
        assert _counted(lambda: (ref.encode(model, audio, kf), ref.guided(model, cond, 2.0))) == whole["encode"]


def test_guide_cached_decode_and_vq():
    from audio2photoreal_tpu_torch.apps.generate import GuideKeyframer
    from audio2photoreal_tpu_torch.core import config as pc
    from audio2photoreal_tpu_torch.models.guide import GuideTransformer
    from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec

    g, v = pc.GuideConfig(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, tokens=64), pc.VQConfig(emb_width=16,
                                                                                                        code_dim=64)
    kf = object.__new__(GuideKeyframer)
    kf.guide, kf.codec = GuideTransformer(g).eval(), TemporalVertexCodec(v).eval()
    inputs.load_weights(kf.guide, 2, "cpu")
    inputs.load_weights(kf.codec, 3, "cpu")
    audio = torch.randn(2, T * 1600, 2)
    c = frontend.Count()
    film.guide_call(c, g, v, 2, T, T // 30)
    with torch.no_grad():
        assert _counted(lambda: kf(audio, T // 30, torch.Generator().manual_seed(0), 0.9)) == c.fwd
    assert film.sample_call_flops(_denoiser("pose"), types.SimpleNamespace(guide=kf.guide, codec=kf.codec), 2, T,
                                  3)["keyframer"] == c.fwd
