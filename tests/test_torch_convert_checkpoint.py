"""The reference-checkpoint converter of the port
(apps/convert_checkpoint.py) against the JAX package's, on the CPU.

A reference-layout ``checkpoints/`` tree (README.md:178-198) is written from
random port modules, whose state dicts carry the reference's names: a pose
and a face denoiser at the widths the converter derives from
``data_format`` (latent 256 / 512, FF 1024; 1 layer), a VQ (width 16, 32
codes, depth 2) saved under ``"net"``, a guide (latent 64, 1 layer) under
``"model_state_dict"`` with the reference's 1998-row ``null_cond_embed``,
the standalone lip regressor, each beside the ``args.json`` fields the JAX
package's own CLI test writes (tests/test_convert_cli.py:55-93).  The
denoisers' files also hold keys no port module has (``REFERENCE_ONLY``:
rotary frequency tables, the rest of vq-wav2vec).  Both converters run on
the tree; for every family the port's ``config.json`` equals the JAX
converter's, and the port's ``model.pt`` equals, tensor for tensor and bit
for bit, ``convert.*_state_dict_from_jax`` of the JAX converter's params.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from audio2photoreal_tpu.apps import convert_checkpoint as j_convert
from audio2photoreal_tpu.train import checkpoints as j_checkpoints
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.apps import convert_checkpoint
from audio2photoreal_tpu_torch.apps.generate import GuideKeyframer, load_model
from audio2photoreal_tpu_torch.core.config import DenoiserConfig, GuideConfig, VQConfig
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.models.guide import GuideTransformer
from audio2photoreal_tpu_torch.models.lip_regressor import LipRegressor
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

PERSON = "PXB184"
COMMON = dict(max_seq_length=600, add_frame_cond=1, data_root=f"dataset/{PERSON}")


def _write_args(d, **kw):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "args.json"), "w") as f:
        json.dump(kw, f)


def _random(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def _with_reference_only_keys(sd, layers):
    sd = dict(sd, **{"rotary.freqs": torch.randn(32),
                     "audio_model.feature_aggregator.conv_layers.0.1.weight": torch.randn(4, 4, 2)})
    for i in range(layers):
        sd[f"seqTransDecoder.stack.{i}.rotary.freqs"] = sd["rotary.freqs"]
    return sd


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkpoints"))
    for i, fmt in enumerate(("pose", "face")):
        wide = dict(nfeats=104, latent_dim=256) if fmt == "pose" else dict(nfeats=256, latent_dim=512)
        model = _random(FiLMDenoiser(DenoiserConfig(data_format=fmt, num_layers=1, num_heads=4,
                                                    cond_encoder_layers=1, **wide)), i)
        d = os.path.join(root, "diffusion", f"c1_{fmt}")
        _write_args(d, data_format=fmt, layers=1, heads=4, noise_schedule="cosine", sigma_small=True,
                    lambda_vel=2.0 if fmt == "pose" else 0.0, not_rotary=False, num_audio_layers=1, **COMMON)
        torch.save(_with_reference_only_keys(model.state_dict(), 1), os.path.join(d, "model000000002.pt"))
        older = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}  # the latest one is converted
        torch.save(_with_reference_only_keys(older, 1), os.path.join(d, "model000000001.pt"))
    vq = _random(TemporalVertexCodec(VQConfig(emb_width=16, code_dim=32, depth=2, kmeans_init=False)), 2)
    vd = os.path.join(root, "vq", "c1_vq")
    _write_args(vd, nb_joints=104, output_emb_width=16, code_dim=32, depth=2, data_format="pose", **COMMON)
    torch.save({"net": vq.state_dict()}, os.path.join(vd, "net_iter000001.pth"))
    guide = _random(GuideTransformer(GuideConfig(tokens=32, latent_dim=64, num_layers=1, vq_depth=2)), 3)
    sd = guide.state_dict()
    sd["null_cond_embed"] = sd["null_cond_embed"][:, :1998].clone()  # the reference's rows for 600 frames
    gd = os.path.join(root, "guide", "c1_pose")
    _write_args(gd, layers=1, dim=64, num_audio_layers=2, resume_pth=os.path.join(vd, "net_iter000001.pth"),
                data_format="pose", **COMMON)
    os.makedirs(os.path.join(gd, "checkpoints"))
    torch.save({"model_state_dict": sd}, os.path.join(gd, "checkpoints", "iter-0000001.pt"))
    lip = os.path.join(root, "assets", "iter-0200000.pt")
    os.makedirs(os.path.dirname(lip))
    torch.save({"model_state_dict": _random(LipRegressor(), 4).state_dict()}, lip)
    return root


@pytest.fixture(scope="module")
def converted(tree, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("converted"))
    port = convert_checkpoint.convert_person(tree, PERSON, os.path.join(out, "port"))
    jax_out = j_convert.convert_person(tree, PERSON, os.path.join(out, "jax"))
    lip = os.path.join(tree, "assets", "iter-0200000.pt")
    port["lip"] = convert_checkpoint.convert_lip_checkpoint(lip, os.path.join(out, "port", "lip"))
    jax_out["lip"] = j_convert.convert_lip_checkpoint(lip, os.path.join(out, "jax", "lip"))
    return port, jax_out


def _config(d):
    with open(os.path.join(d, "config.json")) as f:
        return json.load(f)


def _model(d):
    return torch.load(os.path.join(d, "model.pt"), weights_only=True)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_every_family_converts_as_the_jax_converter_does(converted):
    port, jax_out = converted
    assert set(port) == set(jax_out) == {"c1_pose", "c1_face", "c1_vq", "guide_c1_pose", "lip"}
    for name in port:
        if name != "lip":
            assert _config(port[name]) == _config(jax_out[name]), name
        restored = j_checkpoints.restore(os.path.join(jax_out[name], "ckpt"), None)
        params = restored["params"]
        if name.startswith("c1_") and name != "c1_vq":
            fmt = name.split("_")[1]
            want = convert.film_denoiser_state_dict_from_jax(params, fmt, 1)
        elif name == "c1_vq":
            want = convert.vqvae_state_dict_from_jax(params, restored["vq"])
        elif name == "lip":
            want = convert.lip_regressor_state_dict_from_jax(params["params"] if "params" in params else params)
        else:
            want = convert.guide_state_dict_from_jax(params)
        _assert_same(_model(port[name]), want)


def test_converted_dirs_load_where_generate_reads_them(converted):
    port, _ = converted
    for fmt in ("pose", "face"):
        model = load_model(port[f"c1_{fmt}"], "cpu")
        assert model.cfg.data_format == fmt and model.cfg.num_layers == 1
        assert model.final_layer.weight.abs().max() > 0  # model000000002.pt's, not the zeros of 000001
    keyframer = GuideKeyframer(port["guide_c1_pose"], port["c1_vq"], "cpu")
    assert keyframer.guide.cfg.tokens == 32 and keyframer.codec.cfg.depth == 2
    assert keyframer.guide.null_cond_embed.shape[1] == 2048  # padded on load
    assert all(l._codebook.inited.item() == 1.0 for l in keyframer.codec.quantizer.layers)


def test_a_key_no_port_module_has_raises(tree, tmp_path):
    src = os.path.join(tree, "diffusion", "c1_pose")
    d = str(tmp_path / "c1_pose")
    shutil.copytree(src, d)
    path = os.path.join(d, "model000000002.pt")
    sd = torch.load(path, weights_only=True)
    torch.save(dict(sd, **{"seqTransDecoder.stack.0.bogus.weight": torch.zeros(2)}), path)
    with pytest.raises(RuntimeError, match="bogus"):
        convert_checkpoint.convert_diffusion_checkpoint(path, str(tmp_path / "out"))


def test_convert_person_converts_the_avatar(tree, tmp_path):
    """A tree with ``ca_body/data/<person>/`` converts the avatar into
    ``renderer``: ``body_dec.ckpt``'s tensors under their names (a
    full-width state dict of broadcast zeros: names and shapes are what the
    strict load checks), ``static_assets.pt`` copied, the cameras of
    ``assets/render_defaults_<person>.pth`` beside ``checkpoints/``."""
    from tests.test_torch_convert_avatar import SMALL

    from audio2photoreal_tpu_torch.render.assets import (load_render_defaults, make_synthetic_assets,
                                                         reference_static_assets)
    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig

    root = str(tmp_path / "checkpoints")
    shutil.copytree(tree, root)
    avatar = os.path.join(root, "ca_body", "data", PERSON)
    os.makedirs(avatar)
    torch.save(reference_static_assets(RendererConfig(**SMALL)), os.path.join(avatar, "static_assets.pt"))
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in BodyAvatar(RendererConfig(), make_synthetic_assets(
            RendererConfig(**SMALL))).state_dict().items()}
    sd = {k: torch.zeros(()).expand(s) for k, s in shapes.items()}
    torch.save({"model_state_dict": sd}, os.path.join(avatar, "body_dec.ckpt"))
    rd = str(tmp_path / "assets" / f"render_defaults_{PERSON}.pth")
    os.makedirs(os.path.dirname(rd))
    torch.save({"400029": {"K": torch.eye(3), "Rt": torch.eye(3, 4)}}, rd)
    out = convert_checkpoint.convert_person(root, PERSON, str(tmp_path / "out"))
    assert set(out) == {"c1_pose", "c1_face", "c1_vq", "guide_c1_pose", "renderer"}
    got = _model(out["renderer"])
    assert {k: v.shape for k, v in got.items()} == shapes and not any(v.any() for v in got.values())
    with open(os.path.join(avatar, "static_assets.pt"), "rb") as a, \
            open(os.path.join(out["renderer"], "static_assets.pt"), "rb") as b:
        assert a.read() == b.read()
    cams = np.load(os.path.join(out["renderer"], "cameras.npz"))
    assert list(cams["names"]) == ["400029"]
    np.testing.assert_array_equal(cams["Rt"][0], load_render_defaults(rd)["400029"].Rt)
