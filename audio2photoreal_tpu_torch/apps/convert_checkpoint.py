"""Convert released reference checkpoints -> this port's checkpoint dirs.

Counterpart of ``audio2photoreal_tpu/apps/convert_checkpoint.py``.  The
reference user's flow is ``scripts/download_allmodels.sh`` -> a
``checkpoints/`` tree of torch ``.pt`` files, each re-hydrated from the
``args.json`` beside it (reference: README.md:178-198, demo/demo.py:26-66,
model/vqvae.py:18-31, model/diffusion.py:244-269).  This CLI turns that tree
into directories of ``config.json`` (the JAX package's sidecar format) +
``model.pt`` (a state_dict under the reference's names, which the port's
modules keep) that ``apps/generate.py`` (``--model_path``,
``--resume_trans``, ``--resume_vq``) and the trainers read.

The state dicts need no renaming.  Each is loaded into its port module with
``strict=True`` before it is saved, so a key the port lacks, or one it
misses, raises; the only keys dropped are those of ``REFERENCE_ONLY``
(``AVATAR_REFERENCE_ONLY`` for the avatar), which the JAX package's
converters (``train/convert.py``) never read either.  The ca_body avatar (``convert_avatar_checkpoint``): a person's
``ca_body/data/<person>/`` (``body_dec.ckpt`` + ``static_assets.pt``) → a
renderer bundle (``render/assets.py``) that
``apps/render_pipeline.py:load_body_renderer`` renders; its cameras come
from ``render_defaults_<person>.pth`` when there is one, else a frontal rig
aimed at the template's centre (the JAX converter's fallback).

Per-model usage (paths follow the reference README)::

    python -m audio2photoreal_tpu_torch.apps.convert_checkpoint \\
        --diffusion checkpoints/diffusion/c1_pose/model000340000.pt --out out/c1_pose
    python -m audio2photoreal_tpu_torch.apps.convert_checkpoint \\
        --vq checkpoints/vq/c1_vq/net_iter300000.pth --out out/c1_vq
    python -m audio2photoreal_tpu_torch.apps.convert_checkpoint \\
        --guide checkpoints/guide/c1_pose/checkpoints/iter-0100000.pt \\
        --vq_args checkpoints/vq/c1_vq/args.json --out out/c1_guide
    python -m audio2photoreal_tpu_torch.apps.convert_checkpoint \\
        --avatar checkpoints/ca_body/data/PXB184 \\
        --render_defaults assets/render_defaults_PXB184.pth --out out/renderer

or a whole person: ``--checkpoints_root checkpoints/ --person PXB184 --out
converted/``; there the avatar's cameras are read from
``assets/render_defaults_<person>.pth`` beside ``checkpoints/`` (the
reference repo's layout).  It runs on the host: checkpoints are read with
``torch.load`` (``weights_only``: tensors and plain containers only) on the
CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from audio2photoreal_tpu_torch.core.config import (
    DataConfig,
    DenoiserConfig,
    DiffusionConfig,
    GuideConfig,
    VQConfig,
    save_config,
)
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.models.guide import GuideTransformer
from audio2photoreal_tpu_torch.models.lip_regressor import LipRegressor
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
from audio2photoreal_tpu_torch.render.assets import (STATIC_ASSETS_FILE, Camera, load_render_defaults,
                                                     make_synthetic_assets, save_renderer_bundle)
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig
from audio2photoreal_tpu_torch.train.checkpoints import save_model

# Keys of a released state dict that no port module has and no converter of
# the JAX package reads (train/convert.py): the rest of the frozen wav2vec
# models beyond the parts the models run (vq-wav2vec's aggregator and
# quantizer behind ``audio_model``; wav2vec_large's parts beyond its
# extractor and aggregator in the lip regressor) and rotary_embedding_torch's
# frequency tables, which the port computes (ops/rotary.py).
REFERENCE_ONLY = (
    r"^audio_model\.(?!feature_extractor\.)",
    r"(^|\.)audio_encoder\.wav2vec_model\.(?!feature_extractor\.|feature_aggregator\.)",
    r"(^|\.)rotary\.freqs$",
)
# What a ca_body AutoEncoder's state dict (mesh_vae_drivable.py:AutoEncoder)
# holds beyond the parameters of the port's BodyAvatar: the buffers of its
# static assets, which the port rebuilds from static_assets.pt (the texture
# mean, the condition and region masks, the AO mean, the frontal view, the
# geometry, seam and LBS modules wherever a submodule holds them) and the
# training-only modules (the per-camera calibration, the blur, the pixel
# bias and the differentiable renderer), which the inference bundle does not
# run.  The JAX converter (train/convert.py:convert_body_avatar) reads none
# of these.
AVATAR_REFERENCE_ONLY = (
    r"(^|\.)(tex_mean|tex_std|ao_mean|frontal_view|\w*mask)$",
    r"(^|\.)(geo_fn|lbs_fn|seam_sampler\w*)\.",
    r"^(cal|pixel_cal|learn_blur|renderer)\.",
)
AVATAR_CKPT = "body_dec.ckpt"


def _load_torch(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _args_json(near: str) -> Dict[str, Any]:
    d = near if os.path.isdir(near) else os.path.dirname(near)
    p = os.path.join(d, "args.json")
    if not os.path.exists(p):
        raise FileNotFoundError(f"no args.json next to {near}: the reference keeps one beside every "
                                "checkpoint (README.md:198)")
    with open(p) as f:
        return json.load(f)


def _person_from_root(data_root: str) -> str:
    # "dataset/PXB184/" -> "PXB184" (reference utils/misc get_person_num role)
    return os.path.basename(os.path.normpath(data_root)) if data_root else "PXB184"


def _data_config(args: Dict[str, Any], add_frame_cond: Optional[int]) -> DataConfig:
    return DataConfig(
        data_root=args.get("data_root", ""),
        person=_person_from_root(args.get("data_root", "")),
        data_format=args.get("data_format", "pose"),
        max_seq_length=int(args.get("max_seq_length", 600)),
        add_frame_cond=add_frame_cond,
    )


def _load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor], assign: bool = False,
               reference_only: Tuple[str, ...] = REFERENCE_ONLY) -> torch.nn.Module:
    """``sd`` less those of its keys that ``model`` lacks and that match
    ``reference_only``, into ``model``, strictly (``assign``: the model takes
    ``sd``'s tensors themselves)."""
    own = set(model.state_dict())
    drop = [k for k in sd if k not in own and any(re.search(p, k) for p in reference_only)]
    model.load_state_dict({k: v for k, v in sd.items() if k not in drop}, strict=True, assign=assign)
    return model


def _write(out_dir: str, model: torch.nn.Module, **configs) -> str:
    os.makedirs(out_dir, exist_ok=True)
    if configs:
        save_config(out_dir, **configs)
    save_model(out_dir, model)
    return out_dir


# ------------------------------------------------------------------ #
# diffusion (face / pose FiLMTransformer)
# ------------------------------------------------------------------ #


def convert_diffusion_checkpoint(model_path: str, out_dir: str) -> str:
    """model00XXXX.pt + its args.json -> denoiser checkpoint dir.  The
    configs as utils/model_util.py:41-115 derives them: nfeats and latent
    width from ``data_format``, 1000 steps, x_0 prediction,
    ``sigma_small`` -> fixed_small."""
    args = _args_json(model_path)
    fmt = args["data_format"]
    num_audio_layers = int(args.get("num_audio_layers", 3))
    mcfg = DenoiserConfig(
        data_format=fmt,
        nfeats=256 if fmt == "face" else 104,
        latent_dim=512 if fmt == "face" else 256,
        ff_size=1024,
        num_layers=int(args["layers"]),
        num_heads=int(args["heads"]),
        cond_feature_dim=1024,
        max_seq_length=int(args.get("max_seq_length", 600)),
        use_rotary=not args.get("not_rotary", False),
        cond_encoder_layers=num_audio_layers,
    )
    dcfg = DiffusionConfig(
        steps=1000,
        schedule=args.get("noise_schedule", "cosine"),
        predict="xstart",
        var_type="fixed_small" if args.get("sigma_small", True) else "fixed_large",
        timestep_respacing="",
        lambda_vel=float(args.get("lambda_vel", 0.0)),
    )
    datacfg = _data_config({**args, "data_format": fmt}, args.get("add_frame_cond"))
    model = _load_into(FiLMDenoiser(mcfg), _load_torch(model_path))
    print(f"[diffusion:{fmt}] {model_path} -> {out_dir}")
    return _write(out_dir, model, denoiser=mcfg, diffusion=dcfg, data=datacfg)


# ------------------------------------------------------------------ #
# VQ tokenizer
# ------------------------------------------------------------------ #


def convert_vq_checkpoint(net_path: str, out_dir: str) -> str:
    """net_iterXXXX.pth + its args.json -> VQ checkpoint dir (the
    setup_tokenizer contract, model/vqvae.py:18-31: the state dict under
    ``"net"``).  The codebooks keep the file's ``inited`` flags; a file
    without them loads as inited."""
    args = _args_json(net_path)
    vcfg = VQConfig(
        nfeats=int(args.get("nb_joints", 104)),
        emb_width=int(args["output_emb_width"]),
        code_dim=int(args["code_dim"]),
        depth=int(args["depth"]),
    )
    ckpt = _load_torch(net_path)
    model = _load_into(TemporalVertexCodec(vcfg), ckpt["net"] if "net" in ckpt else ckpt)
    print(f"[vq] {net_path} -> {out_dir}")
    return _write(out_dir, model, vq=vcfg, data=_data_config(args, args.get("add_frame_cond", 1)))


# ------------------------------------------------------------------ #
# guide transformer
# ------------------------------------------------------------------ #


def convert_guide_checkpoint(
    ckpt_path: str,
    out_dir: str,
    vq_args_path: Optional[str] = None,
    checkpoints_root: Optional[str] = None,
) -> str:
    """guide/<c>/checkpoints/iter-XXXX.pt -> guide checkpoint dir.  The
    vocabulary comes from the VQ the guide was trained against
    (model/diffusion.py:244-259: its args.json, found through the guide's
    ``resume_pth``, or ``vq_args_path``).  A 1998-row ``null_cond_embed``
    is zero-padded on load (``GuideTransformer._load_from_state_dict``)."""
    args = _args_json(os.path.dirname(os.path.dirname(ckpt_path)))
    if vq_args_path is None:
        resume = args.get("resume_pth", "")
        for c in (resume, os.path.join(checkpoints_root or ".", resume)):
            if c and os.path.exists(os.path.join(os.path.dirname(c), "args.json")):
                vq_args_path = os.path.join(os.path.dirname(c), "args.json")
                break
    if vq_args_path is None:
        raise FileNotFoundError("cannot locate the VQ args.json (trans_args['resume_pth'] not found): "
                                "pass --vq_args")
    with open(vq_args_path) as f:
        vq_args = json.load(f)
    if int(args.get("num_audio_layers", 2)) != 2:
        raise ValueError(f"the guide's audio pre-net has 2 blocks; {ckpt_path} has {args['num_audio_layers']}")
    gcfg = GuideConfig(
        tokens=int(vq_args["code_dim"]),
        latent_dim=int(args["dim"]),
        num_layers=int(args["layers"]),
        vq_depth=int(vq_args["depth"]),
    )
    ckpt = _load_torch(ckpt_path)
    model = _load_into(GuideTransformer(gcfg), ckpt.get("model_state_dict", ckpt))
    print(f"[guide] {ckpt_path} -> {out_dir}")
    return _write(out_dir, model, guide=gcfg, data=_data_config(args, args.get("add_frame_cond", 1)))


# ------------------------------------------------------------------ #
# lip regressor (standalone assets/iter-0200000.pt)
# ------------------------------------------------------------------ #


def convert_lip_checkpoint(ckpt_path: str, out_dir: str) -> str:
    """assets/iter-0200000.pt (model/diffusion.py:273-280) -> a dir with
    the LipRegressor's ``model.pt`` (no config: the regressor has one
    shape).  A face checkpoint carries its own copy; this is the
    standalone asset."""
    ckpt = _load_torch(ckpt_path)
    model = _load_into(LipRegressor(), ckpt.get("model_state_dict", ckpt))
    print(f"[lip] {ckpt_path} -> {out_dir}")
    return _write(out_dir, model)


# ------------------------------------------------------------------ #
# ca_body photoreal avatar
# ------------------------------------------------------------------ #


def frontal_rig(template_verts, cfg: RendererConfig) -> Dict[str, Camera]:
    """One camera on the template's +z axis, 3.5 of its extents from its
    centre, looking back at it (the JAX converter's fallback)."""
    verts = np.asarray(template_verts, np.float32).reshape(-1, 3)
    c = verts.mean(0)
    extent = float(np.abs(verts - c).max())
    H, W = cfg.image_height, cfg.image_width
    f = 1.2 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    campos = c + np.array([0.0, 0.0, 3.5 * extent], np.float32)
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    return {"frontal": Camera(campos=campos, K=K, Rt=np.concatenate([R, (-R @ campos)[:, None]], 1))}


def convert_avatar_checkpoint(person_dir: str, out_dir: str, render_defaults: Optional[str] = None,
                              cfg: Optional[RendererConfig] = None) -> str:
    """ca_body/data/<person>/ (``body_dec.ckpt`` + ``static_assets.pt``,
    render_codes.py:60-90) → renderer bundle at ``cfg`` (default
    ``RendererConfig()``, the released avatars' widths).  The checkpoint's
    state dict (bare, or under ``model_state_dict`` / ``model``), less its
    ``AVATAR_REFERENCE_ONLY`` keys, is checked strictly against the port's
    reference-named BodyAvatar and saved as it is; ``static_assets.pt`` is
    copied beside it."""
    cfg = cfg or RendererConfig()
    ckpt = _load_torch(os.path.join(person_dir, AVATAR_CKPT))
    sd = ckpt.get("model_state_dict", ckpt.get("model", ckpt))
    # the parameters' shapes follow cfg alone: the smallest synthetic assets do
    assets = make_synthetic_assets(RendererConfig(uv_size=16, init_uv_size=16, upscale_size=16, shadow_size=16,
                                                  encoder_in_size=16))
    with torch.device("meta"):  # names and shapes only: the tensors stay the file's
        model = BodyAvatar(cfg, assets)
    sd = _load_into(model, sd, assign=True, reference_only=AVATAR_REFERENCE_ONLY).state_dict()
    assets_path = os.path.join(person_dir, STATIC_ASSETS_FILE)
    if render_defaults and os.path.exists(render_defaults):
        cams = load_render_defaults(render_defaults)
    else:
        a = torch.load(assets_path, map_location="cpu", weights_only=False)
        cams = frontal_rig(a["lbs_template_verts"], cfg)
    save_renderer_bundle(out_dir, cfg, sd, cams, static_assets=assets_path)
    print(f"[avatar] {person_dir} -> {out_dir}")
    return out_dir


# ------------------------------------------------------------------ #
# whole-person driver
# ------------------------------------------------------------------ #


def convert_person(checkpoints_root: str, person: str, out_root: str) -> Dict[str, str]:
    """Convert every model family found for one person, the latest
    checkpoint of each, and the person's avatar into ``renderer`` (the
    layout of scripts/download_prereq.sh + download_allmodels.sh,
    README.md:178-198)."""
    out: Dict[str, str] = {}
    droot = os.path.join(checkpoints_root, "diffusion")
    for tag_dir in sorted(glob.glob(os.path.join(droot, "c*_face")) + glob.glob(os.path.join(droot, "c*_pose"))):
        pts = sorted(glob.glob(os.path.join(tag_dir, "model*.pt")))
        if pts:
            name = os.path.basename(tag_dir)
            out[name] = convert_diffusion_checkpoint(pts[-1], os.path.join(out_root, name))
    for vq_dir in sorted(glob.glob(os.path.join(checkpoints_root, "vq", "*"))):
        pths = sorted(glob.glob(os.path.join(vq_dir, "net_iter*.pth")))
        if pths:
            name = os.path.basename(vq_dir)
            out[name] = convert_vq_checkpoint(pths[-1], os.path.join(out_root, name))
    for g_dir in sorted(glob.glob(os.path.join(checkpoints_root, "guide", "*"))):
        its = sorted(glob.glob(os.path.join(g_dir, "checkpoints", "iter-*.pt")))
        if its:
            name = "guide_" + os.path.basename(g_dir)
            out[name] = convert_guide_checkpoint(its[-1], os.path.join(out_root, name),
                                                 checkpoints_root=checkpoints_root)
    person_dir = os.path.join(checkpoints_root, "ca_body", "data", person)
    if os.path.exists(os.path.join(person_dir, AVATAR_CKPT)):
        rd = os.path.join(os.path.dirname(os.path.normpath(checkpoints_root)), "assets",
                          f"render_defaults_{person}.pth")
        out["renderer"] = convert_avatar_checkpoint(person_dir, os.path.join(out_root, "renderer"), rd)
    if not out:
        raise FileNotFoundError(f"no convertible checkpoints under {checkpoints_root}")
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="output checkpoint dir (or root for --checkpoints_root)")
    p.add_argument("--diffusion", help="path to diffusion model00X.pt")
    p.add_argument("--vq", help="path to vq net_iterX.pth")
    p.add_argument("--guide", help="path to guide checkpoints/iter-X.pt")
    p.add_argument("--vq_args", help="args.json of the VQ the guide was trained on")
    p.add_argument("--lip", help="path to standalone lip regressor iter-X.pt")
    p.add_argument("--avatar", help="checkpoints/ca_body/data/<person> dir")
    p.add_argument("--render_defaults", help="assets/render_defaults_<person>.pth (with --avatar)")
    p.add_argument("--checkpoints_root", help="convert everything under this root")
    p.add_argument("--person", default="PXB184")
    a = p.parse_args()
    did = False
    if a.checkpoints_root:
        convert_person(a.checkpoints_root, a.person, a.out)
        did = True
    if a.diffusion:
        convert_diffusion_checkpoint(a.diffusion, a.out)
        did = True
    if a.vq:
        convert_vq_checkpoint(a.vq, a.out)
        did = True
    if a.guide:
        convert_guide_checkpoint(a.guide, a.out, vq_args_path=a.vq_args, checkpoints_root=a.checkpoints_root)
        did = True
    if a.lip:
        convert_lip_checkpoint(a.lip, a.out)
        did = True
    if a.avatar:
        convert_avatar_checkpoint(a.avatar, a.out, render_defaults=a.render_defaults)
        did = True
    if not did:
        p.error("nothing to convert: pass --checkpoints_root or a per-model path")


if __name__ == "__main__":
    main()
