"""Renderer assets and the renderer bundle.

Counterpart of ``audio2photoreal_tpu/render/assets.py``:
- ``make_synthetic_assets``: the procedural "capsule person" (cylinder mesh,
  3-joint chain, grid UV atlas) that stands in for capture data.  It draws
  from ``np.random.RandomState(seed)`` in the JAX package's order, so the
  same seed gives the same arrays (image-like ones here as [C, H, W]).
- The port's renderer bundle, a directory of ``renderer.json`` (the
  RendererConfig fields), ``model.pt`` (a BodyAvatar state_dict under the
  reference's names), ``cameras.npz`` (names, campos [N, 3], K [N, 3, 3],
  Rt [N, 3, 4]) and an optional ``assets.json`` naming the synthetic
  assets' seed and mesh density.
- ``convert_static_assets`` (a person's released ``static_assets.pt``) is
  not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from audio2photoreal_tpu_torch.render.geometry import GeometryModule
from audio2photoreal_tpu_torch.render.lbs import LBSModule, Skeleton
from audio2photoreal_tpu_torch.render.mesh_vae import RendererAssets, RendererConfig
from audio2photoreal_tpu_torch.render.seams import SeamSampler

CONFIG_FILE = "renderer.json"
MODEL_FILE = "model.pt"
CAMERAS_FILE = "cameras.npz"
ASSETS_FILE = "assets.json"
# RendererConfig fields of the JAX package that the port does not keep: they
# change no inference result (training noise, a TPU layout switch)
DROPPED_FIELDS = ("noise_std", "s2d_tail")


@dataclass
class Camera:
    campos: np.ndarray  # [3]
    K: np.ndarray  # [3, 3]
    Rt: np.ndarray  # [3, 4]


def synthetic_rig(center: Sequence[float], height: int = 1024, width: int = 667) -> Dict[str, Camera]:
    """The synthetic person's 2-camera rig, framed as a capture rig frames a
    standing person: focal length 1400 px, both cameras 3.5 units from
    ``center`` at its height and looking at it, the second turned 20 degrees
    about the body's up axis (OpenCV camera axes: x right, y down, z
    forward; the body's z is up).  The 2-unit body then spans about 800 of
    1024 rows."""
    center = np.asarray(center, np.float32)
    f = 1400.0
    K = np.array([[f, 0, (width - 1) / 2], [0, f, (height - 1) / 2], [0, 0, 1]], np.float32)
    cams = {}
    for name, deg in (("cam0", 0.0), ("cam1", 20.0)):
        a = np.deg2rad(deg)
        forward = np.array([-np.sin(a), np.cos(a), 0.0])
        R = np.stack([[np.cos(a), np.sin(a), 0.0], [0.0, 0.0, -1.0], forward]).astype(np.float32)
        campos = (center - 3.5 * forward).astype(np.float32)
        Rt = np.concatenate([R, (-R @ campos)[:, None]], 1).astype(np.float32)
        cams[name] = Camera(campos=campos, K=K, Rt=Rt)
    return cams


def empty_seam_sampler(uv_size: int) -> SeamSampler:
    z = np.zeros((0,), np.int64)
    return SeamSampler(z, z, np.zeros((0, 2), np.float32), z, np.zeros((0,), np.float32), uv_size)


def _cylinder_mesh(n_around: int = 8, n_height: int = 6, radius: float = 0.3, height: float = 2.0):
    """Open cylinder with a grid UV atlas; returns (verts, faces, uv, uv_faces)."""
    verts, uvs = [], []
    for j in range(n_height):
        z = height * j / (n_height - 1)
        for i in range(n_around):
            a = 2 * np.pi * i / n_around
            verts.append([radius * np.cos(a), radius * np.sin(a), z])
            uvs.append([(i + 0.5) / n_around, (j + 0.5) / n_height])
    faces = []
    for j in range(n_height - 1):
        for i in range(n_around):
            a = j * n_around + i
            b = j * n_around + (i + 1) % n_around
            c = (j + 1) * n_around + i
            d = (j + 1) * n_around + (i + 1) % n_around
            # skip the wrap-around strip in UV space (it would fold the atlas)
            if (i + 1) % n_around != 0:
                faces.append([a, b, c])
                faces.append([b, d, c])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int64),
        np.asarray(uvs, np.float32),
        np.asarray(faces, np.int64),  # uv faces == geom faces (shared indexing)
    )


def synthetic_seam_sampler(uv_size: int, n: int, rng: np.random.RandomState) -> SeamSampler:
    """Random but structurally valid seam tables at production scale."""
    HW = uv_size * uv_size
    imp = rng.choice(HW, size=2 * n, replace=False)
    dst_r = rng.choice(HW, size=n, replace=False)
    return SeamSampler(
        impaint_dst=imp[:n],
        impaint_src=imp[n:],
        resample_uvs=(rng.rand(n, 2) * 2.0 - 1.0).astype(np.float32),
        resample_dst=dst_r,
        resample_weights=rng.rand(n).astype(np.float32),
        uv_size=uv_size,
    )


def _chw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32).transpose(2, 0, 1))


def make_synthetic_assets(cfg: RendererConfig, seed: int = 0, mesh_density: int = 1) -> RendererAssets:
    """``mesh_density=1``: a coarse 70-face cylinder (tests); ``10``: 9,322
    small faces, the reference body's face count, with production-scale
    synthetic seam tables."""
    rng = np.random.RandomState(seed)
    verts, faces, uvs, uv_faces = _cylinder_mesh(n_around=8 * mesh_density, n_height=6 * mesh_density)
    V = len(verts)
    geo = GeometryModule.create(faces, uvs, uv_faces, cfg.uv_size)
    skel = Skeleton.create(
        parents=[-1, 0, 1],
        offset=np.array([[0, 0, 0], [0, 0, 1.0], [0, 0, 1.0]], np.float32),
        rotation=np.tile(np.array([0, 0, 0, 1], np.float32), (3, 1)),
    )
    # 104-d pose → 21 channel params: root uses pose[0:6], joints 1/2 rotate
    transform = np.zeros((21, 104), np.float32)
    transform[0:6, 0:6] = np.eye(6)
    transform[10, 6] = 1.0  # joint1 rx
    transform[17, 7] = 1.0  # joint2 rx
    offsets = np.zeros(21, np.float32)
    w1 = np.clip(verts[:, 2] / 2.0, 0, 1)
    skin_weights = np.stack([1 - w1, w1 * 0.7, w1 * 0.3], axis=1).astype(np.float32)
    skin_weights /= skin_weights.sum(1, keepdims=True)
    skin_indices = np.tile(np.array([0, 1, 2]), (V, 1))
    lbs = LBSModule(skel, transform, offsets, skin_indices, skin_weights, verts)

    S0, Senc = cfg.init_uv_size, cfg.encoder_in_size
    dense = mesh_density > 1
    seam = synthetic_seam_sampler(cfg.uv_size, 24_000, rng) if dense else empty_seam_sampler(cfg.uv_size)
    seam_2k = (synthetic_seam_sampler(cfg.upscale_size, 48_000, rng) if dense
               else empty_seam_sampler(cfg.upscale_size))
    tex_mean = np.asarray(rng.rand(cfg.upscale_size, cfg.upscale_size, 3) * 100, np.float32)
    ao_mean = np.asarray(rng.rand(cfg.shadow_size, cfg.shadow_size, 1), np.float32)
    face_cond_mask = (rng.rand(S0, S0, 1) > 0.7).astype(np.float32)
    pose_cond_mask = (rng.rand(S0, S0, 104 - 6) > 0.5).astype(np.float32)
    return RendererAssets(
        geo=geo, lbs=lbs, seam=seam, seam_2k=seam_2k,
        tex_mean=_chw(tex_mean), tex_std=64.0, ao_mean=_chw(ao_mean),
        face_cond_mask=_chw(face_cond_mask), pose_cond_mask=_chw(pose_cond_mask),
        body_cond_mask=np.ones((1, S0, S0), np.float32),
        non_head_mask=np.ones((1, Senc, Senc), np.float32),
        face_tex_mask=np.ones((1, Senc, Senc), np.float32),
        frontal_view=np.array([0.0, 0.0, 1.0], np.float32),
    )


def convert_static_assets(static_assets_path: str, cfg: Optional[RendererConfig] = None) -> RendererAssets:
    """A person's released ``static_assets.pt`` → RendererAssets."""
    raise NotImplementedError(
        f"converting {static_assets_path} (real per-person assets) is not ported yet: see ROADMAP"
    )


def save_renderer_bundle(out_dir: str, cfg: RendererConfig, state_dict, cameras: Dict,
                         seed: int = 0, mesh_density: int = 1) -> str:
    """Write a renderer bundle (see the module note) and return its path."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    with open(os.path.join(out_dir, ASSETS_FILE), "w") as f:
        json.dump({"synthetic_seed": seed, "mesh_density": mesh_density}, f, indent=1)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(out_dir, MODEL_FILE))
    names = list(cameras)
    np.savez(
        os.path.join(out_dir, CAMERAS_FILE),
        names=np.array(names),
        campos=np.stack([np.asarray(cameras[n].campos, np.float32) for n in names]),
        K=np.stack([np.asarray(cameras[n].K, np.float32) for n in names]),
        Rt=np.stack([np.asarray(cameras[n].Rt, np.float32) for n in names]),
    )
    return out_dir


def load_bundle_parts(renderer_dir: str):
    """→ (cfg, assets, state_dict, cameras) of a renderer bundle."""
    import torch

    with open(os.path.join(renderer_dir, CONFIG_FILE)) as f:
        fields = json.load(f)
    cfg = RendererConfig(**{k: v for k, v in fields.items() if k not in DROPPED_FIELDS})
    sa = os.path.join(renderer_dir, "static_assets.pt")
    if os.path.exists(sa):
        assets = convert_static_assets(sa, cfg)
    else:
        synth = {"synthetic_seed": 0, "mesh_density": 1}
        ap = os.path.join(renderer_dir, ASSETS_FILE)
        if os.path.exists(ap):
            with open(ap) as f:
                synth.update(json.load(f))
        assets = make_synthetic_assets(cfg, seed=synth["synthetic_seed"], mesh_density=synth["mesh_density"])
    sd = torch.load(os.path.join(renderer_dir, MODEL_FILE), map_location="cpu", weights_only=True)
    camf = np.load(os.path.join(renderer_dir, CAMERAS_FILE), allow_pickle=False)
    cameras = {
        str(n): Camera(campos=camf["campos"][i], K=camf["K"][i], Rt=camf["Rt"][i])
        for i, n in enumerate(camf["names"])
    }
    return cfg, assets, sd, cameras
