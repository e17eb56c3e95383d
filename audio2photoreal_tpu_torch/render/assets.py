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
  assets' seed and mesh density, or a person's released
  ``static_assets.pt``, which ``load_bundle_parts`` prefers.  An avatar
  trainer's bundle (``apps/train_avatar.py``) also holds ``ckpt/``.
- ``convert_static_assets``: a person's ``static_assets.pt`` (reference
  layout: render_codes.py:52-89, mesh_vae_drivable.py:90-200, the LBS
  blobs of ca_body/utils/lbs.py:424+) → RendererAssets, and
  ``load_render_defaults`` (``render_defaults_<person>.pth``) → cameras.
  The two files are read with ``weights_only=False``, as the JAX package
  reads them: besides tensors they hold the LBS model's JSON and may hold
  numpy arrays.
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
STATIC_ASSETS_FILE = "static_assets.pt"
# a RendererConfig field of the JAX package that the port does not keep: a
# TPU layout switch, which changes no result
DROPPED_FIELDS = ("s2d_tail",)


@dataclass
class Camera:
    campos: np.ndarray  # [3]
    K: np.ndarray  # [3, 3]
    Rt: np.ndarray  # [3, 4]


def synthetic_rig(center: Sequence[float], height: int = 1024, width: int = 667,
                  angles: Sequence[float] = (0.0, 20.0)) -> Dict[str, Camera]:
    """The synthetic person's camera rig, framed as a capture rig frames a
    standing person: focal length 1400 px, every camera 3.5 units from
    ``center`` at its height and looking at it, camera i turned ``angles[i]``
    degrees about the body's up axis (OpenCV camera axes: x right, y down, z
    forward; the body's z is up).  The 2-unit body then spans about 800 of
    1024 rows."""
    center = np.asarray(center, np.float32)
    f = 1400.0
    K = np.array([[f, 0, (width - 1) / 2], [0, f, (height - 1) / 2], [0, 0, 1]], np.float32)
    cams = {}
    for name, deg in ((f"cam{i}", float(d)) for i, d in enumerate(angles)):
        a = np.deg2rad(deg)
        forward = np.array([-np.sin(a), np.cos(a), 0.0])
        R = np.stack([[np.cos(a), np.sin(a), 0.0], [0.0, 0.0, -1.0], forward]).astype(np.float32)
        campos = (center - 3.5 * forward).astype(np.float32)
        Rt = np.concatenate([R, (-R @ campos)[:, None]], 1).astype(np.float32)
        cams[name] = Camera(campos=campos, K=K, Rt=Rt)
    return cams


def seam_sampler_from_reference(data, uv_size: int) -> SeamSampler:
    """The reference's seam_data (ca_body/utils/seams.py:16-52): ``dst_ij`` /
    ``src_ij`` [N, 2] (row, col) texel pairs, ``uvs`` a dense [H, W, 2]
    sample grid in [0, 1], ``weights`` a dense [H, W] blend map.  Only the
    texels with a positive weight are kept."""
    W = uv_size
    dst_ij = np.asarray(data["dst_ij"]).astype(np.int64).reshape(-1, 2)
    src_ij = np.asarray(data["src_ij"]).astype(np.int64).reshape(-1, 2)
    uvs = np.asarray(data["uvs"]).astype(np.float32).reshape(W, W, 2)
    weights = np.asarray(data["weights"]).astype(np.float32).reshape(W, W)
    ij = np.argwhere(weights > 0)
    return SeamSampler(
        impaint_dst=dst_ij[:, 0] * W + dst_ij[:, 1],
        impaint_src=src_ij[:, 0] * W + src_ij[:, 1],
        resample_uvs=(2.0 * (uvs[ij[:, 0], ij[:, 1]] - 0.5)).astype(np.float32),
        resample_dst=ij[:, 0] * W + ij[:, 1],
        resample_weights=weights[ij[:, 0], ij[:, 1]],
        uv_size=uv_size,
    )


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


def reference_static_assets(cfg: RendererConfig, seed: int = 0, mesh_density: int = 1) -> dict:
    """The synthetic person in the layout of a released ``static_assets.pt``
    (what ``convert_static_assets`` reads), sized for ``cfg``: the cylinder
    mesh with every UV vertex duplicated a little apart (``v2uv`` [V, 2], as
    on a real topology's seams); a three-joint momentum-style LBS model with
    pre-rotations, three per-joint scale columns set by ``lbs_scale`` and a
    ``global_scaling`` of 1.1; dense seam tables at ``uv_size`` and
    ``upscale_size``; tex_mean, the masks and ao_mean at the reference's
    sizes relative to ``cfg``; a ``head_cond_mask``."""
    import torch

    rng = np.random.RandomState(seed)
    verts, faces, uvs, uv_faces = _cylinder_mesh(n_around=8 * mesh_density, n_height=6 * mesh_density)
    V = len(verts)
    bones = [
        {"Name": "root", "Parent": 9999, "PreRotation": [0.0, 0.0, 0.0, 1.0], "TranslationOffset": [0.0, 0.0, 0.0]},
        {"Name": "b1", "Parent": 0, "PreRotation": [0.0, 0.0, 0.38268343, 0.9238795],
         "TranslationOffset": [0.0, 0.0, 1.0]},
        {"Name": "b2", "Parent": 1, "PreRotation": [0.0, 0.0, 0.0, 1.0], "TranslationOffset": [0.0, 0.1, 1.0]},
    ]
    w1 = np.clip(verts[:, 2] / 2.0, 0, 1)
    w = np.stack([1 - w1, w1 * 0.7, w1 * 0.3], 1)
    w /= w.sum(1, keepdims=True)
    weights, offsets = [], [0]
    for v in range(V):
        for j in range(3 if v % 5 else 2):  # every fifth vertex on two joints only
            weights.append([j, float(w[v, j])])
        offsets.append(len(weights))
    transform = np.zeros((21, 107), np.float32)
    transform[0:6, 0:6] = np.eye(6)
    transform[10, 6] = transform[17, 7] = transform[11, 8] = 1.0
    transform[6, 104] = transform[13, 105] = transform[20, 106] = 1.0  # the joints' scales: the scale params

    def seam_data(S):
        n = S * S // 100
        imp = rng.choice(S * S, size=2 * n, replace=False)
        weights_map = np.zeros((S, S), np.float32)
        ij = np.stack([rng.randint(0, S, 3 * n), rng.randint(0, S, 3 * n)], 1)
        weights_map[ij[:, 0], ij[:, 1]] = rng.rand(3 * n).astype(np.float32)
        return {"dst_ij": torch.as_tensor(np.stack([imp[:n] // S, imp[:n] % S], 1)),
                "src_ij": torch.as_tensor(np.stack([imp[n:] // S, imp[n:] % S], 1)),
                "uvs": torch.as_tensor(rng.rand(S, S, 2).astype(np.float32) * 0.9 + 0.05),
                "weights": torch.as_tensor(weights_map)[None]}

    S0, S, E = cfg.init_uv_size, cfg.uv_size, cfg.face_tex_size
    return dict(
        topology=dict(vi=faces.astype(np.int64), vt=np.concatenate([uvs, uvs + np.float32(0.004)]),
                      vti=uv_faces.astype(np.int64),
                      v2uv=np.stack([np.arange(V), np.arange(V) + V], 1).astype(np.int64)),
        lbs_model_json={"Skeleton": {"Bones": bones},
                        "SkinnedModel": {"SkinningWeights": weights, "SkinningOffsets": offsets}},
        lbs_config_dict={"transform": transform, "transform_offsets": (0.05 * rng.randn(21)).astype(np.float32)},
        lbs_template_verts=verts.astype(np.float32),
        lbs_scale=np.array([[0.1, -0.05, 0.2]], np.float32),
        global_scaling=np.array([1.1], np.float32),
        seam_data_1024=seam_data(S),
        seam_data_2048=seam_data(cfg.upscale_size),
        tex_mean=(rng.rand(3, S, S) * 120).astype(np.float32),
        tex_var=81.0,
        face_cond_mask=(rng.rand(S0, S0) > 0.6).astype(np.float32),
        face_mask=(rng.rand(S, S) > 0.4).astype(np.float32),
        ao_mean=rng.rand(1, S // 2, S // 2).astype(np.float32),
        pose_cond_mask=(rng.rand(98, S0, S0) > 0.5).astype(np.int64),
        head_cond_mask=(rng.rand(S0, S0) > 0.8).astype(np.float32),
        body_cond_mask=(rng.rand(S0, S0) > 0.1).astype(np.float32),
        mugsy_face_mask=(rng.rand(E, E, 1) > 0.3).astype(np.float32),
        face_frontal_view=np.array([0.0, 0.2, 1.0], np.float32),
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


def _load_pickle(path: str):
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_render_defaults(path: str) -> Dict[str, Camera]:
    """A person's ``render_defaults_<person>.pth`` (the default cameras of
    render_codes.py:89) → cameras: one dict of K / Rt [/ campos] (named
    ``default``), or one such dict per camera name.  Without ``campos`` the
    camera sits at -Rᵀt."""
    d = _load_pickle(path)

    def camera(entry) -> Camera:
        K = np.asarray(entry["K"], np.float32).reshape(3, 3)
        Rt = np.asarray(entry["Rt"], np.float32).reshape(3, 4)
        campos = entry.get("campos")
        if campos is None:
            campos = -Rt[:, :3].T @ Rt[:, 3]
        return Camera(campos=np.asarray(campos, np.float32).reshape(3), K=K, Rt=Rt)

    if "K" in d:
        cams = {"default": camera(d)}
    else:
        cams = {str(n): camera(e) for n, e in d.items() if isinstance(e, dict) and "K" in e}
    if not cams:
        raise ValueError(f"no camera entries found in {path}")
    return cams


def _skinning_table(skinned_model, k: int = 8):
    """``SkinningWeights`` [(index, weight), ...] with per-vertex
    ``SkinningOffsets`` → (indices, weights) [V, k], zero-padded."""
    weights = np.array([e[1] for e in skinned_model["SkinningWeights"]], np.float32)
    indices = np.array([e[0] for e in skinned_model["SkinningWeights"]], np.int64)
    offsets = np.array(skinned_model["SkinningOffsets"], np.int64)
    nv = len(offsets) - 1
    skin_weights = np.zeros((nv, k), np.float32)
    skin_indices = np.zeros((nv, k), np.int64)
    for j in range(k):
        left = offsets[:-1] + j
        valid = left < offsets[1:]
        skin_weights[valid, j] = weights[left[valid]]
        skin_indices[valid, j] = indices[left[valid]]
    return skin_indices, skin_weights


def _gaussian_blur11(x):
    """torchvision's gaussian_blur(kernel_size=11) on [1, C, H, W]: sigma =
    0.3·((k−1)/2 − 1) + 0.8 = 2.0, reflect padding, separable (the
    reference blurs tex_mean with it, mesh_vae_drivable.py:113)."""
    import torch
    import torch.nn.functional as F

    k, sigma = 11, 2.0
    coords = torch.arange(k, dtype=torch.float32) - (k - 1) / 2
    g = torch.exp(-(coords**2) / (2 * sigma**2))
    g = g / g.sum()
    C = x.shape[1]
    out = F.pad(x, (k // 2,) * 4, mode="reflect")
    out = F.conv2d(out, g.view(1, 1, 1, k).expand(C, 1, 1, k), groups=C)
    return F.conv2d(out, g.view(1, 1, k, 1).expand(C, 1, k, 1), groups=C)


def convert_static_assets(static_assets_path: str, cfg: Optional[RendererConfig] = None) -> RendererAssets:
    """A person's released ``static_assets.pt`` → RendererAssets, as the
    reference's AutoEncoder.__init__ builds its buffers
    (mesh_vae_drivable.py:90-200):
    - the topology's maps at ``uv_size``, impainted, with its seam
      duplicates ``v2uv`` when it has them;
    - the skeleton and skinning from the LBS model's JSON; the per-person
      scale columns of the LBS transform folded into its offsets, the bind
      state solved from the offsets before that fold, and the global scale;
    - tex_mean blurred (k 11) and resized to ``upscale_size``; the encoder's
      non-head mask resized bilinearly then made boolean; the face
      texture's mask resized at align_corners=True; ao_mean resized nearest
      to ``shadow_size``; the pose mask with the head's cells cleared
      (``head_cond_mask``), made integer."""
    import torch
    import torch.nn.functional as F

    cfg = cfg or RendererConfig()
    a = _load_pickle(static_assets_path)
    topo = a["topology"]
    geo = GeometryModule.create(np.asarray(topo["vi"]), np.asarray(topo["vt"]), np.asarray(topo["vti"]),
                                cfg.uv_size, impaint=True,
                                v2uv=np.asarray(topo["v2uv"]) if "v2uv" in topo else None)

    bones = a["lbs_model_json"]["Skeleton"]["Bones"]
    skel = Skeleton.create(
        [b["Parent"] if b["Parent"] <= len(bones) else -1 for b in bones],
        np.array([b["TranslationOffset"] for b in bones], np.float32),
        np.array([b["PreRotation"] for b in bones], np.float32),
    )
    skin_indices, skin_weights = _skinning_table(a["lbs_model_json"]["SkinnedModel"])
    # transform @ [pose; scale] + off == transform[:, :104] @ pose + (off + transform[:, 104:] @ scale)
    lbs_cfg = a["lbs_config_dict"]
    transform = np.asarray(lbs_cfg["transform"]).astype(np.float64)
    offsets = np.asarray(lbs_cfg["transform_offsets"]).reshape(-1).astype(np.float64)
    bind_offsets = offsets.astype(np.float32)
    n_pose = 104
    if transform.shape[1] > n_pose:
        scale = np.asarray(a.get("lbs_scale", np.zeros(transform.shape[1] - n_pose))).reshape(-1)
        offsets = offsets + transform[:, n_pose:] @ scale.astype(np.float64)
        transform = transform[:, :n_pose]
    lbs = LBSModule(skel, transform.astype(np.float32), offsets.astype(np.float32), skin_indices, skin_weights,
                    np.asarray(a["lbs_template_verts"]),
                    global_scaling=float(np.asarray(a.get("global_scaling", [1.0])).reshape(-1)[0]),
                    bind_offsets=bind_offsets)

    S0, Senc = cfg.init_uv_size, cfg.encoder_in_size
    pose_cond = np.asarray(a["pose_cond_mask"])  # [P, S0, S0] or [S0, S0, P]
    if pose_cond.ndim == 3 and pose_cond.shape[0] != S0:
        pose_cond = pose_cond.transpose(1, 2, 0)
    head_cond = np.asarray(a.get("head_cond_mask", np.zeros((S0, S0))))
    pose_cond = (pose_cond * (1 - head_cond[..., None])).astype(np.int32)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32)

    def hw(x) -> np.ndarray:  # a [.., H, W, ..] mask with unit axes → [1, H, W]
        return np.asarray(x, np.float32).squeeze()[None]

    tex_mean = F.interpolate(_gaussian_blur11(f32(a["tex_mean"])[None]), (cfg.upscale_size,) * 2, mode="bilinear")
    non_head = f32(1.0 - np.asarray(a["face_mask"]))[None, None]
    non_head = (F.interpolate(non_head, (Senc, Senc), mode="bilinear") != 0).float()
    face_tex_mask = f32(np.asarray(a["mugsy_face_mask"])[..., 0])[None, None]
    face_tex_mask = F.interpolate(face_tex_mask, (Senc, Senc), mode="bilinear", align_corners=True)
    ao = np.asarray(a["ao_mean"])
    ao_mean = F.interpolate(f32(ao).reshape(1, 1, *ao.squeeze().shape), (cfg.shadow_size,) * 2)
    return RendererAssets(
        geo=geo, lbs=lbs,
        seam=seam_sampler_from_reference(a["seam_data_1024"], cfg.uv_size),
        seam_2k=seam_sampler_from_reference(a["seam_data_2048"], cfg.upscale_size),
        tex_mean=tex_mean[0].numpy(), tex_std=float(a.get("tex_var", 64.0)), ao_mean=ao_mean[0].numpy(),
        face_cond_mask=hw(a["face_cond_mask"]), pose_cond_mask=_chw(pose_cond),
        body_cond_mask=hw(a["body_cond_mask"]), non_head_mask=non_head[0].numpy(),
        face_tex_mask=face_tex_mask[0].numpy(),
        frontal_view=np.asarray(a["face_frontal_view"], np.float32).reshape(-1)[:3],
    )


def save_renderer_bundle(out_dir: str, cfg: RendererConfig, state_dict, cameras: Dict,
                         seed: int = 0, mesh_density: int = 1, static_assets: Optional[str] = None) -> str:
    """Write a renderer bundle (see the module note) and return its path:
    with ``static_assets`` (a person's ``static_assets.pt``) a copy of it,
    else ``assets.json`` naming the synthetic assets."""
    import shutil

    import torch

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    if static_assets is not None:
        shutil.copy2(static_assets, os.path.join(out_dir, STATIC_ASSETS_FILE))
    else:
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
    sa = os.path.join(renderer_dir, STATIC_ASSETS_FILE)
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
