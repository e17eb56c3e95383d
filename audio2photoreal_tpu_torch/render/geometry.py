"""UV-space geometry machinery.

Counterpart of ``audio2photoreal_tpu/render/geometry.py`` (reference:
visualize/ca_body/utils/geom.py):
- the host precompute of the UV index/bary maps (a numpy bbox rasterizer
  over texel centres, once per topology) and their impainting from the
  nearest valid texel — a numpy copy, the same arrays for the same inputs;
- ``GeometryModule.to_uv`` (values_to_uv, geom.py:304-322) and ``from_uv``
  (sample_uv, geom.py:274-302: ``F.grid_sample`` with align_corners=True and
  zero padding, then the mean over each vertex's UV duplicates);
- face and vertex normals, ``compute_view_cos``, ``project_points`` and
  ``project_points_multi``;
- ``depth2xyz`` / ``xyz2normals`` / ``depth2normals`` (geom.py:559-633),
  channels last as in the JAX package.

UV images are NCHW [B, C, H, W]; vertex arrays [B, V, C].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# --------------------------------------------------------------------- #
# host-side precompute (asset build time)
# --------------------------------------------------------------------- #


def rasterize_uv_maps(
    uv_coords: np.ndarray,  # [Vt, 2] in [0, 1]
    uv_faces: np.ndarray,  # [F, 3] indices into uv_coords
    uv_size: int,
    flip_v: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (face_index [H, W] int32, −1 = empty; barys [H, W, 3] float32),
    row ∝ v and col ∝ u (the reference map orientation)."""
    H = W = uv_size
    face_index = np.full((H, W), -1, np.int32)
    barys = np.zeros((H, W, 3), np.float32)
    uv = uv_coords.astype(np.float64).copy()
    if flip_v:
        uv[:, 1] = 1.0 - uv[:, 1]
    px = uv[:, 0] * W - 0.5
    py = uv[:, 1] * H - 0.5
    best_cover = np.zeros((H, W), np.float64)
    for f, (a, b, c) in enumerate(uv_faces):
        xa, ya = px[a], py[a]
        xb, yb = px[b], py[b]
        xc, yc = px[c], py[c]
        x0 = max(int(np.floor(min(xa, xb, xc))), 0)
        x1 = min(int(np.ceil(max(xa, xb, xc))) + 1, W)
        y0 = max(int(np.floor(min(ya, yb, yc))), 0)
        y1 = min(int(np.ceil(max(ya, yb, yc))) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        det = (yb - yc) * (xa - xc) + (xc - xb) * (ya - yc)
        if abs(det) < 1e-12:
            continue
        w0 = ((yb - yc) * (xs - xc) + (xc - xb) * (ys - yc)) / det
        w1 = ((yc - ya) * (xs - xc) + (xa - xc) * (ys - yc)) / det
        w2 = 1.0 - w0 - w1
        eps = -1e-7
        inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
        if not inside.any():
            continue
        sub_cover = np.where(inside, 1.0, 0.0)
        take = inside & (sub_cover >= best_cover[y0:y1, x0:x1])
        yy, xx = np.where(take)
        face_index[y0 + yy, x0 + xx] = f
        barys[y0 + yy, x0 + xx, 0] = w0[take]
        barys[y0 + yy, x0 + xx, 1] = w1[take]
        barys[y0 + yy, x0 + xx, 2] = w2[take]
        best_cover[y0 + yy, x0 + xx] = 1.0
    return face_index, barys


def impaint_index_maps(
    face_index: np.ndarray, barys: np.ndarray, distance_threshold: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Fill empty texels from the nearest valid texel (geom.py:146-196);
    texels at or beyond ``distance_threshold`` stay empty."""
    valid = face_index >= 0
    if valid.all() or not valid.any():
        return face_index, barys
    from scipy.spatial import cKDTree

    vy, vx = np.where(valid)
    ey, ex = np.where(~valid)
    dist, nearest = cKDTree(np.stack([vy, vx], 1)).query(np.stack([ey, ex], 1))
    src_y, src_x = vy[nearest], vx[nearest]
    if distance_threshold is not None:
        keep = dist < distance_threshold
        ey, ex, src_y, src_x = ey[keep], ex[keep], src_y[keep], src_x[keep]
    fi = face_index.copy()
    ba = barys.copy()
    fi[ey, ex] = face_index[src_y, src_x]
    ba[ey, ex] = barys[src_y, src_x]
    return fi, ba


def uv_vert_index_from_face_index(face_index: np.ndarray, uv_faces_geom: np.ndarray) -> np.ndarray:
    """[H, W] face ids → [H, W, 3] GEOMETRY vertex ids (geom.py:70-108)."""
    vert_index = uv_faces_geom[np.maximum(face_index, 0)]
    vert_index[face_index < 0] = 0
    return vert_index.astype(np.int32)


# --------------------------------------------------------------------- #
# runtime module
# --------------------------------------------------------------------- #


class GeometryModule(nn.Module):
    """Static per-topology maps (non-persistent buffers) + to_uv / from_uv."""

    def __init__(self, faces, uv_coords, uv_faces, vert_index_img, bary_img, valid_mask, v2uv):
        super().__init__()
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
        self.register_buffer("faces", t(faces, torch.long), persistent=False)
        self.register_buffer("uv_coords", t(uv_coords, torch.float32), persistent=False)
        self.register_buffer("uv_faces", t(uv_faces, torch.long), persistent=False)
        self.register_buffer("vert_index_img", t(vert_index_img, torch.long), persistent=False)
        self.register_buffer("bary_img", t(bary_img, torch.float32), persistent=False)
        self.register_buffer("valid_mask", t(valid_mask, torch.float32), persistent=False)
        self.register_buffer("v2uv", t(v2uv, torch.long), persistent=False)

    @classmethod
    def create(cls, verts_faces: np.ndarray, uv_coords: np.ndarray, uv_faces: np.ndarray, uv_size: int,
               impaint: bool = True, flip_uv: bool = False, v2uv: Optional[np.ndarray] = None,
               impaint_threshold: float = 100.0) -> "GeometryModule":
        """Build the maps host-side.  With ``impaint``, texels nearer than
        ``impaint_threshold`` texels to a chart take its nearest texel (the
        reference's distance_threshold); ``flip_uv`` rasterizes v as 1 - v.
        ``v2uv`` [V, K] lists each geometry vertex's UV duplicates (real
        topologies duplicate vertices on UV seams; ``from_uv`` averages over
        K); without it each vertex takes the UV vertex of its first uv-face
        occurrence ([V, 1]: exact for an atlas with no seam duplicates)."""
        face_index, barys = rasterize_uv_maps(uv_coords, uv_faces, uv_size, flip_v=flip_uv)
        valid = (face_index >= 0).astype(np.float32)
        if impaint:
            face_index, barys = impaint_index_maps(face_index, barys, impaint_threshold)
        vert_index = uv_vert_index_from_face_index(face_index, np.asarray(verts_faces))
        if v2uv is None:
            vf = np.asarray(verts_faces).reshape(-1)
            uf = np.asarray(uv_faces).reshape(-1)
            v2uv = np.zeros((int(vf.max()) + 1, 1), np.int64)
            seen = np.zeros(len(v2uv), bool)
            for gi, ti in zip(vf, uf):
                if not seen[gi]:
                    v2uv[gi, 0] = ti
                    seen[gi] = True
        return cls(verts_faces, uv_coords, uv_faces, vert_index, barys, valid, np.asarray(v2uv, np.int64))

    def to_uv(self, values: torch.Tensor) -> torch.Tensor:
        """[B, V, C] → [B, C, H, W] (values_to_uv, geom.py:304-322)."""
        gathered = values[:, self.vert_index_img]  # [B, H, W, 3, C]
        uv = (gathered * self.bary_img[None, ..., None]).sum(dim=-2)  # [B, H, W, C]
        # contiguous NCHW: on the CPU, the weight gradient of the body
        # encoder's strided convs from the channels-last view corrupts the
        # heap (PyTorch 2.13)
        return uv.permute(0, 3, 1, 2).contiguous()

    def from_uv(self, uv_img: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → [B, V, C] (sample_uv, geom.py:274-302).  The f32
        sample coordinates promote a bf16 image: its values are sampled in
        f32, as the JAX package's gather-and-lerp promotes them."""
        B = uv_img.shape[0]
        grid = (self.uv_coords * 2.0 - 1.0)[None, :, None, :].expand(B, -1, 1, 2)
        img = uv_img.to(torch.promote_types(uv_img.dtype, grid.dtype))
        out = F.grid_sample(img, grid.to(img.dtype), mode="bilinear",
                            padding_mode="zeros", align_corners=True)  # [B, C, Vt, 1]
        out = out[..., 0].transpose(1, 2)  # [B, Vt, C]
        return out[:, self.v2uv].mean(dim=2)


def face_normals(verts: torch.Tensor, faces: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """[B, V, 3] x [F, 3] -> [B, F, 3] (geom.py:323-333)."""
    v0, v1, v2 = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    if normalize:
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    return n


def vert_normals(verts: torch.Tensor, faces: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Vertex normals: the sum of the unit normals of the faces around each
    vertex, normalised (geom.py:323-346; not area-weighted)."""
    fn = face_normals(verts, faces, normalize=False)
    norm = torch.linalg.norm(fn, dim=-1, keepdim=True)
    fn = fn / torch.where(norm < eps, torch.ones_like(norm), norm)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(1, faces[:, k], fn)
    norm = torch.linalg.norm(vn, dim=-1, keepdim=True)
    return vn / torch.where(norm < eps, torch.ones_like(norm), norm)


def compute_view_cos(verts: torch.Tensor, faces: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """Per-vertex cos between the normal and the camera→vertex direction
    (geom.py:347-351: facing the camera is NEGATIVE)."""
    vn = vert_normals(verts, faces)
    view = verts - campos[:, None, :]
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True).clamp_min(1e-12)
    return (vn * view).sum(-1)


def project_points(
    verts: torch.Tensor,  # [B, V, 3] world
    K: torch.Tensor,  # [B, 3, 3]
    Rt: torch.Tensor,  # [B, 3, 4] world→cam (OpenCV convention)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (pixel coords [B, V, 2], cam-space depth [B, V]) (geom.py:525-557)."""
    cam = torch.einsum("bij,bvj->bvi", Rt[..., :3], verts) + Rt[..., 3][:, None]
    z = cam[..., 2]
    xy = cam[..., :2] / z[..., None].clamp_min(1e-8)
    pix = torch.einsum("bij,bvj->bvi", K[:, :2, :2], xy) + K[:, :2, 2][:, None]
    return pix, z


def project_points_multi(
    p: torch.Tensor,  # [B, N, 3] world points
    Rt: torch.Tensor,  # [B, NC, 3, 4]
    K: torch.Tensor,  # [B, NC, 3, 3]
    normalize: bool = False,
    size=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole projection into several cameras (geom.py:525-557) -> (pix
    [B, NC, N, 2], depth [B, NC, N]); ``normalize`` maps pixels of an image
    of ``size`` (h, w) to [-1, 1]."""
    cam = torch.einsum("bcij,bnj->bcni", Rt[..., :3], p) + Rt[..., 3][:, :, None]
    pix3 = torch.einsum("bcij,bcnj->bcni", K, cam)
    depth = pix3[..., 2]
    pix = pix3[..., :2] / depth[..., None].clamp_min(1e-8)
    if normalize:
        assert size is not None
        h, w = size
        pix = 2.0 * pix / torch.tensor([w, h], dtype=torch.float32, device=p.device) - 1.0
    return pix, depth


def depth2xyz(depth: torch.Tensor, focal: torch.Tensor, princpt: torch.Tensor) -> torch.Tensor:
    """[B, H, W] depth, [B, 2, 2] focal, [B, 2] principal point -> [B, H, W,
    3] camera-space XYZ (geom.py:584-612, channels last)."""
    _, H, W = depth.shape
    ix = (torch.arange(W, dtype=torch.float32, device=depth.device)[None, None]
          - princpt[:, None, None, 0]) / focal[:, None, None, 0, 0]
    iy = (torch.arange(H, dtype=torch.float32, device=depth.device)[None, :, None]
          - princpt[:, None, None, 1]) / focal[:, None, None, 1, 1]
    return torch.stack([depth * ix, depth * iy, depth], dim=-1)


def xyz2normals(xyz: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[B, H, W, 3] XYZ image -> unit normals by central differences
    (geom.py:559-580, channels last, zero-padded borders)."""
    xp = F.pad(xyz, (0, 0, 1, 1, 1, 1))
    U = (xp[:, 2:, 1:-1] - xp[:, :-2, 1:-1]) / -2
    V = (xp[:, 1:-1, 2:] - xp[:, 1:-1, :-2]) / -2
    n = torch.linalg.cross(U, V, dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(eps)


def depth2normals(depth: torch.Tensor, focal: torch.Tensor, princpt: torch.Tensor) -> torch.Tensor:
    """Depth image -> normal image (geom.py:616-633)."""
    return xyz2normals(depth2xyz(depth, focal, princpt))
