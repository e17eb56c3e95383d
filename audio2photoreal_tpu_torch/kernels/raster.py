"""Tile z-buffer rasterizer: the CUDA kernel ``csrc/raster.cu`` and its plain version.

Replaces ``audio2photoreal_tpu/ops/pallas_raster.py:rasterize_pallas`` (the
TPU kernel ``_raster_kernel``) with the semantics of
``audio2photoreal_tpu/render/rasterizer.py:_rasterize_xla``: pixel centres
at integer coordinates; a face covers a pixel when its three barycentrics
are >= 0, ``|det| > 1e-12`` and the screen-space interpolated depth (no
perspective correction) is > 1e-6; the nearest depth wins and ties go to
the lowest face id.  Background is face -1, depth +inf, zero barycentrics
and UV.  Face ids are the caller's: nothing is sorted, so there is no id
remap.

``rasterize`` dispatches: a CPU tensor takes ``rasterize_reference``, a
CUDA tensor launches the kernel (``rasterize_cuda``), anything else raises.
The kernel's design and what bounds it are in the source's head note.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from audio2photoreal_tpu_torch.kernels import launch_counts
from audio2photoreal_tpu_torch.kernels.build import load_library

NAME = "raster_fwd"
SOURCES = ("raster.cu",)
# elements per [B, chunk, h, w] temporary of the plain version: 64 MB in f32
_REFERENCE_ELEMS = 1 << 24
_LAYOUT_LEN = 18  # csrc/raster.cu:raster_layout's out[]


class Layout(NamedTuple):
    """csrc/raster.cu's worklist layout for one call's shapes (``layout``)."""

    tile: int  # a tile is tile x tile pixels, one block
    small_tiles: int  # a face reaching more tiles is listed in the coarse bins
    stage: int  # face records in one shared-memory stage
    max_bins: int  # coarse bins per frame, at most
    ntx: int  # tiles per row
    nty: int  # tiles per column
    bin_tiles: int  # a coarse bin is bin_tiles x bin_tiles tiles
    nbx: int  # bins per row
    nbins: int  # bins per frame
    offsets: Tuple[int, ...]  # byte offsets of the scratch arrays (Scratch's order), then its size


class RasterOut(NamedTuple):
    face_index: torch.Tensor  # [B, H, W] int32, -1 = background
    barys: Optional[torch.Tensor]  # [B, H, W, 3] f32, when emitted
    depth: torch.Tensor  # [B, H, W] f32, +inf at background
    uv: Optional[torch.Tensor] = None  # [B, H, W, 2] f32, when face_uv was given


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/raster.cu."""
    lib.raster_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    lib.raster_fwd.restype = ctypes.c_int
    lib.raster_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.raster_scratch_bytes.restype = ctypes.c_longlong
    lib.raster_layout.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.raster_layout.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    return bind(load_library(NAME, SOURCES))


def layout(B: int, F: int, height: int, width: int) -> Layout:
    """The kernel's tiles, coarse bins and scratch arrays for these shapes,
    as the library computes them (builds it)."""
    out = (ctypes.c_longlong * _LAYOUT_LEN)()
    err = library().raster_layout(B, F, height, width, out)
    if err != 0:
        raise ValueError(f"no raster layout for B={B} F={F} H={height} W={width}: cudaError_t {err}")
    return Layout(*out[:9], offsets=tuple(out[9:]))


def _corners(pix_verts: torch.Tensor, depth: torch.Tensor, faces: torch.Tensor):
    tri = pix_verts[:, faces]  # [B, F, 3, 2]
    tz = depth[:, faces]  # [B, F, 3]
    return (tri[..., 0, 0], tri[..., 0, 1], tri[..., 1, 0], tri[..., 1, 1],
            tri[..., 2, 0], tri[..., 2, 1], tz)


def _det(xa, ya, xb, yb, xc, yc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(det ok, inv_det): the plain version's exact operations."""
    det = (yb - yc) * (xa - xc) + (xc - xb) * (ya - yc)
    ok = det.abs() > 1e-12
    return ok, torch.where(ok, 1.0 / det, torch.zeros_like(det))


def rasterize_reference(
    pix_verts: torch.Tensor,  # [B, V, 2] pixel coords
    depth: torch.Tensor,  # [B, V] camera-space z
    faces: torch.Tensor,  # [F, 3]
    height: int,
    width: int,
    face_uv: Optional[torch.Tensor] = None,  # [F, 3, 2] per-corner UV
    emit_barys: bool = True,
    chunk: Optional[int] = None,
) -> RasterOut:
    """The plain PyTorch version: ``_rasterize_xla``'s chunked argmin scan.

    Faces go in chunks of ``chunk`` (default: as many as keep one [B, chunk,
    H, W] temporary at 64 MB); each chunk is evaluated over the pixel window
    of its faces' screen bboxes widened by one pixel, which is where its
    faces can pass the inside test, and merged with a strict ``<`` so that
    the lowest face id keeps a tie.  Faces with ``|det| <= 1e-12`` or
    non-finite corners never pass and do not widen the window."""
    B = pix_verts.shape[0]
    F = faces.shape[0]
    H, W = height, width
    dev = pix_verts.device
    if chunk is None:
        chunk = max(1, min(256, _REFERENCE_ELEMS // max(B * H * W, 1)))
    best_z = torch.full((B, H, W), float("inf"), device=dev)
    best_f = torch.full((B, H, W), -1, dtype=torch.int32, device=dev)
    best_b = torch.zeros((B, H, W, 3), device=dev)
    gy = torch.arange(H, dtype=torch.float32, device=dev)
    gx = torch.arange(W, dtype=torch.float32, device=dev)
    for base in range(0, F, chunk):
        fc = faces[base : base + chunk]
        xa, ya, xb, yb, xc, yc, tz = _corners(pix_verts, depth, fc)
        ok, inv_det = _det(xa, ya, xb, yb, xc, yc)
        xs = torch.stack([xa, xb, xc], -1)
        ys = torch.stack([ya, yb, yc], -1)
        live = ok[..., None] & torch.isfinite(xs) & torch.isfinite(ys)
        if not bool(live.any()):
            continue
        lo_x = torch.where(live, xs, torch.inf).amin()
        hi_x = torch.where(live, xs, -torch.inf).amax()
        lo_y = torch.where(live, ys, torch.inf).amin()
        hi_y = torch.where(live, ys, -torch.inf).amax()
        box = torch.stack([lo_x.floor() - 1, hi_x.ceil() + 1, lo_y.floor() - 1, hi_y.ceil() + 1])
        box = torch.stack([box[:2].clamp(0, W - 1), box[2:].clamp(0, H - 1)]).reshape(-1)
        x0, x1, y0, y1 = (int(v) for v in box.tolist())
        if hi_x < 0 or lo_x > W - 1 or hi_y < 0 or lo_y > H - 1:
            continue
        win = (slice(None), slice(y0, y1 + 1), slice(x0, x1 + 1))
        e = lambda t: t[..., None, None]  # noqa: E731  [B, C] -> [B, C, 1, 1]
        dx = gx[x0 : x1 + 1][None, None, None] - e(xc)  # [B, C, 1, w]
        dy = gy[y0 : y1 + 1][None, None, :, None] - e(yc)  # [B, C, h, 1]
        w0 = (e(yb - yc) * dx + e(xc - xb) * dy) * e(inv_det)
        w1 = (e(yc - ya) * dx + e(xa - xc) * dy) * e(inv_det)
        w2 = 1.0 - w0 - w1
        z = w0 * e(tz[..., 0]) + w1 * e(tz[..., 1]) + w2 * e(tz[..., 2])
        front = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & e(ok) & (z > 1e-6)
        z = torch.where(front, z, torch.inf)
        zmin = z.amin(dim=1)  # [B, h, w]
        amin = z.argmin(dim=1)  # the first minimum: the lowest id in the chunk
        take = zmin < best_z[win]
        bary = torch.stack(torch.broadcast_tensors(w0, w1, w2), -1)  # [B, C, h, w, 3]
        bsel = torch.gather(bary, 1, amin[:, None, ..., None].expand(-1, 1, -1, -1, 3))[:, 0]
        best_f[win] = torch.where(take, (base + amin).to(torch.int32), best_f[win])
        best_b[win] = torch.where(take[..., None], bsel, best_b[win])
        best_z[win] = torch.minimum(best_z[win], zmin)
    uv = None
    if face_uv is not None:
        cov = best_f >= 0
        fuv = face_uv[best_f.clamp_min(0).long()]  # [B, H, W, 3, 2]
        b = best_b[..., None]
        uv = b[..., 0, :] * fuv[..., 0, :] + b[..., 1, :] * fuv[..., 1, :] + b[..., 2, :] * fuv[..., 2, :]
        uv = torch.where(cov[..., None], uv, torch.zeros_like(uv))
    return RasterOut(best_f, best_b if emit_barys else None, best_z, uv)


class Scratch(NamedTuple):
    """Views of a kernel call's device scratch (csrc/raster.cu's head note)."""

    rec: torch.Tensor  # [B, F, 16] f32 face records
    rect: torch.Tensor  # [B, F, 4] i32 tile rectangles: first, last column; first, last row
    tile_count: torch.Tensor  # [B, T] i32 faces listed per tile
    bin_count: torch.Tensor  # [B, nbins] i32 large faces per coarse bin
    start: torch.Tensor  # [B, T] i32 each tile's list in tile_list
    end: torch.Tensor  # [B, T] i32
    tile_list: torch.Tensor  # [B * F * small_tiles] i32
    bin_list: torch.Tensor  # [B, nbins, F] i32


def scratch_views(buf: torch.Tensor, B: int, F: int, height: int, width: int) -> Scratch:
    """The arrays of ``_launch``'s scratch buffer, where the library put them."""
    g = layout(B, F, height, width)
    T = g.ntx * g.nty
    shapes = ((B, F, 16), (B, F, 4), (B, T), (B, g.nbins), (B, T), (B, T), (B * F * g.small_tiles,),
              (B, g.nbins, F))
    views = []
    for off, shape in zip(g.offsets, shapes):
        n = 4 * int(torch.Size(shape).numel())
        views.append(buf[off:off + n].view(torch.int32).view(shape))
    views[0] = views[0].view(torch.float32)
    return Scratch(*views)


def _launch(pix_verts, depth, faces, height, width, face_uv, emit_barys) -> Tuple[RasterOut, torch.Tensor]:
    """Launch on the current stream; returns the outputs and the uint8
    scratch buffer (``scratch_views`` cuts it)."""
    if pix_verts.device.type != "cuda":
        raise ValueError(f"the raster kernel takes CUDA tensors, not {pix_verts.device}")
    if pix_verts.dtype != torch.float32 or depth.dtype != torch.float32:
        raise ValueError(f"pix_verts and depth must be float32; got {pix_verts.dtype}, {depth.dtype}")
    if face_uv is not None and face_uv.dtype != torch.float32:
        raise ValueError(f"face_uv must be float32; got {face_uv.dtype}")
    B, V, F = pix_verts.shape[0], pix_verts.shape[1], faces.shape[0]
    if (B * height * width >= 2**31 or B * F * 16 >= 2**31 or B * V >= 2**31
            or max(height, width) > 2**24):
        raise ValueError(f"too large for int32 indexing: B={B} V={V} H={height} W={width} F={F}")
    dev = pix_verts.device
    pix_verts, depth, faces = pix_verts.contiguous(), depth.contiguous(), faces.long().contiguous()
    if face_uv is not None:
        face_uv = face_uv.contiguous()
    lib = library()
    nbytes = lib.raster_scratch_bytes(B, F, height, width)
    if nbytes < 0:
        raise ValueError(f"the raster kernel does not take B={B} F={F} H={height} W={width}")
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)  # the allocator aligns it to 512 bytes
    face = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    dep = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    bary = torch.empty((B, height, width, 3), device=dev) if emit_barys else None
    uv = torch.empty((B, height, width, 2), device=dev) if face_uv is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.raster_fwd(
            ptr(pix_verts), ptr(depth), ptr(faces), ptr(face_uv), B, V, F, height, width, ptr(buf),
            ptr(face), ptr(dep), ptr(bary), ptr(uv), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return RasterOut(face, bary, dep, uv), buf


def rasterize_cuda(
    pix_verts: torch.Tensor,
    depth: torch.Tensor,
    faces: torch.Tensor,
    height: int,
    width: int,
    face_uv: Optional[torch.Tensor] = None,
    emit_barys: bool = True,
) -> RasterOut:
    """Launch the kernels on the current stream (CUDA tensors, f32 coords):
    the per-face setup and binning, the per-frame scan, the list fill, then
    the tile raster.  Faces whose corner indices fall outside [0, V) never
    cover a pixel."""
    return _launch(pix_verts, depth, faces, height, width, face_uv, emit_barys)[0]


def rasterize(
    pix_verts: torch.Tensor,
    depth: torch.Tensor,
    faces: torch.Tensor,
    height: int,
    width: int,
    face_uv: Optional[torch.Tensor] = None,
    emit_barys: Optional[bool] = None,
) -> RasterOut:
    """Rasterize [B, V] projected vertices.  ``face_uv`` makes the result
    carry per-pixel UV; barycentrics are emitted by default only without
    it.  CPU tensors take ``rasterize_reference``; CUDA tensors launch the
    kernel; any other device raises."""
    if pix_verts.dim() != 3 or pix_verts.shape[-1] != 2:
        raise ValueError(f"pix_verts must be [B, V, 2]; got {tuple(pix_verts.shape)}")
    if tuple(depth.shape) != tuple(pix_verts.shape[:2]):
        raise ValueError(f"depth must be {tuple(pix_verts.shape[:2])}; got {tuple(depth.shape)}")
    if faces.dim() != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be [F, 3]; got {tuple(faces.shape)}")
    if face_uv is not None and tuple(face_uv.shape) != (faces.shape[0], 3, 2):
        raise ValueError(f"face_uv must be [{faces.shape[0]}, 3, 2]; got {tuple(face_uv.shape)}")
    tensors = (pix_verts, depth, faces) + ((face_uv,) if face_uv is not None else ())
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"rasterize inputs on different devices: {devices}")
    if emit_barys is None:
        emit_barys = face_uv is None
    dev = pix_verts.device
    if dev.type == "cpu":
        return rasterize_reference(pix_verts, depth, faces, height, width, face_uv, emit_barys)
    if dev.type != "cuda":
        raise ValueError(f"no raster kernel for device {dev}")
    return rasterize_cuda(pix_verts, depth, faces, height, width, face_uv, emit_barys)
