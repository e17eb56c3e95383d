"""A numpy float32 emulation of the raster kernels in csrc/raster.cu.

The tests hold it to the plain version on the CPU (``test_torch_raster.py``)
and the kernels to it on the card (``test_torch_cuda.py``).  The kernel's
constants are read from the source, so the emulation follows an edit of
them; the grid and scratch layout rules are copied here, and a card test
holds them to the library's ``raster_layout``.  Imports neither JAX nor the
JAX package.
"""

import re
from typing import NamedTuple

import numpy as np

from audio2photoreal_tpu_torch.kernels.build import CSRC


def cu_constants():
    """{name: value} of the ``constexpr int`` constants of csrc/raster.cu, in
    order, each expression evaluated over the ones before it."""
    values = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", (CSRC / "raster.cu").read_text(), re.M):
        if not re.fullmatch(r"[\w\s*+()-]+", expr):
            raise ValueError(f"csrc/raster.cu: {name} = {expr!r} is not an integer expression over constants")
        values[name] = int(eval(expr, {"__builtins__": {}}, dict(values)))
    return values


_K = cu_constants()
TILE, SMALL_TILES, STAGE, MAX_BINS = _K["kTile"], _K["kSmallTiles"], _K["kStage"], _K["kMaxBins"]


class Layout(NamedTuple):
    ntx: int  # tiles per row
    nty: int  # tiles per column
    bin_tiles: int  # a coarse bin is bin_tiles x bin_tiles tiles
    nbx: int  # bins per row
    nbins: int  # bins per frame


def layout(H, W):
    """csrc/raster.cu:make_grid: the smallest square coarse bins of which a
    frame has at most MAX_BINS."""
    ntx, nty = -(-W // TILE), -(-H // TILE)
    bt = 1
    while -(-ntx // bt) * -(-nty // bt) > MAX_BINS:
        bt += 1
    nbx = -(-ntx // bt)
    return Layout(ntx, nty, bt, nbx, nbx * -(-nty // bt))


def scratch_offsets(B, F, H, W):
    """csrc/raster.cu:scratch_layout: the byte offsets of rec, rect,
    tile_count, bin_count, start, end, tile_list and bin_list, each rounded
    up to 16 bytes, then the scratch size."""
    g = layout(H, W)
    bf, bt, bins = B * F, B * g.ntx * g.nty, B * g.nbins
    off = [0]
    for n in (bf * 64, bf * 16, bt * 4, bins * 4, bt * 4, bt * 4, bf * SMALL_TILES * 4, bins * F * 4):
        off.append(-(-(off[-1] + n) // 16) * 16)
    return tuple(off)


def _tile_range(lo, hi, n):
    """csrc/raster.cu's first_tile / last_tile in float32: clamp, scale by
    1/TILE, round, convert."""
    t, f32 = TILE, np.float32
    lim = f32(n * t + 32)
    lo, hi = np.clip(lo, f32(-32), lim), np.clip(hi, f32(-32), lim)
    first = np.maximum(np.ceil(lo * f32(1.0 / t)).astype(np.int64) - 1, 0)
    last = np.minimum(np.floor((hi + f32(1)) * f32(1.0 / t)).astype(np.int64), n - 1)
    return first, last


def emulate_setup(pix, depth, faces, face_uv, H, W):
    """numpy float32 emulation of csrc/raster.cu's setup, scan and fill
    kernels: each face's record (xc, yc, yb-yc, xc-xb, yc-ya, xa-xc, 1/det,
    za, zb, zc, corner UVs) and tile rectangle (empty where |det| <= 1e-12, a
    corner is not finite, or off the image); the small faces' ids in the list
    of every tile they reach and the large faces' in every coarse bin they
    reach, both in face order (the kernel's atomics give any order)."""
    g = layout(H, W)
    tri = pix[:, faces]  # [B, F, 3, 2]
    (xa, ya), (xb, yb), (xc, yc) = (tri[:, :, k].transpose(2, 0, 1) for k in range(3))
    z = depth[:, faces]
    a0, b0, a1, b1 = yb - yc, xc - xb, yc - ya, xa - xc
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        det = a0 * b1 + b0 * (ya - yc)
        ok = np.abs(det) > np.float32(1e-12)
        inv_det = np.where(ok, np.float32(1.0) / det, np.float32(0.0)).astype(np.float32)
    uv = np.broadcast_to(face_uv.reshape(1, -1, 6), xa.shape + (6,))
    rec = np.concatenate([np.stack([xc, yc, a0, b0, a1, b1, inv_det], -1), z, uv], -1).astype(np.float32)
    xs, ys = tri[..., 0], tri[..., 1]
    live = ok & np.isfinite(xs).all(-1) & np.isfinite(ys).all(-1)
    xs, ys = np.where(live[..., None], xs, 0), np.where(live[..., None], ys, 0)
    tx0, tx1 = _tile_range(xs.min(-1), xs.max(-1), g.ntx)
    ty0, ty1 = _tile_range(ys.min(-1), ys.max(-1), g.nty)
    rect = np.stack([tx0, tx1, ty0, ty1], -1)
    rect[~(live & (tx0 <= tx1) & (ty0 <= ty1))] = [0, -1, 0, -1]
    B, F = live.shape
    tiles = [[[] for _ in range(g.ntx * g.nty)] for _ in range(B)]
    bins = [[[] for _ in range(g.nbins)] for _ in range(B)]
    for b in range(B):
        for f in range(F):
            x0, x1, y0, y1 = rect[b, f]
            if x0 > x1:
                continue
            if (x1 - x0 + 1) * (y1 - y0 + 1) <= SMALL_TILES:
                for ty in range(y0, y1 + 1):
                    for tx in range(x0, x1 + 1):
                        tiles[b][ty * g.ntx + tx].append(f)
            else:
                bt = g.bin_tiles
                for by in range(y0 // bt, y1 // bt + 1):
                    for bx in range(x0 // bt, x1 // bt + 1):
                        bins[b][by * g.nbx + bx].append(f)
    return rec, rect, tiles, bins


def emulate_stages(rect, tiles, bins, g, b, tx, ty):
    """The stages raster_kernel tests at tile (tx, ty) of frame b: its tile
    list, STAGE faces a stage, then each STAGE of its coarse bin's large faces
    culled to those whose rectangle holds the tile."""
    own = tiles[b][ty * g.ntx + tx]
    stages = [own[i:i + STAGE] for i in range(0, len(own), STAGE)]
    large = bins[b][(ty // g.bin_tiles) * g.nbx + tx // g.bin_tiles]
    for i in range(0, len(large), STAGE):
        stages.append([f for f in large[i:i + STAGE]
                       if rect[b, f, 0] <= tx <= rect[b, f, 1] and rect[b, f, 2] <= ty <= rect[b, f, 3]])
    return stages


def tile_list(setup, H, W, b, tx, ty):
    """Every face raster_kernel tests at tile (tx, ty) of frame b."""
    _, rect, tiles, bins = setup
    return [f for s in emulate_stages(rect, tiles, bins, layout(H, W), b, tx, ty) for f in s]


def emulate_kernel(pix, depth, faces, H, W, face_uv, order_seed=None):
    """numpy float32 emulation of csrc/raster.cu: the setup's records and
    worklists, each tile's stages, the same individually rounded operations,
    the (z, id) compare.  ``order_seed`` shuffles every list first, as the
    kernel's atomics may order it."""
    rec, rect, tiles, bins = emulate_setup(pix, depth, faces, face_uv, H, W)
    if order_seed is not None:
        rng = np.random.RandomState(order_seed)
        for lists in tiles + bins:
            for lst in lists:
                rng.shuffle(lst)
    g, t, f32 = layout(H, W), TILE, np.float32
    B = pix.shape[0]
    face = np.full((B, H, W), -1, np.int32)
    best = np.full((B, H, W), np.inf, np.float32)
    uv = np.zeros((B, H, W, 2), np.float32)
    for b in range(B):
        for ty in range(g.nty):
            for tx in range(g.ntx):
                ys, xs = np.mgrid[ty * t:ty * t + t, tx * t:tx * t + t].astype(np.float32)
                bz = np.full(ys.shape, np.inf, np.float32)
                bf = np.full(ys.shape, -1, np.int32)
                bu = np.zeros(ys.shape + (2,), np.float32)
                for stage in emulate_stages(rect, tiles, bins, g, b, tx, ty):
                    for f in stage:
                        r = rec[b, f]
                        dx, dy = xs - r[0], ys - r[1]
                        with np.errstate(over="ignore", invalid="ignore"):
                            w0 = (f32(r[2]) * dx + f32(r[3]) * dy) * f32(r[6])
                            w1 = (f32(r[4]) * dx + f32(r[5]) * dy) * f32(r[6])
                            w2 = (f32(1.0) - w0) - w1
                            z = (w0 * r[7] + w1 * r[8]) + w2 * r[9]
                            take = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z > f32(1e-6)) & (
                                (z < bz) | ((z == bz) & (f < bf)))
                            bz = np.where(take, z, bz)
                            bf = np.where(take, f, bf)
                            for k in range(2):
                                u = (w0 * r[10 + k] + w1 * r[12 + k]) + w2 * r[14 + k]
                                bu[..., k] = np.where(take, u, bu[..., k])
                y0, x0 = ty * t, tx * t
                h, w = min(t, H - y0), min(t, W - x0)
                face[b, y0:y0 + h, x0:x0 + w] = bf[:h, :w]
                best[b, y0:y0 + h, x0:x0 + w] = bz[:h, :w]
                uv[b, y0:y0 + h, x0:x0 + w] = bu[:h, :w]
    return face, best, uv
