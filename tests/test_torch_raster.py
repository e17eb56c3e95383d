"""The port's rasterizer (kernels/raster.py) on the CPU, against the JAX package.

``rasterize_reference`` (the plain version, what a CPU tensor takes) is
held to ``render/rasterizer.py:_rasterize_xla`` and to the TPU kernel
``ops/pallas_raster.py:rasterize_pallas`` run in interpret mode: coverage
equal, face ids equal on >= 99.9% of covered pixels (edge pixels may flip
where XLA contracts products into FMAs), depth / barycentrics / UV within
1e-5 where the ids agree.  The CUDA kernel's face records and tile cull are
checked through a numpy emulation of the kernel, which must equal the plain
version exactly.  The kernel itself runs in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2photoreal_tpu.ops.pallas_raster import rasterize_pallas
from audio2photoreal_tpu.render.rasterizer import _rasterize_xla
from audio2photoreal_tpu_torch.kernels import launch_counts, raster
from audio2photoreal_tpu_torch.render import rasterizer

TOL = 1e-5


def random_mesh(seed, H, W, B=2, n_verts=30, n_faces=40):
    rng = np.random.RandomState(seed)
    pix = (rng.rand(B, n_verts, 2) * [W + 8, H + 8] - 4).astype(np.float32)  # some off-screen
    depth = (rng.rand(B, n_verts) * 4 + 0.5).astype(np.float32)
    faces = rng.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    face_uv = rng.rand(n_faces, 3, 2).astype(np.float32)
    return pix, depth, faces, face_uv


def _port(pix, depth, faces, H, W, face_uv=None, **kw):
    return raster.rasterize_reference(torch.from_numpy(pix), torch.from_numpy(depth),
                                      torch.from_numpy(faces).long(), H, W,
                                      None if face_uv is None else torch.from_numpy(face_uv), **kw)


def _hold(got, want_face, want_depth, want=None, min_same=0.999):
    """Coverage equal; ids equal on >= min_same of covered; the rest within TOL."""
    face = got.face_index.numpy()
    cov = np.asarray(want_face) >= 0
    np.testing.assert_array_equal(face >= 0, cov)
    same = face == np.asarray(want_face)
    assert same[cov].mean() >= min_same
    sel = cov & same
    np.testing.assert_allclose(got.depth.numpy()[sel], np.asarray(want_depth)[sel], atol=TOL, rtol=TOL)
    assert np.isinf(got.depth.numpy()[~cov]).all()
    for name, arr in (want or {}).items():
        np.testing.assert_allclose(getattr(got, name).numpy()[sel], np.asarray(arr)[sel], atol=TOL)


@pytest.mark.parametrize("seed,H,W", [(0, 64, 64), (1, 61, 77), (2, 33, 50)])
def test_reference_matches_xla_rasterizer(seed, H, W):
    pix, depth, faces, _ = random_mesh(seed, H, W)
    want = _rasterize_xla(jnp.asarray(pix), jnp.asarray(depth), jnp.asarray(faces), H, W, 16)
    got = _port(pix, depth, faces, H, W)
    _hold(got, want.face_index, want.depth, {"barys": want.barys})
    assert got.uv is None


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_pallas_kernel_interpret(seed):
    H, W = 48, 40
    pix, depth, faces, face_uv = random_mesh(seed + 10, H, W)
    face, bary, dep, uv = rasterize_pallas(
        jnp.asarray(pix), jnp.asarray(depth), jnp.asarray(faces), H, W, tile=(16, 16), chunk=8,
        interpret=True, face_uv=jnp.asarray(face_uv), emit_barys=True,
    )
    got = _port(pix, depth, faces, H, W, face_uv)
    _hold(got, face, dep, {"barys": bary, "uv": uv})


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_reference_does_not_depend_on_chunk(chunk):
    pix, depth, faces, face_uv = random_mesh(3, 45, 37, n_faces=60)
    want = _port(pix, depth, faces, 45, 37, face_uv)
    got = _port(pix, depth, faces, 45, 37, face_uv, chunk=chunk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def tie_mesh():
    """Exact depth ties (a face listed twice, and a third face whose corners
    sit at the same places), a face with collinear corners (det = 0) and a
    face behind the camera."""
    pix = np.array([[[2, 2], [30, 3], [4, 25], [2, 2], [20, 20], [27, 27], [10, 30], [25, 10], [2, 2]]],
                   np.float32)
    depth = np.array([[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, -2.0, -2.0, -1.0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 2], [3, 4, 5], [8, 6, 7], [3, 1, 2]], np.int32)
    return pix, depth, faces


def test_ties_go_to_the_lowest_face_id():
    pix, depth, faces = tie_mesh()
    out = _port(pix, depth, faces, 31, 33)
    face = out.face_index.numpy()[0]
    assert face[5, 5] == 0  # faces 0, 1 and 4 cover it at the same depth
    assert not np.isin(face, [1, 2, 3, 4]).any()  # duplicates lose, collinear and behind never win
    want = _rasterize_xla(jnp.asarray(pix), jnp.asarray(depth), jnp.asarray(faces), 31, 33)
    np.testing.assert_array_equal(face, np.asarray(want.face_index)[0])


def emulate_setup(pix, depth, faces, face_uv):
    """numpy float32 emulation of csrc/raster.cu's setup kernel: each face's
    record (xc, yc, yb-yc, xc-xb, yc-ya, xa-xc, 1/det, za, zb, zc, corner
    UVs) and its screen bbox, empty where |det| <= 1e-12."""
    tri = pix[:, faces]  # [B, F, 3, 2]
    (xa, ya), (xb, yb), (xc, yc) = (tri[:, :, k].transpose(2, 0, 1) for k in range(3))
    z = depth[:, faces]
    a0, b0, a1, b1 = yb - yc, xc - xb, yc - ya, xa - xc
    det = a0 * b1 + b0 * (ya - yc)
    ok = np.abs(det) > np.float32(1e-12)
    with np.errstate(divide="ignore"):
        inv_det = np.where(ok, np.float32(1.0) / det, np.float32(0.0)).astype(np.float32)
    uv = np.broadcast_to(face_uv.reshape(1, -1, 6), xa.shape + (6,))
    rec = np.concatenate([np.stack([xc, yc, a0, b0, a1, b1, inv_det], -1), z, uv], -1)
    xs, ys = tri[..., 0], tri[..., 1]
    bbox = np.stack([xs.min(-1), xs.max(-1), ys.min(-1), ys.max(-1)], -1)
    bbox[~ok] = [np.inf, -np.inf, np.inf, -np.inf]
    return rec.astype(np.float32), bbox


def emulate_kernel(pix, depth, faces, H, W, face_uv, tile=16):
    """numpy float32 emulation of csrc/raster.cu: the setup kernel's records
    and bboxes, tile cull with one pixel of margin, the same individually
    rounded operations, (z, id) compare."""
    rec, bbox = emulate_setup(pix, depth, faces, face_uv)
    B = pix.shape[0]
    face = np.full((B, H, W), -1, np.int32)
    best = np.full((B, H, W), np.inf, np.float32)
    uv = np.zeros((B, H, W, 2), np.float32)
    f32 = np.float32
    for b in range(B):
        for ty in range(0, H, tile):
            for tx in range(0, W, tile):
                ys, xs = np.mgrid[ty:ty + tile, tx:tx + tile].astype(np.float32)
                bz = np.full(ys.shape, np.inf, np.float32)
                bf = np.full(ys.shape, -1, np.int32)
                bu = np.zeros(ys.shape + (2,), np.float32)
                for f in range(len(faces)):
                    x0, x1, y0, y1 = bbox[b, f]
                    if not (x0 <= tx + tile and x1 >= tx - 1 and y0 <= ty + tile and y1 >= ty - 1):
                        continue
                    r = rec[b, f]
                    dx, dy = xs - r[0], ys - r[1]
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
                h, w = min(tile, H - ty), min(tile, W - tx)
                face[b, ty:ty + h, tx:tx + w] = bf[:h, :w]
                best[b, ty:ty + h, tx:tx + w] = bz[:h, :w]
                uv[b, ty:ty + h, tx:tx + w] = bu[:h, :w]
    return face, best, uv


@pytest.mark.parametrize("case", ["random", "ties"])
def test_kernel_records_and_cull_equal_plain_exactly(case):
    if case == "random":
        pix, depth, faces, face_uv = random_mesh(4, 37, 45, n_faces=50)
        H, W = 37, 45
    else:
        (pix, depth, faces), H, W = tie_mesh(), 31, 33
        face_uv = np.random.RandomState(5).rand(len(faces), 3, 2).astype(np.float32)
    face, dep, uv = emulate_kernel(pix, depth, faces, H, W, face_uv)
    want = _port(pix, depth, faces, H, W, face_uv)
    np.testing.assert_array_equal(face, want.face_index.numpy())
    np.testing.assert_array_equal(dep, want.depth.numpy())
    np.testing.assert_array_equal(uv, want.uv.numpy())


def test_dispatch_by_device():
    pix, depth, faces, face_uv = random_mesh(6, 20, 24)
    before = dict(launch_counts)
    out = rasterizer.rasterize(torch.from_numpy(pix), torch.from_numpy(depth), torch.from_numpy(faces),
                               20, 24, face_uv=torch.from_numpy(face_uv))
    assert out.barys is None and out.uv.shape == (2, 20, 24, 2)
    assert dict(launch_counts) == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="no raster kernel"):
        rasterizer.rasterize(*(torch.from_numpy(a).to("meta") for a in (pix, depth, faces)), 20, 24)
    with pytest.raises(ValueError, match="different devices"):
        rasterizer.rasterize(torch.from_numpy(pix), torch.from_numpy(depth).to("meta"),
                             torch.from_numpy(faces), 20, 24)
    with pytest.raises(ValueError, match="CUDA tensors"):
        raster.rasterize_cuda(torch.from_numpy(pix), torch.from_numpy(depth), torch.from_numpy(faces), 20, 24)


def test_render_mesh_samples_the_texture_where_covered():
    pix, depth, faces, face_uv = random_mesh(7, 24, 20)
    uv_coords = face_uv.reshape(-1, 2)
    uv_faces = np.arange(len(uv_coords)).reshape(-1, 3)
    tex = np.random.RandomState(8).rand(2, 3, 16, 16).astype(np.float32)
    img, ras = rasterizer.render_mesh(
        torch.from_numpy(pix), torch.from_numpy(depth), torch.from_numpy(faces).long(),
        torch.from_numpy(uv_coords), torch.from_numpy(uv_faces), torch.from_numpy(tex), 24, 20)
    cov = (ras.face_index >= 0).numpy()
    assert img.shape == (2, 24, 20, 3) and (img.numpy()[~cov] == 0).all()
    # the UV the raster carries equals the barycentric interpolation
    bary = _port(pix, depth, faces, 24, 20).barys
    want_uv = rasterizer.interpolate_uv(ras._replace(barys=bary), torch.from_numpy(uv_coords),
                                        torch.from_numpy(uv_faces))
    np.testing.assert_allclose(ras.uv.numpy()[cov], want_uv.numpy()[cov], atol=TOL)
