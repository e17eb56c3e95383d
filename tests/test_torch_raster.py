"""The port's rasterizer (kernels/raster.py) on the CPU, against the JAX package.

``rasterize_reference`` (the plain version, what a CPU tensor takes) is
held to ``render/rasterizer.py:_rasterize_xla`` and to the TPU kernel
``ops/pallas_raster.py:rasterize_pallas`` run in interpret mode: coverage
equal, face ids equal on >= 99.9% of covered pixels (edge pixels may flip
where XLA contracts products into FMAs), depth / barycentrics / UV within
1e-5 where the ids agree.  The CUDA kernels' face records, tile rectangles,
tile and coarse-bin worklists and shared-memory stages are checked through a
numpy emulation (``tests/raster_emulation.py``), which must equal the plain
version exactly and list every face that can win a pixel for that pixel's
tile.  The kernels themselves run in ``tests/test_torch_cuda.py``, held to
the same emulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio2photoreal_tpu.ops.pallas_raster import rasterize_pallas
from audio2photoreal_tpu.render.rasterizer import _rasterize_xla
from audio2photoreal_tpu_torch.kernels import launch_counts, raster
from audio2photoreal_tpu_torch.render import rasterizer
from chip_smoke import crowded_tile_arrays
from raster_emulation import (  # tests/raster_emulation.py
    MAX_BINS,
    STAGE,
    TILE,
    emulate_kernel,
    emulate_setup,
    emulate_stages,
    layout,
    scratch_offsets,
    tile_list,
)
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

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


def edge_mesh():
    """Faces whose bbox ends exactly one pixel outside tile 1 of a row or a
    column (listed there) and one float32 step beyond (not listed)."""
    f32 = np.float32
    below, above = np.nextafter(f32(15), f32(0)), np.nextafter(f32(32), f32(64))
    tris = [
        [(5, 5), (15, 5), (5, 12)],  # x_max = 15: reaches tile column 1
        [(5, 5), (below, 5), (5, 12)],  # x_max just below 15: does not
        [(32, 20), (40, 20), (32, 28)],  # x_min = 32: reaches tile column 1
        [(above, 20), (40, 20), (above, 28)],  # x_min just above 32: does not
        [(5, 5), (12, 5), (5, 15)],  # y_max = 15: reaches tile row 1
        [(5, 5), (12, 5), (5, below)],
        [(20, 32), (28, 32), (20, 40)],  # y_min = 32
        [(20, above), (28, above), (20, 40)],
        [(14, 14), (34, 15), (15, 34)],  # covers tile (1, 1)'s edges from inside
    ]
    pix = np.asarray(tris, np.float32).reshape(1, -1, 2)
    depth = np.linspace(1.0, 2.0, pix.shape[1], dtype=np.float32)[None]
    faces = np.arange(pix.shape[1]).reshape(-1, 3)
    return pix, depth, faces, 40, 48


def huge_mesh():
    """Corners at +-1e30 beside on-screen ones (finite det: huge slivers over
    the image), faces entirely off screen on every side or at +-1e30, a
    non-finite corner, and a few ordinary faces."""
    pix = np.array([[
        [10, 10], [1e30, 12], [12, 30],  # a sliver to x = +1e30
        [-1e30, -1e30], [20, 5], [5, 20],  # a sliver from (-1e30, -1e30)
        [-500, 10], [-300, 20], [-400, 40],  # off screen to the left
        [10, 500], [30, 600], [20, 700],  # below
        [1e30, 1e30], [2e30, 1e30], [1e30, 3e30],  # far off at +1e30
        [-1e30, 5], [-2e30, 9], [-1e30, 30],  # far off at -1e30
        [5, 5], [np.inf, 8], [9, 30],  # a non-finite corner
        [2, 2], [40, 6], [8, 45],
        [30, 30], [45, 33], [33, 47],
    ]], np.float32)
    depth = np.linspace(0.5, 3.0, pix.shape[1], dtype=np.float32)[None]
    faces = np.arange(pix.shape[1]).reshape(-1, 3)
    return pix, depth, faces, 49, 50


def cover_all_mesh():
    """One face over every tile (listed in every coarse bin) above random
    faces, and one behind them."""
    H, W = 70, 90
    pix, depth, faces, _ = random_mesh(11, H, W, B=1, n_verts=30, n_faces=40)
    big = np.array([[[-100, -100], [4 * W, -100], [-100, 4 * H], [-50, -60], [2 * W, -60], [-50, 2 * H]]],
                   np.float32)
    pix = np.concatenate([pix, big], 1)
    depth = np.concatenate([depth, [[0.2, 0.2, 0.2, 9.0, 9.0, 9.0]]], 1).astype(np.float32)
    faces = np.concatenate([faces, [[30, 31, 32], [33, 34, 35]]])
    return pix, depth, faces, H, W


def _case(name):
    if name == "random":
        pix, depth, faces, face_uv = random_mesh(4, 37, 45, n_faces=50)
        return pix, depth, faces, face_uv, 37, 45
    if name == "crowded":
        return crowded_tile_arrays()
    if name == "ties":
        (pix, depth, faces), H, W = tie_mesh(), 31, 33
    else:
        pix, depth, faces, H, W = {"edges": edge_mesh, "huge": huge_mesh, "cover_all": cover_all_mesh}[name]()
    face_uv = np.random.RandomState(5).rand(len(faces), 3, 2).astype(np.float32)
    return pix, depth, faces, face_uv, H, W


@pytest.mark.parametrize("case", ["random", "ties", "edges", "huge", "cover_all", "crowded", "shuffled"])
def test_kernel_records_and_cull_equal_plain_exactly(case):
    pix, depth, faces, face_uv, H, W = _case("random" if case == "shuffled" else case)
    face, dep, uv = emulate_kernel(pix, depth, faces, H, W, face_uv, order_seed=13 if case == "shuffled" else None)
    want = _port(pix, depth, faces, H, W, face_uv)
    np.testing.assert_array_equal(face, want.face_index.numpy())
    np.testing.assert_array_equal(dep, want.depth.numpy())
    np.testing.assert_array_equal(uv, want.uv.numpy())


@pytest.mark.parametrize("case", ["random", "ties", "edges", "huge", "cover_all", "crowded"])
def test_tile_ranges_equal_the_emulated_setup(case):
    """The emulated setup's tile rectangles are the earlier sweep's rule
    evaluated exactly: tile t of a row is reached when x_min <= TILE t + TILE
    and x_max >= TILE t - 1, clamped to the image's tiles; no tile for a face
    with |det| <= 1e-12 or a non-finite corner."""
    pix, depth, faces, face_uv, H, W = _case(case)
    rect = emulate_setup(pix, depth, faces, face_uv, H, W)[1]
    g = layout(H, W)
    tri = pix[:, faces].astype(np.float64)  # [B, F, 3, 2]
    xs, ys = tri[..., 0], tri[..., 1]
    with np.errstate(invalid="ignore", over="ignore"):
        det = (ys[..., 1] - ys[..., 2]) * (xs[..., 0] - xs[..., 2]) + (xs[..., 2] - xs[..., 1]) * (
            ys[..., 0] - ys[..., 2])
        live = (np.abs(det.astype(np.float32)) > np.float32(1e-12)) & np.isfinite(tri).all((-1, -2))
        first = lambda lo: np.maximum(np.ceil(lo / TILE) - 1, 0)  # noqa: E731
        last = lambda hi, n: np.minimum(np.floor((hi + 1) / TILE), n - 1)  # noqa: E731
        want = np.stack([first(xs.min(-1)), last(xs.max(-1), g.ntx), first(ys.min(-1)), last(ys.max(-1), g.nty)], -1)
    want[~(live & (want[..., 0] <= want[..., 1]) & (want[..., 2] <= want[..., 3]))] = [0, -1, 0, -1]
    np.testing.assert_array_equal(rect, want.astype(np.int64))


def test_faces_at_tile_edges_are_listed_by_the_old_cull_rule():
    pix, depth, faces, H, W = edge_mesh()
    setup = emulate_setup(pix, depth, faces, np.zeros((len(faces), 3, 2), np.float32), H, W)
    rect = setup[1][0]
    assert rect[0, 1] == 1 and rect[1, 1] == 0  # x_max = 15 reaches column 1; just below does not
    assert rect[2, 0] == 1 and rect[3, 0] == 2  # x_min = 32 reaches column 1; just above does not
    assert rect[4, 3] == 1 and rect[5, 3] == 0
    assert rect[6, 2] == 1 and rect[7, 2] == 2
    for (tx, ty), yes, no in (((1, 0), 0, 1), ((1, 1), 2, 3), ((0, 1), 4, 5), ((1, 1), 6, 7)):
        listed = tile_list(setup, H, W, 0, tx, ty)
        assert yes in listed and no not in listed
    assert 8 in tile_list(setup, H, W, 0, 1, 1)
    # the rule of the earlier sweep, evaluated exactly: tile t reached when
    # x_min <= 16 t + 16 and x_max >= 16 t - 1
    g = layout(H, W)
    xs, ys = pix[0, faces, 0].astype(np.float64), pix[0, faces, 1].astype(np.float64)
    for f in range(len(faces)):
        for ty in range(g.nty):
            for tx in range(g.ntx):
                old = (xs[f].min() <= 16 * tx + 16 and xs[f].max() >= 16 * tx - 1
                       and ys[f].min() <= 16 * ty + 16 and ys[f].max() >= 16 * ty - 1)
                assert (f in tile_list(setup, H, W, 0, tx, ty)) == old, (f, tx, ty)


def test_huge_and_off_screen_faces_are_clamped():
    pix, depth, faces, H, W = huge_mesh()
    g = layout(H, W)
    rect = emulate_setup(pix, depth, faces, np.zeros((len(faces), 3, 2), np.float32), H, W)[1][0]
    assert (rect[:2] == [[0, g.ntx - 1, 0, 1], [0, 1, 0, 1]]).all()  # the slivers, clamped
    assert (rect[2:7] == [0, -1, 0, -1]).all()  # off screen, at +-1e30, non-finite: no tile
    assert rect[7:].min() >= 0 and rect[7:, [1, 3]].max() < max(g.ntx, g.nty)


def test_one_face_over_every_tile_is_in_every_coarse_bin():
    pix, depth, faces, face_uv, H, W = _case("cover_all")
    setup = emulate_setup(pix, depth, faces, face_uv, H, W)
    g = layout(H, W)
    big = len(faces) - 2
    assert g.nbins > 1 and all(big in lst and big + 1 in lst for lst in setup[3][0])
    for ty in range(g.nty):
        for tx in range(g.ntx):
            assert big in tile_list(setup, H, W, 0, tx, ty)
    want = _port(pix, depth, faces, H, W, face_uv)
    assert (want.face_index.numpy() >= 0).all()


def test_crowded_tile_takes_several_stages():
    pix, depth, faces, face_uv, H, W = _case("crowded")
    rec, rect, tiles, bins = emulate_setup(pix, depth, faces, face_uv, H, W)
    g = layout(H, W)
    # crowded_tile_arrays: 2,000 tiny faces in tile (1, 1), then 5 others;
    # frame 1 lists the triangles the other way round
    for b, tiny in enumerate((range(2000), range(5, 2005))):
        own = tiles[b][g.ntx + 1]
        stages = emulate_stages(rect, tiles, bins, g, b, 1, 1)
        assert set(tiny) <= set(own) and len(own) > 4 * STAGE
        assert sorted(f for s in stages for f in s) == sorted(own)
        assert len(stages) >= 8 and max(len(s) for s in stages) == STAGE


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), H=st.integers(1, 50), W=st.integers(1, 50),
       n_faces=st.integers(1, 30), spread=st.sampled_from([1.0, 4.0, 1e3]))
def test_every_winning_face_is_in_its_tiles_list(seed, H, W, n_faces, spread):
    """The plain version's winner at every covered pixel is listed for the
    pixel's tile: the worklists drop no face that can win."""
    rng = np.random.RandomState(seed)
    n_verts = 3 * n_faces
    centre = rng.rand(n_faces, 1, 2) * [W + 20, H + 20] - 10
    pix = (centre + (rng.rand(n_faces, 3, 2) - 0.5) * rng.rand(n_faces, 1, 1) * 40 * spread)
    pix = pix.astype(np.float32).reshape(1, n_verts, 2)
    depth = (rng.rand(1, n_verts) * 4 + 0.5).astype(np.float32)
    faces = rng.randint(0, n_verts, (n_faces, 3)) if seed % 3 == 0 else np.arange(n_verts).reshape(-1, 3)
    face_uv = np.zeros((n_faces, 3, 2), np.float32)
    want = _port(pix, depth, faces, H, W).face_index.numpy()[0]
    setup = emulate_setup(pix, depth, faces, face_uv, H, W)
    t = TILE
    for ty in range(-(-H // t)):
        for tx in range(-(-W // t)):
            winners = set(want[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t].ravel()) - {-1}
            assert winners <= set(tile_list(setup, H, W, 0, tx, ty)), (tx, ty)


def test_scratch_stays_small_at_the_dense_mesh():
    """Scratch of the 85,562-face mesh_density=30 mesh at frame batch 8 and
    the render's 1024x667: well under 1 GB (the bins' F slots a face bound
    it, not the tiles)."""
    g = layout(1024, 667)
    assert (g.ntx, g.nty) == (42, 64) and g.nbins <= MAX_BINS
    assert scratch_offsets(8, 85_562, 1024, 667)[-1] < 160e6
    assert scratch_offsets(8, 9_322, 1024, 667)[-1] < 20e6


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
