#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio2photoreal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and the CUDA toolkit
(nvcc).  Each phase prints one JSON line; any failure is an uncaught
exception and a nonzero exit.

1. device: the card, its power limit, torch/CUDA versions; TF32 is turned off
   for matmuls and cuDNN convs, so f32 stays f32 throughout.
2. build: compile every kernel library from kernels/csrc/ (nvcc, sm_90a), one
   nvcc per library, all started together; ptxas registers and spills.
3. kernel vs plain, attention: the CUDA attention kernel against its plain
   PyTorch version on the card, f32 and bf16, at the denoiser's shapes and a
   small ragged masked case; max abs error, the time of each, the time of
   ``scaled_dot_product_attention`` with the same mask (a yardstick only),
   and the bound (f32 FLOPs over the CUDA-core rate, bf16 FLOPs over the
   tensor-core rate, against bytes over the HBM rate).
4. kernel vs plain, raster: the tile rasterizer against its plain version at
   the full image (1024x667) on the mesh_density=10 synthetic mesh (9,322
   faces) posed by random poses and projected by the synthetic rig's two
   cameras (render/assets.py:synthetic_rig, the body about 800 rows tall), at
   frame batch 2 and 8 (the main path's), and on a small ragged case with
   degenerate and depth-tied faces; face ids and coverage equal, depth / UV /
   barycentrics within 1e-5.  Then frame batch 16, 24 and 32, kernel alone,
   each frame equal to the batch-8 result for its pose.
5. slice parity: a full-width pose denoiser from ``--seed``, encode + cached
   CFG + DDIM-5 from one numpy x_T, on the card (with the kernel) against the
   CPU (plain attention).
6. render parity: a full-width BodyAvatar (RendererConfig() defaults) from
   ``--seed``, 1 frame x 2 cameras through render_sequence_multicam, on the
   card (kernel) against the CPU (plain raster): uint8 frames within 1 count
   on >= 99.9% of the pixels that either render covers, coverage equal on
   >= 99.99% of all pixels.
7. main path: ``apps.generate.generate`` on a synthetic person, full-width
   pose model, DDIM-500, CFG 2.0, 2 samples (attention kernel launches
   counted: 8 layers x 2 attentions x 500 steps); then sample 0's first 64
   frames with the ground-truth face codes of the same chunks rendered at
   full width by ``load_body_renderer`` + ``render_full_video``: frame batch
   8, the 2 rig cameras, the mesh_density=10 assets (raster launches
   counted: 8 batches x 2 cameras).

Then one line with every kernel's numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Work files go to build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "audio2photoreal_tpu_torch"
WORK = os.path.join(ROOT, "build", "chip_smoke")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # kernel vs plain, unit-normal inputs
SLICE_TOL = 1e-3  # card vs CPU pred_xstart after DDIM-5
RASTER_TOL = 1e-5  # depth / UV / barycentrics, kernel vs plain
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by input
# type, f32 on the CUDA cores and bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
RASTER_FLOPS_PER_TEST = 17  # csrc/raster.cu: 9 mul + 8 add/sub per listed (pixel, face)
# (B, H, Tq, Tk, Dh, masked): self- and cross-attention of the pose denoiser
# under CFG with 2 samples, the face width, and a ragged kv_valid + causal case
KERNEL_CASES = [
    (4, 4, 600, 600, 64, False),
    (4, 4, 600, 2000, 64, False),
    (4, 4, 600, 2000, 128, False),
    (2, 3, 77, 203, 64, True),
]
MAIN_CASE = (4, 4, 600, 2000, 64, False)  # the kernel's numbers in the summary line
RENDER_FRAMES, RENDER_BATCH = 64, 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build() -> None:
    from audio2photoreal_tpu_torch.kernels import build, flash_attn, raster

    def one(mod):
        path = build.library_path(mod.NAME, mod.SOURCES)
        cached = path.exists()
        t0 = time.perf_counter()
        mod.library()
        return mod, path, cached, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        results = list(pool.map(one, (flash_attn, raster)))
    wall = time.perf_counter() - t0
    for mod, path, cached, seconds in results:
        log = path.with_suffix(".log").read_text()
        ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        emit("build", kernel=mod.NAME, library=os.path.relpath(path, ROOT), already_built=cached,
             seconds=seconds, all_builds_wall_s=wall, ptxas=ptxas)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the card's peak rate for the inputs' type."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOP_PER_S[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_reference
    from audio2photoreal_tpu_torch.ops.attention import causal_bias, padding_bias

    g = torch.Generator(device="cuda").manual_seed(seed)
    summary = {}
    for B, H, Tq, Tk, Dh, masked in KERNEL_CASES:
        q, k, v = (torch.randn((B, H, T, Dh), generator=g, device="cuda") for T in (Tq, Tk, Tk))
        kv_valid = None
        if masked:  # the last keys of every batch row but the last are masked
            lengths = torch.tensor([Tk - 50 * (B - 1 - b) for b in range(B)], device="cuda")
            kv_valid = (torch.arange(Tk, device="cuda")[None] < lengths[:, None]).float()
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            args = (qd, kd, vd, kv_valid, masked)
            got = flash_attention(*args)
            want = flash_attention_reference(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).replace("torch.", "")
            # the library call with the same additive mask, as a yardstick
            mask = None
            if masked:
                mask = (padding_bias(kv_valid) + causal_bias(Tq, Tk, device="cuda")).to(dtype)
            lib = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
            lib_err = (lib().float() - want.float()).abs().max().item()
            # in turns: plain, kernel, kernel, plain
            p1 = _time_ms(lambda: flash_attention_reference(*args))
            k1 = _time_ms(lambda: flash_attention(*args))
            k2 = _time_ms(lambda: flash_attention(*args))
            p2 = _time_ms(lambda: flash_attention_reference(*args))
            l1 = _time_ms(lib)
            item = qd.element_size()
            nbytes = item * (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) + (4 * B * Tk if masked else 0)
            bound_ms, bound_by = _bound(nbytes, 4.0 * B * H * Tq * Tk * Dh, name)
            row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, kv_valid_causal=masked, dtype=name,
                       max_abs_err=err, tol=TOL[name], ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       library_ms=l1, library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by)
            emit("kernel_vs_plain", kernel="flash_attn_fwd", **row)
            if not err <= TOL[name]:
                raise AssertionError(f"flash_attn_fwd disagrees with its plain version: {row}")
            if (B, H, Tq, Tk, Dh, masked) == MAIN_CASE and name == "float32":
                summary = row
    return summary


def _raster_inputs(assets, cams, motion):
    """[B = poses x cameras] projected vertices of the LBS-posed template."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.render.geometry import project_points

    verts = assets.lbs.pose(None, motion)  # [P, V, 3]
    pix, dep = [], []
    for c in cams.values():
        K = torch.as_tensor(np.asarray(c.K), device=verts.device)[None].expand(len(verts), 3, 3)
        Rt = torch.as_tensor(np.asarray(c.Rt), device=verts.device)[None].expand(len(verts), 3, 4)
        p, d = project_points(verts, K, Rt)
        pix.append(p)
        dep.append(d)
    # frame order: pose-major, camera-minor
    return torch.stack(pix, 1).flatten(0, 1).contiguous(), torch.stack(dep, 1).flatten(0, 1).contiguous()


def _raster_cost(pix, dep, faces, face_uv, H, W, emit_barys):
    """(bytes, flops, tests) of one wrapper call on these inputs: vertices,
    faces and corner UVs read once, every output plane written once; 17 f32
    operations per (pixel, listed face).  A face is listed for a tile when
    its screen bbox touches the tile widened by one pixel and |det| > 1e-12,
    as csrc/raster.cu lists them."""
    import torch

    tri = pix[:, faces.long()]  # [B, F, 3, 2]
    xs, ys = tri[..., 0], tri[..., 1]
    (xa, xb, xc), (ya, yb, yc) = xs.unbind(-1), ys.unbind(-1)
    det = (yb - yc) * (xa - xc) + (xc - xb) * (ya - yc)
    live = (det.abs() > 1e-12) & torch.isfinite(xs).all(-1) & torch.isfinite(ys).all(-1)
    bbox = torch.stack([xs.amin(-1), xs.amax(-1), ys.amin(-1), ys.amax(-1)], -1)  # [B, F, 4]
    t = 16
    nty, ntx = -(-H // t), -(-W // t)
    x0 = torch.arange(ntx, device=pix.device, dtype=torch.float32) * t
    y0 = torch.arange(nty, device=pix.device, dtype=torch.float32) * t
    ox = ((bbox[:, None, :, 0] <= x0[None, :, None] + t) & (bbox[:, None, :, 1] >= x0[None, :, None] - 1)
          & live[:, None]).float()
    oy = ((bbox[:, None, :, 2] <= y0[None, :, None] + t) & (bbox[:, None, :, 3] >= y0[None, :, None] - 1)).float()
    listed = torch.einsum("byf,bxf->byx", oy, ox)  # [B, nty, ntx] faces listed per tile
    px = torch.clamp(W - x0, max=t)  # pixels per tile column / row inside the image
    py = torch.clamp(H - y0, max=t)
    tests = float((listed * py[None, :, None] * px[None, None, :]).sum())
    B = pix.shape[0]
    per_pixel = 4 + 4 + (8 if face_uv is not None else 0) + (12 if emit_barys else 0)
    inputs = pix.numel() * 4 + dep.numel() * 4 + faces.numel() * faces.element_size()
    inputs += face_uv.numel() * 4 if face_uv is not None else 0
    return inputs + B * H * W * per_pixel, tests * RASTER_FLOPS_PER_TEST, tests


def _raster_compare(got, want) -> dict:
    import torch

    cov = want.face_index >= 0
    out = dict(ids_equal=bool(torch.equal(got.face_index, want.face_index)),
               coverage_equal=bool(torch.equal(got.face_index >= 0, cov)),
               covered_share=float(cov.float().mean()))
    errs = [(got.depth[cov] - want.depth[cov]).abs().max().item() if cov.any() else 0.0]
    for name in ("uv", "barys"):
        a, b = getattr(got, name), getattr(want, name)
        if a is not None and b is not None:
            errs.append((a - b).abs().max().item())
    out["max_abs_err"] = max(errs)
    out["ok"] = out["ids_equal"] and out["coverage_equal"] and out["max_abs_err"] <= RASTER_TOL
    return out


def _ragged_case(device):
    """Odd H and W, random faces partly off screen, a duplicated face and a
    face at the same places (exact depth ties), collinear and behind-camera
    faces."""
    import numpy as np
    import torch

    rng = np.random.RandomState(5)
    H, W = 61, 77
    pix = (rng.rand(2, 40, 2) * [W + 20, H + 20] - 10).astype(np.float32)
    dep = (rng.rand(2, 40) * 4 + 0.5).astype(np.float32)
    pix[:, 30:33] = [[3, 4], [50, 9], [20, 45]]
    pix[:, 33] = pix[:, 30]
    pix[:, 34:37] = [[10, 10], [20, 20], [40, 40]]
    dep[:, 30:37] = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    dep[:, 37:40] = -2.0
    faces = rng.randint(0, 30, (300, 3))
    faces[10] = faces[20] = [30, 31, 32]
    faces[15] = [33, 31, 32]
    faces[25] = [34, 35, 36]
    faces[26] = [37, 38, 39]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    face_uv = t(rng.rand(300, 3, 2).astype(np.float32))
    return t(pix), t(dep), t(faces.astype(np.int64)), face_uv, H, W


def phase_raster(seed: int) -> dict:
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.kernels import raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    cfg = RendererConfig()
    H, W = cfg.image_height, cfg.image_width
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10).to("cuda")
    geo = assets.geo
    faces, face_uv = geo.faces, geo.uv_coords[geo.uv_faces].contiguous()
    cams = synthetic_rig((0.0, 0.0, 1.0), H, W)
    rng = np.random.RandomState(seed)
    motion = torch.from_numpy((rng.randn(4, 104) * 0.3).astype(np.float32)).to("cuda")
    pix8, dep8 = _raster_inputs(assets, cams, motion)  # [8, V, 2]: 4 poses x 2 cameras

    summary = {}
    ragged = _ragged_case("cuda")
    cases = [("ragged_ties", *ragged[:4], ragged[4], ragged[5], True),
             ("full_b2", pix8[:2], dep8[:2], faces, face_uv, H, W, True),
             ("full_b8", pix8, dep8, faces, face_uv, H, W, False)]
    results = {}
    for name, pix, dep, fc, fuv, h, w, barys in cases:
        got = raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)
        want = raster.rasterize_reference(pix, dep, fc, h, w, fuv, emit_barys=barys)
        torch.cuda.synchronize()
        cmp = _raster_compare(got, want)
        results[name] = got
        B = pix.shape[0]
        call = lambda: raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)  # noqa: E731
        plain = lambda: raster.rasterize_reference(pix, dep, fc, h, w, fuv, emit_barys=barys)  # noqa: E731
        # in turns: plain, kernel, kernel, plain (the plain version is slow: one call each)
        p1 = _time_ms(plain, iters=1, warmup=1)
        k1 = _time_ms(call)
        k2 = _time_ms(call)
        p2 = _time_ms(plain, iters=1, warmup=0)
        nbytes, flops, tests = _raster_cost(pix, dep, fc, fuv, h, w, barys)
        bound_ms, bound_by = _bound(nbytes, flops)
        row = dict(case=name, B=B, H=h, W=w, faces=int(fc.shape[0]), emit_barys=barys, **cmp,
                   tol=RASTER_TOL, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by, listed_tests=tests, bytes=nbytes)
        emit("kernel_vs_plain", kernel=raster.NAME, **row)
        if not cmp["ok"]:
            raise AssertionError(f"{raster.NAME} disagrees with its plain version: {row}")
        if name == "full_b8":
            summary = row
    # frame batches the TPU kernel could not run, kernel alone: frame i is pose i % 8
    ref = results["full_b8"]
    for B in (16, 24, 32):
        idx = torch.arange(B, device="cuda") % 8
        got = raster.rasterize_cuda(pix8[idx], dep8[idx], faces, H, W, face_uv, emit_barys=False)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got, k), getattr(ref, k)[idx]) for k in ("face_index", "depth", "uv"))
        ms = _time_ms(lambda: raster.rasterize_cuda(pix8[idx], dep8[idx], faces, H, W, face_uv,
                                                     emit_barys=False), iters=10)
        emit("raster_batch", B=B, H=H, W=W, frames_equal_batch8=same, ms=ms, ms_per_frame=ms / B)
        if not same:
            raise AssertionError(f"frame batch {B}: frames differ from the batch-8 result")
    return summary


def _pose_model(seed: int, **overrides):
    import torch

    from audio2photoreal_tpu_torch.core.config import DenoiserConfig
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    cfg = DenoiserConfig(data_format="pose", flash_attention=True, **overrides)
    model = FiLMDenoiser(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, model.eval()


def phase_slice_parity(seed: int) -> None:
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    cfg, model_cpu = _pose_model(seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    rng = np.random.RandomState(seed)
    B, T = 1, cfg.max_seq_length
    inputs = [
        rng.randn(B, T * 1600, 2).astype(np.float32),  # z-normed 48 kHz stereo
        rng.randn(B, -(-T // cfg.keyframe_step), cfg.key_feature_dim).astype(np.float32),
        np.ones((B, -(-T // cfg.keyframe_step)), np.float32),
    ]
    x_T = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    sched = maybe_respaced("cosine", 1000, "ddim5")

    def run(model, device):
        audio, kf, kv = (torch.from_numpy(a).to(device) for a in inputs)
        with torch.no_grad():
            cond = model.encode_conditioning(audio, kf, kv)
            model_fn = cfg_model_fn_cached(model, cond, 2.0)
            res = ddim_sample_loop(sched, "xstart", model_fn, torch.from_numpy(x_T).to(device))
        return res.pred_xstart.cpu().numpy()

    before = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    gpu = run(model_gpu, "cuda")
    gpu_s = time.perf_counter() - t0
    launches = launch_counts[flash_attn.NAME] - before
    t0 = time.perf_counter()
    cpu = run(model_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu - cpu).max())
    row = dict(steps=5, guidance=2.0, batch=B, latent=cfg.latent_dim, layers=cfg.num_layers,
               max_abs_err=err, tol=SLICE_TOL, kernel_launches=launches,
               gpu_s=gpu_s, cpu_s=cpu_s, finite=bool(np.isfinite(gpu).all()))
    emit("slice_parity", **row)
    if not (row["finite"] and err <= SLICE_TOL and launches == cfg.num_layers * 2 * 5):
        raise AssertionError(f"card and CPU disagree on the pose slice: {row}")


def _avatar_state_dict(cfg, assets, seed: int):
    import torch

    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar

    model = BodyAvatar(cfg, assets)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.state_dict()


def phase_render_parity(seed: int) -> None:
    import numpy as np

    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    cfg = RendererConfig()
    t0 = time.perf_counter()
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10)
    sd = _avatar_state_dict(cfg, assets, seed)
    setup_s = time.perf_counter() - t0
    cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width)
    rng = np.random.RandomState(seed + 1)
    pose = (rng.randn(1, 104) * 0.3).astype(np.float32)
    face = (rng.randn(1, 256) * 0.3).astype(np.float32)
    out, secs = {}, {}
    for device in ("cuda", "cpu"):
        r = BodyRenderer(cfg, assets, sd, cams, frame_batch=1, device=device)
        t0 = time.perf_counter()
        out[device] = r.render_sequence_multicam(pose, face)
        secs[device] = time.perf_counter() - t0
        del r
    gpu, cpu = out["cuda"].astype(np.int32), out["cpu"].astype(np.int32)
    diff = np.abs(gpu - cpu)
    # coverage: a pixel is covered where a render is not background; the
    # 1-count share is read over the pixels that either render covers
    cov_g, cov_c = gpu.any(-1), cpu.any(-1)
    within = diff.max(-1) <= 1
    either = cov_g | cov_c
    row = dict(frames=1, cameras=2, shape=list(out["cuda"].shape), uv=cfg.uv_size, upscale=cfg.upscale_size,
               face_tex=cfg.face_tex_size, image=[cfg.image_height, cfg.image_width],
               within_1_count_covered=float(within[either].mean()) if either.any() else 0.0,
               within_1_count_all=float(within.mean()), max_count_diff=int(diff.max()),
               coverage_gpu=float(cov_g.mean()), coverage_cpu=float(cov_c.mean()),
               coverage_agree=float((cov_g == cov_c).mean()), setup_s=setup_s,
               gpu_s=secs["cuda"], cpu_s=secs["cpu"], cut=None)
    emit("render_parity", **row)
    if not (row["within_1_count_covered"] >= 0.999 and row["coverage_agree"] >= 0.9999
            and 0.02 <= row["coverage_gpu"] <= 0.9):
        raise AssertionError(f"card and CPU disagree on the render: {row}")


def phase_main_path(seed: int, smi: str) -> dict:
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, find_stats, generate
    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
    from audio2photoreal_tpu_torch.core.config import DataConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts, raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, save_renderer_bundle, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    shutil.rmtree(WORK, ignore_errors=True)
    person, num_samples, steps = "SYNTH01", 2, 500
    t0 = time.perf_counter()
    make_synthetic_person(WORK, person, num_scenes=8, frames_per_scene=600, seed=seed)
    cfg, model = _pose_model(seed)
    model_dir = os.path.join(WORK, "pose_model")
    datacfg = DataConfig(person=person, max_seq_length=cfg.max_seq_length)
    save_config(model_dir, denoiser=cfg, diffusion=DiffusionConfig(), data=datacfg)
    torch.save(model.state_dict(), os.path.join(model_dir, MODEL_FILE))
    setup_s = time.perf_counter() - t0

    # --- pose: generate ---------------------------------------------------
    timings: dict = {}
    launch_counts.clear()
    t0 = time.perf_counter()
    path = generate(model_dir, WORK, num_samples=num_samples, guidance_param=2.0,
                    timestep_respacing=f"ddim{steps}", device="cuda", timings=timings)
    total_s = time.perf_counter() - t0
    attn_launches = launch_counts[flash_attn.NAME]

    res = np.load(path, allow_pickle=True).item()
    T = cfg.max_seq_length
    checks = {
        "motions_shape": list(res["motions"].shape) == [num_samples, cfg.nfeats, 1, T],
        "motions_finite": bool(np.isfinite(res["motions"]).all()),
        "keys": all(k in res for k in ("gt", "audio", "lengths", "keyframes")),
        "attention_launches": attn_launches == cfg.num_layers * 2 * steps,
    }
    audio_s = num_samples * T / 30.0
    emit("main_path_generate", nvidia_smi=smi, samples=num_samples, ddim_steps=steps, guidance=2.0,
         latent=cfg.latent_dim, layers=cfg.num_layers, heads=cfg.num_heads,
         setup_s=setup_s, encode_s=timings["encode_s"], ddim_s=timings["ddim_s"],
         generate_s=total_s, audio_s=audio_s, audio_s_per_wall_s=audio_s / total_s,
         kernel_launches=attn_launches, motions_shape=list(res["motions"].shape), checks=checks)

    # --- the face branch's stand-in: ground-truth face codes of the same
    # test chunks, with the same audio, in the face model's results.npy layout
    t0 = time.perf_counter()
    scenes = load_local_data(WORK, person)
    stats = find_stats(os.path.join(WORK, person))
    face_ds = SocialDataset(scenes, stats, DataConfig(person=person, data_format="face",
                                                      max_seq_length=T), "test")
    chunks = [face_ds.get_chunk(i) for i in range(num_samples)]
    codes = np.stack([stats.inv_code(c["motion"]) for c in chunks])  # [B, T, 256]
    face_res = {"motions": codes.transpose(0, 2, 1)[:, :, None], "gt": codes.transpose(0, 2, 1)[:, :, None],
                "audio": stats.inv_audio(np.stack([c["audio"] for c in chunks])),
                "lengths": np.stack([c["lengths"] for c in chunks])}
    np.save(os.path.join(WORK, "face_results.npy"), face_res)
    if not np.array_equal(face_res["audio"], res["audio"]):
        raise AssertionError("the face codes' audio differs from the pose run's audio")

    # --- render: a full-width renderer bundle, loaded as a user would --------
    rcfg = RendererConfig()
    bundle_assets = make_synthetic_assets(rcfg, seed=seed, mesh_density=10)
    # the rig frames the person where its root stands on average (pose[0:3])
    cams = synthetic_rig(stats.pose_mean[:3] + np.array([0.0, 0.0, 1.0]), rcfg.image_height, rcfg.image_width)
    bundle = save_renderer_bundle(os.path.join(WORK, "renderer"), rcfg,
                                  _avatar_state_dict(rcfg, bundle_assets, seed), cams,
                                  seed=seed, mesh_density=10)
    del bundle_assets
    renderer = load_body_renderer(bundle, frame_batch=RENDER_BATCH, device="cuda")
    render_setup_s = time.perf_counter() - t0
    n = RENDER_FRAMES
    body = res["motions"][0].transpose(2, 0, 1)[:n, :, 0]
    face = face_res["motions"][0].transpose(2, 0, 1)[:n, :, 0]

    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = renderer.render_sequence_multicam(body, face)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    raster_launches = launch_counts[raster.NAME]
    render_attn = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    video = renderer.render_full_video(
        {"audio": res["audio"][0][: n * datacfg.audio_per_frame], "body_motion": body, "face_motion": face},
        os.path.join(WORK, "sample00_rep00"))
    video_s = time.perf_counter() - t0
    covered = (frames.reshape(n, rcfg.image_height, 2, rcfg.image_width, 3).any(-1)).mean(axis=(1, 3))
    checks.update({
        "frames_shape": list(frames.shape) == [n, rcfg.image_height, 2 * rcfg.image_width, 3],
        "frames_uint8": frames.dtype == np.uint8,
        "coverage_in_range": bool(0.02 <= covered.mean() <= 0.9),
        "raster_launches": raster_launches == (n // RENDER_BATCH) * len(cams),
        "no_attention_in_render": render_attn == 0,
        "video_written": os.path.exists(video),
    })
    emit("main_path_render", nvidia_smi=smi, frames=n, frame_batch=RENDER_BATCH, cameras=len(cams),
         uv=rcfg.uv_size, upscale=rcfg.upscale_size, image=[rcfg.image_height, rcfg.image_width],
         faces=int(renderer.model.assets.geo.faces.shape[0]), setup_s=render_setup_s,
         render_s=render_s, frames_per_s=n / render_s, video=os.path.relpath(video, ROOT), video_s=video_s,
         kernel_launches=raster_launches, covered_share_mean=float(covered.mean()),
         covered_share_min=float(covered.min()), covered_share_max=float(covered.max()),
         frames_shape=list(frames.shape), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    return {flash_attn.NAME: attn_launches, raster.NAME: raster_launches}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        raise SystemExit(f"{PKG}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)

    smi = phase_device()
    phase_build()
    attn = phase_kernels(args.seed)
    ras = phase_raster(args.seed)
    phase_slice_parity(args.seed)
    phase_render_parity(args.seed)
    launches = phase_main_path(args.seed, smi)

    import torch

    from audio2photoreal_tpu_torch.kernels import flash_attn, raster

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": flash_attn.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/flash_attn_fwd.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:124", "launches": launches[flash_attn.NAME],
         **{k: attn[k] for k in keys}},
        {"name": raster.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/raster.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas_raster.py:143", "launches": launches[raster.NAME],
         **{k: ras[k] for k in keys}},
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
