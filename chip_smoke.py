#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio2photoreal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and the CUDA toolkit
(nvcc).  Each phase prints one JSON line; any failure is an uncaught
exception and a nonzero exit.

1. device: the card, its power limit, torch/CUDA versions; TF32 is turned off
   for matmuls and cuDNN convs, so f32 stays f32 throughout.
2. build: compile every kernel library from kernels/csrc/ (nvcc, sm_90a), one
   nvcc per library, all started together; ptxas registers and spills; the
   tensor-core instructions (HMMA / HGMMA) in each attention kernel's SASS
   (``cuobjdump --dump-sass``), which every kernel with products (the
   forward, the backward's dK/dV + dQ-partial kernel) must have, f32 and
   bf16; and the fused multiply-adds (FFMA) in the raster library's kernels,
   of which the raster kernel must have none.
3. kernel vs plain, attention: the CUDA attention kernel against its plain
   PyTorch version on the card, f32 and bf16, at the pose and face
   denoisers' shapes (Dh 64 and 128), the face cond-encoder's 1998 x 1998,
   and a small ragged masked case, on the model's layout (q, k, v the
   head-split views of [B, T, H*Dh] projections); max abs error, the time of
   each, the time of ``scaled_dot_product_attention`` with the same mask (a
   yardstick only), the cluster split the kernel took, and two bounds: the
   CUDA-core one (f32 FLOPs over 67 TFLOP/s; bf16 over the tensor cores'
   989) against bytes over the HBM rate, and for f32 the 3xTF32 one (three
   TF32 products per f32 product: FLOPs over 495/3 TFLOP/s).
4. kernel vs plain, raster: the tile rasterizer against its plain version at
   the full image (1024x667) on the mesh_density=10 synthetic mesh (9,322
   faces) posed by random poses and projected by the synthetic rig's two
   cameras (render/assets.py:synthetic_rig, the body about 800 rows tall), at
   frame batch 2 and 8 (the main path's), on the mesh_density=30 mesh (85,562
   faces) at frame batch 2, on a small ragged case with degenerate and
   depth-tied faces, and on a crowded tile (2,000 faces in one 16x16 tile, a
   face over every tile, corners at +-1e30); face ids and coverage equal,
   depth / UV / barycentrics within 1e-5, a rerun bit-identical.  Then the
   85,562-face mesh at frame batch 8 and frame batch 16, 24 and 32 (each
   frame equal to the batch-8 result for its pose), kernel alone.  Every row
   has the bound (the function's (pixel, face) tests: each face's bbox
   widened by one pixel, clipped to the image, ``bound_tests``), and, from one
   more kernel call, the tests its worklists listed (``listed_tests``) and
   its scratch bytes.
5. slice parity: a full-width pose denoiser from ``--seed``, encode + cached
   CFG + DDIM-5 from one numpy x_T, on the card (with the kernel) against the
   CPU (plain attention), within 1e-3; then the same for the full-width face
   denoiser (latent 512, 8 layers, 4 heads, with its lip regressor and
   rotary cond-encoder) on 20 s of audio at the face guidance 10.0, within
   1e-4 of its output's largest magnitude (~300 with random weights).
6. render parity: a full-width BodyAvatar (RendererConfig() defaults) from
   ``--seed``, 1 frame x 2 cameras through render_sequence_multicam, on the
   card (kernels) against the CPU (plain versions): uint8 frames within 1
   count on >= 99.9% of the pixels that either render covers, coverage equal
   on >= 99.99% of all pixels.
7. main path: ``apps.generate.generate`` on a synthetic person, the
   full-width face model at DDIM-500, CFG 10.0, 2 samples (attention kernel
   launches counted: the cond-encoder's 2, then 8 layers x 2 attentions x
   500 steps; the lip regressor's share of the encode timed), then the
   full-width pose model at DDIM-500, CFG 2.0, 2 samples (8 x 2 x 500
   launches); after each, 5 more DDIM steps of the same model, timed alone
   and then under torch.profiler (device busy, launches, attention and GEMM
   ms per step); then sample 0's first 64 frames with the face model's codes
   of the same audio rendered at full width by ``load_body_renderer`` +
   ``render_full_video``: frame batch 8, the 2 rig cameras, the
   mesh_density=10 assets (raster and display kernel launches counted: 8
   batches x 2 cameras each).  Then the display kernel against its plain
   version on the render's own tensors (frame batch 8, 2048^2) and on a
   ragged H 200 x W 2047 case: >= 99.99% of the 8-bit values exact, none
   more than 1 count off, tex_rec bit for bit; times with and without the
   tex_rec output and in the packed mode, the plain version's, the bound.
8. kernel vs plain, attention training: at the pose trainer's shapes (B 64,
   H 4, Tq 600, Tk 600 and 2000, Dh 64), the face width (B 16, Dh 128) and
   the ragged masked causal case, f32 and bf16: the forward with the
   replayed dropout at rate 0.5 against the plain version with the explicit
   mask (f32, so one wrong mask element shows), then at rate 0.1 forward and
   backward through autograd against the plain versions (gradients within
   2e-5 (f32) / 2e-2 (bf16) of the largest plain gradient), the backward run
   twice and compared bit for bit; times of the kernels, the plain versions
   and the backward of ``scaled_dot_product_attention`` with the same mask
   at rate 0 (a yardstick only), and the backward's bound (10 B H Tq Tk Dh
   flops, flash.py:266, against bytes; for f32 also over 495/3 TFLOP/s).
9. train parity: a full-width pose model from ``--seed``, one deterministic
   step at batch 4 with fixed t and noise, on the card (kernels) against the
   CPU (plain versions): loss 1e-5 relative, every gradient within 1e-4 of
   its largest element, params after the AdamW step within 2 lr and 99.9%
   within 1e-6.
10. main path, training: ``apps.train_diffusion.train`` at the reference's
   pose operating point (DenoiserConfig() widths, flash attention and hash
   dropout, raw audio through the frozen wav2vec frontend, batch 64, AdamW lr
   1e-4, cond_drop_prob 0.2) for 4 steps on the synthetic person (attention
   launches counted: 8 layers x 2 attentions x 4 steps, forward and
   backward); the checkpoint sampled by ``generate`` (one DDIM-10 clip);
   steps/s, peak memory, and one more step under torch.profiler for the
   device time by kernel.

Then one line with every kernel's numbers (the f32 attention rows' bound
there is the 3xTF32 one, the arithmetic they do), the nvidia-smi line, and last
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
# the face slice's bar, relative to its output's largest magnitude: the random
# full-width face model at guidance 10 puts pred_xstart at a scale of ~300
# (random lip vertices of scale ~18 feed its conditioning), where f32 rounding
# alone differs by more than the pose slice's absolute 1e-3
FACE_SLICE_REL_TOL = 1e-4
RASTER_TOL = 1e-5  # depth / UV / barycentrics, kernel vs plain
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by input
# type, f32 on the CUDA cores and bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
# "tf32x3": the f32 attention kernels' products as three TF32 tensor-core
# products each (attn_common.cuh), so 495 TFLOP/s of TF32 buys a third of that
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
RASTER_FLOPS_PER_TEST = 17  # csrc/raster.cu: 9 mul + 8 add/sub per (pixel, face) test
# (B, H, Tq, Tk, Dh, masked): self- and cross-attention of the pose and the
# face denoiser under CFG with 2 samples, the face cond-encoder's
# self-attention over the 1998 audio tokens of 2 samples, and a ragged
# kv_valid + causal case
KERNEL_CASES = [
    (4, 4, 600, 600, 64, False),
    (4, 4, 600, 2000, 64, False),
    (4, 4, 600, 600, 128, False),
    (4, 4, 600, 2000, 128, False),
    (2, 4, 1998, 1998, 128, False),
    (2, 3, 77, 203, 64, True),
]
MAIN_CASE = (4, 4, 600, 2000, 64, False)  # the kernel's numbers in the summary line
RENDER_FRAMES, RENDER_BATCH = 64, 8
FACE_GUIDANCE = 10.0  # the reference's face guidance (bench.py:142-160)
# display kernel vs plain: >= 99.99% of the 8-bit channel values exact, none
# more than one count off (powf against torch.pow may cross a .5)
DISPLAY_EXACT_SHARE, DISPLAY_MAX_COUNT = 0.9999, 1
DISPLAY_FLOPS_PER_VALUE = 24  # csrc/display_pack.cu: f32 operations per channel texel, powf as one
# (B, H, Tq, Tk, Dh, masked): the pose trainer's self- and cross-attention at
# batch 64, the face width, and a ragged kv_valid + causal case
TRAIN_KERNEL_CASES = [
    (64, 4, 600, 600, 64, False),
    (64, 4, 600, 2000, 64, False),
    (16, 4, 600, 2000, 128, False),
    (2, 3, 77, 203, 64, True),
]
TRAIN_MAIN_CASE = (64, 4, 600, 2000, 64, False)  # the backward's numbers in the summary line
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # of the largest plain gradient
TRAIN_DROPOUT = 0.1
TRAIN_STEPS, TRAIN_BATCH = 4, 64
LR = 1e-4


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
    from audio2photoreal_tpu_torch.kernels import build, display_pack, flash_attn, raster

    libraries = [(flash_attn.NAME, flash_attn.SOURCES, flash_attn.library),
                 (flash_attn.BWD_NAME, flash_attn.BWD_SOURCES, flash_attn.bwd_library),
                 (raster.NAME, raster.SOURCES, raster.library),
                 (display_pack.NAME, display_pack.SOURCES, display_pack.library)]

    def one(lib):
        name, sources, load = lib
        path = build.library_path(name, sources)
        cached = path.exists()
        t0 = time.perf_counter()
        load()
        return name, path, cached, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        results = list(pool.map(one, libraries))
    wall = time.perf_counter() - t0
    for name, path, cached, seconds in results:
        log = path.with_suffix(".log").read_text()
        ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        emit("build", kernel=name, library=os.path.relpath(path, ROOT), already_built=cached,
             seconds=seconds, all_builds_wall_s=wall, ptxas=ptxas)


def _sass_counts(lib: str, op: str) -> dict:
    """{kernel (mangled): instructions matching the regex ``op``} in a built
    library's SASS."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "--dump-sass", lib],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(op, line):
            counts[name] += 1
    return counts


def phase_sass() -> None:
    """The tensor-core instructions in each attention kernel: every kernel
    with products must have some (the forward, and the backward's dK/dV
    kernel, which also forms the dQ partials); the backward's delta and dQ
    kernels are reductions.  The raster kernel must have no fused f32
    multiply-add (FFMA): its face ids equal the plain version's only because
    every product and sum rounds on its own.  (The setup kernel's 1/det is a
    correctly rounded division, whose Newton steps are FFMAs.)"""
    from audio2photoreal_tpu_torch.kernels import build, flash_attn, raster

    for name, sources in ((flash_attn.NAME, flash_attn.SOURCES), (flash_attn.BWD_NAME, flash_attn.BWD_SOURCES)):
        counts = _sass_counts(str(build.library_path(name, sources)), r"\bH(G)?MMA\b")
        rows = {}
        for fn, n in counts.items():
            kind = next((k for k in ("attn_fwd_kernel", "attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel",
                                     "attn_bwd_delta_kernel") if k in fn), fn)
            dtype = "float32" if f"{kind}If" in fn else "bfloat16" if "bfloat16" in fn else "?"
            dh = "128" if "Li128E" in fn else "64" if "Li64E" in fn else "?"
            rows[f"{kind}<{dtype},{dh}>"] = n
        emit("sass", library=name, tensor_core_instructions=rows)
        missing = [k for k, n in rows.items() if n == 0 and not k.startswith(("attn_bwd_delta", "attn_bwd_dq"))]
        if missing or not rows:
            raise AssertionError(f"{name}: no tensor-core instruction in {missing or 'any kernel'}")
    counts = _sass_counts(str(build.library_path(raster.NAME, raster.SOURCES)), r"\bFFMA\b")
    rows = {next((k for k in ("raster_setup_kernel", "raster_scan_kernel", "raster_fill_kernel", "raster_kernel")
                  if k in fn), fn): n for fn, n in counts.items()}
    emit("sass", library=raster.NAME, ffma_instructions=rows)
    if rows.get("raster_kernel", 1) != 0:
        raise AssertionError(f"{raster.NAME}: raster_kernel has fused multiply-adds or is missing: {rows}")


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


def _graph_ms(fn, iters: int = 20) -> float:
    """ms per replay of one call of ``fn`` captured in a CUDA graph: the
    card's time for the call without the host's per-launch work.  A call
    that synchronised with the host could not be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(graph.replay, iters=iters)
    del graph
    return ms


def _bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the card's peak rate for the inputs' type."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOP_PER_S[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _split_heads(x, H: int):
    """[B, T, H*Dh] -> the model's strided [B, H, T, Dh] view (blocks.py:_split)."""
    return x.unflatten(-1, (H, -1)).transpose(1, 2)


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_reference
    from audio2photoreal_tpu_torch.ops.attention import causal_bias, padding_bias

    from audio2photoreal_tpu_torch.kernels.flash_attn import fwd_split

    g = torch.Generator(device="cuda").manual_seed(seed)
    summary = {}
    for B, H, Tq, Tk, Dh, masked in KERNEL_CASES:
        # the model's layout: q from its projection, k and v slices of one stacked projection
        q = _split_heads(torch.randn((B, Tq, H * Dh), generator=g, device="cuda"), H)
        kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device="cuda")
        k, v = _split_heads(kv[..., : H * Dh], H), _split_heads(kv[..., H * Dh :], H)
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
            flops = 4.0 * B * H * Tq * Tk * Dh
            bound_ms, bound_by = _bound(nbytes, flops, name)
            bound_tc_ms, bound_tc_by = _bound(nbytes, flops, "tf32x3") if name == "float32" else (None, None)
            row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, kv_valid_causal=masked, dtype=name,
                       layout="strided views of [B, T, H*Dh]", split=fwd_split(B, H, Tq, Tk, Dh, dtype),
                       max_abs_err=err, tol=TOL[name], ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       library_ms=l1, library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
                       bound_tc_ms=bound_tc_ms, bound_tc_by=bound_tc_by)
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
    """(bytes, flops, tests) of the function on these inputs: vertices, faces
    and corner UVs read once, every output plane written once; 17 f32
    operations per (pixel, face) test the function needs: the pixels of each
    face's bbox widened by one pixel and clipped to the image, the window
    where the plain version evaluates it.  Faces with |det| <= 1e-12, a
    non-finite corner or no pixel in the image need none."""
    import torch

    tri = pix[:, faces.long()]  # [B, F, 3, 2]
    xs, ys = tri[..., 0], tri[..., 1]
    det = (ys[..., 1] - ys[..., 2]) * (xs[..., 0] - xs[..., 2]) + (xs[..., 2] - xs[..., 1]) * (ys[..., 0] - ys[..., 2])
    lo_x, hi_x, lo_y, hi_y = xs.amin(-1), xs.amax(-1), ys.amin(-1), ys.amax(-1)
    need = ((det.abs() > 1e-12) & torch.isfinite(xs).all(-1) & torch.isfinite(ys).all(-1)
            & (hi_x >= 0) & (lo_x <= W - 1) & (hi_y >= 0) & (lo_y <= H - 1))
    span = lambda lo, hi, n: (hi.ceil() + 1).clamp(0, n - 1) - (lo.floor() - 1).clamp(0, n - 1) + 1  # noqa: E731
    window = span(lo_x, hi_x, W).double() * span(lo_y, hi_y, H).double()
    tests = float(torch.where(need, window, torch.zeros_like(window)).sum())
    B = pix.shape[0]
    per_pixel = 4 + 4 + (8 if face_uv is not None else 0) + (12 if emit_barys else 0)
    inputs = pix.numel() * 4 + dep.numel() * 4 + faces.numel() * faces.element_size()
    inputs += face_uv.numel() * 4 if face_uv is not None else 0
    return inputs + B * H * W * per_pixel, tests * RASTER_FLOPS_PER_TEST, tests


def _listed_tests(buf, B, F, H, W) -> float:
    """The (pixel, face) tests one kernel call listed: every in-image pixel of
    every tile of each face's rectangle, as the setup kernel wrote it into
    the call's scratch ``buf`` (a large face is tested at the tiles of its
    rectangle too)."""
    import torch

    from audio2photoreal_tpu_torch.kernels import raster

    g = raster.layout(B, F, H, W)
    r = raster.scratch_views(buf, B, F, H, W).rect.long()  # [B, F, 4]; (0, -1, 0, -1) where no tile

    def pixels_before(n, size):  # pixels in the image before tile k, k = 0..n
        per_tile = torch.clamp(size - torch.arange(n, device=buf.device) * g.tile, max=g.tile)
        return torch.cat([per_tile.new_zeros(1), per_tile.cumsum(0)])

    cx, cy = pixels_before(g.ntx, W), pixels_before(g.nty, H)
    reach = r[..., 0] <= r[..., 1]
    px = cx[(r[..., 1] + 1).clamp_min(0)] - cx[r[..., 0]]
    py = cy[(r[..., 3] + 1).clamp_min(0)] - cy[r[..., 2]]
    return float((px * py * reach).sum())


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


def crowded_tile_arrays(n_faces: int = 2000):
    """(pix, dep, faces, face_uv, H, W) in numpy: n_faces tiny faces in tile
    (1, 1) of a 48 x 48 image (more faces than one shared-memory stage
    holds), one face over every tile behind them, and faces with corners at
    +-1e30 or entirely off screen; frame 1 lists the triangles the other way
    round."""
    import numpy as np

    rng = np.random.RandomState(12)
    corner = rng.rand(n_faces, 1, 2) * 14 + 16.5
    tris = np.concatenate([
        corner + rng.rand(n_faces, 3, 2) * 3 - 1.5,
        [[[-100, -100], [200, -100], [-100, 200]],
         [[10, 10], [1e30, 12], [12, 30]], [[-1e30, -1e30], [20, 5], [5, 20]],
         [[1e30, 1e30], [2e30, 1e30], [1e30, 3e30]], [[-500, 10], [-300, 20], [-400, 40]]],
    ]).astype(np.float32)
    pix = np.stack([tris.reshape(-1, 2), tris[::-1].reshape(-1, 2)])
    dep = (rng.rand(2, pix.shape[1]) * 4 + 0.5).astype(np.float32)
    dep[:, 3 * n_faces:3 * n_faces + 3] = 9.0
    faces = np.arange(pix.shape[1]).reshape(-1, 3)
    face_uv = rng.rand(len(faces), 3, 2).astype(np.float32)
    return pix, dep, faces.astype(np.int64), face_uv, 48, 48


def _crowded_case(device):
    import torch

    pix, dep, faces, face_uv, H, W = crowded_tile_arrays()
    return (*(torch.from_numpy(a).to(device) for a in (pix, dep, faces, face_uv)), H, W)


def _raster_numbers(pix, dep, fc, fuv, h, w, barys) -> dict:
    """The bound of the function on these inputs, and the tests and scratch
    bytes of one more kernel call on them."""
    from audio2photoreal_tpu_torch.kernels import raster

    nbytes, flops, tests = _raster_cost(pix, dep, fc, fuv, h, w, barys)
    bound_ms, bound_by = _bound(nbytes, flops)
    _, buf = raster._launch(pix, dep, fc, h, w, fuv, barys)
    return dict(bound_ms=bound_ms, bound_by=bound_by, bound_tests=tests, bytes=nbytes,
                listed_tests=_listed_tests(buf, pix.shape[0], fc.shape[0], h, w), scratch_bytes=buf.numel())


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
    # the mesh_density=30 body (85,562 faces) in the same poses; its UV atlas
    # size does not reach the raster
    dense = make_synthetic_assets(RendererConfig(uv_size=256, upscale_size=512), seed=seed,
                                  mesh_density=30).to("cuda")
    dfaces, dface_uv = dense.geo.faces, dense.geo.uv_coords[dense.geo.uv_faces].contiguous()
    dpix8, ddep8 = _raster_inputs(dense, cams, motion)

    summary = {}
    ragged, crowded = _ragged_case("cuda"), _crowded_case("cuda")
    cases = [("ragged_ties", *ragged[:4], ragged[4], ragged[5], True),
             ("crowded_tile", *crowded, True),
             ("full_b2", pix8[:2], dep8[:2], faces, face_uv, H, W, True),
             ("full_b8", pix8, dep8, faces, face_uv, H, W, False),
             ("full_b2_dense", dpix8[:2], ddep8[:2], dfaces, dface_uv, H, W, False)]
    results = {}
    for name, pix, dep, fc, fuv, h, w, barys in cases:
        got = raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)
        want = raster.rasterize_reference(pix, dep, fc, h, w, fuv, emit_barys=barys)
        again = raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)
        torch.cuda.synchronize()
        cmp = _raster_compare(got, want)
        cmp["rerun_identical"] = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        cmp["ok"] = cmp["ok"] and cmp["rerun_identical"]
        results[name] = got
        B = pix.shape[0]
        call = lambda: raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)  # noqa: E731
        plain = lambda: raster.rasterize_reference(pix, dep, fc, h, w, fuv, emit_barys=barys)  # noqa: E731
        # in turns: plain, kernel, kernel, plain (the plain version is slow: one
        # call each, warmed up by the comparison above)
        p1 = _time_ms(plain, iters=1, warmup=0)
        k1 = _time_ms(call)
        k2 = _time_ms(call)
        p2 = _time_ms(plain, iters=1, warmup=0)
        row = dict(case=name, B=B, H=h, W=w, faces=int(fc.shape[0]), emit_barys=barys, **cmp,
                   tol=RASTER_TOL, ms=(k1 + k2) / 2, graph_ms=_graph_ms(call), plain_ms=(p1 + p2) / 2,
                   library_ms=None, **_raster_numbers(pix, dep, fc, fuv, h, w, barys))
        emit("kernel_vs_plain", kernel=raster.NAME, **row)
        if not cmp["ok"]:
            raise AssertionError(f"{raster.NAME} disagrees with its plain version: {row}")
        if name == "full_b8":
            summary = row
    # the dense mesh at the main path's frame batch, kernel alone
    call = lambda: raster.rasterize_cuda(dpix8, ddep8, dfaces, H, W, dface_uv, emit_barys=False)  # noqa: E731
    emit("raster_alone", case="full_b8_dense", B=8, H=H, W=W, faces=int(dfaces.shape[0]), ms=_time_ms(call),
         graph_ms=_graph_ms(call), **_raster_numbers(dpix8, ddep8, dfaces, dface_uv, H, W, False))
    # frame batches the TPU kernel could not run, kernel alone: frame i is pose i % 8
    ref = results["full_b8"]
    for B in (16, 24, 32):
        idx = torch.arange(B, device="cuda") % 8
        pb, db = pix8[idx], dep8[idx]
        call = lambda: raster.rasterize_cuda(pb, db, faces, H, W, face_uv, emit_barys=False)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got, k), getattr(ref, k)[idx]) for k in ("face_index", "depth", "uv"))
        ms = _time_ms(call, iters=10)
        emit("raster_batch", B=B, H=H, W=W, frames_equal_batch8=same, ms=ms, ms_per_frame=ms / B,
             graph_ms=_graph_ms(call, iters=10), **_raster_numbers(pb, db, faces, face_uv, H, W, False))
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


def _face_model(seed: int):
    """The face denoiser at the reference's face width: latent 512, 8
    layers, 4 heads (Dh 128), FF 1024, 256-d codes, with its lip regressor
    (wav2vec_large) and rotary cond-encoder; random weights from ``seed``."""
    import torch

    from audio2photoreal_tpu_torch.core.config import DenoiserConfig
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    cfg = DenoiserConfig(data_format="face", nfeats=256, latent_dim=512, ff_size=1024, num_layers=8,
                         num_heads=4, flash_attention=True)
    model = FiLMDenoiser(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, model.eval()


def phase_face_slice_parity(seed: int) -> None:
    """The full-width face model, card (kernels) against CPU (plain
    versions): encode 20 s of audio (wav2vec, lip regressor, cond-encoder),
    then cached CFG at the face guidance and DDIM-5 from one numpy x_T."""
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    cfg, model_cpu = _face_model(seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    rng = np.random.RandomState(seed + 3)
    B, T = 1, cfg.max_seq_length
    audio = rng.randn(B, T * 1600, 2).astype(np.float32)  # z-normed 48 kHz stereo
    x_T = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    sched = maybe_respaced("cosine", 1000, "ddim5")

    def run(model, device):
        with torch.no_grad():
            a = torch.from_numpy(audio).to(device)
            lip = model.lip_vertices(a)
            cond = model.encode_conditioning(a, lip_verts=lip)
            model_fn = cfg_model_fn_cached(model, cond, FACE_GUIDANCE)
            res = ddim_sample_loop(sched, "xstart", model_fn, torch.from_numpy(x_T).to(device))
        return lip.cpu().numpy(), cond.cond_tokens.cpu().numpy(), res.pred_xstart.cpu().numpy()

    before = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    gpu = run(model_gpu, "cuda")
    gpu_s = time.perf_counter() - t0
    launches = launch_counts[flash_attn.NAME] - before
    t0 = time.perf_counter()
    cpu = run(model_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    errs = [float(np.abs(g - c).max()) for g, c in zip(gpu, cpu)]
    scales = [float(np.abs(c).max()) for c in cpu]
    want_launches = cfg.cond_encoder_layers + cfg.num_layers * 2 * 5
    row = dict(steps=5, guidance=FACE_GUIDANCE, batch=B, latent=cfg.latent_dim, layers=cfg.num_layers,
               heads=cfg.num_heads, lip_max_abs_err=errs[0], lip_scale=scales[0],
               cond_tokens_max_abs_err=errs[1], cond_tokens_scale=scales[1], max_abs_err=errs[2],
               pred_scale=scales[2], rel_err=errs[2] / scales[2], rel_tol=FACE_SLICE_REL_TOL,
               kernel_launches=launches, expected_launches=want_launches,
               gpu_s=gpu_s, cpu_s=cpu_s, finite=bool(np.isfinite(gpu[2]).all()))
    emit("face_slice_parity", **row)
    if not (row["finite"] and row["rel_err"] <= FACE_SLICE_REL_TOL and launches == want_launches):
        raise AssertionError(f"card and CPU disagree on the face slice: {row}")


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
               max_abs_err=err, pred_scale=float(np.abs(cpu).max()), tol=SLICE_TOL, kernel_launches=launches,
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


def _display_inputs(model, decoded, cams, frames: int):
    """The display pass's inputs on the render's own tensors: the raw 2048^2
    texture of the first camera, the seam-resampled shadow, the texture mean
    and std, as ``render_view`` hands them to the kernel."""
    import numpy as np
    import torch

    c = next(iter(cams.values()))
    campos = torch.as_tensor(np.asarray(c.campos), device="cuda")[None].expand(frames, 3)
    with torch.no_grad():
        view = model.decoder_view(decoded["geom"], decoded["tex_mean_rec"], campos, model.assets.geo)
        tex = model.upscale_tex(decoded["tex_mean_rec"], view["tex_view_rec"])
    return tex, decoded["shadow_seamed"], model.assets.tex_mean, model.assets.tex_std


def _display_compare(args) -> dict:
    """Kernel against plain: 8-bit values (planar and packed), tex_rec bit
    for bit, times of each mode and of the plain version, and the bound."""
    import torch

    from audio2photoreal_tpu_torch.kernels import display_pack

    tex = args[0]
    B, _, H, W = tex.shape
    got, rec = display_pack.finalize_display(*args)
    packed = display_pack.finalize_display_packed(*args)
    want, want_rec = display_pack.finalize_display_reference(*args)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    out = dict(B=B, H=H, W=W, exact_share=float((diff == 0).float().mean()), max_count_diff=int(diff.max()),
               max_abs_err=float(diff.max()), tex_rec_equal=bool(torch.equal(rec, want_rec)),
               packed_equal_planar=bool(torch.equal(packed, display_pack.pack_rgb8(got))),
               exact_bar=DISPLAY_EXACT_SHARE, count_bar=DISPLAY_MAX_COUNT)
    del got, rec, packed, want, want_rec, diff
    plain = lambda: display_pack.finalize_display_reference(*args)  # noqa: E731
    kern = lambda: display_pack.finalize_display(*args)  # noqa: E731
    # in turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = _time_ms(plain), _time_ms(kern), _time_ms(kern), _time_ms(plain)
    n = H * W
    values = B * 3 * n
    planar_bytes = 4 * (values + B * n + 3 * n) + 4 * 2 * values  # display and tex_rec written
    bound_ms, bound_by = _bound(planar_bytes, DISPLAY_FLOPS_PER_VALUE * values)
    out.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               bytes=planar_bytes)
    # the same kernel without the tex_rec output, and in the packed mode
    out["no_tex_rec_ms"] = _time_ms(lambda: display_pack.finalize_display(*args, with_tex_rec=False))
    out["no_tex_rec_bound_ms"] = _bound(planar_bytes - 4 * values, DISPLAY_FLOPS_PER_VALUE * values)[0]
    out["packed_ms"] = _time_ms(lambda: display_pack.finalize_display_packed(*args))
    out["packed_bound_ms"] = _bound(4 * (values + B * n + 3 * n) + 4 * B * n, DISPLAY_FLOPS_PER_VALUE * values)[0]
    out["ok"] = (out["exact_share"] >= DISPLAY_EXACT_SHARE and out["max_count_diff"] <= DISPLAY_MAX_COUNT
                 and out["tex_rec_equal"] and out["packed_equal_planar"])
    return out


def _profile_ddim(model_dir: str, guidance: float, seed: int, steps: int = 5) -> dict:
    """``steps`` DDIM steps of generate's loop (cached CFG, 2 clips of 20 s,
    random z-normed audio) on a model loaded as generate loads it: the wall
    per step without the profiler (after a warm-up loop), then the same loop
    under torch.profiler for the device-busy time, launches and the
    attention kernel's share per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.apps.generate import load_model
    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    model = load_model(model_dir, "cuda")
    c = model.cfg
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, T = 2, c.max_seq_length
    audio = torch.randn((B, T * 1600, 2), generator=g, device="cuda")
    kf = kv = None
    if c.data_format == "pose":
        kf = torch.randn((B, -(-T // c.keyframe_step), c.key_feature_dim), generator=g, device="cuda")
        kv = torch.ones(kf.shape[:2], device="cuda")
    x_T = torch.randn((B, T, c.nfeats), generator=g, device="cuda")
    sched = maybe_respaced("cosine", 1000, f"ddim{steps}")
    with torch.no_grad():
        fn = cfg_model_fn_cached(model, model.encode_conditioning(audio, kf, kv), guidance)
        run = lambda: ddim_sample_loop(sched, "xstart", fn, x_T)  # noqa: E731
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    per = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3 / steps
            launches += e.count
    busy = sum(per.values())
    if busy == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    attn = sum(v for k, v in per.items() if "attn_fwd_kernel" in k)
    gemm = sum(v for k, v in per.items() if "gemm" in k.lower())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return dict(profiled_steps=steps, step_wall_ms=wall_ms, step_device_ms=busy,
                step_idle_share=1.0 - busy / wall_ms, step_device_launches=launches / steps,
                step_attn_fwd_ms=attn, step_gemm_ms=gemm, step_top_kernels_ms=[[k[:80], v] for k, v in top])


def phase_main_path(seed: int, smi: str) -> dict:
    """The face generate, the pose generate, and the render of the two
    (phases 7-9 of the head note); the display kernel against its plain
    version on the render's tensors."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, find_stats, generate
    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
    from audio2photoreal_tpu_torch.core.config import DataConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, launch_counts, raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, save_renderer_bundle, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    shutil.rmtree(WORK, ignore_errors=True)
    person, num_samples, steps = "SYNTH01", 2, 500
    t0 = time.perf_counter()
    make_synthetic_person(WORK, person, num_scenes=8, frames_per_scene=600, seed=seed)
    dirs, cfgs = {}, {}
    for fmt, build in (("face", _face_model), ("pose", _pose_model)):
        cfgs[fmt], model = build(seed)
        dirs[fmt] = os.path.join(WORK, f"{fmt}_model")
        save_config(dirs[fmt], denoiser=cfgs[fmt], diffusion=DiffusionConfig(),
                    data=DataConfig(person=person, data_format=fmt, max_seq_length=cfgs[fmt].max_seq_length))
        torch.save(model.state_dict(), os.path.join(dirs[fmt], MODEL_FILE))
        del model
    fcfg, cfg = cfgs["face"], cfgs["pose"]
    setup_s = time.perf_counter() - t0
    T = cfg.max_seq_length
    audio_s = num_samples * T / 30.0

    # --- face: generate ---------------------------------------------------
    timings: dict = {}
    launch_counts.clear()
    t0 = time.perf_counter()
    face_path = generate(dirs["face"], WORK, num_samples=num_samples, guidance_param=FACE_GUIDANCE,
                         timestep_respacing=f"ddim{steps}", device="cuda", timings=timings)
    face_s = time.perf_counter() - t0
    face_attn = launch_counts[flash_attn.NAME]
    face_res = np.load(face_path, allow_pickle=True).item()
    face_prof = _profile_ddim(dirs["face"], FACE_GUIDANCE, seed)
    face_checks = {
        "motions_shape": list(face_res["motions"].shape) == [num_samples, fcfg.nfeats, 1, T],
        "motions_finite": bool(np.isfinite(face_res["motions"]).all()),
        "keys": sorted(face_res) == ["audio", "gt", "lengths", "motions"],
        # the cond-encoder's self-attentions once, then 8 layers x 2 attentions x 500 steps
        "attention_launches": face_attn == fcfg.cond_encoder_layers + fcfg.num_layers * 2 * steps,
    }
    emit("main_path_face", nvidia_smi=smi, samples=num_samples, ddim_steps=steps, guidance=FACE_GUIDANCE,
         latent=fcfg.latent_dim, layers=fcfg.num_layers, heads=fcfg.num_heads, ff=fcfg.ff_size,
         encode_s=timings["encode_s"], lip_s=timings["lip_s"], ddim_s=timings["ddim_s"],
         ddim_step_ms=1e3 * timings["ddim_s"] / steps, generate_s=face_s, audio_s=audio_s,
         audio_s_per_wall_s=audio_s / face_s, kernel_launches=face_attn,
         motions_shape=list(face_res["motions"].shape), **face_prof, checks=face_checks)
    if not all(face_checks.values()):
        raise AssertionError(f"main path (face) checks failed: {face_checks}")

    # --- pose: generate ---------------------------------------------------
    timings = {}
    launch_counts.clear()
    t0 = time.perf_counter()
    path = generate(dirs["pose"], WORK, num_samples=num_samples, guidance_param=2.0,
                    timestep_respacing=f"ddim{steps}", device="cuda", timings=timings)
    total_s = time.perf_counter() - t0
    attn_launches = launch_counts[flash_attn.NAME]

    res = np.load(path, allow_pickle=True).item()
    pose_prof = _profile_ddim(dirs["pose"], 2.0, seed)
    checks = {
        "motions_shape": list(res["motions"].shape) == [num_samples, cfg.nfeats, 1, T],
        "motions_finite": bool(np.isfinite(res["motions"]).all()),
        "keys": all(k in res for k in ("gt", "audio", "lengths", "keyframes")),
        "attention_launches": attn_launches == cfg.num_layers * 2 * steps,
        # face and pose runs were made from the same audio (sample/generate.py:187-189)
        "face_audio_equal": bool(np.array_equal(face_res["audio"], res["audio"])),
    }
    emit("main_path_generate", nvidia_smi=smi, samples=num_samples, ddim_steps=steps, guidance=2.0,
         latent=cfg.latent_dim, layers=cfg.num_layers, heads=cfg.num_heads,
         setup_s=setup_s, encode_s=timings["encode_s"], ddim_s=timings["ddim_s"],
         generate_s=total_s, audio_s=audio_s, audio_s_per_wall_s=audio_s / total_s,
         kernel_launches=attn_launches, motions_shape=list(res["motions"].shape), **pose_prof, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (pose) checks failed: {checks}")

    # --- render: a full-width renderer bundle, loaded as a user would --------
    t0 = time.perf_counter()
    stats = find_stats(os.path.join(WORK, person))
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
    # sample 0's pose and its face model's codes, as generate --plot pairs them
    body = res["motions"][0].transpose(2, 0, 1)[:n, :, 0]
    face = face_res["motions"][0].transpose(2, 0, 1)[:n, :, 0]

    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = renderer.render_sequence_multicam(body, face)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    raster_launches = launch_counts[raster.NAME]
    display_launches = launch_counts[display_pack.NAME]
    render_attn = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    video = renderer.render_full_video(
        {"audio": res["audio"][0][: n * 1600], "body_motion": body, "face_motion": face},
        os.path.join(WORK, "sample00_rep00"))
    video_s = time.perf_counter() - t0
    covered = (frames.reshape(n, rcfg.image_height, 2, rcfg.image_width, 3).any(-1)).mean(axis=(1, 3))
    per_view = (n // RENDER_BATCH) * len(cams)
    checks = {
        "face_codes_from_face_model": face_res["motions"].shape[1] == fcfg.nfeats,
        "frames_shape": list(frames.shape) == [n, rcfg.image_height, 2 * rcfg.image_width, 3],
        "frames_uint8": frames.dtype == np.uint8,
        "coverage_in_range": bool(0.02 <= covered.mean() <= 0.9),
        "raster_launches": raster_launches == per_view,
        "display_pack_launches": display_launches == per_view,
        "no_attention_in_render": render_attn == 0,
        "video_written": os.path.exists(video),
    }
    emit("main_path_render", nvidia_smi=smi, frames=n, frame_batch=RENDER_BATCH, cameras=len(cams),
         uv=rcfg.uv_size, upscale=rcfg.upscale_size, image=[rcfg.image_height, rcfg.image_width],
         faces=int(renderer.model.assets.geo.faces.shape[0]), setup_s=render_setup_s,
         render_s=render_s, frames_per_s=n / render_s, video=os.path.relpath(video, ROOT), video_s=video_s,
         kernel_launches={raster.NAME: raster_launches, display_pack.NAME: display_launches},
         covered_share_mean=float(covered.mean()), covered_share_min=float(covered.min()),
         covered_share_max=float(covered.max()), frames_shape=list(frames.shape), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (render) checks failed: {checks}")

    # --- the display kernel against its plain version, on the render's own
    # tensors (frame batch 8, 2048^2), and on a ragged case
    m = renderer.model
    with torch.no_grad():
        codes = torch.from_numpy(np.ascontiguousarray(face[:RENDER_BATCH])).cuda()
        motion = torch.from_numpy(np.ascontiguousarray(body[:RENDER_BATCH])).cuda()
        decoded = m.decode_frame(motion, face_embs=codes, embs=m.template_body_embs().expand(RENDER_BATCH, -1),
                                 encode=False)
    args = _display_inputs(m, decoded, cams, RENDER_BATCH)
    del decoded
    summary = _display_compare(args)
    emit("kernel_vs_plain", kernel=display_pack.NAME, case="render_b8", **summary)
    g = torch.Generator(device="cuda").manual_seed(seed)
    ragged = (torch.randn((3, 3, 200, 2047), generator=g, device="cuda") * 0.3,
              torch.rand((3, 1, 200, 2047), generator=g, device="cuda"),
              torch.rand((3, 200, 2047), generator=g, device="cuda") * 200.0, 35.0)
    row = _display_compare(ragged)
    emit("kernel_vs_plain", kernel=display_pack.NAME, case="ragged_h200_w2047", **row)
    for r in (summary, row):
        if not r["ok"]:
            raise AssertionError(f"{display_pack.NAME} disagrees with its plain version: {r}")
    return {"face": face_attn, flash_attn.NAME: attn_launches, raster.NAME: raster_launches,
            display_pack.NAME: display_launches, "display": summary}


def _attn_inputs(g, B, H, Tq, Tk, Dh, masked):
    import torch

    q, k, v, do = (torch.randn((B, H, T, Dh), generator=g, device="cuda") for T in (Tq, Tk, Tk, Tq))
    kv_valid = None
    if masked:  # the last keys of every batch row but the last are masked
        lengths = torch.tensor([Tk - 50 * (B - 1 - b) for b in range(B)], device="cuda")
        kv_valid = (torch.arange(Tk, device="cuda")[None] < lengths[:, None]).float()
    return q, k, v, do, kv_valid


def phase_train_kernels(seed: int) -> dict:
    """The dropout forward and the backward kernels against their plain
    versions at the trainer's shapes (phase 8 of the head note)."""
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels.flash_attn import (
        dropout_mask,
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from audio2photoreal_tpu_torch.ops.attention import causal_bias, padding_bias

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    summary = {}
    for B, H, Tq, Tk, Dh, masked in TRAIN_KERNEL_CASES:
        q, k, v, do, kv_valid = _attn_inputs(g, B, H, Tq, Tk, Dh, masked)
        dseed = 1_000_003 + Tq + Tk
        # the mask, exactly: at rate 0.5 in f32 one wrong element moves an
        # output by ~p*v, above the f32 bar
        got = flash_attention(q, k, v, kv_valid, masked, 0.5, dseed)
        want = flash_attention_reference(q, k, v, kv_valid, masked, 0.5, dseed)
        torch.cuda.synchronize()
        mask_err = (got - want).abs().max().item()
        del got, want
        if not mask_err <= TOL["float32"]:
            raise AssertionError(f"the dropout forward disagrees with the explicit mask: {mask_err}")
        # the mask alone: its plain version builds the [B, H, Tq, Tk] multiplier,
        # whose least cost is writing it once; in the kernels it is never stored
        it = dict(iters=5, warmup=1) if B * Tk >= 64 * 2000 else {}
        mask_plain_ms = _time_ms(lambda: dropout_mask(B, H, Tq, Tk, TRAIN_DROPOUT, dseed, None, "cuda"), **it)
        mask_bound_ms = _bound(4.0 * B * H * Tq * Tk, 0.0)[0]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            args = (kv_valid, masked, TRAIN_DROPOUT, dseed)
            qg, kg, vg = (x.clone().requires_grad_() for x in (qd, kd, vd))
            out = flash_attention(qg, kg, vg, *args)
            grads = torch.autograd.grad(out, (qg, kg, vg), dod, retain_graph=True)
            again = torch.autograd.grad(out, (qg, kg, vg), dod, retain_graph=True)
            want_out = flash_attention_reference(qd, kd, vd, *args)
            want = flash_attention_bwd_reference(qd, kd, vd, dod, *args)
            torch.cuda.synchronize()
            fwd_err = (out.detach().float() - want_out.float()).abs().max().item()
            scale = max(w.float().abs().max().item() for w in want)
            err = max((a.float() - w.float()).abs().max().item() for a, w in zip(grads, want))
            identical = all(torch.equal(a, b) for a, b in zip(grads, again))
            del want_out, want, again, grads
            # the library's backward with the same mask at rate 0, as a yardstick
            mask = None
            if masked:
                mask = (padding_bias(kv_valid) + causal_bias(Tq, Tk, device="cuda")).to(dtype)
            ql, kl, vl = (x.clone().requires_grad_() for x in (qd, kd, vd))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
            bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dod, retain_graph=True)  # noqa: E731
            plain = lambda: flash_attention_bwd_reference(qd, kd, vd, dod, *args)  # noqa: E731
            fwd = lambda: flash_attention(qd, kd, vd, *args)  # noqa: E731
            fwd_nodrop = lambda: flash_attention(qd, kd, vd, kv_valid, masked)  # noqa: E731
            fwd_plain = lambda: flash_attention_reference(qd, kd, vd, *args)  # noqa: E731
            lib = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dod, retain_graph=True)  # noqa: E731
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = _time_ms(plain, **it), _time_ms(bwd), _time_ms(bwd), _time_ms(plain, **it)
            fp1, fk1, fk2, fp2 = _time_ms(fwd_plain, **it), _time_ms(fwd), _time_ms(fwd), _time_ms(fwd_plain, **it)
            fn1, fn2 = _time_ms(fwd_nodrop), _time_ms(fwd_nodrop)
            l1 = _time_ms(lib)
            del out, lib_out
            item = qd.element_size()
            # each input read once (q, k, v, dO, O, lse, kv_valid), each gradient written once
            nbytes = (item * (3 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) + 4 * B * H * Tq
                      + item * (B * H * Tq * Dh + 2 * B * H * Tk * Dh) + (4 * B * Tk if masked else 0))
            bound_ms, bound_by = _bound(nbytes, 10.0 * B * H * Tq * Tk * Dh, name)
            bound_tc_ms, bound_tc_by = (_bound(nbytes, 10.0 * B * H * Tq * Tk * Dh, "tf32x3") if name == "float32"
                                        else (None, None))
            row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, kv_valid_causal=masked, dtype=name, dropout=TRAIN_DROPOUT,
                       mask_rate05_max_abs_err=mask_err, fwd_max_abs_err=fwd_err, max_abs_err=err,
                       grad_scale=scale, tol=GRAD_TOL[name] * scale, bitwise_deterministic=identical,
                       ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=l1,
                       fwd_dropout_ms=(fk1 + fk2) / 2, fwd_dropout_plain_ms=(fp1 + fp2) / 2,
                       fwd_no_dropout_ms=(fn1 + fn2) / 2, mask_in_kernel_ms=(fk1 + fk2 - fn1 - fn2) / 2,
                       mask_plain_ms=mask_plain_ms, mask_bound_ms=mask_bound_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=bound_tc_ms, bound_tc_by=bound_tc_by)
            emit("kernel_vs_plain", kernel="flash_attn_bwd", **row)
            if not (err <= GRAD_TOL[name] * scale and fwd_err <= TOL[name] and identical):
                raise AssertionError(f"flash_attn_bwd disagrees with its plain version: {row}")
            if (B, H, Tq, Tk, Dh, masked) == TRAIN_MAIN_CASE and name == "float32":
                summary = row
            del qg, kg, vg, ql, kl, vl
        del q, k, v, do
        torch.cuda.empty_cache()
    return summary


def _train_batch(rng, B, T):
    import numpy as np

    mask = np.ones((B, T), np.float32)
    mask[-1, T - 150:] = 0.0
    kv = np.ones((B, -(-T // 30)), np.float32)
    kv[-1, -5:] = 0.0
    return {"motion": rng.randn(B, T, 104).astype(np.float32) * mask[..., None], "mask": mask,
            "audio": (rng.randn(B, T * 1600, 2) * 0.5).astype(np.float32),
            "keyframes": rng.randn(B, kv.shape[1], 104).astype(np.float32), "keyframe_valid": kv}


def phase_train_parity(seed: int) -> None:
    """One deterministic full-width train step, card against CPU (phase 9)."""
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.core.config import DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    cfg, model_cpu = _pose_model(seed, hash_dropout=True)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    rng = np.random.RandomState(seed + 2)
    B, T = 4, cfg.max_seq_length
    batch = _train_batch(rng, B, T)
    t = np.array([0, 250, 600, 999])
    noise = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    dcfg = DiffusionConfig(cond_drop_prob=0.0)
    out, secs = {}, {}
    for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
        state = TrainState(model.eval(), TrainConfig(lr=LR))
        before = (launch_counts[flash_attn.NAME], launch_counts[flash_attn.BWD_NAME])
        t0 = time.perf_counter()
        metrics, _ = diffusion_train_step(
            state, make_schedule().to_device(device), dcfg, {k: torch.from_numpy(v).to(device) for k, v in
                                                             batch.items()},
            t=torch.from_numpy(t), noise=torch.from_numpy(noise).to(device))
        secs[device] = time.perf_counter() - t0
        launches = (launch_counts[flash_attn.NAME] - before[0], launch_counts[flash_attn.BWD_NAME] - before[1])
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        out[device] = (metrics, grads, params, launches)
    (mg, gg, pg, lg), (mc, gc, pc, lc) = out["cuda"], out["cpu"]
    loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    grad_rel = max((gg[n] - gc[n]).abs().max().item() / max(gc[n].abs().max().item(), 1e-30) for n in gc)
    d = torch.cat([(pg[n] - pc[n]).abs().flatten() for n in pc])
    row = dict(batch=B, latent=cfg.latent_dim, layers=cfg.num_layers, t=t.tolist(), loss_gpu=mg["loss"],
               loss_cpu=mc["loss"], loss_rel_err=loss_rel, grad_max_rel_err=grad_rel,
               grads_compared=len(gc), same_grad_names=sorted(gg) == sorted(gc),
               param_max_abs_diff=d.max().item(), param_share_within_1e6=(d <= 1e-6).float().mean().item(),
               kernel_launches_fwd_bwd=list(lg), cpu_launches=list(lc), gpu_s=secs["cuda"], cpu_s=secs["cpu"])
    emit("train_parity", **row)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and row["same_grad_names"] and d.max().item() <= 2 * LR
            and row["param_share_within_1e6"] >= 0.999 and lg == (2 * cfg.num_layers,) * 2 and lc == (0, 0)):
        raise AssertionError(f"card and CPU disagree on the train step: {row}")


def _profile_step(state, sched, dcfg, batch) -> dict:
    """One more train step under torch.profiler: device time by kernel (the
    device-side events only; a host op's own row repeats its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        diffusion_train_step(state, sched, dcfg, batch, torch.Generator().manual_seed(7),
                             torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(per.values())
    if total == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    group = lambda pat: sum(v for k, v in per.items() if pat in k)  # noqa: E731
    top = sorted(per.items(), key=lambda kv: -kv[1])[:15]
    return dict(profiled_wall_ms=wall_ms, device_ms=total, device_idle_share=1.0 - total / wall_ms,
                device_launches=sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                attn_bwd_ms=group("attn_bwd_"), attn_bwd_share=group("attn_bwd_") / total,
                attn_fwd_ms=group("attn_fwd_kernel"), attn_fwd_share=group("attn_fwd_kernel") / total,
                int64_elementwise_ms=group("<long"),  # the hash dropout masks' uint32-in-int64 math
                cudnn_conv_fprop_ms=group("fprop_implicit_gemm"), top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_main_path_train(seed: int, smi: str):
    """``train()`` at the reference's pose operating point (phase 10); the
    backward kernel's launches on it."""
    import dataclasses

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import generate
    from audio2photoreal_tpu_torch.apps.train_diffusion import train
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.train import checkpoints

    person = "SYNTH01"
    root = os.path.join(WORK, "train_data")
    save_dir = os.path.join(WORK, "train_run")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(save_dir, ignore_errors=True)
    make_synthetic_person(root, person, num_scenes=8, frames_per_scene=600, seed=seed)
    mcfg = DenoiserConfig(data_format="pose", flash_attention=True, hash_dropout=True)
    dcfg = DiffusionConfig()
    datacfg = DataConfig(person=person, batch_size=TRAIN_BATCH, max_seq_length=mcfg.max_seq_length)
    tcfg = TrainConfig(lr=LR, num_steps=TRAIN_STEPS, log_interval=1, save_interval=10**9, seed=seed)
    timings: dict = {}

    launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(root, save_dir, mcfg, dcfg, datacfg, tcfg, device="cuda", timings=timings)
    train_s = time.perf_counter() - t0
    fwd, bwd = launch_counts[flash_attn.NAME], launch_counts[flash_attn.BWD_NAME]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_done = state.step

    logged = [json.loads(l) for l in open(os.path.join(save_dir, "log.jsonl"))]
    steady = timings["step_s"][1:]
    per_step = 2 * mcfg.num_layers
    # the saved model samples: one DDIM-10 clip through generate
    res = np.load(generate(save_dir, root, num_samples=1, timestep_respacing="ddim10", device="cuda",
                           output_dir=os.path.join(WORK, "train_samples")), allow_pickle=True).item()
    # one more step under the profiler, on a batch of the same shapes
    from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
    from audio2photoreal_tpu_torch.apps.generate import find_stats
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule

    ds = SocialDataset(load_local_data(root, person), find_stats(os.path.join(root, person)), datacfg, "train")
    batch = {k: torch.from_numpy(np.asarray(v)).to("cuda") for k, v in
             ds.sample_batch(np.random.RandomState(seed), TRAIN_BATCH).items()}
    prof = _profile_step(state, make_schedule().to_device("cuda"), dcfg, batch)

    checks = {
        "losses_finite": len(logged) == TRAIN_STEPS and all(np.isfinite(r["loss"]) for r in logged),
        "no_skipped_step": steps_done == TRAIN_STEPS and all(r["skipped_nonfinite"] == 0 for r in logged),
        "checkpoint_written": checkpoints.latest_step(os.path.join(save_dir, "ckpt")) == TRAIN_STEPS
        and os.path.exists(os.path.join(save_dir, checkpoints.MODEL_FILE)),
        "attention_fwd_launches": fwd == per_step * TRAIN_STEPS,
        "attention_bwd_launches": bwd == per_step * TRAIN_STEPS,
        "generate_from_checkpoint": list(res["motions"].shape) == [1, mcfg.nfeats, 1, mcfg.max_seq_length]
        and bool(np.isfinite(res["motions"]).all()),
    }
    emit("main_path_train", nvidia_smi=smi, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         config=dataclasses.asdict(mcfg), train_s=train_s, step_s=timings["step_s"], batch_s=timings["batch_s"],
         steady_step_ms=1e3 * sum(steady) / len(steady), steady_steps_per_s=len(steady) / sum(steady),
         steady_batch_share=sum(timings["batch_s"][1:]) / sum(steady), peak_memory_gb=peak_gb,
         device_idle_share_of_steady_step=1.0 - prof["device_ms"] / (1e3 * sum(steady) / len(steady)),
         losses=[r["loss"] for r in logged], grad_norms=[r["grad_norm"] for r in logged],
         kernel_launches_fwd=fwd, kernel_launches_bwd=bwd, **prof, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (train) checks failed: {checks}")
    return fwd, bwd


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        raise SystemExit(f"{PKG}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)

    smi = phase_device()
    phase_build()
    phase_sass()
    attn = phase_kernels(args.seed)
    ras = phase_raster(args.seed)
    phase_slice_parity(args.seed)
    phase_face_slice_parity(args.seed)
    phase_render_parity(args.seed)
    launches = phase_main_path(args.seed, smi)
    bwd = phase_train_kernels(args.seed)
    phase_train_parity(args.seed)
    train_fwd, train_bwd = phase_main_path_train(args.seed, smi)

    import torch

    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, raster

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the f32 attention rows' bound is that of the arithmetic they do: 3xTF32
    attn_keys = ("max_abs_err", "ms", "plain_ms", "library_ms")
    tc = lambda row: {"bound_ms": row["bound_tc_ms"], "bound_by": row["bound_tc_by"]}  # noqa: E731
    disp = launches["display"]
    print(json.dumps({"kernels": [
        {"name": flash_attn.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/flash_attn_fwd.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:124",
         "launches": launches[flash_attn.NAME] + launches["face"] + train_fwd,
         "launches_by_path": {"generate": launches[flash_attn.NAME], "face": launches["face"], "train": train_fwd},
         "dropout": "replayed hash mask in the kernel (training); these numbers are at rate 0",
         "arithmetic": "3xTF32 on mma.sync m16n8k8 (f32); bound_ms at 495/3 TFLOP/s",
         **{k: attn[k] for k in attn_keys}, **tc(attn)},
        {"name": flash_attn.BWD_NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/flash_attn_bwd.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:157", "launches": train_bwd,
         "launches_by_path": {"train": train_bwd}, "dropout": bwd["dropout"], "shape": [
             bwd[k] for k in ("B", "H", "Tq", "Tk", "Dh")],
         "arithmetic": "3xTF32 on mma.sync m16n8k8 (f32); bound_ms at 495/3 TFLOP/s",
         **{k: bwd[k] for k in attn_keys}, **tc(bwd)},
        {"name": raster.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/raster.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas_raster.py:143", "launches": launches[raster.NAME],
         "shape": [ras[k] for k in ("B", "H", "W", "faces")], "graph_ms": ras["graph_ms"],
         **{k: ras[k] for k in keys}},
        {"name": display_pack.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/display_pack.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/display_pack.py:56", "launches": launches[display_pack.NAME],
         "launches_by_path": {"render": launches[display_pack.NAME]},
         "shape": [disp[k] for k in ("B", "H", "W")], "exact_share": disp["exact_share"],
         "no_tex_rec_ms": disp["no_tex_rec_ms"], "packed_ms": disp["packed_ms"], **{k: disp[k] for k in keys}},
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
