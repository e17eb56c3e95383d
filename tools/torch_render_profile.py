#!/usr/bin/env python3
"""Where the port's render time goes on one CUDA card.

    python3 tools/torch_render_profile.py [--batches 3] [--out build/render_profile.json]

Builds chip_smoke.py's main-path renderer (full-width BodyAvatar from a seed,
mesh_density=10 synthetic assets, the 2-camera rig, frame batch 8), warms it
up on one batch, then measures on random poses and face codes:
1. wall ms per frame batch of ``render_sequence_multicam`` (host clock
   around work that ends in a synchronize), and frames per second;
2. wall ms per stage, each synchronized: decode_frame, and per camera
   decoder_view, upscale_tex, the display pass (x std + mean, x shadow,
   display transform) through the display_pack kernel and, beside it on the
   same inputs, through its plain version (the composed chain), the
   display-space seam pass, projection + raster + texture sample;
3. torch.profiler over ``--batches`` batches: device time by kernel (top 25),
   device busy ms, launches, the idle share against the unprofiled wall
   time, and the device ms per launch of the raster wrapper's four kernels
   (the per-face setup and binning, the scan, the list fill and the tile
   raster) and of the display kernel.
Prints one JSON object and writes it to ``--out``.  TF32 is off, as in
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _sync_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "render_profile.json"))
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
    from audio2photoreal_tpu_torch.kernels import display_pack
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.geometry import project_points
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig
    from audio2photoreal_tpu_torch.render.rasterizer import render_mesh

    cfg = RendererConfig()
    assets = make_synthetic_assets(cfg, seed=args.seed, mesh_density=10)
    sd = chip_smoke._avatar_state_dict(cfg, assets, args.seed)
    cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width)
    fb = chip_smoke.RENDER_BATCH
    r = BodyRenderer(cfg, assets, sd, cams, frame_batch=fb, device="cuda")
    rng = np.random.RandomState(args.seed)
    pose = (rng.randn(fb * (args.batches + 1), 104) * 0.3).astype(np.float32)
    face = (rng.randn(fb * (args.batches + 1), 256) * 0.3).astype(np.float32)

    r.render_sequence_multicam(pose[:fb], face[:fb])  # warm-up: cuDNN plans, allocator
    _, wall_ms = _sync_ms(lambda: r.render_sequence_multicam(pose[fb:], face[fb:]))
    per_batch_ms = wall_ms / args.batches

    # stages of one batch, each synchronized
    m = r.model
    motion = torch.from_numpy(pose[:fb]).cuda()
    codes = torch.from_numpy(face[:fb]).cuda()
    stages = {}
    with torch.no_grad():
        dec, stages["decode_frame"] = _sync_ms(lambda: m.decode_frame(
            motion, face_embs=codes, embs=r._template_embs.expand(fb, -1), encode=False))
        for name, c in cams.items():
            campos, K, Rt = (r._tensor(getattr(c, k), fb) for k in ("campos", "K", "Rt"))
            view, stages[f"{name}.decoder_view"] = _sync_ms(
                lambda: m.decoder_view(dec["geom"], dec["tex_mean_rec"], campos, m.assets.geo))
            tex, stages[f"{name}.upscale_tex"] = _sync_ms(
                lambda: m.upscale_tex(dec["tex_mean_rec"], view["tex_view_rec"]))
            a = m.assets
            fin = (tex, dec["shadow_seamed"], a.tex_mean, a.tex_std)
            (q, _), stages[f"{name}.display_pass_kernel"] = _sync_ms(lambda: display_pack.finalize_display(*fin))
            _, stages[f"{name}.display_pass_plain"] = _sync_ms(
                lambda: display_pack.finalize_display_reference(*fin))
            q, stages[f"{name}.display_seam"] = _sync_ms(lambda: a.seam_2k.apply_display(q, 2))

            def raster_and_sample():
                pix, depth = project_points(dec["geom"], K, Rt)
                g = m.assets.geo
                return render_mesh(pix, depth, g.faces, g.uv_coords, g.uv_faces, q,
                                   cfg.image_height, cfg.image_width, display=True)

            rgb, stages[f"{name}.raster_and_sample"] = _sync_ms(raster_and_sample)
        _, stages["to_uint8_host"] = _sync_ms(lambda: torch.cat([rgb[0]] * 2, 2).to(torch.uint8).cpu().numpy())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render_sequence_multicam(pose[fb:], face[fb:])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = [{"name": e.key[:120], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]]
    launches = sum(e.count for e in kernels)
    def per_launch_ms(tag):
        es = [e for e in kernels if tag in e.key]
        return sum(e.self_device_time_total for e in es) / 1e3 / max(sum(e.count for e in es), 1)

    raster_ms, setup_ms = per_launch_ms("raster_kernel"), per_launch_ms("raster_setup_kernel")
    scan_ms, fill_ms = per_launch_ms("raster_scan_kernel"), per_launch_ms("raster_fill_kernel")
    display_ms = per_launch_ms("display_pack_kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {
        "nvidia_smi": smi, "frame_batch": fb, "cameras": len(cams), "batches": args.batches,
        "wall_ms_per_batch": per_batch_ms, "frames_per_s": fb * 1e3 / per_batch_ms,
        "stage_ms": stages, "device_busy_ms_per_batch": busy_us / 1e3 / args.batches,
        "idle_share": 1.0 - (busy_us / 1e3) / wall_ms, "device_launches_per_batch": launches / args.batches,
        "raster_kernel_device_ms_per_launch": raster_ms, "raster_setup_device_ms_per_launch": setup_ms,
        "raster_scan_device_ms_per_launch": scan_ms, "raster_fill_device_ms_per_launch": fill_ms,
        "display_pack_device_ms_per_launch": display_ms,
        "top_device_kernels": top,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
