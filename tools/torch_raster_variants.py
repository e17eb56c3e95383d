#!/usr/bin/env python3
"""Where the raster kernel's time goes, by taking parts of it out, on one CUDA card.

    python3 tools/torch_raster_variants.py [--calls 20] [--out build/raster_variants.json]

Builds copies of kernels/csrc/raster.cu under build/raster_variants/, each
with one edit (all built at once, one nvcc each), and times each through the
``rasterize_cuda`` wrapper at chip_smoke.py's raster shapes: the render's
1024x667, the synthetic rig's 2 cameras, 4 random poses, UV out, the
mesh_density=10 (9,322 faces) and mesh_density=30 (85,562 faces) bodies at
frame batch 8.  The variants:
- ``as_is``: the source as it is;
- ``no_early_out``: each (pixel, face) test computes w0, w1, w2 and z before
  it checks any of them;
- ``no_tests``: the tiles stage their lists but test nothing;
- ``no_lists``: the tiles read their list bounds and write their outputs,
  with no staging and no tests;
- ``no_lists_no_uv``: the same without the UV store;
- ``launch_only``: the tiles read their list bounds and store nothing.
All but the first two give wrong images: they measure.  For each variant and
mesh: the device µs per call of the call's memset and four kernels
(torch.profiler over ``--calls`` calls), the ms per wrapper call back to
back (CUDA events) and per replay of one captured call (CUDA graph), the
host's µs to issue one call (perf_counter around the Python call, the card
idle before it), and whether the outputs equal ``as_is``'s.  Two rounds, in
turns.  Prints one JSON line per variant and round and writes them all to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_TESTS = ("    best.test(s_rec, s_id, n, px, py, with_uv);\n",
          "    best.test(s_rec, s_id, s_count, px, py, with_uv);\n")
_NO_LISTS = [("  const int begin = start[tile], stop = end[tile];", "  const int begin = start[tile], stop = begin;"),
             ("  const int n_large = bin_count[bin];", "  const int n_large = 0 * bin_count[bin];")]
_UV_STORE = ("    if (with_uv) reinterpret_cast<float2*>(uv_out)[p] = make_float2(best.u, best.v);\n", "")
_STORES = ("    face_out[p] = best.f;\n    depth_out[p] = best.z;\n", "")
_EARLY = """      if (!(a >= 0.f)) continue;
      const float b = __fmul_rn(__fadd_rn(__fmul_rn(r1.x, dx), __fmul_rn(r1.y, dy)), r1.z);
      if (!(b >= 0.f)) continue;
      const float c = __fsub_rn(__fsub_rn(1.0f, a), b);
      if (!(c >= 0.f)) continue;
      const float4 r2 = s_rec[i][2];  // zb zc ua va
      const float zz = __fadd_rn(__fadd_rn(__fmul_rn(a, r1.w), __fmul_rn(b, r2.x)), __fmul_rn(c, r2.y));
      if (!(zz > 1e-6f)) continue;
"""
_LATE = """      const float b = __fmul_rn(__fadd_rn(__fmul_rn(r1.x, dx), __fmul_rn(r1.y, dy)), r1.z);
      const float c = __fsub_rn(__fsub_rn(1.0f, a), b);
      const float4 r2 = s_rec[i][2];  // zb zc ua va
      const float zz = __fadd_rn(__fadd_rn(__fmul_rn(a, r1.w), __fmul_rn(b, r2.x)), __fmul_rn(c, r2.y));
      if (!(a >= 0.f && b >= 0.f && c >= 0.f && zz > 1e-6f)) continue;
"""
VARIANTS = {
    "as_is": [],
    "no_early_out": [(_EARLY, _LATE)],
    "no_tests": [(t, "") for t in _TESTS],
    "no_lists": _NO_LISTS,
    "no_lists_no_uv": _NO_LISTS + [_UV_STORE],
    "launch_only": _NO_LISTS + [_UV_STORE, _STORES],
}


def build_variants(out_dir: str) -> dict:
    """{name: ctypes library} for every variant, built in parallel."""
    from audio2photoreal_tpu_torch.kernels import build, raster

    source = (build.CSRC / "raster.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"raster_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libraster_{name}.so")
        procs[name] = (lib, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log[-3000:]}")
        libs[name] = raster.bind(ctypes.CDLL(path))
    return libs


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "raster_variants.json"))
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke
    from audio2photoreal_tpu_torch.kernels import raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    libs = build_variants(os.path.join(ROOT, "build", "raster_variants"))
    cfg = RendererConfig()
    H, W = cfg.image_height, cfg.image_width
    cams = synthetic_rig((0.0, 0.0, 1.0), H, W)
    rng = np.random.RandomState(args.seed)
    motion = torch.from_numpy((rng.randn(4, 104) * 0.3).astype(np.float32)).to("cuda")
    meshes = {}
    for density in (10, 30):
        assets = make_synthetic_assets(RendererConfig(uv_size=256, upscale_size=512), seed=args.seed,
                                       mesh_density=density).to("cuda")
        pix, dep = chip_smoke._raster_inputs(assets, cams, motion)
        meshes[density] = (pix, dep, assets.geo.faces, assets.geo.uv_coords[assets.geo.uv_faces].contiguous())

    library = raster.library
    rows, reference = [], {}
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                raster.library = lambda lib=lib: lib
                row = {"variant": name, "round": rnd}
                for density, (pix, dep, faces, face_uv) in meshes.items():
                    call = lambda: raster.rasterize_cuda(pix, dep, faces, H, W, face_uv, emit_barys=False)  # noqa: E731
                    out = call()
                    torch.cuda.synchronize()
                    reference.setdefault(density, out)
                    same = all(torch.equal(a, b) for a, b in zip(out, reference[density]) if a is not None)
                    for _ in range(3):
                        call()
                    torch.cuda.synchronize()
                    host_us = []
                    for _ in range(args.calls):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        call()
                        host_us.append((time.perf_counter() - t0) * 1e6)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(args.calls):
                            call()
                        torch.cuda.synchronize()
                    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
                    us = {k: sum(e.self_device_time_total for e in events if k in e.key) / args.calls
                          for k in ("Memset", "raster_setup_kernel", "raster_scan_kernel", "raster_fill_kernel",
                                    "raster_kernel")}
                    row[f"faces_{faces.shape[0]}"] = dict(
                        B=pix.shape[0], equal_as_is=same, device_us=us, device_us_sum=sum(us.values()),
                        ms=chip_smoke._time_ms(call, iters=args.calls),
                        graph_ms=chip_smoke._graph_ms(call, iters=args.calls), host_us=float(np.median(host_us)))
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        raster.library = library
    out = {"nvidia_smi": chip_smoke.nvidia_smi(), "calls": args.calls, "rows": rows}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"nvidia_smi": out["nvidia_smi"], "out": args.out}))


if __name__ == "__main__":
    main()
