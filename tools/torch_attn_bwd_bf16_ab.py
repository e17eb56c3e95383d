#!/usr/bin/env python3
"""The bf16 attention backward, two builds side by side on one card.

    python3 tools/torch_attn_bwd_bf16_ab.py [--old PATH] [--cases train|all] [--out FILE]

"new" is the package's ``kernels/csrc/flash_attn_bwd_bf16.cu``; "old" is
another source with the same C interface (``flash_attn_bwd_bf16`` and its
``_scratch_floats`` query), by default ``build/ab/flash_attn_bwd_bf16_old.cu``.
The ``mma.sync`` kernel that the warp-specialised ``wgmma`` design replaced is
``git show 993810f:audio2photoreal_tpu_torch/kernels/csrc/flash_attn_bwd_bf16.cu``;
write it there before the call (``build/`` travels to the card and git does
not track it).  Both are built from source with the package's nvcc flags, in
parallel; without ``--old`` file only "new" runs.

At each case of chip_smoke's ``BF16_KERNEL_CASES`` (``--cases train``: the
five training shapes, dropout 0.1), at the case's dropout and at rate 0, each
build's C entry is called as the package's wrapper calls it (outputs and
scratch allocated per call; the old kernel also takes a [B, H, Tq] delta) on
the model's strided views: it is held to the plain version at the case's
plain batch (chip_smoke's bar, 1e-2 of the largest plain gradient) and rerun
bit for bit, then timed in turns old, new, new, old: calls back to back
(chip_smoke's ``_time_ms``) and one call replayed in a CUDA graph
(``_graph_ms``: the card's time alone).  Beside them SDPA's backward at rate
0 on the same inputs, the bound (10·B·H·Tq·Tk·Dh at 989 TFLOP/s), each
build's scratch and its device ms by kernel (torch.profiler, one call).  One
JSON line per case and rate, with the card's name and power limit and each
build's ptxas lines, on stdout and appended to ``--out``.  Needs one CUDA
card and the toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OLD = os.path.join(ROOT, "build", "ab", "flash_attn_bwd_bf16_old.cu")


def _build(name: str, src: str) -> tuple:
    """nvcc ``src`` (its includes resolved in the package's csrc/) into
    build/ab/lib<name>.so; (library path, ptxas lines)."""
    from audio2photoreal_tpu_torch.kernels import build

    d = os.path.join(ROOT, "build", "ab")
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, f"lib{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}: {proc.stderr[-3000:]}")
    ptxas = [l.strip() for l in proc.stderr.splitlines()
             if "registers" in l or "spill" in l or "warning" in l.lower()]
    return lib, ptxas


def _device_ms_by_kernel(fn) -> dict:
    """``fn()`` once under torch.profiler: {kernel name: device ms}."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"attn_bwd\w*kernel(<[^>]*>)?", e.key)
            name = m.group(0) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def _bind(path: str) -> ctypes.CDLL:
    from audio2photoreal_tpu_torch.kernels import flash_attn as fa

    lib = ctypes.CDLL(path)
    fn = getattr(lib, fa.BF16_BWD_NAME)
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + fa._DROPOUT_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = getattr(lib, f"{fa.BF16_BWD_NAME}_scratch_floats")
    scratch.argtypes = [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    return lib


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", default=DEFAULT_OLD)
    p.add_argument("--cases", choices=("train", "all"), default="train")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "ab", "attn_bwd_bf16_ab.jsonl"))
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from audio2photoreal_tpu_torch.kernels import build
    from audio2photoreal_tpu_torch.kernels import flash_attn as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    jobs = {"new": str(build.CSRC / fa.BF16_BWD_SOURCES[0])}
    if os.path.exists(args.old):
        jobs["old"] = args.old
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _build(f"ab_{kv[0]}", kv[1]), jobs.items())))
    libs = {name: _bind(path) for name, (path, _) in built.items()}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def emit(row: dict) -> None:
        line = json.dumps({"nvidia_smi": smi, **row})
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    emit({"builds": {name: {"source": os.path.relpath(jobs[name], ROOT), "ptxas": ptxas}
                     for name, (_, ptxas) in built.items()}})
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = [c for c in cs.BF16_KERNEL_CASES if args.cases == "all" or c[5] > 0.0]
    failed = []
    for B, H, Tq, Tk, Dh, rate, pB in cases:
        q = cs._split_heads(torch.randn((B, Tq, H * Dh), generator=g, device="cuda").to(bf16), H)
        kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device="cuda").to(bf16)
        k, v = cs._split_heads(kv[..., : H * Dh], H), cs._split_heads(kv[..., H * Dh:], H)
        do = torch.randn((B, H, Tq, Dh), generator=g, device="cuda").to(bf16)
        seed = 3_000_017 + Tq + Tk + Dh
        for r in sorted({rate, 0.0}, reverse=True):
            a = (None, False, r, seed)
            out, lse = fa._launch_fwd(q, k, v, *a, None, True)
            qp, kp, vp, dop = (x[:pB] for x in (q, k, v, do))
            want = fa.flash_attention_bwd_reference(qp, kp, vp, dop, *a)
            scale = max(w.float().abs().max().item() for w in want)
            row = dict(case=[B, H, Tq, Tk, Dh], dropout=r, plain_B=pB, grad_scale=scale, tol=cs.BF16_TOL * scale)

            drop = fa._dropout_args(r, seed, Tq, Tk, None)
            floats = {name: getattr(lib, f"{fa.BF16_BWD_NAME}_scratch_floats")(B, H, Tq, Tk, Dh)
                      for name, lib in libs.items()}

            def call(name):
                dq, dk, dv = (torch.empty(x.shape, dtype=bf16, device="cuda") for x in (q, k, v))
                delta = torch.empty((B, H, Tq), device="cuda")
                scratch = torch.empty(floats[name], device="cuda")
                err = getattr(libs[name], fa.BF16_BWD_NAME)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    fa._strides(q, k, v, out, do, dq, dk, dv), B, H, Tq, Tk, Dh, 0, *drop,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: error {err}")
                return dq, dk, dv

            for name in libs:
                first, second = call(name), call(name)
                torch.cuda.synchronize()
                err = max((x[:pB].float() - w.float()).abs().max().item() for x, w in zip(first, want))
                row[name] = dict(max_abs_err=err, ok=err <= cs.BF16_TOL * scale,
                                 bitwise_deterministic=all(torch.equal(x, y) for x, y in zip(first, second)),
                                 scratch_gb=4 * floats[name] / 1e9)
                if not (row[name]["ok"] and row[name]["bitwise_deterministic"]):
                    failed.append([name, B, H, Tq, Tk, Dh, r])
                del first, second
            del want
            torch.cuda.empty_cache()
            order = ["old", "new", "new", "old"] if "old" in libs else ["new", "new"]
            ms = {name: [] for name in libs}
            graph = {name: [] for name in libs}
            for name in order:
                ms[name].append(cs._time_ms(lambda: call(name)))
            for name in order:
                graph[name].append(cs._graph_ms(lambda: call(name)))
            for name in libs:
                row[name].update(ms=ms[name], graph_ms=graph[name],
                                 device_ms_by_kernel=_device_ms_by_kernel(lambda: call(name)))
            if r == 0.0:
                ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
                lib_out = F.scaled_dot_product_attention(ql, kl, vl)
                row["sdpa_ms"] = cs._time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                                         retain_graph=True))
                del lib_out, ql, kl, vl
            row["bound_ms"] = 10.0 * B * H * Tq * Tk * Dh / cs.FLOP_PER_S["bfloat16"] * 1e3
            emit(row)
            del out, lse
            torch.cuda.empty_cache()
        del q, k, v, kv, do
        torch.cuda.empty_cache()
    emit({"done": True, "failed": failed})
    if failed:
        raise SystemExit(f"builds that disagree with the plain version or with themselves: {failed}")


if __name__ == "__main__":
    main()
