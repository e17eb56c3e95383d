#!/usr/bin/env python3
"""Tile and occupancy variants of the attention kernels, timed side by side
on one card.

    python3 tools/torch_attn_tune.py [--fwd NAME:EDITS ...] [--bwd NAME:EDITS ...]
                                     [--fwd_bf16 NAME:EDITS ...] [--bwd_bf16 NAME:EDITS ...]

Each variant is a copy of ``kernels/csrc/flash_attn_fwd.cu`` (``_bwd.cu``,
``_fwd_bf16.cu``, ``_bwd_bf16.cu``) under build/tune/ whose ``Cfg`` members
are given other initializers: a variant is ``NAME:MEMBER=EXPR[,MEMBER=EXPR...]``,
such as ``bk64:BK=64,MIN_BLOCKS=2`` (``NAME:`` alone is the source as it
is); all are built in parallel.  The f32 forward variants run at the f32
cases of chip_smoke's ``KERNEL_CASES`` at every cluster split (0 = the
kernel's own choice, then 1-4), the f32 backward variants at the f32 cases
of ``TRAIN_KERNEL_CASES`` (dropout 0.1), the bf16 variants at
``BF16_KERNEL_CASES`` (each at its own dropout; the forward at the kernel's
own split); each is checked against the plain version (chip_smoke's bars)
and timed with CUDA events (chip_smoke's ``_time_ms``).  One JSON line per
(variant, case[, split]), with the card's name and power limit and each
variant's ptxas registers and spills.  Needs one CUDA card and the toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_FWD = ["base:"]
DEFAULT_BWD = ["base:"]
# kind -> (source, C entry point)
KINDS = {"fwd": ("flash_attn_fwd.cu", "flash_attn_fwd"), "bwd": ("flash_attn_bwd.cu", "flash_attn_bwd"),
         "fwd_bf16": ("flash_attn_fwd_bf16.cu", "flash_attn_fwd_bf16"),
         "bwd_bf16": ("flash_attn_bwd_bf16.cu", "flash_attn_bwd_bf16")}


def _patched(text: str, edits: str) -> str:
    """``text`` with the initializer of each named ``static constexpr``
    member replaced; raises unless each names exactly one."""
    for edit in filter(None, edits.split(",")):
        member, expr = edit.split("=", 1)
        pattern = rf"(static constexpr \w+ {re.escape(member.strip())} = )[^;]*;"
        text, n = re.subn(pattern, lambda m: m.group(1) + expr.strip() + ";", text)
        if n != 1:
            raise SystemExit(f"{member!r} names {n} Cfg members, not one")
    return text


def _build(name: str, src: str, edits: str) -> tuple:
    from audio2photoreal_tpu_torch.kernels import build

    d = os.path.join(ROOT, "build", "tune")
    os.makedirs(d, exist_ok=True)
    lib, copy = os.path.join(d, f"lib{name}.so"), os.path.join(d, f"{name}.cu")
    with open(copy, "w") as f:
        f.write(_patched((build.CSRC / src).read_text(), edits))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", lib, copy],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}: {proc.stderr[-3000:]}")
    ptxas = [l.strip() for l in proc.stderr.splitlines() if "registers" in l or "spill" in l]
    return lib, ptxas


def _bf16_variant(kind, name, fn, lib, entry, head, g, cs, fa, stream) -> None:
    """A bf16 variant at chip_smoke's BF16_KERNEL_CASES, against the plain
    versions at the case's plain batch (bar: chip_smoke's BF16_TOL of the
    largest plain output or gradient)."""
    import torch

    for B, H, Tq, Tk, Dh, rate, pB in cs.BF16_KERNEL_CASES:
        q, k, v, do = (torch.randn((B, H, T, Dh), generator=g, device="cuda").to(torch.bfloat16)
                       for T in (Tq, Tk, Tk, Tq))
        seed = 77
        drop = fa._dropout_args(rate, seed, Tq, Tk, None)
        args = (None, False, rate, seed)
        if kind == "fwd_bf16":
            def run():
                out = torch.empty((B, Tq, H, Dh), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), None,
                         fa._strides(q, k, v, out), B, H, Tq, Tk, Dh, 0, 0, *drop, stream(q.device))
                if err:
                    raise RuntimeError(f"{name}: error {err}")
                return out

            got = run()[:pB]
            want = fa.flash_attention_reference(q[:pB], k[:pB], v[:pB], *args)
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
        else:
            out, lse = fa._launch_fwd(q, k, v, *args, None, True)
            delta = torch.empty((B, H, Tq), device="cuda")
            part = torch.empty(getattr(lib, f"{entry}_scratch_floats")(B, H, Tq, Tk, Dh), device="cuda")

            def run():
                dq, dk, dv = (torch.empty(x.shape, dtype=torch.bfloat16, device="cuda") for x in (q, k, v))
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), delta.data_ptr(), part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), fa._strides(q, k, v, out, do, dq, dk, dv), B, H, Tq, Tk, Dh, 0, *drop,
                         stream(q.device))
                if err:
                    raise RuntimeError(f"{name}: error {err}")
                return dq, dk, dv

            got = [x[:pB] for x in run()]
            want = fa.flash_attention_bwd_reference(q[:pB], k[:pB], v[:pB], do[:pB], *args)
            scale = max(w.float().abs().max().item() for w in want)
            err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
        torch.cuda.synchronize()
        ms = cs._time_ms(run)
        print(json.dumps({**head, "case": [B, H, Tq, Tk, Dh, rate], "ms": ms, "max_abs_err": err,
                          "ok": err <= cs.BF16_TOL * scale}), flush=True)
        del q, k, v, do, got, want
        torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fwd", nargs="*", default=DEFAULT_FWD)
    p.add_argument("--bwd", nargs="*", default=DEFAULT_BWD)
    p.add_argument("--fwd_bf16", nargs="*", default=[])
    p.add_argument("--bwd_bf16", nargs="*", default=[])
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from audio2photoreal_tpu_torch.kernels import flash_attn as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    jobs = [(f"{kind}_" + v.split(":", 1)[0], KINDS[kind][0], v.split(":", 1)[1])
            for kind in KINDS for v in getattr(args, kind)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip([j[0] for j in jobs], pool.map(lambda j: _build(*j), jobs)))
    stream = lambda dev: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(0)

    for name, _, edits in jobs:
        lib_path, ptxas = built[name]
        lib = ctypes.CDLL(lib_path)
        head = dict(variant=name, edits=edits, nvidia_smi=smi)
        print(json.dumps({**head, "ptxas": ptxas}), flush=True)
        kind = next(k for k in sorted(KINDS, key=len, reverse=True) if name.startswith(k + "_"))
        entry = KINDS[kind][1]
        fn = getattr(lib, entry)
        if kind.startswith("fwd"):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + fa._DROPOUT_ARGTYPES + [ctypes.c_void_p]
            getattr(lib, f"{entry}_split").argtypes = [ctypes.c_int] * 5
        else:
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + fa._DROPOUT_ARGTYPES + [ctypes.c_void_p]
            getattr(lib, f"{entry}_scratch_floats").argtypes = [ctypes.c_int] * 5
            getattr(lib, f"{entry}_scratch_floats").restype = ctypes.c_longlong
        if kind.endswith("bf16"):
            _bf16_variant(kind, name, fn, lib, entry, head, g, cs, fa, stream)
        elif kind == "fwd":
            for B, H, Tq, Tk, Dh, masked in cs.KERNEL_CASES:
                q, k, v = (torch.randn((B, H, T, Dh), generator=g, device="cuda") for T in (Tq, Tk, Tk))
                valid = None
                if masked:
                    lengths = torch.tensor([Tk - 50 * (B - 1 - b) for b in range(B)], device="cuda")
                    valid = (torch.arange(Tk, device="cuda")[None] < lengths[:, None]).float()
                want = fa.flash_attention_reference(q, k, v, valid, masked)
                drop = fa._dropout_args(0.0, 0, Tq, Tk, None)

                def run(split):
                    out = torch.empty((B, Tq, H, Dh), device="cuda").transpose(1, 2)
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), fa._ptr(valid), out.data_ptr(), None,
                             fa._strides(q, k, v, out), B, H, Tq, Tk, Dh, int(masked), split, *drop,
                             stream(q.device))
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                    return out

                auto = lib.flash_attn_fwd_split(B, H, Tq, Tk, Dh)
                for split in (0, 1, 2, 3, 4):
                    try:
                        got = run(split)
                    except RuntimeError:  # more splits than key tiles
                        continue
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    ms = cs._time_ms(lambda: run(split))
                    print(json.dumps({**head, "case": [B, H, Tq, Tk, Dh, masked], "split": split, "auto_split": auto,
                                      "ms": ms, "max_abs_err": err, "ok": err <= cs.TOL["float32"]}), flush=True)
        else:
            for B, H, Tq, Tk, Dh, masked in cs.TRAIN_KERNEL_CASES:
                q, k, v, do, valid = cs._attn_inputs(g, B, H, Tq, Tk, Dh, masked)
                args = (valid, masked, cs.TRAIN_DROPOUT, 77)
                out, lse = fa._launch_fwd(q, k, v, *args, None, True)
                want = fa.flash_attention_bwd_reference(q, k, v, do, *args)
                drop = fa._dropout_args(cs.TRAIN_DROPOUT, 77, Tq, Tk, None)
                delta = torch.empty((B, H, Tq), device="cuda")
                part = torch.empty(lib.flash_attn_bwd_scratch_floats(B, H, Tq, Tk, Dh), device="cuda")

                def run():
                    dq, dk, dv = (torch.empty(x.shape, device="cuda") for x in (q, k, v))
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), fa._ptr(valid), out.data_ptr(), do.data_ptr(),
                             lse.data_ptr(), delta.data_ptr(), part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(),
                             fa._strides(q, k, v, out, do, dq, dk, dv), B, H, Tq, Tk, Dh, int(masked), *drop,
                             stream(q.device))
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                    return dq, dk, dv

                got = run()
                torch.cuda.synchronize()
                scale = max(w.abs().max().item() for w in want)
                err = max((a - w).abs().max().item() for a, w in zip(got, want))
                ms = cs._time_ms(run)
                print(json.dumps({**head, "case": [B, H, Tq, Tk, Dh, masked], "ms": ms, "max_abs_err": err,
                                  "ok": err <= cs.GRAD_TOL["float32"] * scale}), flush=True)
                del q, k, v, do, out, lse, want, got, part
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
