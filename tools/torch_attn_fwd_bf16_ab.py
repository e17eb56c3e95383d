#!/usr/bin/env python3
"""The bf16 attention forward, two builds side by side on one card.

    python3 tools/torch_attn_fwd_bf16_ab.py [--old PATH] [--cases train|all] [--out FILE]

"new" is the package's ``kernels/csrc/flash_attn_fwd_bf16.cu``; "old" is
another source with the same C interface (``flash_attn_fwd_bf16`` and its
``_split`` query), by default ``build/ab/flash_attn_fwd_bf16_old.cu``.  The
two-warpgroup kernel that the warp-specialised design replaced is
``git show d67d5ec:audio2photoreal_tpu_torch/kernels/csrc/flash_attn_fwd_bf16.cu``;
write it there before the call (``build/`` travels to the card and git does
not track it).  Both are built from source with the package's nvcc flags, in
parallel; without the ``--old`` file only "new" runs.

At each case of chip_smoke's ``BF16_KERNEL_CASES`` (``--cases train``: the
five training shapes), at the case's dropout and at rate 0, each build's C
entry is called as the package's wrapper calls it (output and log-sum-exp
allocated per call, the kernel's own split) on the model's strided views:
held to the plain version at the case's plain batch (chip_smoke's bar, 1e-2
of the largest plain output) and rerun bit for bit, then timed in turns old,
new, new, old: calls back to back (chip_smoke's ``_time_ms``) and one call
replayed in a CUDA graph (``_graph_ms``: the card's time alone).  Beside them
SDPA's forward at rate 0 on the same inputs and the bound (4·B·H·Tq·Tk·Dh at
989 TFLOP/s, or the bytes at 3.35 TB/s where larger).  One JSON line per case
and rate, with the card's name and power limit, on stdout and appended to
``--out``; a first line with each build's ptxas lines and, from its SASS
(``cuobjdump``), each kernel's instructions, spill loads and stores, and the
dropout path's instructions per score element: the instructions a dropout
build adds over one without dropout (the new kernel's two instantiations;
for the old one, a copy with ``a.drop.on`` compiled out), over the hash's
element bodies (its shifts by 13).  Needs one CUDA card and the toolkit.
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
DEFAULT_OLD = os.path.join(ROOT, "build", "ab", "flash_attn_fwd_bf16_old.cu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_attn_bwd_bf16_ab import _build  # noqa: E402  (tools/torch_attn_bwd_bf16_ab.py)


def _sass(lib: str) -> dict:
    """{kernel (demangled by its template arguments): counts} from a
    library's SASS: instructions, spill stores (STL) and loads (LDL), and the
    hash's first shift (SHF.R.U32.HI by 13), one per element body."""
    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "--dump-sass", lib],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            dh = "128" if "Li128E" in fn else "64" if "Li64E" in fn else "?"
            name = f"{'attn_fwd_bf16_kernel' if 'attn_fwd_bf16_kernel' in fn else fn}<{dh}" + (
                ", dropout>" if "Lb1E" in fn else ", no dropout>" if "Lb0E" in fn else ">")
            out[name] = dict(instructions=0, STL=0, LDL=0, hash_shift13=0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if name and m:
            op, rest = m.group(2), m.group(3)
            c = out[name]
            c["instructions"] += 1
            c["STL"] += op.startswith("STL")
            c["LDL"] += op.startswith("LDL")
            c["hash_shift13"] += op == "SHF.R.U32.HI" and re.search(r",\s*0xd\s*,", rest) is not None
    return out


def _per_element(sass_drop: dict, sass_plain: dict) -> dict:
    """{Dh: instructions the dropout path adds per score element}."""
    out = {}
    for name, c in sass_drop.items():
        if c["hash_shift13"] == 0:
            continue
        dh = "128" if "<128" in name else "64"
        base = next((p for n, p in sass_plain.items() if f"<{dh}" in n and p["hash_shift13"] == 0), None)
        if base is not None:
            out[dh] = dict(added=c["instructions"] - base["instructions"], element_bodies=c["hash_shift13"],
                           per_element=(c["instructions"] - base["instructions"]) / c["hash_shift13"])
    return out


def _bind(path: str) -> ctypes.CDLL:
    from audio2photoreal_tpu_torch.kernels import flash_attn as fa

    lib = ctypes.CDLL(path)
    fn = getattr(lib, fa.BF16_NAME)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + fa._DROPOUT_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    split = getattr(lib, f"{fa.BF16_NAME}_split")
    split.argtypes = [ctypes.c_int] * 5
    split.restype = ctypes.c_int
    return lib


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", default=DEFAULT_OLD)
    p.add_argument("--cases", choices=("train", "all"), default="all")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "ab", "attn_fwd_bf16_ab.jsonl"))
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
    jobs = {"new": str(build.CSRC / fa.BF16_SOURCES[0])}
    if os.path.exists(args.old):
        jobs["old"] = args.old
        nodrop = os.path.join(os.path.dirname(args.old), "flash_attn_fwd_bf16_old_nodrop.cu")
        with open(args.old) as f, open(nodrop, "w") as g:
            g.write(f.read().replace("a.drop.on ?", "false ?"))
        jobs["old_nodrop"] = nodrop
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _build(f"ab_fwd_{kv[0]}", kv[1]), jobs.items())))
    sass = {name: _sass(path) for name, (path, _) in built.items()}
    per_element = {"new": _per_element({n: c for n, c in sass["new"].items() if n.endswith(", dropout>")},
                                       {n: c for n, c in sass["new"].items() if n.endswith(", no dropout>")})}
    if "old" in built:
        per_element["old"] = _per_element(sass["old"], sass["old_nodrop"])
    libs = {name: _bind(built[name][0]) for name in ("old", "new") if name in built}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(row: dict) -> None:
        line = json.dumps({"nvidia_smi": smi, **row})
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    emit({"builds": {name: {"source": os.path.relpath(jobs[name], ROOT), "ptxas": ptxas, "sass": sass[name]}
                     for name, (_, ptxas) in built.items()},
          "dropout_instructions_per_element": per_element})
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = [c for c in cs.BF16_KERNEL_CASES if args.cases == "all" or c[5] > 0.0]
    failed = []
    for B, H, Tq, Tk, Dh, rate, pB in cases:
        q = cs._split_heads(torch.randn((B, Tq, H * Dh), generator=g, device="cuda").to(bf16), H)
        kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device="cuda").to(bf16)
        k, v = cs._split_heads(kv[..., : H * Dh], H), cs._split_heads(kv[..., H * Dh:], H)
        seed = 3_000_017 + Tq + Tk + Dh
        flops = 4.0 * B * H * Tq * Tk * Dh
        nbytes = 2 * (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh)
        for r in sorted({rate, 0.0}, reverse=True):
            drop = fa._dropout_args(r, seed, Tq, Tk, None)
            want = fa.flash_attention_reference(q[:pB], k[:pB], v[:pB], None, False, r, seed)
            scale = want.float().abs().max().item()
            bound, by = cs._bound(nbytes, flops, "bfloat16")
            row = dict(case=[B, H, Tq, Tk, Dh], dropout=r, plain_B=pB, out_scale=scale, tol=cs.BF16_TOL * scale,
                       bound_ms=bound, bound_by=by)

            def call(name):
                out = torch.empty((B, Tq, H, Dh), dtype=bf16, device="cuda").transpose(1, 2)
                lse = torch.empty((B, H, Tq), device="cuda")
                err = getattr(libs[name], fa.BF16_NAME)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), lse.data_ptr(),
                    fa._strides(q, k, v, out), B, H, Tq, Tk, Dh, 0, 0, *drop,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: error {err}")
                return out, lse

            for name in libs:
                first, second = call(name), call(name)
                torch.cuda.synchronize()
                err = (first[0][:pB].float() - want.float()).abs().max().item()
                row[name] = dict(max_abs_err=err, ok=err <= cs.BF16_TOL * scale,
                                 bitwise_deterministic=all(torch.equal(x, y) for x, y in zip(first, second)),
                                 split=getattr(libs[name], f"{fa.BF16_NAME}_split")(B, H, Tq, Tk, Dh))
                if not (row[name]["ok"] and row[name]["bitwise_deterministic"]):
                    failed.append([name, B, H, Tq, Tk, Dh, r])
                del first, second
            del want
            order = ["old", "new", "new", "old"] if "old" in libs else ["new", "new"]
            ms = {name: [] for name in libs}
            graph = {name: [] for name in libs}
            for name in order:
                ms[name].append(cs._time_ms(lambda: call(name)))
            for name in order:
                graph[name].append(cs._graph_ms(lambda: call(name)))
            for name in libs:
                row[name].update(ms=ms[name], graph_ms=graph[name],
                                 share_of_bound=bound / min(min(ms[name]), min(graph[name])))
            if r == 0.0:
                row["sdpa_ms"] = cs._time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                row["sdpa_graph_ms"] = cs._graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            emit(row)
            torch.cuda.empty_cache()
        del q, k, v, kv
        torch.cuda.empty_cache()
    emit({"done": True, "failed": failed})
    if failed:
        raise SystemExit(f"builds that disagree with the plain version or with themselves: {failed}")


if __name__ == "__main__":
    main()
