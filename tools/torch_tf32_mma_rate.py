#!/usr/bin/env python3
"""Rates of the instructions the attention kernels are built from, on the
card: mma.sync m16n8k8 TF32 issued back to back from registers, alone and
with the 3xTF32 operand split beside it (cvt.rna.tf32.f32, or the same
rounding in integer operations), and the SASS mix of each attention kernel.

    python3 tools/torch_tf32_mma_rate.py

Builds a small probe library with nvcc (sm_90a) under build/probes/, times
each probe kernel with CUDA events over a grid of 8 blocks of 4 warps per
SM, and prints one JSON line per probe (TFLOP/s of mma work, instructions
per second) and one with the SASS histogram of every kernel in the attention
libraries (``cuobjdump --dump-sass``).  Needs one CUDA card and the toolkit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
               "{%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ uint32_t int_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// mode 0: mma only; 1: + 4 cvt.rna per mma; 2: + 4 integer roundings per mma
template <int MODE>
__global__ void probe(float* out, int iters, float seed) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  float x = seed + threadIdx.x;
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(x + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(x - i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (MODE == 1) {
        a[j & 3] = cvt_rna(__uint_as_float(a[j & 3]) + 1.f);
        a[(j + 1) & 3] = cvt_rna(__uint_as_float(a[(j + 1) & 3]) + 1.f);
        b[0] = cvt_rna(__uint_as_float(b[0]) + 1.f);
        b[1] = cvt_rna(__uint_as_float(b[1]) + 1.f);
      } else if (MODE == 2) {
        a[j & 3] = int_rna(__uint_as_float(a[j & 3]) + 1.f);
        a[(j + 1) & 3] = int_rna(__uint_as_float(a[(j + 1) & 3]) + 1.f);
        b[0] = int_rna(__uint_as_float(b[0]) + 1.f);
        b[1] = int_rna(__uint_as_float(b[1]) + 1.f);
      }
      mma(c[j], a, b);
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_probe(int mode, float* out, int blocks, int iters, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {  // the first run warms up
    cudaEventRecord(e0);
    if (mode == 0) probe<0><<<blocks, 128>>>(out, iters, 1.f);
    if (mode == 1) probe<1><<<blocks, 128>>>(out, iters, 1.f);
    if (mode == 2) probe<2><<<blocks, 128>>>(out, iters, 1.f);
    cudaEventRecord(e1);
  }
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""


def sass_histogram(lib: str) -> dict:
    """{kernel: Counter of SASS opcodes} of a built library."""
    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "--dump-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    from audio2photoreal_tpu_torch.kernels import build, flash_attn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    d = os.path.join(ROOT, "build", "probes")
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "tf32_probe.cu"), os.path.join(d, "libtf32_probe.so")
    open(src, "w").write(SRC)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src], check=True, capture_output=True)
    probe = ctypes.CDLL(lib).run_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096
    out = torch.empty(blocks * 128, device="cuda")
    for mode, name in ((0, "mma_only"), (1, "mma_plus_4_cvt_rna"), (2, "mma_plus_4_int_rna")):
        ms = ctypes.c_float()
        err = probe(mode, out.data_ptr(), blocks, iters, ctypes.byref(ms))
        if err:
            raise RuntimeError(f"probe {name}: cudaError_t {err}")
        mmas = blocks * 4 * iters * 8  # per warp: iters x 8 mma
        print(json.dumps({"probe": name, "nvidia_smi": smi, "ms": ms.value, "mma_per_s": mmas / ms.value * 1e3,
                          "tflops": mmas * 2048 / ms.value / 1e9, "blocks": blocks, "warps_per_block": 4}),
              flush=True)
    for n, srcs, load in ((flash_attn.NAME, flash_attn.SOURCES, flash_attn.library),
                          (flash_attn.BWD_NAME, flash_attn.BWD_SOURCES, flash_attn.bwd_library)):
        load()
        for fn, c in sass_histogram(str(build.library_path(n, srcs))).items():
            top = dict(c.most_common(14))
            print(json.dumps({"sass": fn[-60:], "total": sum(c.values()), "top": top}), flush=True)


if __name__ == "__main__":
    main()
