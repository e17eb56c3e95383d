#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio2photoreal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and the CUDA toolkit
(nvcc).  Each phase prints one JSON line; any failure is an uncaught
exception and a nonzero exit.

1. device: the card, its power limit, torch/CUDA versions; TF32 is turned off
   for matmuls and cuDNN convs, so f32 stays f32 throughout.
2. build: compile the attention kernel from kernels/csrc/ (nvcc, sm_90a).
3. kernel vs plain: the CUDA attention kernel against its plain PyTorch
   version on the card, f32 and bf16, at the denoiser's shapes and a small
   ragged masked case; max abs error and the time of each.
4. slice parity: a full-width pose denoiser from ``--seed``, encode + cached
   CFG + DDIM-5 from one numpy x_T, on the card (with the kernel) against the
   CPU (plain attention).
5. main path: ``apps.generate.generate`` on a synthetic person, full-width
   pose model, DDIM-500, CFG 2.0, 2 samples; checks results.npy and that the
   kernel launched 8 layers x 2 attentions x 500 steps times.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "audio2photoreal_tpu_torch"
WORK = os.path.join(ROOT, "build", "chip_smoke")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # kernel vs plain, unit-normal inputs
SLICE_TOL = 1e-3  # card vs CPU pred_xstart after DDIM-5
# (B, H, Tq, Tk, Dh, masked): self- and cross-attention of the pose denoiser
# under CFG with 2 samples, the face width, and a ragged kv_valid + causal case
KERNEL_CASES = [
    (4, 4, 600, 600, 64, False),
    (4, 4, 600, 2000, 64, False),
    (4, 4, 600, 2000, 128, False),
    (2, 3, 77, 203, 64, True),
]
MAIN_CASE = (4, 4, 600, 2000, 64, False)  # the kernel's numbers in the summary line


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
    from audio2photoreal_tpu_torch.kernels import build, flash_attn

    path = build.library_path(flash_attn.NAME, flash_attn.SOURCES)
    cached = path.exists()
    t0 = time.perf_counter()
    flash_attn.library()
    seconds = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text()
    ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
    emit("build", kernel=flash_attn.NAME, library=os.path.relpath(path, ROOT),
         already_built=cached, seconds=seconds, ptxas=ptxas)


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(seed: int) -> dict:
    import torch

    from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_reference

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
            # in turns: plain, kernel, kernel, plain
            p1 = _time_ms(lambda: flash_attention_reference(*args))
            k1 = _time_ms(lambda: flash_attention(*args))
            k2 = _time_ms(lambda: flash_attention(*args))
            p2 = _time_ms(lambda: flash_attention_reference(*args))
            row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, kv_valid_causal=masked, dtype=name,
                       max_abs_err=err, tol=TOL[name], ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
            emit("kernel_vs_plain", **row)
            if not err <= TOL[name]:
                raise AssertionError(f"flash_attn_fwd disagrees with its plain version: {row}")
            if (B, H, Tq, Tk, Dh, masked) == MAIN_CASE and name == "float32":
                summary = row
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


def phase_main_path(seed: int, smi: str) -> int:
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts

    shutil.rmtree(WORK, ignore_errors=True)
    person, num_samples, steps = "SYNTH01", 2, 500
    t0 = time.perf_counter()
    make_synthetic_person(WORK, person, num_scenes=8, frames_per_scene=600, seed=seed)
    cfg, model = _pose_model(seed)
    model_dir = os.path.join(WORK, "pose_model")
    save_config(model_dir, denoiser=cfg, diffusion=DiffusionConfig(),
                data=DataConfig(person=person, max_seq_length=cfg.max_seq_length))
    torch.save(model.state_dict(), os.path.join(model_dir, MODEL_FILE))
    setup_s = time.perf_counter() - t0

    timings: dict = {}
    launch_counts.clear()
    t0 = time.perf_counter()
    path = generate(model_dir, WORK, num_samples=num_samples, guidance_param=2.0,
                    timestep_respacing=f"ddim{steps}", device="cuda", timings=timings)
    total_s = time.perf_counter() - t0
    launches = launch_counts[flash_attn.NAME]

    res = np.load(path, allow_pickle=True).item()
    T = cfg.max_seq_length
    checks = {
        "motions_shape": list(res["motions"].shape) == [num_samples, cfg.nfeats, 1, T],
        "motions_finite": bool(np.isfinite(res["motions"]).all()),
        "keys": all(k in res for k in ("gt", "audio", "lengths", "keyframes")),
        "launches": launches == cfg.num_layers * 2 * steps,
    }
    audio_s = num_samples * T / 30.0
    emit("main_path", nvidia_smi=smi, samples=num_samples, ddim_steps=steps, guidance=2.0,
         latent=cfg.latent_dim, layers=cfg.num_layers, heads=cfg.num_heads,
         setup_s=setup_s, encode_s=timings["encode_s"], ddim_s=timings["ddim_s"],
         generate_s=total_s, audio_s=audio_s, audio_s_per_wall_s=audio_s / total_s,
         kernel_launches=launches, motions_shape=list(res["motions"].shape), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    return launches


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        raise SystemExit(f"{PKG}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)

    smi = phase_device()
    phase_build()
    summary = phase_kernels(args.seed)
    phase_slice_parity(args.seed)
    launches = phase_main_path(args.seed, smi)

    import torch

    from audio2photoreal_tpu_torch.kernels import flash_attn

    print(json.dumps({"kernels": [{
        "name": flash_attn.NAME,
        "route": "cuda",
        "source": f"{PKG}/kernels/csrc/flash_attn_fwd.cu",
        "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:124",
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
    }]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
