#!/usr/bin/env python3
"""Time the port's pose generate path on one CUDA card.

    python3 tools/torch_generate_time.py [--root CHECKOUT] [--steps 500] [--seed 0]

Imports ``audio2photoreal_tpu_torch`` from ``--root`` (default: the checkout
this file sits in), makes a synthetic person and a full-width random pose
model with flash attention (as chip_smoke.py's main path does), and times
``generate`` at DDIM-``steps``, CFG 2.0, 2 samples; prints one JSON line with
the card, its power limit, ``encode_s``, ``ddim_s`` and ``generate_s``.  To
compare two trees on one card, run it with each ``--root`` in turns (A B B A)
in one call.  Work files go to ``build/generate_time/`` under this checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE, help="checkout whose audio2photoreal_tpu_torch is timed")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    import audio2photoreal_tpu_torch

    if not audio2photoreal_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {audio2photoreal_tpu_torch.__file__}, not the package under {root}")
    work = os.path.join(HERE, "build", "generate_time")
    shutil.rmtree(work, ignore_errors=True)
    make_synthetic_person(work, "SYNTH01", num_scenes=8, frames_per_scene=600, seed=args.seed)
    cfg = DenoiserConfig(data_format="pose", flash_attention=True)
    model = FiLMDenoiser(cfg)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model_dir = os.path.join(work, "pose_model")
    save_config(model_dir, denoiser=cfg, diffusion=DiffusionConfig(),
                data=DataConfig(person="SYNTH01", max_seq_length=cfg.max_seq_length))
    torch.save(model.state_dict(), os.path.join(model_dir, MODEL_FILE))
    timings: dict = {}
    t0 = time.perf_counter()
    generate(model_dir, work, num_samples=2, guidance_param=2.0, timestep_respacing=f"ddim{args.steps}",
             device="cuda", timings=timings)
    total = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "nvidia_smi": smi, "ddim_steps": args.steps, "generate_s": total,
                      "audio_s_per_wall_s": 2 * cfg.max_seq_length / 30.0 / total, **timings}), flush=True)


if __name__ == "__main__":
    main()
