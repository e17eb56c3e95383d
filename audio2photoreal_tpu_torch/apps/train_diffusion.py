"""Diffusion trainer CLI, pose and face.

Counterpart of ``audio2photoreal_tpu/apps/train_diffusion.py`` (reference:
train/train_diffusion.py + train/training_loop.py): configs -> the
``config.json`` sidecar, data -> model -> train steps -> checkpoints, the
log, and ``model.pt`` beside ``config.json`` so the save dir is a checkpoint
that ``apps/generate.py`` samples from.

Batches come from ``data/loader.py:make_train_iterator``: windowed native
reads (``FastLoader``), assembled in a worker thread a few steps ahead of
the loop.  With ``cache_audio_features`` the frozen frontends (wav2vec, and
for face the lip regressor) run once over the train split before the first
step, from the weights as resumed (``data/feature_cache.py``), and batches
carry their windows in place of raw audio.  Each step's draws (batch
windows, t, noise, guidance and dropout masks) come from generators seeded
by (``--seed``, step index), so a resumed run takes the same steps as an
uninterrupted one.  Runs on the card unless ``device`` says otherwise;
without a card and without ``device`` it raises.  ``--dtype bfloat16`` trains
with the JAX package's mixed precision (f32 parameters and AdamW state, bf16
compute, f32 output and loss) and ``--frontend_dtype bfloat16`` runs the
frozen frontend, and the feature cache's build, on bf16 convs.  Gradient
checkpointing and the TensorBoard / ClearML reporters raise.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.apps.generate import CKPT_DIR, find_stats
from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, TrainConfig, save_config
from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.data.feature_cache import build_cache_for_index, make_frontend_apply, make_lip_apply
from audio2photoreal_tpu_torch.data.loader import SceneIndex, make_train_iterator, step_seed
from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
from audio2photoreal_tpu_torch.diffusion.tsample import LossSecondMomentState
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.train import checkpoints
from audio2photoreal_tpu_torch.train.logging import PLATFORMS, KVLogger, TrainPlatform, create_platform
from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
from audio2photoreal_tpu_torch.train.state import TrainState


def train(
    data_root: str,
    save_dir: str,
    mcfg: DenoiserConfig,
    dcfg: DiffusionConfig,
    datacfg: DataConfig,
    tcfg: TrainConfig,
    cache_audio_features: bool = False,
    platform: Optional[TrainPlatform] = None,
    device: Optional[str] = None,
    timings: Optional[dict] = None,
    reader: str = "auto",
) -> TrainState:
    """Train ``tcfg.num_steps`` steps (resuming from ``save_dir/ckpt``) and
    return the state.  ``reader`` is the loader's (``data/loader.py``:
    "auto", "fastdata" or "numpy").  ``timings``, when given, receives each
    step's wall seconds under ``step_s`` (a step ends in a read-back from the
    device, so each is complete); under ``batch_s`` the part of it spent
    waiting for the batch plus the copy to the device (on the card the
    copy is enqueued without blocking and timed by CUDA events around it,
    so it counts even while it overlaps the host's work); under ``cache_s``
    the feature cache's build and under ``cache_mb`` its host size; under
    ``reader`` the reads the loader ran
    ("fastdata" or "numpy")."""
    if mcfg.remat:
        raise NotImplementedError("gradient checkpointing (remat) is not ported: see ROADMAP")
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    os.makedirs(save_dir, exist_ok=True)
    save_config(save_dir, denoiser=mcfg, diffusion=dcfg, data=datacfg, train=tcfg)
    if platform is not None:
        platform.report_args(tcfg, name="train_args")

    stats = find_stats(os.path.join(data_root, datacfg.person))
    model = FiLMDenoiser(mcfg)
    model.reset_parameters(torch.Generator().manual_seed(tcfg.seed))
    model.to(dev).train()
    print(f"model params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M", flush=True)
    sched = make_schedule(dcfg.schedule, dcfg.steps).to_device(dev)
    state = TrainState(model, tcfg)
    ts_state = None
    if tcfg.schedule_sampler == "loss_second_moment":
        ts_state = LossSecondMomentState.init(sched.num_timesteps)
    elif tcfg.schedule_sampler != "uniform":
        raise ValueError(f"unknown schedule_sampler {tcfg.schedule_sampler!r}")

    ckpt_dir = os.path.join(save_dir, CKPT_DIR)
    last, _ = checkpoints.try_resume(ckpt_dir, state)
    if last is not None:
        print(f"resumed from step {last}", flush=True)

    feature_cache = None
    if cache_audio_features:
        # the frozen frontends once over the train split, from the resumed weights
        t0 = time.perf_counter()
        index = SceneIndex(data_root, datacfg.person, "train", datacfg.num_val_seqs, datacfg.num_test_seqs)
        lip_apply = make_lip_apply(model.lip_model) if mcfg.data_format == "face" else None
        feature_cache = build_cache_for_index(index, stats.norm_audio, make_frontend_apply(model.audio_model),
                                              lip_apply)
        timings["cache_s"] = time.perf_counter() - t0
        timings["cache_mb"] = feature_cache.nbytes() / 1e6

    pin = dev.type == "cuda"

    def to_tensors(b):  # in the worker: pinned host memory, so the copy below does not block
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out

    batches, loader = make_train_iterator(data_root, stats, datacfg, seed=tcfg.seed, start_step=state.step,
                                          num_steps=tcfg.num_steps, feature_cache=feature_cache, reader=reader,
                                          transform=to_tensors)
    timings["reader"] = loader.reader

    def save(step: int) -> None:
        checkpoints.save_train_state(ckpt_dir, step, state)
        checkpoints.save_model(save_dir, model)

    logger = KVLogger(save_dir)
    try:
        for i in range(state.step, tcfg.num_steps):
            t0 = time.perf_counter()
            host = next(batches)
            if pin:  # the copy is enqueued without blocking: CUDA events time it on the card
                copy = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                copy[0].record()
            batch = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            wait_s = time.perf_counter() - t0
            if pin:
                copy[1].record()
            s = step_seed(tcfg.seed, i)
            metrics, ts_state = diffusion_train_step(
                state, sched, dcfg, batch, torch.Generator().manual_seed(s),
                torch.Generator(device=dev).manual_seed(s), ts_state=ts_state)
            # the step ends in a read-back, so the copy's events have completed
            copy_s = copy[0].elapsed_time(copy[1]) / 1e3 if pin else 0.0
            timings.setdefault("batch_s", []).append(wait_s + copy_s)
            timings.setdefault("step_s", []).append(time.perf_counter() - t0)
            if i % tcfg.log_interval == 0:
                kv = {k: v for k, v in metrics.items() if np.isfinite(v)}
                logger.log(i, kv)
                if platform is not None:
                    for k, v in kv.items():
                        platform.report_scalar(k, v, i, group_name="train")
            if (i + 1) % tcfg.save_interval == 0:
                save(i + 1)
        save(tcfg.num_steps)
    finally:
        batches.close()
        logger.close()
        if platform is not None:
            platform.close()
    return state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--person", default="PXB184")
    p.add_argument("--data_format", choices=["pose", "face"], default="pose")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=800_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--latent_dim", type=int, default=None)
    p.add_argument("--lambda_vel", type=float, default=0.0)
    p.add_argument("--max_seq_length", type=int, default=600)
    p.add_argument("--save_interval", type=int, default=5000)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--flash_attention", action="store_true",
                   help="attention through the CUDA kernels (kernels/flash_attn.py), with the "
                        "probability dropout replayed inside them")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="denoiser compute dtype: bfloat16 computes in bf16 with f32 parameters, optimizer "
                        "state and loss (core/dtypes.py)")
    p.add_argument("--frontend_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="frozen wav2vec frontend dtype (and the feature cache's); generate runs it in "
                        "float32 whatever the config says")
    p.add_argument("--remat", action="store_true",
                   help="gradient-checkpoint the decoder layers (not ported yet; raises)")
    p.add_argument("--hash_dropout", action="store_true",
                   help="position-hash dropout masks (models/blocks.py:hash_drop_mult) instead of "
                        "Bernoulli draws: the same law, deterministic in (seed, position)")
    p.add_argument("--cache_audio_features", action="store_true",
                   help="run the frozen frontends once over the train split and train on windows of "
                        "their features (data/feature_cache.py)")
    p.add_argument("--reader", choices=["auto", "fastdata", "numpy"], default="auto",
                   help="the loader's reads: the fastdata C extension (built at first use into "
                        "build/torch_host/), numpy, or fastdata when it builds")
    p.add_argument("--schedule_sampler", default="uniform", choices=["uniform", "loss_second_moment"])
    p.add_argument("--train_platform_type", default="NoPlatform", choices=list(PLATFORMS))
    p.add_argument("--device", default=None, help="torch device (default: cuda; raises without one)")
    args = p.parse_args()

    nfeats = 104 if args.data_format == "pose" else 256
    latent = args.latent_dim or (256 if args.data_format == "pose" else 512)
    mcfg = DenoiserConfig(
        data_format=args.data_format, nfeats=nfeats, latent_dim=latent, num_layers=args.layers,
        num_heads=args.heads, max_seq_length=args.max_seq_length, dtype=args.dtype,
        flash_attention=args.flash_attention, frontend_dtype=args.frontend_dtype,
        hash_dropout=args.hash_dropout, remat=args.remat,
    )
    dcfg = DiffusionConfig(lambda_vel=args.lambda_vel)
    datacfg = DataConfig(person=args.person, data_format=args.data_format, batch_size=args.batch_size,
                         max_seq_length=args.max_seq_length)
    tcfg = TrainConfig(save_dir=args.save_dir, lr=args.lr, num_steps=args.num_steps,
                       save_interval=args.save_interval, log_interval=args.log_interval, seed=args.seed,
                       schedule_sampler=args.schedule_sampler)
    train(args.data_root, args.save_dir, mcfg, dcfg, datacfg, tcfg,
          cache_audio_features=args.cache_audio_features,
          platform=create_platform(args.train_platform_type, args.save_dir), device=args.device,
          reader=args.reader)


if __name__ == "__main__":
    main()
