"""Guide-transformer trainer CLI.

Counterpart of ``audio2photoreal_tpu/apps/train_guide.py`` (reference:
train/train_guide.py): a frozen VQ codec (a directory of
``apps/train_vq.py``, ``--resume_pth``) tokenises the 1 fps keyframes of the
train split's random windows, and the guide LM learns them by teacher
forcing with label-smoothed cross-entropy, its conditioning dropped for
20% of the clips.  The vocabulary and the tokens a keyframe come from the
VQ's config (``tokens = code_dim``, ``vq_depth = depth``).

With ``cache_audio_features`` the frozen wav2vec frontend runs once over
the train split before the first step (``data/feature_cache.py``) and
batches carry its features in place of raw audio.  The save dir holds
``config.json`` (``guide``, ``data``, ``train``) and ``model.pt``: a
directory that ``generate --resume_trans`` samples; ``ckpt/step_N.pt``
keeps the train state.  Each step's draws (the batch's windows, the
conditioning dropout, the dropout sites' seeds) come from generators seeded
by (``--seed``, step).  Runs on the card unless ``device`` says otherwise;
without a card and without ``device`` it raises.  The JAX CLI's
``--rng_impl`` is not ported (ROADMAP queue 1).

On N processes (the JAX CLI's distributed flags, ``parallel/distributed.py``)
each process loads its ``batch_size / N`` rows of every batch from its
process-folded seed, builds its own feature cache in memory, and the steps
compute the global batch's step (``train/loops.py``); only process 0 writes
the config, the checkpoints, ``model.pt`` and the log.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.apps.generate import CKPT_DIR, MODEL_FILE, find_stats
from audio2photoreal_tpu_torch.core.config import DataConfig, GuideConfig, TrainConfig, load_config, save_config
from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.data.feature_cache import build_cache_for_index, make_frontend_apply
from audio2photoreal_tpu_torch.data.loader import SceneIndex, make_train_iterator, step_seed
from audio2photoreal_tpu_torch.models.guide import GuideTransformer
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
from audio2photoreal_tpu_torch.parallel import distributed as dist
from audio2photoreal_tpu_torch.parallel.mesh import data_mesh
from audio2photoreal_tpu_torch.parallel.sharding import replicated
from audio2photoreal_tpu_torch.train import checkpoints
from audio2photoreal_tpu_torch.train.logging import KVLogger
from audio2photoreal_tpu_torch.train.loops import guide_train_step
from audio2photoreal_tpu_torch.train.state import TrainState

BATCH_KEYS = ("keyframes", "keyframe_valid", "audio", "audio_features")


def load_tokenizer(vq_dir: str, device) -> TemporalVertexCodec:
    """The frozen codec of a VQ directory (``config.json`` + ``model.pt``),
    in eval mode on ``device`` (reference setup_tokenizer,
    model/vqvae.py:18-34)."""
    codec = TemporalVertexCodec(load_config(vq_dir)["vq"])
    codec.load_state_dict(torch.load(os.path.join(vq_dir, MODEL_FILE), map_location="cpu", weights_only=True),
                          strict=True)
    return codec.requires_grad_(False).to(device).eval()


def train(
    data_root: str,
    save_dir: str,
    vq_dir: str,
    gcfg: GuideConfig,
    datacfg: DataConfig,
    tcfg: TrainConfig,
    cache_audio_features: bool = False,
    device: Optional[str] = None,
    timings: Optional[dict] = None,
    reader: str = "auto",
) -> TrainState:
    """Train ``tcfg.num_steps`` steps (resuming from ``save_dir/ckpt``) and
    return the state.  ``timings``, when given, receives each step's wall
    seconds under ``step_s`` and the feature cache's build under
    ``cache_s``.  In a process group ``datacfg.batch_size`` is the global
    batch, and ``device`` defaults to this process's card."""
    dev = resolve_device(device) if device is not None else dist.local_device()
    mesh = data_mesh(datacfg.batch_size, dev)
    coord = dist.is_coordinator()  # only process 0 writes
    timings = {} if timings is None else timings
    codec = load_tokenizer(vq_dir, dev)
    gcfg = dataclasses.replace(gcfg, tokens=codec.cfg.code_dim, vq_depth=codec.cfg.depth)
    if coord:
        os.makedirs(save_dir, exist_ok=True)
        save_config(save_dir, guide=gcfg, data=datacfg, train=tcfg)

    stats = find_stats(os.path.join(data_root, datacfg.person))
    model = GuideTransformer(gcfg)
    model.reset_parameters(torch.Generator().manual_seed(tcfg.seed))
    model.to(dev).train()
    state = TrainState(model, tcfg)
    ckpt_dir = os.path.join(save_dir, CKPT_DIR)
    last, _ = checkpoints.try_resume(ckpt_dir, state)
    if last is not None:
        print(f"resumed from step {last}", flush=True)
    replicated(model)

    feature_cache = None
    if cache_audio_features:
        # the frozen frontend once over the train split, from the resumed weights
        t0 = time.perf_counter()
        index = SceneIndex(data_root, datacfg.person, "train", datacfg.num_val_seqs, datacfg.num_test_seqs)
        feature_cache = build_cache_for_index(index, stats.norm_audio, make_frontend_apply(model.audio_model))
        timings["cache_s"] = time.perf_counter() - t0

    pin = dev.type == "cuda"

    def to_tensors(b):  # in the worker
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items() if k in BATCH_KEYS}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out

    local = dataclasses.replace(datacfg, batch_size=dist.local_batch_size(datacfg.batch_size))
    batches, _ = make_train_iterator(data_root, stats, local, seed=dist.per_process_seed(tcfg.seed),
                                     start_step=state.step, num_steps=tcfg.num_steps, feature_cache=feature_cache,
                                     reader=reader, transform=to_tensors)

    def save(step: int) -> None:
        if coord:
            checkpoints.save_train_state(ckpt_dir, step, state)
            checkpoints.save_model(save_dir, model)

    logger = KVLogger(save_dir, tensorboard=True) if coord else None
    try:
        for i in range(state.step, tcfg.num_steps):
            t0 = time.perf_counter()
            batch = dist.shard_batch_global(mesh, next(batches))
            metrics = guide_train_step(state, codec, batch, torch.Generator().manual_seed(step_seed(tcfg.seed, i)),
                                       mesh=mesh)
            timings.setdefault("step_s", []).append(time.perf_counter() - t0)
            if i % tcfg.log_interval == 0 and logger is not None:
                logger.log(i, metrics)
            if (i + 1) % tcfg.save_interval == 0:
                save(i + 1)
        save(tcfg.num_steps)
        dist.barrier()  # the run is saved when train() returns on any process
    finally:
        batches.close()
        if logger is not None:
            logger.close()
    return state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--resume_pth", required=True, help="VQ checkpoint dir (config.json + model.pt)")
    p.add_argument("--person", default="PXB184")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--max_seq_length", type=int, default=240)
    p.add_argument("--save_interval", type=int, default=10_000)
    p.add_argument("--frontend_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="frozen wav2vec frontend dtype (and the feature cache's)")
    p.add_argument("--cache_audio_features", action="store_true",
                   help="run the frozen wav2vec frontend once over the train split and train on windows of "
                        "its features (data/feature_cache.py)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:{LOCAL_RANK}; raises without that card)")
    dist.add_distributed_args(p)
    args = p.parse_args()
    dist.initialize_from_args(args)  # before any device query

    gcfg = GuideConfig(latent_dim=args.dim, num_layers=args.layers, frontend_dtype=args.frontend_dtype)
    datacfg = DataConfig(person=args.person, data_format="pose", batch_size=args.batch_size,
                         max_seq_length=args.max_seq_length, min_seq_length=args.max_seq_length)
    tcfg = TrainConfig(save_dir=args.save_dir, lr=args.lr, num_steps=args.num_steps,
                       save_interval=args.save_interval, grad_clip=1.0, warmup_steps=1000)
    train(args.data_root, args.save_dir, args.resume_pth, gcfg, datacfg, tcfg,
          cache_audio_features=args.cache_audio_features, device=args.device)


if __name__ == "__main__":
    main()
