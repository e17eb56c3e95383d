"""VQ-VAE trainer CLI.

Counterpart of ``audio2photoreal_tpu/apps/train_vq.py`` (reference:
train/train_vq.py): the 1 fps keyframes of the train split's random windows
-> the codec with EMA codebooks (k-means init in the first step, dead-code
expiry, the EMA), SmoothL1 reconstruction + commitment + velocity; every
``save_interval`` steps the val split's reconstruction and perplexity, the
best of them kept in ``ckpt_best/``, and a checkpoint.

The save dir holds ``config.json`` (``vq``, ``data``, ``train``) and
``model.pt``: a VQ directory that ``generate --resume_vq`` and
``apps/train_guide.py`` read.  ``ckpt/step_N.pt`` keeps the train state
(the codebooks and their ``inited`` flags among the model's buffers, so a
resumed run runs no k-means) and the best validation loss.  Batches come
from ``data/loader.py:make_train_iterator``; each step's draws (the batch's
windows, the codebooks' k-means and replacement rows) from generators
seeded by (``--seed``, step).  Runs on the card unless ``device`` says
otherwise; without a card and without ``device`` it raises.  The loader
reads no audio: the codec sees the keyframes only (the JAX trainer's batches
carry the windows' audio too).  The JAX CLI's ``--rng_impl`` and distributed
flags are not ported (ROADMAP queue 1, items 6-7).
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.apps.generate import CKPT_DIR, find_stats
from audio2photoreal_tpu_torch.core.config import DataConfig, TrainConfig, VQConfig, save_config
from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
from audio2photoreal_tpu_torch.data.loader import make_train_iterator, step_seed
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
from audio2photoreal_tpu_torch.train import checkpoints
from audio2photoreal_tpu_torch.train.logging import KVLogger
from audio2photoreal_tpu_torch.train.loops import huber, vq_train_step
from audio2photoreal_tpu_torch.train.state import TrainState

BEST_DIR = "ckpt_best"  # config.json + model.pt of the best validation reconstruction
EVAL_CHUNKS = 16


@torch.no_grad()
def evaluate(model: TemporalVertexCodec, val_ds: SocialDataset) -> dict:
    """Val reconstruction (SmoothL1) and perplexity, each the mean over the
    first ``EVAL_CHUNKS`` chunks of the val split, one chunk at a time
    (reference: train_vq.py:216-271); the model runs in eval mode and is
    handed back in the mode it came in."""
    n = min(len(val_ds), EVAL_CHUNKS)
    if n == 0:
        raise ValueError(f"the val split has no chunk of {val_ds.Tmax} frames to evaluate on")
    device, was_training = next(model.parameters()).device, model.training
    model.eval()
    recons, ppls = [], []
    for i in range(n):
        kf = torch.from_numpy(val_ds.get_chunk(i)["keyframes"])[None].to(device)
        out = model(kf)
        recons.append(huber(out.recon, kf))
        ppls.append(out.perplexity)
    model.train(was_training)
    recon, ppl = torch.stack(recons).cpu().numpy(), torch.stack(ppls).cpu().numpy()
    return {"val_recon": float(np.mean(recon)), "val_ppl": float(np.mean(ppl))}


def train(
    data_root: str,
    save_dir: str,
    vcfg: VQConfig,
    datacfg: DataConfig,
    tcfg: TrainConfig,
    device: Optional[str] = None,
    timings: Optional[dict] = None,
    reader: str = "auto",
) -> TrainState:
    """Train ``tcfg.num_steps`` steps (resuming from ``save_dir/ckpt``) and
    return the state.  ``timings``, when given, receives each step's wall
    seconds under ``step_s`` (a step ends in a read-back, so each is
    complete) and each evaluation's under ``eval_s``."""
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    os.makedirs(save_dir, exist_ok=True)
    save_config(save_dir, vq=vcfg, data=datacfg, train=tcfg)

    stats = find_stats(os.path.join(data_root, datacfg.person))
    val_ds = SocialDataset(load_local_data(data_root, datacfg.person), stats, datacfg, "val")
    model = TemporalVertexCodec(vcfg)
    model.reset_parameters(torch.Generator().manual_seed(tcfg.seed))
    model.to(dev).train()
    state = TrainState(model, tcfg)
    ckpt_dir = os.path.join(save_dir, CKPT_DIR)
    last, extra = checkpoints.try_resume(ckpt_dir, state)
    best = float(extra.get("best", math.inf))
    if last is not None:
        print(f"resumed from step {last}", flush=True)

    def keyframes(b):  # in the worker
        kf = torch.from_numpy(np.asarray(b["keyframes"]))
        return kf.pin_memory() if dev.type == "cuda" else kf

    batches, _ = make_train_iterator(data_root, stats, datacfg, seed=tcfg.seed, start_step=state.step,
                                     num_steps=tcfg.num_steps, reader=reader, transform=keyframes, audio=False)

    def save(step: int) -> None:
        checkpoints.save_train_state(ckpt_dir, step, state, extra={"best": best})
        checkpoints.save_model(save_dir, model)

    logger = KVLogger(save_dir)
    try:
        for i in range(state.step, tcfg.num_steps):
            t0 = time.perf_counter()
            batch = {"keyframes": next(batches).to(dev, non_blocking=True)}
            metrics = vq_train_step(state, batch, torch.Generator(device=dev).manual_seed(step_seed(tcfg.seed, i)),
                                    vcfg.commit_weight)
            timings.setdefault("step_s", []).append(time.perf_counter() - t0)
            if i % tcfg.log_interval == 0:
                logger.log(i, metrics)
            if (i + 1) % tcfg.save_interval == 0:
                t0 = time.perf_counter()
                val = evaluate(model, val_ds)
                timings.setdefault("eval_s", []).append(time.perf_counter() - t0)
                logger.log(i, val)
                if val["val_recon"] < best:
                    best = val["val_recon"]
                    best_dir = os.path.join(save_dir, BEST_DIR)
                    save_config(best_dir, vq=vcfg, data=datacfg, train=tcfg)
                    checkpoints.save_model(best_dir, model)
                save(i + 1)
        save(tcfg.num_steps)
    finally:
        batches.close()
        logger.close()
    return state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--person", default="PXB184")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--total_iter", type=int, default=300_000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--code_dim", type=int, default=1024)
    p.add_argument("--output_emb_width", type=int, default=64)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--save_interval", type=int, default=10_000)
    p.add_argument("--device", default=None, help="torch device (default: cuda; raises without one)")
    args = p.parse_args()

    vcfg = VQConfig(nfeats=104, emb_width=args.output_emb_width, code_dim=args.code_dim, depth=args.depth)
    datacfg = DataConfig(person=args.person, data_format="pose", batch_size=args.batch_size)
    tcfg = TrainConfig(save_dir=args.save_dir, lr=args.lr, num_steps=args.total_iter,
                       save_interval=args.save_interval, warmup_steps=1000)
    train(args.data_root, args.save_dir, vcfg, datacfg, tcfg, device=args.device)


if __name__ == "__main__":
    main()
