"""Fine-tune the codec avatar (BodyAvatar) on a renderer bundle.

Counterpart of ``audio2photoreal_tpu/apps/train_avatar.py`` (the role of the
reference's config-driven loop, visualize/ca_body/utils/train.py:152-222):
the training forward with the GT-AO shadow, the pose-shadow distillation and
the per-camera calibration (mesh_vae_drivable.py:322-371), optimised by
``train/loops.py:avatar_train_step`` with AdamW.

Data: a directory of ``.npz`` frame batches, the JAX trainer's contract:
    motion [B, 104]  geom [B, V, 3]  face_embs [B, Nf]  ao [B, S, S, 1]
    campos [B, 3]  K [B, 3, 3]  Rt [B, 3, 4]  image [B, H, W, 3]
    image_mask [B, H, W, 1] (optional)  cam_idx [B] int
step i reads the (i mod n)-th file in name order; ``ao`` goes to the card
as [B, 1, S, S].

The bundle (``render/assets.py``) must say ``n_cameras > 0`` in its
``renderer.json``.  A first run takes the inference weights from its
``model.pt`` and starts the calibration at identity; a bundle's
``static_assets.pt`` is preferred over synthetic assets.  Every
``save_interval`` steps and at the last, the whole train state goes to
``ckpt/step_N.pt`` (a later run resumes from the newest) and ``model.pt``
is rewritten with the trained weights, the calibration among them, so
``apps/render_pipeline.py:load_body_renderer`` renders the trained avatar.
Each step's posterior noise comes from a generator on the card seeded by
(``seed``, step).  Runs on the card unless ``device`` says otherwise.

On N processes (the JAX CLI's distributed flags, ``parallel/distributed.py``)
each process reads its own contiguous slice of the frame files
(``slice_for_process``), a step's global batch is the N files' frames
together, and the steps compute the global batch's step
(``train/loops.py``); only process 0 writes the checkpoints, ``model.pt``
and the log.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.apps.generate import CKPT_DIR
from audio2photoreal_tpu_torch.core.config import TrainConfig
from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.data.loader import step_seed
from audio2photoreal_tpu_torch.parallel import distributed as dist
from audio2photoreal_tpu_torch.parallel.mesh import local_mesh
from audio2photoreal_tpu_torch.parallel.sharding import replicated
from audio2photoreal_tpu_torch.render.assets import load_bundle_parts
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar
from audio2photoreal_tpu_torch.train import checkpoints
from audio2photoreal_tpu_torch.train.logging import KVLogger
from audio2photoreal_tpu_torch.train.loops import avatar_train_step
from audio2photoreal_tpu_torch.train.state import TrainState

LOG_DIR = "train_log"
LOG_INTERVAL = 50


def load_frame_batch(path: str, device) -> Dict[str, torch.Tensor]:
    """One ``.npz`` frame batch → tensors on ``device`` in the port's layout."""
    with np.load(path) as z:
        batch = {k: torch.from_numpy(np.asarray(z[k])) for k in z.files}
    batch["ao"] = batch["ao"].permute(0, 3, 1, 2)  # [B, S, S, 1] → [B, 1, S, S]
    batch["cam_idx"] = batch["cam_idx"].long()
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _load_inference_weights(model: BodyAvatar, state_dict) -> None:
    """The bundle's weights into ``model``; only the calibration may be
    missing (it then stays as initialised)."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    fresh = [k for k in missing if k.split(".")[0] not in BodyAvatar.CALIBRATION]
    if fresh or unexpected:
        raise RuntimeError(f"the bundle's model.pt does not fit the avatar: missing {fresh}, "
                           f"unexpected {unexpected}")


def train(
    renderer_dir: str,
    data_dir: str,
    num_steps: int = 1000,
    lr: float = 1e-3,
    save_interval: int = 500,
    kl_weight: float = 1e-3,
    seed: int = 0,
    device: Optional[str] = None,
    timings: Optional[dict] = None,
) -> TrainState:
    """Train up to step ``num_steps`` (resuming from ``ckpt/``) and return
    the state.  ``timings``, when given, receives each step's wall seconds
    under ``step_s`` (a step ends in a read-back).  In a process group
    ``device`` defaults to this process's card."""
    dev = resolve_device(device) if device is not None else dist.local_device()
    mesh = local_mesh(dev)
    coord = dist.is_coordinator()  # only process 0 writes
    timings = {} if timings is None else timings
    cfg, assets, sd, _ = load_bundle_parts(renderer_dir)
    if cfg.n_cameras <= 0:
        raise SystemExit("renderer.json has n_cameras=0 (an inference-only config): set it to the capture's "
                         "camera count to build the calibration modules")
    files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not files:
        raise SystemExit(f"no .npz frame batches under {data_dir}")
    files = files[dist.slice_for_process(len(files))] or files  # this process's frame files
    model = BodyAvatar(cfg, assets)  # the calibration's constructors start it at identity
    _load_inference_weights(model, sd)
    model.to(dev).train()
    state = TrainState(model, TrainConfig(lr=lr))
    ckpt_dir = os.path.join(renderer_dir, CKPT_DIR)
    last, _ = checkpoints.try_resume(ckpt_dir, state)
    if last is not None:
        print(f"resumed avatar training from step {last}", flush=True)
    replicated(model)
    logger = KVLogger(os.path.join(renderer_dir, LOG_DIR)) if coord else None
    try:
        for i in range(state.step, num_steps):
            t0 = time.perf_counter()
            batch = load_frame_batch(files[i % len(files)], dev)
            generator = torch.Generator(device=dev).manual_seed(step_seed(seed, state.step))
            metrics = avatar_train_step(state, batch, generator, kl_weight=kl_weight, mesh=mesh)
            timings.setdefault("step_s", []).append(time.perf_counter() - t0)
            if (i % LOG_INTERVAL == 0 or i == num_steps - 1) and logger is not None:
                logger.log(i, metrics)
            if ((i + 1) % save_interval == 0 or i == num_steps - 1) and coord:
                checkpoints.save_train_state(ckpt_dir, i + 1, state)
                checkpoints.save_model(renderer_dir, model)
        dist.barrier()  # the run is saved when train() returns on any process
    finally:
        if logger is not None:
            logger.close()
    return state


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--renderer_dir", required=True, help="renderer bundle dir (render/assets.py layout)")
    p.add_argument("--data_dir", required=True, help="dir of .npz frame batches")
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--save_interval", type=int, default=500)
    p.add_argument("--kl_weight", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:{LOCAL_RANK}; raises without that card)")
    dist.add_distributed_args(p)
    args = p.parse_args()
    dist.initialize_from_args(args)  # before any device query
    train(args.renderer_dir, args.data_dir, args.num_steps, args.lr, args.save_interval, args.kl_weight,
          args.seed, device=args.device)


if __name__ == "__main__":
    main()
