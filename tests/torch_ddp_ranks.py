"""Tiny steps of the port's four trainers, alone or as one rank of a
data-parallel group, for ``tests/test_torch_ddp_train.py``.

Imports torch and the port only, so the rank processes never load JAX.  Run
as a script it is one rank:

    python tests/torch_ddp_ranks.py RANK WORLD INIT_URL OUT

which joins the gloo group at ``INIT_URL`` (a ``file://`` store), runs every
case of ``CASES`` on its rows of the global batch and saves the results to
``OUT``.  The test runs the same cases in its own process without a group
(``run_case(name, None)``): the 1-process step at the global batch.

Each case builds its model and its global batch from fixed seeds and takes
two steps, each from generators seeded by the step: the diffusion step (pose,
the feature cache's audio features, the flash gate open at T 132, hash
dropout 0.1, guidance dropout 0.2, the loss-aware timestep sampler), the VQ
step (k-means in the first, the EMA and dead-code expiry in both), the
guide step (cached features, Bernoulli dropout 0.1, guidance dropout 0.2)
and the avatar step (posterior noise, the raster's coverage as the L1's
mask).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio2photoreal_tpu_torch.core.config import (DenoiserConfig, DiffusionConfig, GuideConfig,  # noqa: E402
                                                   TrainConfig, VQConfig)
from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames  # noqa: E402
from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule  # noqa: E402
from audio2photoreal_tpu_torch.diffusion.tsample import LossSecondMomentState  # noqa: E402
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser  # noqa: E402
from audio2photoreal_tpu_torch.models.guide import GuideTransformer  # noqa: E402
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec  # noqa: E402
from audio2photoreal_tpu_torch.parallel import distributed as dist  # noqa: E402
from audio2photoreal_tpu_torch.parallel.mesh import data_mesh  # noqa: E402
from audio2photoreal_tpu_torch.parallel.sharding import shard_batch  # noqa: E402
from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets  # noqa: E402
from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar, RendererConfig  # noqa: E402
from audio2photoreal_tpu_torch.train import loops  # noqa: E402
from audio2photoreal_tpu_torch.train.state import TrainState  # noqa: E402

CASES = ("diffusion", "vq", "guide", "avatar")
STEPS = 2
T = 132  # the flash gate opens at 128; the feature cache counts frames in threes
POSE = dict(data_format="pose", latent_dim=64, ff_size=128, num_layers=1, num_heads=2, max_seq_length=T,
            flash_attention=True, dropout=0.1, hash_dropout=True)
POSE_LR = 1e-4
VQ = dict(nfeats=104, emb_width=8, code_dim=16, depth=2, kmeans_iters=2)
VQ_LR = 1e-3
GUIDE = dict(tokens=16, latent_dim=64, ff_size=96, num_layers=2, num_heads=2, vq_depth=2, dropout=0.1,
             dtype="float32")
GUIDE_FRAMES = 21
GUIDE_LR = 2e-4
AVATAR = dict(uv_size=64, init_uv_size=16, upscale_size=128, n_embs=16, n_face_embs=16, n_pose_enc_channels=8,
              n_embs_enc_channels=8, n_init_channels=16, n_min_channels=4, shadow_size=32, view_unet_ftrs=4,
              encoder_in_size=64, face_tex_size=64, n_face_verts=64, image_height=48, image_width=32, n_cameras=3)
AVATAR_LR = 2e-3
BATCH = {"diffusion": 2, "vq": 4, "guide": 2, "avatar": 2}  # global rows


def _jitter_biases(model: torch.nn.Module, seed: int) -> None:
    """Nonzero biases and non-identity norms: every parameter is exercised."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1 and p.requires_grad:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))


def pose_model() -> FiLMDenoiser:
    m = FiLMDenoiser(DenoiserConfig(**POSE))
    m.reset_parameters(torch.Generator().manual_seed(0))
    _jitter_biases(m, 1)
    return m


def pose_batch(B: int = BATCH["diffusion"]):
    rng = np.random.RandomState(3)
    mask = np.ones((B, T), np.float32)
    mask[-1, 100:] = 0.0
    kv = np.ones((B, 5), np.float32)
    kv[-1, 4] = 0.0
    return {
        "motion": rng.randn(B, T, 104).astype(np.float32) * mask[..., None],
        "mask": mask,
        "lengths": np.array([T] * (B - 1) + [100], np.int64),
        "audio_features": rng.rand(B, tokens_for_frames(T), 1024).astype(np.float32),
        "keyframes": rng.randn(B, 5, 104).astype(np.float32),
        "keyframe_valid": kv,
    }


def _build(name: str):
    """-> (state, the global batch as tensors, step(state, batch, i, mesh) -> metrics, extra state)."""
    if name == "diffusion":
        state = TrainState(pose_model().train(), TrainConfig(lr=POSE_LR))
        sched, dcfg = make_schedule().to_device("cpu"), DiffusionConfig(cond_drop_prob=0.2)
        box = {"ts": LossSecondMomentState.init(sched.num_timesteps)}

        def step(state, batch, i, mesh):
            metrics, box["ts"] = loops.diffusion_train_step(
                state, sched, dcfg, batch, torch.Generator().manual_seed(100 + i),
                torch.Generator().manual_seed(200 + i), ts_state=box["ts"], mesh=mesh)
            return metrics

        return state, pose_batch(), step, box
    if name == "vq":
        m = TemporalVertexCodec(VQConfig(**VQ))
        m.reset_parameters(torch.Generator().manual_seed(0))
        state = TrainState(m.train(), TrainConfig(lr=VQ_LR))
        rng = np.random.RandomState(5)
        batch = {"keyframes": rng.randn(BATCH["vq"], 20, 104).astype(np.float32)}

        def step(state, batch, i, mesh):
            return loops.vq_train_step(state, batch, torch.Generator().manual_seed(300 + i), mesh=mesh)

        return state, batch, step, {}
    if name == "guide":
        codec = TemporalVertexCodec(VQConfig(**{**VQ, "kmeans_init": False}))
        codec.reset_parameters(torch.Generator().manual_seed(0))
        codec = codec.requires_grad_(False).eval()
        guide = GuideTransformer(GuideConfig(**GUIDE))
        guide.reset_parameters(torch.Generator().manual_seed(1))
        _jitter_biases(guide, 2)
        state = TrainState(guide.train(), TrainConfig(lr=GUIDE_LR, grad_clip=1.0))
        rng = np.random.RandomState(3)
        B = BATCH["guide"]
        batch = {"keyframes": rng.randn(B, 3, 104).astype(np.float32),
                 "keyframe_valid": np.array([[1, 1, 1]] * (B - 1) + [[1, 1, 0]], np.float32),
                 "audio_features": rng.rand(B, tokens_for_frames(GUIDE_FRAMES), 1024).astype(np.float32)}

        def step(state, batch, i, mesh):
            return loops.guide_train_step(state, codec, batch, torch.Generator().manual_seed(400 + i), mesh=mesh)

        return state, batch, step, {}
    if name == "avatar":
        cfg = RendererConfig(**AVATAR)
        assets = make_synthetic_assets(cfg)
        m = BodyAvatar(cfg, assets)
        m.reset_parameters(torch.Generator().manual_seed(0))
        state = TrainState(m.train(), TrainConfig(lr=AVATAR_LR))
        rng, B = np.random.RandomState(7), BATCH["avatar"]
        motion = (rng.randn(B, 104) * 0.1).astype(np.float32)
        offset = (0.02 * rng.randn(*assets.lbs.template_verts.shape)).astype(np.float32)
        with torch.no_grad():
            geom = assets.lbs.pose(torch.from_numpy(offset), torch.from_numpy(motion)).numpy()
        K = np.array([[40.0, 0, 16], [0, 40.0, 24], [0, 0, 1]], np.float32)
        Rt = np.array([[1, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32)
        batch = {"motion": motion, "geom": geom, "face_embs": rng.randn(B, 16).astype(np.float32),
                 "ao": rng.rand(B, 1, 32, 32).astype(np.float32),
                 "campos": np.tile(np.array([0.0, -3.0, 1.0], np.float32), (B, 1)),
                 "K": np.tile(K, (B, 1, 1)), "Rt": np.tile(Rt, (B, 1, 1)),
                 "image": (rng.rand(B, 48, 32, 3) * 100).astype(np.float32),
                 "cam_idx": np.array([0, 2] * (B // 2), np.int64)}

        def step(state, batch, i, mesh):
            return loops.avatar_train_step(state, batch, torch.Generator().manual_seed(500 + i), mesh=mesh)

        return state, batch, step, {}
    raise ValueError(name)


def run_case(name: str, mesh, steps: int = STEPS) -> dict:
    """``steps`` steps of case ``name`` on the global batch (``mesh`` None)
    or on ``mesh``'s rows of it -> {metrics: one dict a step, grads: the
    (summed) gradients of the first step, state: the parameters and buffers
    after the last, ts: the timestep sampler's history}."""
    state, batch, step, extra = _build(name)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    metrics, grads = [], None
    for i in range(steps):
        metrics.append(step(state, batch, i, mesh))
        if grads is None:
            grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters() if p.grad is not None}
    out = {"metrics": metrics, "grads": grads,
           "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()}}
    if "ts" in extra:
        out["ts"] = extra["ts"].history.clone()
    return out


def main(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.initialize(init, world, rank, backend="gloo")
    results = {}
    for name in CASES:
        results[name] = run_case(name, data_mesh(BATCH[name], "cpu"))
    dist.barrier()
    torch.save(results, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
