"""Batch inference CLI: the pose and face generate paths.

Counterpart of ``audio2photoreal_tpu/apps/generate.py:generate`` (reference:
sample/generate.py): re-hydrate the configs from the checkpoint's
``config.json``, take the test-split chunks, encode the conditioning once,
run DDIM with cached classifier-free guidance, inverse-normalise, and save
``results.npy`` in the reference layout {motions, gt, audio, lengths} plus,
for a pose model, {keyframes}, motions as [B, C, 1, T]
(sample/generate.py:146-152).

A checkpoint directory holds ``config.json`` (the JAX package's sidecar
format) and ``model.pt``, a ``state_dict`` under the reference's names.

A pose model takes its 1 fps keyframes from the guide LM when given a guide
and a VQ checkpoint (``--resume_trans`` / ``--resume_vq``, each a directory
with ``config.json`` + ``model.pt``): ``GuideKeyframer`` samples
keyframes x depth tokens by nucleus sampling (``--top_p``) and decodes them
through the frozen residual VQ, and every keyframe counts as valid.  Without
them it takes the dataset's ground-truth keyframes.  A face model takes none
and its codes are inverse-normalised with the code statistics.  ``--plot``
renders each pose sample with the photoreal renderer (``--renderer_path``, a
bundle of ``render/assets.py``) and the face codes of a face model's
``results.npy`` (``--face_codes``) made from the same audio.

Everything runs on the card unless ``device`` says otherwise; without a
card and without ``device`` it raises.

x_T is drawn from a ``torch.Generator`` seeded with ``seed`` and the guide's
Gumbel noise from one seeded with ``seed + 1``, so for the same seed both
differ from the JAX package's ``jax.random`` draws.  ``use_ema`` samples from
the EMA of the parameters that the trainer keeps in its latest checkpoint
(``ckpt/step_N.pt``); without one it warns and takes ``model.pt``'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.core.config import (
    DataConfig,
    DenoiserConfig,
    DiffusionConfig,
    GuideConfig,
    VQConfig,
    load_config,
)
from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
from audio2photoreal_tpu_torch.data.stats import DataStats
from audio2photoreal_tpu_torch.diffusion import sampling
from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached
from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
from audio2photoreal_tpu_torch.models.guide import GuideTransformer
from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
from audio2photoreal_tpu_torch.train import checkpoints

MODEL_FILE = "model.pt"
CKPT_DIR = "ckpt"  # where apps/train_diffusion.py keeps its train states, the EMA among them


def find_stats(person_dir: str) -> DataStats:
    for name in ("data_stats.npz", "data_stats.pth"):
        p = os.path.join(person_dir, name)
        if os.path.exists(p):
            return DataStats.load(p)
    raise FileNotFoundError(f"no data stats under {person_dir}")


def _state_dict(path: str) -> dict:
    return torch.load(os.path.join(path, MODEL_FILE), map_location="cpu", weights_only=True)


def _ema_params(model_path: str) -> Optional[dict]:
    """The EMA of the parameters in the trainer's latest checkpoint, or None."""
    ckpt_dir = os.path.join(model_path, CKPT_DIR)
    last = checkpoints.latest_step(ckpt_dir)
    if last is None:
        return None
    return torch.load(checkpoints.checkpoint_path(ckpt_dir, last), map_location="cpu", weights_only=True).get("ema")


def load_model(model_path: str, device, use_ema: bool = False) -> FiLMDenoiser:
    """``config.json`` + ``model.pt`` -> an eval-mode FiLMDenoiser on
    ``device``; with ``use_ema`` the parameters are the trainer's EMA."""
    mcfg: DenoiserConfig = load_config(model_path)["denoiser"]
    # the frozen frontend may be trained in bf16, but inference runs it in
    # f32, as the JAX generate does
    mcfg = dataclasses.replace(mcfg, frontend_dtype="float32")
    model = FiLMDenoiser(mcfg)
    sd = _state_dict(model_path)
    if use_ema:
        ema = _ema_params(model_path)
        if ema is None:
            warnings.warn(f"use_ema=True but {model_path} has no EMA of its parameters: sampling from "
                          "model.pt's (was it trained with ema_decay=0?)")
        else:
            sd.update(ema)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


class GuideKeyframer:
    """Keyframes from the guide LM, decoded by the frozen VQ codec
    (reference: sample/generate.py:51-71 _replace_keyframes; JAX
    apps/generate.py:52-88).  Each directory holds ``config.json`` (a
    ``guide`` resp. ``vq`` section) and ``model.pt``."""

    def __init__(self, guide_path: str, vq_path: str, device):
        gcfg: GuideConfig = load_config(guide_path)["guide"]
        vcfg: VQConfig = load_config(vq_path)["vq"]
        self.guide = GuideTransformer(gcfg)
        self.guide.load_state_dict(_state_dict(guide_path), strict=True)
        self.guide.to(device).eval()
        self.codec = TemporalVertexCodec(vcfg)
        self.codec.load_state_dict(_state_dict(vq_path), strict=True)
        self.codec.to(device).eval()

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, num_keyframes: int, generator: torch.Generator,
                 top_p: float = 0.94) -> torch.Tensor:
        """[B, S, 2] audio -> [B, num_keyframes, nfeats] normalised keyframes."""
        depth = self.codec.cfg.depth
        tokens = self.guide.generate(audio, num_keyframes * depth, generator, top_p)
        return self.codec.decode(tokens.reshape(audio.shape[0], num_keyframes, depth))


def draw_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """x_T ~ N(0, I)."""
    return torch.randn(shape, generator=generator, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(
    model_path: str,
    data_root: str,
    *,
    num_samples: int = 5,
    num_repetitions: int = 1,
    guidance_param: float = 2.0,
    timestep_respacing: str = "ddim500",
    guide_path: Optional[str] = None,
    vq_path: Optional[str] = None,
    top_p: float = 0.94,
    seed: int = 10,
    output_dir: Optional[str] = None,
    use_ema: bool = False,
    plot: bool = False,
    face_codes: Optional[str] = None,
    renderer_path: Optional[str] = None,
    render_gt: bool = False,
    device: Optional[str] = None,
    timings: Optional[Dict[str, float]] = None,
) -> str:
    """Write ``results.npy`` and return its path.  ``timings``, when given,
    receives the wall seconds of the guide's keyframes (``guide_s``, 0
    without a guide), of the conditioning encode (``encode_s``), the lip
    regressor's share of it (``lip_s``, 0 for a pose model) and of the DDIM
    loop (``ddim_s``), summed over repetitions (the device is synchronised
    at each)."""
    if bool(guide_path) != bool(vq_path):
        raise ValueError("the guide keyframes need both --resume_trans (guide) and --resume_vq (VQ)")
    if plot and not (renderer_path and face_codes):
        raise ValueError("--plot needs --renderer_path (a renderer bundle) and --face_codes "
                         "(a face model's results.npy)")
    dev = resolve_device(device)
    cfgs = load_config(model_path)
    dcfg: DiffusionConfig = cfgs["diffusion"]
    datacfg: DataConfig = cfgs["data"]
    model = load_model(model_path, dev, use_ema)

    scenes = load_local_data(data_root, datacfg.person)
    stats = find_stats(os.path.join(data_root, datacfg.person))
    ds = SocialDataset(scenes, stats, datacfg, "test")
    sched = maybe_respaced(dcfg.schedule, dcfg.steps, timestep_respacing)

    pose = model.cfg.data_format == "pose"
    inv = stats.inv_pose if pose else stats.inv_code
    n = min(num_samples, len(ds))
    batch = {k: np.stack([ds.get_chunk(i)[k] for i in range(n)]) for k in ds.get_chunk(0)}
    audio = torch.from_numpy(batch["audio"]).to(dev)
    kf = kv = None
    if pose:
        kf = torch.from_numpy(batch["keyframes"]).to(dev)
        kv = torch.from_numpy(batch["keyframe_valid"]).to(dev)
    B, T, C = batch["motion"].shape
    generator = torch.Generator(device=dev).manual_seed(seed)
    keyframer = guide_generator = None
    if pose and guide_path:
        keyframer = GuideKeyframer(guide_path, vq_path, dev)
        guide_generator = torch.Generator(device=dev).manual_seed(seed + 1)
    if timings is not None:
        timings.update(guide_s=0.0, encode_s=0.0, lip_s=0.0, ddim_s=0.0)

    all_motions, all_keyframes = [], []
    for _ in range(num_repetitions):
        if keyframer is not None:  # as JAX apps/generate.py:172-174
            t0 = time.perf_counter()
            kf = keyframer(audio, batch["keyframes"].shape[1], guide_generator, top_p)
            kv = torch.ones_like(kv)
            if timings is not None:
                _sync(dev)
                timings["guide_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        lip = None
        if not pose:
            lip = model.lip_vertices(audio)
            if timings is not None:
                _sync(dev)
                timings["lip_s"] += time.perf_counter() - t0
        cond = model.encode_conditioning(audio, kf, kv, lip_verts=lip)
        if timings is not None:
            _sync(dev)
            timings["encode_s"] += time.perf_counter() - t0
        xT = draw_noise((B, T, C), generator, dev)
        t0 = time.perf_counter()
        model_fn = cfg_model_fn_cached(model, cond, guidance_param)
        res = sampling.ddim_sample_loop(sched, dcfg.predict, model_fn, xT)
        sample = res.pred_xstart.cpu().numpy()  # the reference returns the final pred_xstart
        if timings is not None:
            timings["ddim_s"] += time.perf_counter() - t0
        all_motions.append(inv(sample))
        if pose:
            all_keyframes.append(stats.inv_pose(kf.cpu().numpy()))

    out_dir = output_dir or os.path.join(model_path, f"samples_{timestep_respacing}_seed{seed}")
    os.makedirs(out_dir, exist_ok=True)
    results = {
        # reference layout: [B, C, 1, T] (sample/generate.py:146-152)
        "motions": np.concatenate(all_motions, 0).transpose(0, 2, 1)[:, :, None, :],
        "gt": inv(batch["motion"]).transpose(0, 2, 1)[:, :, None, :],
        "audio": stats.inv_audio(batch["audio"]),
        "lengths": batch["lengths"],
    }
    if pose:
        results["keyframes"] = np.concatenate(all_keyframes, 0)
    out_path = os.path.join(out_dir, "results.npy")
    np.save(out_path, results)
    if plot:
        _render_pred(
            results,
            face_codes_path=face_codes,
            renderer_path=renderer_path,
            out_dir=out_dir,
            num_samples=n,
            num_repetitions=num_repetitions,
            render_gt=render_gt,
            audio_per_frame=datacfg.audio_per_frame,
            device=dev,
        )
    return out_path


def _render_pred(
    results: dict,
    *,
    face_codes_path: str,
    renderer_path: str,
    out_dir: str,
    num_samples: int,
    num_repetitions: int,
    render_gt: bool,
    audio_per_frame: int = 1600,
    device=None,
) -> None:
    """Photoreal-render the generated motion (reference sample/generate.py:
    155-207): pair each pose sample with its face-codes sample, check that
    both were made from the same audio, and write the per-sample video(s)."""
    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer

    face_res = np.load(face_codes_path, allow_pickle=True).item()
    face_motions, face_gts, face_audio = face_res["motions"], face_res.get("gt"), face_res["audio"]
    renderer = load_body_renderer(renderer_path, device=device)
    for sample_i in range(num_samples):
        for rep_i in range(num_repetitions):
            idx = rep_i * num_samples + sample_i
            length = int(results["lengths"][idx])
            # face and pose runs must be conditioned on the same audio (:187-189)
            if not np.array_equal(results["audio"][idx], face_audio[idx]):
                raise ValueError(f"sample {idx}: the face codes were made from other audio")
            block = {
                "audio": results["audio"][idx][: length * audio_per_frame],
                "body_motion": results["motions"][idx].transpose(2, 0, 1)[:length].squeeze(-1),
                "face_motion": face_motions[idx].transpose(2, 0, 1)[:length].squeeze(-1),
            }
            if render_gt:
                block["gt_body"] = results["gt"][idx].transpose(2, 0, 1)[:length].squeeze(-1)
                block["gt_face"] = face_gts[idx].transpose(2, 0, 1)[:length].squeeze(-1)
            save_base = os.path.join(out_dir, f"sample{sample_i:02d}_rep{rep_i:02d}")
            renderer.render_full_video(block, save_base, render_gt=False)
            if render_gt:
                renderer.render_full_video(block, save_base, render_gt=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True, help="checkpoint dir with config.json + model.pt")
    p.add_argument("--data_root", required=True)
    p.add_argument("--num_samples", type=int, default=5)
    p.add_argument("--num_repetitions", type=int, default=1)
    p.add_argument("--guidance_param", type=float, default=2.0)
    p.add_argument("--timestep_respacing", default="ddim500")
    p.add_argument("--resume_trans", default=None, help="guide checkpoint dir (config.json + model.pt)")
    p.add_argument("--resume_vq", default=None, help="VQ checkpoint dir (config.json + model.pt)")
    p.add_argument("--top_p", type=float, default=0.94, help="nucleus mass of the guide's token draws")
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--use_ema", action="store_true", help="sample from the trainer's EMA of the parameters")
    p.add_argument("--plot", action="store_true", help="photoreal-render the samples")
    p.add_argument("--face_codes", default=None, help="face model results.npy for --plot")
    p.add_argument("--renderer_path", default=None, help="renderer bundle dir for --plot")
    p.add_argument("--render_gt", action="store_true", help="also render the ground truth")
    p.add_argument("--device", default=None, help="torch device (default: cuda; raises without one)")
    args = p.parse_args()
    out = generate(
        args.model_path,
        args.data_root,
        num_samples=args.num_samples,
        num_repetitions=args.num_repetitions,
        guidance_param=args.guidance_param,
        timestep_respacing=args.timestep_respacing,
        guide_path=args.resume_trans,
        vq_path=args.resume_vq,
        top_p=args.top_p,
        seed=args.seed,
        output_dir=args.output_dir,
        use_ema=args.use_ema,
        plot=args.plot,
        face_codes=args.face_codes,
        renderer_path=args.renderer_path,
        render_gt=args.render_gt,
        device=args.device,
    )
    print(f"saved {out}")


if __name__ == "__main__":
    main()
