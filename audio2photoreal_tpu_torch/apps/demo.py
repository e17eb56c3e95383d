"""Demo server: a wav -> face codes + body pose (-> a 2-camera video).

Counterpart of ``audio2photoreal_tpu/apps/demo.py`` (reference: demo/demo.py):
the audio averaged to mono, resampled to 48 kHz (``ops/resample.py``, on
the host), cut to a multiple of 4 s, with a near-silent second channel
N(0, 0.001²) from ``np.random.RandomState(seed)`` (demo.py:174-190); the
face at guidance 10.0, then the pose at 2.0 on keyframes that the guide LM
samples by top-p (0.94) and the VQ decodes; both by DDIM-100 with cached
classifier-free guidance.  ``DemoPipeline`` loads the models once, through
``apps/generate.py:load_model`` (the frozen frontend in f32, a bf16
checkpoint's compute dtype kept), and answers requests; ``render_video``
renders a result through a renderer bundle.

Per request, x_T comes from ``draw_noise`` with a ``torch.Generator``
seeded with ``seed`` (face first, then pose) and the guide's Gumbel noise
from one seeded with ``seed + 1``, so for the same seed the motion differs
from the JAX package's (its ``jax.random`` keys); the second channel is the
same, bit for bit.  A pose model directory with ``guide/`` and ``vq/``
checkpoint directories samples its keyframes; without them the keyframes
are zero and marked invalid.  Everything runs on the card unless
``device`` says otherwise.

    python -m audio2photoreal_tpu_torch.apps.demo --wav <file.wav> --face_model <dir> \\
        --pose_model <dir> --data_root <dir> [--person PXB184] [--renderer_path <bundle>] [--device cpu]

writes ``<out>/demo_results.npy`` ({face [T, 256], pose [T, 104], audio
[S, 2]}) and, with a renderer, ``<out>/demo_video_pred.mp4``; a gradio UI
follows where gradio is installed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from audio2photoreal_tpu_torch.apps.generate import GuideKeyframer, _sync, draw_noise, find_stats, load_model
from audio2photoreal_tpu_torch.core.config import load_config
from audio2photoreal_tpu_torch.core.device import resolve_device
from audio2photoreal_tpu_torch.data.dataset import read_wav
from audio2photoreal_tpu_torch.diffusion import sampling
from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached
from audio2photoreal_tpu_torch.ops.resample import resample

SR = 48_000
FOUR_SECONDS = 4 * SR


def prepare_audio(wav: np.ndarray, sr: int, seed: int = 0) -> np.ndarray:
    """[S] or [S, C] at ``sr`` -> [n, 2] at 48 kHz, n a multiple of 4 s: the
    mono mix, and N(0, 0.001²) as the second channel (demo.py:156-190)."""
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if sr != SR:
        wav = resample(torch.from_numpy(np.asarray(wav, np.float32)[None]), sr, SR).numpy()[0]
    n = (len(wav) // FOUR_SECONDS) * FOUR_SECONDS
    if n == 0:
        raise ValueError("need at least 4 seconds of audio")
    wav = wav[:n]
    ch2 = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.001
    return np.stack([wav, ch2], axis=1)


class DemoPipeline:
    """Loads the face and pose models once and generates per request
    (reference GradioModel, demo.py:26-69)."""

    def __init__(
        self,
        face_model_path: str,
        pose_model_path: str,
        data_root: str,
        person: str = "PXB184",
        timestep_respacing: str = "ddim100",
        renderer_path: Optional[str] = None,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.stats = find_stats(os.path.join(data_root, person))
        self.respacing = timestep_respacing
        self.face = self._load(face_model_path)
        self.pose = self._load(pose_model_path)
        self.renderer = None
        if renderer_path:
            from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer

            self.renderer = load_body_renderer(renderer_path, device=self.device)
        self.keyframer: Optional[GuideKeyframer] = None
        guide_dir, vq_dir = (os.path.join(pose_model_path, d) for d in ("guide", "vq"))
        if os.path.isdir(guide_dir) and os.path.isdir(vq_dir):
            self.keyframer = GuideKeyframer(guide_dir, vq_dir, self.device)

    def _load(self, path: str) -> dict:
        dcfg = load_config(path)["diffusion"]
        return {"model": load_model(path, self.device), "predict": dcfg.predict,
                "sched": maybe_respaced(dcfg.schedule, dcfg.steps, self.respacing)}

    def _sample(self, entry: dict, audio_n, kf, kv, guidance: float, generator: torch.Generator,
                timings: dict, name: str) -> torch.Tensor:
        """encode once -> cached CFG -> DDIM -> the last pred_xstart."""
        model = entry["model"]
        t0 = time.perf_counter()
        cond = model.encode_conditioning(audio_n, kf, kv)
        _sync(self.device)
        t1 = time.perf_counter()
        x_T = draw_noise((audio_n.shape[0], audio_n.shape[1] // 1600, model.cfg.nfeats), generator, self.device)
        res = sampling.ddim_sample_loop(entry["sched"], entry["predict"], cfg_model_fn_cached(model, cond, guidance),
                                        x_T)
        _sync(self.device)
        timings[f"{name}_encode_s"], timings[f"{name}_ddim_s"] = t1 - t0, time.perf_counter() - t1
        return res.pred_xstart

    @torch.no_grad()
    def generate(
        self,
        wav: np.ndarray,
        sr: int,
        *,
        face_guidance: float = 10.0,
        pose_guidance: float = 2.0,
        top_p: float = 0.94,
        seed: int = 0,
        timings: Optional[Dict[str, float]] = None,
    ) -> Dict[str, np.ndarray]:
        """-> {"face": [T, 256], "pose": [T, 104], "audio": [S, 2]}, face
        first, then pose (demo.py:113-216).  ``timings``, when given,
        receives the wall seconds of each model's encode and DDIM loop and of
        the guide's keyframes (the device synchronised at each)."""
        timings = {} if timings is None else timings
        audio = prepare_audio(wav, sr, seed)
        audio_n = torch.from_numpy(np.asarray(self.stats.norm_audio(audio), np.float32))[None].to(self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        face = self._sample(self.face, audio_n, None, None, face_guidance, generator, timings, "face")

        T = audio.shape[0] // 1600
        K = -(-T // self.pose["model"].cfg.keyframe_step)
        t0 = time.perf_counter()
        if self.keyframer is not None:
            guide_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
            kf = self.keyframer(audio_n, K, guide_generator, top_p)
            kv = torch.ones((1, K), device=self.device)
        else:
            kf = torch.zeros((1, K, self.pose["model"].cfg.key_feature_dim), device=self.device)
            kv = torch.zeros((1, K), device=self.device)
        _sync(self.device)
        timings["guide_s"] = time.perf_counter() - t0
        pose = self._sample(self.pose, audio_n, kf, kv, pose_guidance, generator, timings, "pose")
        return {
            "face": self.stats.inv_code(face[0].float().cpu().numpy()),
            "pose": self.stats.inv_pose(pose[0].float().cpu().numpy()),
            "audio": audio,
        }

    def render_video(self, result: Dict[str, np.ndarray], out_path: str) -> str:
        """The photoreal video of a ``generate`` result (demo.py:219-235):
        ``<out_path>_pred.mp4`` (an ``.npz`` of the frames without ffmpeg)."""
        if self.renderer is None:
            raise ValueError("DemoPipeline was built without renderer_path")
        return self.renderer.render_full_video(
            {"body_motion": result["pose"], "face_motion": result["face"], "audio": result["audio"]}, out_path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav", required=True)
    p.add_argument("--face_model", required=True, help="face checkpoint dir (config.json + model.pt)")
    p.add_argument("--pose_model", required=True,
                   help="pose checkpoint dir; its guide/ and vq/ dirs, when present, sample the keyframes")
    p.add_argument("--data_root", required=True, help="holds <person>/data_stats.npz")
    p.add_argument("--person", default="PXB184")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--top_p", type=float, default=0.94)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--renderer_path", default=None,
                   help="ca_body renderer bundle: renders the demo video (demo.py:219-235)")
    p.add_argument("--device", default=None, help="torch device (default: cuda; raises without one)")
    args = p.parse_args(argv)

    pipe = DemoPipeline(args.face_model, args.pose_model, args.data_root, args.person,
                        renderer_path=args.renderer_path, device=args.device)
    wav = read_wav(args.wav)
    out = pipe.generate(wav, SR, top_p=args.top_p, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "demo_results.npy"), out)
    print(f"saved {args.out}/demo_results.npy (face {out['face'].shape}, pose {out['pose'].shape})")
    if pipe.renderer is not None:
        print(f"rendered {pipe.render_video(out, os.path.join(args.out, 'demo_video'))}")

    try:  # the optional web UI (demo.py:238-276)
        import gradio as gr

        def fn(audio_tuple, top_p):
            sr, wav = audio_tuple
            res = pipe.generate(wav.astype(np.float32) / 32768.0, sr, top_p=top_p)
            return str({k: v.shape for k, v in res.items()})

        gr.Interface(fn, [gr.Audio(), gr.Slider(0.6, 1.0, value=0.94)], "text").launch()
    except ImportError:
        pass


if __name__ == "__main__":
    main()
