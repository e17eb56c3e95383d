"""Ground-truth annotation render: dataset chunks -> video (or .npz).

Counterpart of ``audio2photoreal_tpu/apps/render_anno.py`` (reference:
visualize/render_anno.py:22-58): the test split of one person, chunked at
``--max_seq_length``; each chunk's pose is inverse-normalised and, without a
renderer, written with its audio to ``anno_NNNN.npz`` {pose, audio}.  With
``--body_ckpt`` (a renderer bundle, as ``apps/convert_checkpoint.py
--avatar`` writes one; ``--assets`` a ``static_assets.pt`` in place of the
bundle's assets) each chunk renders from the JAX package's fixed camera to
``anno_NNNN_pred.mp4``, with the scene's own face codes of those frames as
the reference renders them (render_anno.py:41-48; the JAX package renders
zero face codes).  Runs on the card unless ``--device`` says otherwise.

    python -m audio2photoreal_tpu_torch.apps.render_anno --data_root <dir> --save_dir <dir>
        [--person PXB184] [--body_ckpt <bundle> [--assets static_assets.pt]] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from audio2photoreal_tpu_torch.apps.generate import find_stats
from audio2photoreal_tpu_torch.core.config import DataConfig
from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data


def anno_camera():
    """The JAX package's camera (render_anno.py:50-54)."""
    from audio2photoreal_tpu_torch.render.assets import Camera

    return Camera(
        campos=np.array([0.0, -3.0, 1.0], np.float32),
        K=np.array([[800.0, 0, 333], [0, 800.0, 512], [0, 0, 1]], np.float32),
        Rt=np.array([[1, 0, 0, 0], [0, 0, -1, 1], [0, 1, 0, 3]], np.float32),
    )


def load_anno_renderer(body_ckpt: str, assets_path=None, device=None):
    """A BodyRenderer of the bundle ``body_ckpt`` from ``anno_camera``."""
    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
    from audio2photoreal_tpu_torch.render.assets import convert_static_assets, load_bundle_parts

    cfg, assets, sd, _ = load_bundle_parts(body_ckpt)
    if assets_path:
        assets = convert_static_assets(assets_path, cfg)
    return BodyRenderer(cfg, assets, sd, {"default": anno_camera()}, device=device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--person", default="PXB184")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--max_seq_length", type=int, default=600)
    p.add_argument("--assets", default=None, help="static_assets.pt for the renderer (default: the bundle's)")
    p.add_argument("--body_ckpt", default=None,
                   help="renderer bundle, as apps/convert_checkpoint.py --avatar writes it")
    p.add_argument("--device", default=None, help="torch device (default: cuda; raises without one)")
    args = p.parse_args(argv)

    scenes = load_local_data(args.data_root, args.person)
    stats = find_stats(os.path.join(args.data_root, args.person))
    cfg = DataConfig(person=args.person, data_format="pose", max_seq_length=args.max_seq_length,
                     min_seq_length=args.max_seq_length)
    ds = SocialDataset(scenes, stats, cfg, "test")
    os.makedirs(args.save_dir, exist_ok=True)
    renderer = load_anno_renderer(args.body_ckpt, args.assets, args.device) if args.body_ckpt else None

    for i in range(len(ds)):
        ex = ds.get_chunk(i)
        length = int(ex["lengths"])
        pose = stats.inv_pose(ex["motion"][:length])
        audio = stats.inv_audio(ex["audio"])
        out = os.path.join(args.save_dir, f"anno_{i:04d}")
        if renderer is None:  # no renderer: the GT pose and audio, renderable later
            np.savez(out + ".npz", pose=pose, audio=audio)
            print(f"saved {out}.npz")
        else:
            si, start, _ = ds.chunks[i]
            face = ds.scenes[si].face[start : start + length]
            video = renderer.render_full_video({"body_motion": pose, "face_motion": face, "audio": audio}, out)
            print(f"rendered {video}")


if __name__ == "__main__":
    main()
