#!/usr/bin/env python3
"""Save dirs written by the JAX package -> save dirs the PyTorch port reads.

    python3 tools/torch_from_jax.py SRC OUT

SRC is one directory that the JAX trainers or converter wrote:

- a FiLM denoiser (pose or face): ``config.json`` + orbax ``ckpt/``, with
  the trainer's ``ema_params`` when it kept an EMA;
- a guide LM: ``config.json`` (a ``guide`` section) + ``ckpt/``;
- a residual VQ: ``config.json`` (a ``vq`` section) + ``ckpt/`` with the
  codebook state (``embed``, ``embed_avg``, ``cluster_size``);
- a renderer bundle (``render/assets.py:save_renderer_bundle``):
  ``renderer.json`` + ``ckpt/`` + ``cameras.npz`` [+ ``static_assets.pt``].

Each is read with the JAX package's own readers (``train/checkpoints.py:
restore``, ``render/assets.py:load_renderer_bundle``) and written in the
port's layout through ``audio2photoreal_tpu_torch/convert.py``: ``config.json``
+ ``model.pt`` for ``apps/generate.py:load_model`` and ``GuideKeyframer``,
the EMA as ``ckpt/step_<N>.pt`` where ``load_model(use_ema=True)`` reads it,
and the port's renderer bundle for ``load_body_renderer``.  The trainer's
optimizer state is not carried: a port trainer starts a new run rather than
resume from OUT.  The kind of SRC is told by ``renderer.json`` and by the
sections of its ``config.json``.

This file imports JAX, orbax and the JAX package to read their checkpoints,
so it runs where they are installed; copy OUT to the machine with the card
afterwards (the port itself never imports JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG_FILE = "config.json"


def detect_kind(src: str) -> str:
    """renderer.json -> a renderer bundle; else the config.json section."""
    import json

    if os.path.exists(os.path.join(src, "renderer.json")):
        return "renderer"
    with open(os.path.join(src, CONFIG_FILE)) as f:
        sections = json.load(f)
    for kind in ("denoiser", "guide", "vq"):
        if kind in sections:
            return kind
    raise ValueError(f"{src}: neither renderer.json nor a denoiser, guide or vq section in {CONFIG_FILE}")


def _numpy(tree):
    import jax
    import numpy as np

    return jax.tree_util.tree_map(np.asarray, tree)


def _restore(src: str) -> dict:
    """The orbax tree of ``src/ckpt`` at its latest step, as numpy."""
    from audio2photoreal_tpu.train import checkpoints

    return _numpy(checkpoints.restore(os.path.join(src, "ckpt"), None))


def _state(tree: dict) -> dict:
    """An inference save ``{"params", ...}`` or a trainer's ``{"state": ...}``."""
    return tree["state"] if "state" in tree else tree


def _copy_config(src: str, out: str) -> dict:
    """config.json as it is (the port reads the JAX sidecar's format), checked
    by the port's loader."""
    from audio2photoreal_tpu_torch.core.config import load_config

    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(src, CONFIG_FILE), os.path.join(out, CONFIG_FILE))
    return load_config(out)


def convert_denoiser(src: str, out: str) -> str:
    """A FiLM denoiser dir -> ``model.pt`` (+ the EMA in ``ckpt/``)."""
    import torch

    from audio2photoreal_tpu_torch import convert
    from audio2photoreal_tpu_torch.apps import generate
    from audio2photoreal_tpu_torch.train import checkpoints

    mcfg = _copy_config(src, out)["denoiser"]
    state = _state(_restore(src))
    sd = lambda p: convert.film_denoiser_state_dict_from_jax(p, mcfg.data_format, mcfg.num_layers)  # noqa: E731
    torch.save(sd(state["params"]), os.path.join(out, generate.MODEL_FILE))
    if state.get("ema_params") is not None:
        step = int(state.get("step", 0))
        path = checkpoints.checkpoint_path(os.path.join(out, generate.CKPT_DIR), step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"step": step, "ema": sd(state["ema_params"])}, path)
    return out


def convert_guide(src: str, out: str) -> str:
    """A guide dir -> ``model.pt``."""
    import torch

    from audio2photoreal_tpu_torch import convert
    from audio2photoreal_tpu_torch.apps import generate

    _copy_config(src, out)
    torch.save(convert.guide_state_dict_from_jax(_state(_restore(src))["params"]),
               os.path.join(out, generate.MODEL_FILE))
    return out


def convert_vq(src: str, out: str) -> str:
    """A VQ dir -> ``model.pt`` with its codebooks (loaded as inited, as the
    JAX ``GuideKeyframer`` takes them)."""
    import torch

    from audio2photoreal_tpu_torch import convert
    from audio2photoreal_tpu_torch.apps import generate

    _copy_config(src, out)
    tree = _restore(src)
    torch.save(convert.vqvae_state_dict_from_jax(_state(tree)["params"], {**tree["vq"], "inited": True}),
               os.path.join(out, generate.MODEL_FILE))
    return out


def convert_renderer(src: str, out: str) -> str:
    """A JAX renderer bundle -> the port's (``render/assets.py``)."""
    from audio2photoreal_tpu.render.assets import load_renderer_bundle

    from audio2photoreal_tpu_torch import convert
    from audio2photoreal_tpu_torch.render import assets
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    renderer = load_renderer_bundle(src)
    fields = {k: v for k, v in dataclasses.asdict(renderer.cfg).items() if k not in assets.DROPPED_FIELDS}
    cfg = RendererConfig(**fields)
    sd = convert.body_avatar_state_dict_from_jax(_numpy(renderer.params), cfg)
    sa = os.path.join(src, assets.STATIC_ASSETS_FILE)
    # no static_assets.pt: the JAX bundle renders make_synthetic_assets(cfg)'s defaults
    return assets.save_renderer_bundle(out, cfg, sd, renderer.cameras,
                                       static_assets=sa if os.path.exists(sa) else None)


CONVERTERS = dict(denoiser=convert_denoiser, guide=convert_guide, vq=convert_vq, renderer=convert_renderer)


def convert_dir(src: str, out: str) -> str:
    """Convert one JAX save dir; returns ``out``."""
    if os.path.abspath(src) == os.path.abspath(out):
        raise ValueError("OUT must differ from SRC")
    return CONVERTERS[detect_kind(src)](src, out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="a save dir written by the JAX package")
    p.add_argument("out", help="the port's save dir to write")
    args = p.parse_args(argv)
    print(convert_dir(args.src, args.out))


if __name__ == "__main__":
    main()
