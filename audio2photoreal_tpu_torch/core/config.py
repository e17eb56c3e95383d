"""Typed configuration with a JSON sidecar round-trip.

A copy of ``audio2photoreal_tpu/core/config.py`` that imports no JAX: the
same frozen dataclasses and the same ``config.json`` format, so a sidecar
written by either package is read by the other.  Fields that only the JAX
package acts on (``rng_impl``, the mesh) are kept so that the file
round-trips.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

FPS = 30
AUDIO_SR = 48_000
AUDIO_PER_FRAME = AUDIO_SR // FPS  # 1600 samples / motion frame (get_data.py:90-92)
WAV2VEC_SR = 16_000
# valid-conv downsampling of the wav2vec feature extractor: strides 5*4*2*2*2
WAV2VEC_HOP = 160


@dataclass(frozen=True)
class DiffusionConfig:
    """Gaussian diffusion process hyperparameters.

    Matches the reference operating point (utils/model_util.py:79-114):
    1000 cosine steps, model predicts x0, MSE loss, FIXED_SMALL variance.
    """

    steps: int = 1000
    schedule: str = "cosine"  # "cosine" | "linear"
    predict: str = "xstart"  # "xstart" | "eps" | "v"
    var_type: str = "fixed_small"  # "fixed_small" | "fixed_large"
    timestep_respacing: str = ""  # "" | "ddimN" | comma-separated section counts
    lambda_vel: float = 0.0  # optional velocity loss weight (gaussian_diffusion.py:1236-1245)
    cond_drop_prob: float = 0.2  # train-time CFG dropout (gaussian_diffusion.py:1219)


@dataclass(frozen=True)
class DenoiserConfig:
    """FiLM transformer denoiser (reference: model/diffusion.py:82-403).

    ``data_format`` selects the face (256-d codes) or pose (104-d angles)
    variant; pose adds guide-keyframe cross-attention and a causal dilated
    conv post-net, face adds a conditioning pre-encoder + lip features.
    """

    data_format: str = "pose"  # "pose" | "face"
    nfeats: int = 104
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    cond_feature_dim: int = 1024  # 2ch wav2vec concat (model/diffusion.py:285-293)
    lip_dim: int = 338 * 3  # face-only lip vertex conditioning (diffusion.py:156)
    key_feature_dim: int = 104  # pose-only guide keyframe dim
    keyframe_step: int = FPS  # 1 fps keyframes (data.py:146-150)
    max_seq_length: int = 600
    use_rotary: bool = True
    cond_encoder_layers: int = 2  # face-only rotary encoder over cond tokens
    postnet_receptive_field: int = 25  # pose-only causal conv stack (diffusion.py:153)
    dtype: str = "float32"  # "bfloat16" → bf16 compute, f32 params (TPU policy)
    remat: bool = False  # gradient-checkpoint the decoder stack (diffusion/nn.py:145 role)
    # Pallas memory-efficient attention (ops/pallas/flash.py) for the decoder
    # stack's un-biased self/cross attention, incl. in-kernel replayable
    # attention-prob dropout in training.  Numerics: bf16-rounding-level vs
    # the einsum path.  Off by default for torch-checkpoint bit-parity runs.
    flash_attention: bool = False
    # training dropout masks from a fused integer position-hash instead of
    # materialized RNG-bit tensors (models/blocks.py:hash_drop_mult).  XLA
    # cannot fuse rng_bit_generator output into consumers, so the ~30 masks
    # of a bs-64 step cost 21 ms (pose) / 50 ms (face) — the hash masks are
    # free.  Same Bernoulli(rate) law, deterministic in (step rng, position);
    # NOT bit-identical to nn.Dropout streams, so off by default.
    hash_dropout: bool = False
    # dtype of the FROZEN wav2vec conditioning frontend's conv matmuls.
    # float32 (default) is bit-faithful to the reference (the 1e-3
    # inference-parity target); "bfloat16" (f32 accumulation, f32 norms) is
    # ~3x faster on the MXU and only quantizes frozen features ~0.3% rel —
    # recommended for training.  Inference CLIs force float32 on load.
    frontend_dtype: str = "float32"

    @property
    def cond_dim(self) -> int:
        if self.data_format == "face":
            return self.cond_feature_dim + self.lip_dim  # 1024 + 1014
        return self.cond_feature_dim


@dataclass(frozen=True)
class VQConfig:
    """Residual VQ-VAE over 1 fps pose keyframes (reference: model/vqvae.py:395-550)."""

    nfeats: int = 104
    emb_width: int = 64
    code_dim: int = 1024  # number of codes per codebook (n_clusters)
    depth: int = 4  # residual quantizers
    encoder_layers: int = 3  # causal dilated convs, receptive field 8 (vqvae.py:403-414)
    decay: float = 0.99
    commit_weight: float = 0.02
    threshold_ema_dead_code: float = 2.0
    kmeans_init: bool = True
    kmeans_iters: int = 10


@dataclass(frozen=True)
class GuideConfig:
    """Autoregressive audio→VQ-token transformer (reference: model/guide.py:26-222)."""

    tokens: int = 1024  # = VQConfig.code_dim; vocab adds 1 start token (guide.py:43-45)
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 6
    num_heads: int = 4
    dropout: float = 0.1
    cond_feature_dim: int = 1024
    vq_depth: int = 4
    max_tokens: int = 20 * 4  # 20s @ 1fps × depth
    dtype: str = "bfloat16"
    frontend_dtype: str = "float32"  # see DenoiserConfig.frontend_dtype


@dataclass(frozen=True)
class DataConfig:
    """Dataset contract of the reference (SURVEY §2.3)."""

    data_root: str = ""
    person: str = "PXB184"
    data_format: str = "pose"
    max_seq_length: int = 600
    min_seq_length: int = 400  # random crop length range (data.py:178-185)
    batch_size: int = 4
    add_frame_cond: Optional[int] = 1  # 1 → 1fps keyframes
    audio_per_frame: int = AUDIO_PER_FRAME
    num_val_seqs: int = 2
    num_test_seqs: int = 4


@dataclass(frozen=True)
class TrainConfig:
    save_dir: str = ""
    lr: float = 1e-4
    weight_decay: float = 0.0
    num_steps: int = 800_000
    lr_anneal_steps: int = 0
    warmup_steps: int = 0
    save_interval: int = 5000
    log_interval: int = 100
    seed: int = 10
    # step-rng bit generator: "rbg" = XLA RngBitGenerator (TPU-accelerated;
    # the bs-64 step's ~3.6B dropout draws cost 125 ms under threefry —
    # core/rng.py); "threefry" = JAX default, kept for bit-reproducibility
    rng_impl: str = "rbg"
    grad_clip: float = 0.0
    ema_decay: float = 0.0  # 0 disables
    # timestep sampler: "uniform" (reference default) or "loss_second_moment"
    # (importance sampling by loss second moment, resample.py:138-168)
    schedule_sampler: str = "uniform"
    # parallelism: -1 = all remaining devices on that axis
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)


_CONFIG_TYPES: Dict[str, type] = {
    "diffusion": DiffusionConfig,
    "denoiser": DenoiserConfig,
    "vq": VQConfig,
    "guide": GuideConfig,
    "data": DataConfig,
    "train": TrainConfig,
}


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    """Build a (possibly nested) dataclass from a plain dict, ignoring unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for name, f in fields.items():
        if name not in d:
            continue
        v = d[name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            v = from_dict(f.type, v)  # type: ignore[arg-type]
        elif isinstance(v, list) and "Tuple" in str(f.type):
            v = tuple(v)
        kwargs[name] = v
    return cls(**kwargs)


def save_config(path: str, **configs: Any) -> None:
    """Write a config.json sidecar: ``save_config(dir, denoiser=dc, diffusion=df)``."""
    os.makedirs(path, exist_ok=True)
    payload = {name: _to_jsonable(cfg) for name, cfg in configs.items()}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


def load_config(path: str) -> Dict[str, Any]:
    """Re-hydrate the config sidecar into dataclasses by section name."""
    fname = path if path.endswith(".json") else os.path.join(path, "config.json")
    with open(fname) as f:
        payload = json.load(f)
    out: Dict[str, Any] = {}
    for name, d in payload.items():
        cls = _CONFIG_TYPES.get(name)
        out[name] = from_dict(cls, d) if cls is not None else d
    return out
