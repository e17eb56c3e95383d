"""The model configurations the reference builds from: frozen dataclasses
with the fields and defaults of the measured package's, so a configuration
file's ``denoiser``, ``guide`` and ``vq`` sections build both.
"""

from __future__ import annotations

from dataclasses import dataclass

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
