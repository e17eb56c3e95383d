"""audio2photoreal_tpu_torch — the PyTorch and CUDA port of audio2photoreal_tpu.

The JAX package beside it is the reference; every module here has its
counterpart at the same path there and is held to it by the tests
(``tests/test_torch_*.py``).  This package imports ``torch`` and never
``jax``.  Plain tensor code is PyTorch; each TPU kernel of the JAX package
becomes a kernel written by hand for Hopper (``kernels/``), with a plain
PyTorch version beside it that CPU tensors take.

Layering:
  core/      config dataclasses (the same config.json sidecar)
  data/      dataset contract, stats, synthetic person fixture (numpy)
  ops/       convs, resampler, rotary, embeddings, plain attention
  kernels/   hand-written CUDA kernels, their build and ctypes binding
  models/    wav2vec frontend, FiLM blocks, pose FiLM denoiser, batched CFG
  diffusion/ schedules, respacing, q/p math, DDIM loop
  render/    ca_body avatar: LBS, UV geometry, weight-norm layers, decoders,
             seams, display colour, rasterizer, synthetic assets, video
  apps/      generate CLI, photoreal render pipeline
  convert.py JAX param tree -> this package's state_dict
"""

__version__ = "0.1.0"
