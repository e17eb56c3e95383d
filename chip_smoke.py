#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio2photoreal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and the CUDA toolkit
(nvcc).  Each phase prints one JSON line; any failure is an uncaught
exception and a nonzero exit.

1. device: the card, its power limit, torch/CUDA versions; TF32 is turned off
   for matmuls and cuDNN convs, so f32 stays f32 throughout; whether cuBLAS
   may reduce bf16 split-K partials in bf16 (PyTorch's default, left as it
   is: the bf16 phases below show whether it passes their bars).
2. build: compile every kernel library from kernels/csrc/ (nvcc, sm_90a), one
   nvcc per library, all started together; ptxas registers and spills; the
   tensor-core instructions in each attention kernel's SASS (``cuobjdump
   --dump-sass``), which every kernel with products (the forward; the f32
   backward's dK/dV + dQ-partial kernel; the bf16 backward's dK/dV and dQ
   kernels) must have: TF32 HMMA.1688 in the f32 libraries (3xTF32), HGMMA
   (wgmma) in the bf16 forward and backward, and no TF32 HMMA in either bf16
   library;
   and the fused multiply-adds (FFMA) in the raster library's kernels, of
   which the raster kernel must have none.
3. kernel vs plain, attention: the CUDA attention kernel against its plain
   PyTorch version on the card, f32 and bf16, at the pose and face
   denoisers' shapes (Dh 64 and 128), the face cond-encoder's 1998 x 1998,
   and a small ragged masked case, on the model's layout (q, k, v the
   head-split views of [B, T, H*Dh] projections); max abs error, the time of
   each, the time of ``scaled_dot_product_attention`` with the same mask (a
   yardstick only), the cluster split the kernel took, and two bounds: the
   CUDA-core one (f32 FLOPs over 67 TFLOP/s; bf16 over the tensor cores'
   989) against bytes over the HBM rate, and for f32 the 3xTF32 one (three
   TF32 products per f32 product: FLOPs over 495/3 TFLOP/s).
4. kernel vs plain, raster: the tile rasterizer against its plain version at
   the full image (1024x667) on the mesh_density=10 synthetic mesh (9,322
   faces) posed by random poses and projected by the synthetic rig's two
   cameras (render/assets.py:synthetic_rig, the body about 800 rows tall), at
   frame batch 2 and 8 (the main path's), on the mesh_density=30 mesh (85,562
   faces) at frame batch 2, on a small ragged case with degenerate and
   depth-tied faces, and on a crowded tile (2,000 faces in one 16x16 tile, a
   face over every tile, corners at +-1e30); face ids and coverage equal,
   depth / UV / barycentrics within 1e-5, a rerun bit-identical.  Then the
   85,562-face mesh at frame batch 8 and frame batch 16, 24 and 32 (each
   frame equal to the batch-8 result for its pose), kernel alone.  Every row
   has the bound (the function's (pixel, face) tests: each face's bbox
   widened by one pixel, clipped to the image, ``bound_tests``), and, from one
   more kernel call, the tests its worklists listed (``listed_tests``) and
   its scratch bytes.
5. slice parity: a full-width pose denoiser from ``--seed``, encode + cached
   CFG + DDIM-5 from one numpy x_T, on the card (with the kernel) against the
   CPU (plain attention), within 1e-3; then the same for the full-width face
   denoiser (latent 512, 8 layers, 4 heads, with its lip regressor and
   rotary cond-encoder) on 20 s of audio at the face guidance 10.0, within
   1e-4 of its output's largest magnitude (~300 with random weights).
6. render parity: a full-width BodyAvatar (RendererConfig() defaults) from
   ``--seed``, 1 frame x 2 cameras through render_sequence_multicam, on the
   card (kernels) against the CPU (plain versions): uint8 frames within 1
   count on >= 99.9% of the pixels that either render covers, coverage equal
   on >= 99.99% of all pixels.
7. guide parity: the guide LM at ``GuideConfig()`` (latent 512, 6 layers,
   4 heads, FF 1024, 1024 tokens) from ``--seed`` on 2 clips of 20 s:
   teacher-forced logits over 81 tokens, card against CPU, within 1e-5 of
   their largest magnitude; the VQ decode at ``VQConfig()`` (width 64, 1024
   codes, depth 4) of 20 keyframes, card against CPU, within 1e-5 of its
   scale; the cached decode of 80 tokens equal to the uncached one token
   for token on the card, for the same Gumbel noise.
8. main path: ``apps.generate.generate`` on a synthetic person, the
   full-width face model at DDIM-500, CFG 10.0, 2 samples (attention kernel
   launches counted: the cond-encoder's 2, then 8 layers x 2 attentions x
   500 steps; the lip regressor's share of the encode timed), then the
   full-width pose model at DDIM-500, CFG 2.0, 2 samples, on keyframes that
   the full-width guide and VQ (random weights from ``--seed``, saved as
   checkpoint directories) sample from the audio: 20 keyframes x depth 4 =
   80 tokens a clip by cached nucleus sampling (top-p 0.94), every token in
   range, the keyframes [2, 20, 104], finite and not the dataset's (8 x 2 x
   500 attention launches); the guide's keyframing once more under
   torch.profiler (device busy, launches a token); after each model, 5 more
   DDIM steps of it, timed alone
   and then under torch.profiler (device busy, launches, attention and GEMM
   ms per step); then sample 0's first 64 frames with the face model's codes
   of the same audio rendered at full width by ``load_body_renderer`` +
   ``render_full_video``: frame batch 8, the 2 rig cameras, the
   mesh_density=10 assets (raster and display kernel launches counted: 8
   batches x 2 cameras each).  Then the display kernel against its plain
   version on the render's own tensors (frame batch 8, 2048^2) and on a
   ragged H 200 x W 2047 case: >= 99.99% of the 8-bit values exact, none
   more than 1 count off, tex_rec bit for bit; times with and without the
   tex_rec output and in the packed mode, the plain version's, the bound.
9. kernel vs plain, attention training: at the pose trainer's shapes (B 64,
   H 4, Tq 600, Tk 600 and 2000, Dh 64), the face width (B 16, Dh 128) and
   the ragged masked causal case, f32 and bf16: the forward with the
   replayed dropout at rate 0.5 against the plain version with the explicit
   mask (f32, so one wrong mask element shows), then at rate 0.1 forward and
   backward through autograd against the plain versions (gradients within
   2e-5 (f32) / 2e-2 (bf16) of the largest plain gradient), the backward run
   twice and compared bit for bit; times of the kernels, the plain versions
   and the backward of ``scaled_dot_product_attention`` with the same mask
   at rate 0 (a yardstick only), and the backward's bound (10 B H Tq Tk Dh
   flops, flash.py:266, against bytes; for f32 also over 495/3 TFLOP/s).
10. the same at the face trainer's shapes, f32, dropout 0.1: B 64, H 4,
   Dh 128, Tq = Tk = 1998 (the cond-encoder), Tq 600 x Tk 2000 (the
   decoder's cross-attention) and Tq = Tk = 600 (the decoder's
   self-attention): the mask exact at B 64 (rate 0.5 against the plain
   version run a few batch rows at a time), forward and gradients against
   the plain versions at B 16 for 1998 x 1998 (the plain [B, H, Tq, Tk]
   temporaries do not fit at B 64) and B 64 for the decoder's two shapes;
   times at B 64 (kernels, SDPA) and at the plain batch (plain versions);
   the backward's peak memory and its dQ-partial scratch.
11. train parity: a full-width pose model from ``--seed``, one deterministic
   step at batch 4 with fixed t and noise, on the card (kernels) against the
   CPU (plain versions): loss 1e-5 relative, every gradient within 1e-4 of
   its largest element, params after the AdamW step within 2 lr and 99.9%
   within 1e-6.
12. feature cache: the trainers' synthetic person (12 scenes of ~60 s, 6 in
   the train split); the full-width face model's frozen wav2vec frontend and
   lip regressor run once over the train split on the card
   (``data/feature_cache.py``): scene 0 against the same build on the CPU
   within 1e-5 of the scale (features, lip vertices, both silence vectors),
   a 600-frame crop from frame 303 against the live frontend on that crop
   (cosine > 0.99, median interior relative error < 0.05 over the entries
   nonzero in either); MB, seconds.
13. face train parity: phase 11 for the full-width face model at batch 4 on
   cached features and lip vertices (18 attention launches each way).
14. main path, training: ``apps.train_diffusion.train`` at the reference's
   pose operating point (DenoiserConfig() widths, flash attention and hash
   dropout, batch 64, AdamW lr 1e-4, cond_drop_prob 0.2, the loader's
   fastdata reads) for 4 steps on raw audio through the frozen wav2vec
   frontend, then 4 steps on the feature cache (attention launches counted
   in each: 8 layers x 2 attentions x 4 steps, forward and backward); each
   checkpoint sampled by ``generate`` (one DDIM-10 clip); steps/s, the
   batch wait's share, peak memory, and one more step under torch.profiler
   for the device time by kernel.
15. main path, face training: ``train`` at the face operating point (the
   face width, flash attention, hash dropout, f32, batch 64, cached
   features, fastdata reads) for 4 steps: 18 attention launches a step
   each way, losses finite, no skipped step, the checkpoint sampled by a
   face ``generate`` (DDIM-10); steps/s, the batch wait's share, the cache
   build, peak memory, the host batch's MB and assembly time, and the
   device's idle share of a profiled step.

16. main path, bf16 generate (after 8): the face and pose models saved with
   ``dtype`` and ``frontend_dtype`` bfloat16, as train() writes them at the
   JAX package's training point; ``generate`` loads them with the frontend
   in f32 and samples in bf16: face DDIM-500 CFG 10.0, pose on the guide's
   keyframes DDIM-500 CFG 2.0, 2 clips of 20 s; every attention launch the
   bf16 kernel's (none of the f32 one); 5 more DDIM steps of each timed and
   profiled.
17. bf16 kernels: ``flash_attn_fwd_bf16.cu`` (wgmma, TMA) and
   ``flash_attn_bwd_bf16.cu`` (warp-specialised wgmma, TMA) at the shapes of
   the bf16 paths (generate B4 600 x 2000 and 600 x 600 at Dh 64 and 128,
   the cond-encoder B2 1998 x 1998; train B64 at Dh 64 and 128, dropout
   0.1), on the model's strided views: forward and gradients within 1e-2 of
   the largest plain output / gradient (the plain versions round where the
   TPU kernel rounds), the mask exact at rate 0.5 (q = 0 and one-hot v: each
   output counts kept keys), the backward twice bit for bit; wrapper, CUDA
   graph, plain and SDPA (rate 0) times, the kernels at rate 0 as well (like
   for like with SDPA), bounds at 989 TFLOP/s, the backward's scratch.
18. bf16 slice parity: the full-width pose and face models in bf16 (f32
   weights from ``--seed``), encode + cached CFG + DDIM-5, on the card
   against the CPU in bf16 and in f32: err(card bf16 vs CPU f32) <= 1.5
   err(CPU bf16 vs CPU f32) + 1e-3 scale.
19. bf16 train parity: one full-width step at batch 4, pose on raw audio
   through the bf16 frontend and face on cached features, card bf16 against
   CPU bf16 and CPU f32, at weight seeds ``--seed`` and ``--seed`` + 1: loss
   1e-2 relative, each gradient tensor by the ratio bar on its relative L2
   error, params after AdamW within 2 lr, except an element whose bf16
   gradient took the other sign on the card, which may land 2 lr plus one
   ulp of the parameter away when |g| of the CPU's f32 step there lies
   below the largest error the ratio rule admits in its tensor (each such
   element printed); parameters and AdamW state f32; the card's step once
   more with cuBLAS's bf16 reduced-precision reduction off, as a witness of
   that flag.
20. main path, bf16 training: ``train()`` at the JAX package's training point
   (BENCH_r05.json ``train_config``: bf16 compute and frontend, the feature
   cache, flash attention, hash dropout) for the pose and the face width,
   batch 64, 4 steps; steps/s, the batch wait, peak memory, the bf16
   cache's size and build, device ms by kernel (attention, GEMMs, the int64
   masks) from one profiled step; each checkpoint sampled.
21. VQ train parity: one step of the codec at ``VQConfig()`` (width 64,
   1024 codes, depth 4), batch 32 x 20 keyframes, k-means (10 iterations)
   firing in it, card against CPU with the same rows drawn: loss 1e-5
   relative, codes equal or each differing one a near-tie of its two best
   distances (counted), codebooks 1e-5 of their scale, gradients 1e-4 of
   their largest element.
22. guide train parity: one guide step at ``GuideConfig()`` (latent 512, 6
   layers), batch 32 x 240 frames (798 audio tokens, 32 tokens a clip), raw
   audio and cached features, card against CPU, dropout off and the
   conditioning dropout injected, the CPU step on the card's leaky ReLU
   slopes (as in 24): the f32 train-parity bars on every gradient, the
   flips the CPU's own pre-activations would take at most 1e-6 of the
   slopes.
23. main path, VQ and guide training: ``train_vq`` at the JAX CLI's point
   (batch 32) for 4 steps with evaluate and ``ckpt_best`` at the last, then
   ``train_guide`` on that VQ (batch 32, 240 frames) raw and cached, 4
   steps each; steps/s, device ms, idle and launches of a profiled step;
   then ``generate`` of phase 8's pose model from the trained guide and VQ
   (2 clips, DDIM-50): the keyframes are the trained VQ's decode of the
   sampled tokens.
24. avatar train parity: a full-width BodyAvatar (``RendererConfig()``,
   ``n_cameras`` 4, random weights and calibration from ``--seed``), one
   step at frame batch 2 (the identity camera among its cameras), the
   posterior noise one numpy draw on both sides: the card step's raster
   (the kernel) equal to ``rasterize_reference`` on the same inputs (face
   ids and coverage; depth and UV within 1e-5); the CPU step, fed the
   card's raster outputs, within 1e-5 relative on each loss part, 1e-4 of
   each gradient's largest element, params after AdamW within 2 lr and
   99.9% within 1e-6, the identity camera's calibration unmoved bit for
   bit; the coverage flips the CPU's own vertices would give, printed; the
   leaky ReLU slopes the CPU's own pre-activations would flip (the CPU step
   replays the card's), at most 1e-6 of them.
25. main path, avatar training: a full-width renderer bundle (``n_cameras``
   4, synthetic assets at mesh_density 10) and 3 .npz batches of 4 frames,
   each frame with its own camera of a 4-camera rig, the targets rendered
   by a second random avatar, AO random; ``apps.train_avatar.train`` for 5
   steps, resumed to 6 (one raster launch a step, no other kernel); one
   frame x 4 cameras through ``load_body_renderer`` before and after (the
   trained bundle renders its trained weights); steps/s over steps 2-4,
   peak memory, first and last loss, one more step profiled (device ms of
   the raster, the convolutions and GEMMs, the grid sampler's backward, the
   rest; launches, idle share).
26. checkpoint conversion: a reference-layout tree written from random
   full-width modules (pose denoiser, guide, VQ; ``args.json``, ``"net"``,
   ``"model_state_dict"``, 1998 null rows, reference-only keys) and a
   person's avatar (a reference-layout ``static_assets.pt`` at UV 1024 /
   2048, a ``body_dec.ckpt`` of a random full-width avatar with a trained
   AutoEncoder's calibration and asset buffers beside it), converted by
   ``convert_person``; ``generate`` from the converted dirs equals
   ``generate`` from the source modules' dirs bit for bit (2 clips,
   DDIM-50, same seed), and the converted avatar's bundle renders one frame
   on the card bit for bit as the source avatar does (both on cuDNN's
   deterministic algorithms).

27. main path, demo server: ``apps.demo.DemoPipeline`` on phase 8's
   full-width face and pose models (the guide and VQ as the pose dir's
   ``guide/`` and ``vq/``) and renderer bundle (2 cameras) answers three
   requests at DDIM-100 (8 s mono at 16 kHz, 8 s stereo at 44.1 kHz, 12 s
   mono at 48 kHz), the first rendered to a video, then a fourth (8 s mono at 16
   kHz) to a pipeline on phase 16's bf16 checkpoints, not rendered: per
   request the wall, face and pose DDIM, guide, ``audio_s_per_wall_s``,
   render and frames/s (with and without the video's write), each kernel's
   launches (the attention forward 2 + 16 x 100 + 16 x 100 a request, the
   raster and the display pass one a frame batch and camera); one DDIM-100
   step of each model profiled (device ms, idle share, launches).
28. demo parity: ``DemoPipeline.generate`` on the card against the CPU at
   full width, DDIM-5, one 4 s request at 16 kHz, the same x_T and
   keyframes injected: face within 1e-4 and pose within 1e-3 of the
   output's largest magnitude, the audio bit for bit.
29. samplers: PLMS-10 and ancestral-10 with the full-width pose model
   (cached CFG 2.0, one 20 s clip), card against CPU, the same x_T and step
   noise: within 1e-3.
30. remat: the full-width face model in training mode (hash dropout 0.1,
   guidance drop 0.2), one step at batch 4 with and without
   ``DenoiserConfig.remat``, f32 and bf16: gradients within 1e-6 of each
   tensor's largest element (bit-equal printed), the decoder's forward
   launches doubled, the backward's unchanged; then the face point at batch
   64, 4 steps each way, f32 and bf16: steps/s over steps 2-4, peak GB.
31. data parallel (``parallel/``): two ranks, NCCL with a card each when
   two cards are visible, else gloo with both on cuda:0 (NCCL refuses two
   ranks on one card; the steps still run on the card), spawned and joined
   through a file store; the backend, world size and card count printed
   first.  (a) Two steps of each case on each rank's rows of the global
   batch against the same steps on the whole batch in this process: pose
   f32 (``DenoiserConfig()``, raw audio, hash dropout 0.1, batch 8), pose
   bf16 (cached, batch 8: the ratio rule against the same step in f32),
   the VQ (``VQConfig()``, batch 32: k-means in the first step, the EMA in
   both), the guide (``GuideConfig()``, cached, batch 32, its Bernoulli
   dropout) and the avatar (``RendererConfig(n_cameras=4)``, frame batch
   4); the 1-process guide and avatar replay the ranks' leaky ReLU slopes,
   the avatar their rasters (as 22 and 24 replay the card's): the train-parity bars on the first step,
   the codebooks within 1e-5 of their scale, the ranks' parameters and
   buffers bit-equal after both steps, each rank's attention and raster
   launches.  The VQ step in a 1-rank NCCL group here, held to the
   ungrouped step by the same bars, and NCCL's all-reduce of a buffer the
   size of the pose model's gradients timed.  (b) ``train()``
   through the trainer's distributed flags at the JAX training point (bf16
   pose, cached, global batch 64), 4 steps, then resumed to 6: steps/s,
   one more step profiled on each rank (device ms, idle), the gradients'
   all-reduce timed, one log, one event file and one checkpoint (only the
   coordinator writes).  (c) phase 8's renderer bundle on two devices (two
   replicas on cuda:0 with one card) against one device, 16 frames, both
   rendering 4 frames a call: within 1 count (against one device at frame
   batch 8 printed: cuDNN's algorithms, and their rounding, move with the
   batch).

32. render bf16 parity (after 6): the full-width avatar of 6 (1 frame x 2
   cameras) in f32 and inside ``render_compute_dtype(torch.bfloat16)`` on
   the card and on the CPU: each camera's tex_rec and the geometry by the
   bf16 ratio bar (card bf16 against CPU f32, against CPU bf16 against CPU
   f32), the card's bf16 render through the display kernel's bf16
   instantiation; the uint8 frames card bf16 against CPU bf16, printed.
33. main path, bf16 render (after 8): 8's renderer bundle, 64 frames x 2
   cameras at frame batch 8, in f32 and in bf16 on the same weights:
   frames/s, launches (raster, and the display instantiation of the
   dtype), peak GB, one batch profiled (decode_frame and the views apart,
   device ms by kernel group: convs, cuDNN's layout transposes, raster,
   display); then the bf16 display instantiation against its plain version
   (B8 3 x 2048^2 of the render's own bf16 tensors, and the ragged H 200 x
   W 2047 case; packed and planar, tex_rec bit for bit, the display bar;
   ms, bound at 3.35 TB/s).
34. sequence-sharded frontend (``parallel/seq_shard.py``, after 31): two
   ranks laid out as 31's, the full-width vq-wav2vec extractor on a 60 s
   clip at 16 kHz (960,000 samples, 5,998 frames), each rank one window,
   the group norms' moments summed over the ranks: within 1e-5 of scale of
   the 1-process extractor on the card; both walls, each rank's peak GB.

Then the wall seconds of each phase, one line with every kernel's numbers
(the raster's launches by path: the render, the demo, the avatar trainer
and the data-parallel paths; the f32 attention rows' bound
there is the 3xTF32 one, the arithmetic they do; the bf16 rows at the pose
trainer's B64 600 x 2000 Dh 64 shape), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Work files go to build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "audio2photoreal_tpu_torch"
WORK = os.path.join(ROOT, "build", "chip_smoke")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # kernel vs plain, unit-normal inputs
SLICE_TOL = 1e-3  # card vs CPU pred_xstart after DDIM-5
# the face slice's bar, relative to its output's largest magnitude: the random
# full-width face model at guidance 10 puts pred_xstart at a scale of ~300
# (random lip vertices of scale ~18 feed its conditioning), where f32 rounding
# alone differs by more than the pose slice's absolute 1e-3
FACE_SLICE_REL_TOL = 1e-4
RASTER_TOL = 1e-5  # depth / UV / barycentrics, kernel vs plain
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by input
# type, f32 on the CUDA cores and bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
# "tf32x3": the f32 attention kernels' products as three TF32 tensor-core
# products each (attn_common.cuh), so 495 TFLOP/s of TF32 buys a third of that
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
RASTER_FLOPS_PER_TEST = 17  # csrc/raster.cu: 9 mul + 8 add/sub per (pixel, face) test
# (B, H, Tq, Tk, Dh, masked): self- and cross-attention of the pose and the
# face denoiser under CFG with 2 samples, the face cond-encoder's
# self-attention over the 1998 audio tokens of 2 samples, and a ragged
# kv_valid + causal case
KERNEL_CASES = [
    (4, 4, 600, 600, 64, False),
    (4, 4, 600, 2000, 64, False),
    (4, 4, 600, 600, 128, False),
    (4, 4, 600, 2000, 128, False),
    (2, 4, 1998, 1998, 128, False),
    (2, 3, 77, 203, 64, True),
]
MAIN_CASE = (4, 4, 600, 2000, 64, False)  # the kernel's numbers in the summary line
RENDER_FRAMES, RENDER_BATCH = 64, 8
FACE_GUIDANCE = 10.0  # the reference's face guidance (bench.py:142-160)
# display kernel vs plain: >= 99.99% of the 8-bit channel values exact, none
# more than one count off (powf against torch.pow may cross a .5)
DISPLAY_EXACT_SHARE, DISPLAY_MAX_COUNT = 0.9999, 1
DISPLAY_FLOPS_PER_VALUE = 24  # csrc/display_pack.cu: f32 operations per channel texel, powf as one
# (B, H, Tq, Tk, Dh, masked): the pose trainer's self- and cross-attention at
# batch 64, the face width, and a ragged kv_valid + causal case
TRAIN_KERNEL_CASES = [
    (64, 4, 600, 600, 64, False),
    (64, 4, 600, 2000, 64, False),
    (16, 4, 600, 2000, 128, False),
    (2, 3, 77, 203, 64, True),
]
TRAIN_MAIN_CASE = (64, 4, 600, 2000, 64, False)  # the backward's numbers in the summary line
# (B, H, Tq, Tk, Dh, plain_B): the face trainer's attention at batch 64, f32 with
# dropout 0.1 (its cond-encoder's self-attention over the 1998 audio tokens, the
# decoder's cross-attention to them and the two t-tokens, the decoder's
# self-attention); the plain versions, whose [B, H, Tq, Tk] temporaries do not fit
# at B64 for 1998 x 1998, run at plain_B
TRAIN_FACE_KERNEL_CASES = [(64, 4, 1998, 1998, 128, 16), (64, 4, 600, 2000, 128, 64),
                           (64, 4, 600, 600, 128, 64)]
# the trainers' synthetic person: 12 scenes of 1790 frames (~60 s) each, 6 of them
# in the train split (2 val, 4 test held out); 1790 frames make 5963 tokens, three
# 2000-token cache segments, the last one partial, and 15 lip chunks, the last padded
# the bf16 kernels at the shapes of the bf16 paths: (B, H, Tq, Tk, Dh, dropout,
# batch of the plain versions); generate at CFG batch 2 clips x 2 branches
BF16_KERNEL_CASES = [
    (4, 4, 600, 2000, 64, 0.0, 4), (4, 4, 600, 600, 64, 0.0, 4),  # pose generate: cross, self
    (4, 4, 600, 2000, 128, 0.0, 4), (4, 4, 600, 600, 128, 0.0, 4),  # face generate
    (2, 4, 1998, 1998, 128, 0.0, 2),  # the face cond-encoder, once a clip
    (64, 4, 600, 2000, 64, 0.1, 64), (64, 4, 600, 600, 64, 0.1, 64),  # pose train
    (64, 4, 600, 2000, 128, 0.1, 64), (64, 4, 600, 600, 128, 0.1, 64),  # face train: the decoder
    (64, 4, 1998, 1998, 128, 0.1, 16),  # face train: the cond-encoder
]
BF16_MAIN_CASE = (64, 4, 600, 2000, 64)  # the bf16 kernels' numbers in the summary line
BF16_TOL = 1e-2  # bf16 kernel vs plain, of the largest plain output / gradient
# the card in bf16 no less accurate than the CPU in bf16, both against the CPU in f32:
# err(card bf16) <= BF16_RATIO err(CPU bf16) + BF16_SLACK scale
BF16_RATIO, BF16_SLACK = 1.5, 1e-3
TRAIN_PERSON = dict(num_scenes=12, frames_per_scene=1790)
CACHE_REL_TOL = 1e-5  # the feature cache, card vs CPU, of its largest magnitude
# a cached crop against the live frontend on that crop (the JAX package's bar,
# tests/test_feature_cache.py): the group norm spans the cache's segment; the
# median runs over the entries that are nonzero in either (the last layer ends
# in a ReLU, so about half of them are zero in both)
CACHE_CROP_COS, CACHE_CROP_MEDIAN_REL = 0.99, 0.05
CACHE_CROP = (303, 600)  # (start frame, frames) of that crop in scene 0: from mid-scene
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # of the largest plain gradient
TRAIN_DROPOUT = 0.1
TRAIN_STEPS, TRAIN_BATCH = 4, 64
LR = 1e-4
GUIDE_REL_TOL = 1e-5  # guide logits and VQ decode, card vs CPU, of the largest magnitude
FACE_WIDTH = dict(data_format="face", nfeats=256, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
                  flash_attention=True)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         # cuBLAS may reduce bf16 split-K partials in bf16; the port leaves the default
         matmul_allow_bf16_reduced_precision_reduction=(
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build() -> None:
    from audio2photoreal_tpu_torch.kernels import build, display_pack, flash_attn, raster

    libraries = [(flash_attn.NAME, flash_attn.SOURCES, flash_attn.library),
                 (flash_attn.BWD_NAME, flash_attn.BWD_SOURCES, flash_attn.bwd_library),
                 (flash_attn.BF16_NAME, flash_attn.BF16_SOURCES, flash_attn.bf16_library),
                 (flash_attn.BF16_BWD_NAME, flash_attn.BF16_BWD_SOURCES, flash_attn.bf16_bwd_library),
                 (raster.NAME, raster.SOURCES, raster.library),
                 (display_pack.NAME, display_pack.SOURCES, display_pack.library)]

    def one(lib):
        name, sources, load = lib
        path = build.library_path(name, sources)
        cached = path.exists()
        t0 = time.perf_counter()
        load()
        return name, path, cached, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        results = list(pool.map(one, libraries))
    wall = time.perf_counter() - t0
    for name, path, cached, seconds in results:
        log = path.with_suffix(".log").read_text()
        ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        emit("build", kernel=name, library=os.path.relpath(path, ROOT), already_built=cached,
             seconds=seconds, all_builds_wall_s=wall, ptxas=ptxas)


def _sass_counts(lib: str, op: str) -> dict:
    """{kernel (mangled): instructions matching the regex ``op``} in a built
    library's SASS."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "--dump-sass", lib],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(op, line):
            counts[name] += 1
    return counts


def _sass_ops(lib: str, op: str) -> dict:
    """{kernel (mangled): Counter of the distinct instructions matching the
    regex ``op``} in a built library's SASS."""
    import re
    from collections import Counter

    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "--dump-sass", lib],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    ops, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = Counter()
        elif name:
            ops[name].update(re.findall(op, line))
    return ops


def phase_sass() -> None:
    """The tensor-core instructions in each attention kernel: every kernel
    with products must have some (the forward; the f32 backward's dK/dV
    kernel, which also forms the dQ partials; the bf16 backward's dK/dV and
    dQ kernels); the f32 backward's delta and dQ-sum kernels and the bf16
    backward's rows kernel are reductions.  The f32 kernels' are TF32 HMMA
    (3xTF32); every bf16 product kernel's must be HGMMA (wgmma), and neither
    bf16 library may hold a TF32 HMMA.  The raster
    kernel must have no fused f32 multiply-add (FFMA): its face ids equal the
    plain version's only because every product and sum rounds on its own.
    (The setup kernel's 1/det is a correctly rounded division, whose Newton
    steps are FFMAs.)"""
    from audio2photoreal_tpu_torch.kernels import build, flash_attn, raster

    kinds = ("attn_fwd_bf16_kernel", "attn_fwd_kernel", "attn_bwd_bf16_dkdv_kernel", "attn_bwd_dkdv_kernel",
             "attn_bwd_bf16_dq_kernel", "attn_bwd_dq_kernel", "attn_bwd_bf16_rows_kernel", "attn_bwd_delta_kernel")
    reductions = ("attn_bwd_dq_kernel", "attn_bwd_bf16_rows_kernel", "attn_bwd_delta_kernel")
    # library -> the tensor-core opcode (a prefix) each of its product kernels must hold
    wanted = {flash_attn.NAME: "HMMA.1688.F32.TF32", flash_attn.BWD_NAME: "HMMA.1688.F32.TF32",
              flash_attn.BF16_NAME: "HGMMA.", flash_attn.BF16_BWD_NAME: "HGMMA."}
    sources = {flash_attn.NAME: flash_attn.SOURCES, flash_attn.BWD_NAME: flash_attn.BWD_SOURCES,
               flash_attn.BF16_NAME: flash_attn.BF16_SOURCES, flash_attn.BF16_BWD_NAME: flash_attn.BF16_BWD_SOURCES}
    for name, op in wanted.items():
        ops = _sass_ops(str(build.library_path(name, sources[name])), r"\bH(?:G)?MMA\.\S+")
        rows = {}
        for fn, found in ops.items():
            kind = next((k for k in kinds if k in fn), fn)
            dh = "128" if "Li128E" in fn else "64" if "Li64E" in fn else "?"
            rows[f"{kind}<{dh}{', dropout' if 'Lb1E' in fn else ''}>"] = dict(found)
        emit("sass", library=name, wanted=op, tensor_core_instructions=rows)
        products = {k: r for k, r in rows.items() if not k.startswith(reductions)}
        missing = [k for k, r in products.items() if not any(o.startswith(op) for o in r)]
        if missing or not products:
            raise AssertionError(f"{name}: no {op} in {missing or 'any kernel'}: {rows}")
        if name in (flash_attn.BF16_NAME, flash_attn.BF16_BWD_NAME) and any(
                "TF32" in o for r in rows.values() for o in r):
            raise AssertionError(f"{name}: a bf16 kernel holds TF32 HMMA: {rows}")
    counts = _sass_counts(str(build.library_path(raster.NAME, raster.SOURCES)), r"\bFFMA\b")
    rows = {next((k for k in ("raster_setup_kernel", "raster_scan_kernel", "raster_fill_kernel", "raster_kernel")
                  if k in fn), fn): n for fn, n in counts.items()}
    emit("sass", library=raster.NAME, ffma_instructions=rows)
    if rows.get("raster_kernel", 1) != 0:
        raise AssertionError(f"{raster.NAME}: raster_kernel has fused multiply-adds or is missing: {rows}")


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """ms per replay of one call of ``fn`` captured in a CUDA graph: the
    card's time for the call without the host's per-launch work.  A call
    that synchronised with the host could not be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(graph.replay, iters=iters)
    del graph
    return ms


def _bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the card's peak rate for the inputs' type."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOP_PER_S[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _split_heads(x, H: int):
    """[B, T, H*Dh] -> the model's strided [B, H, T, Dh] view (blocks.py:_split)."""
    return x.unflatten(-1, (H, -1)).transpose(1, 2)


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_reference
    from audio2photoreal_tpu_torch.ops.attention import causal_bias, padding_bias

    from audio2photoreal_tpu_torch.kernels import flash_attn
    from audio2photoreal_tpu_torch.kernels.flash_attn import fwd_split

    g = torch.Generator(device="cuda").manual_seed(seed)
    summary = {}
    for B, H, Tq, Tk, Dh, masked in KERNEL_CASES:
        # the model's layout: q from its projection, k and v slices of one stacked projection
        q = _split_heads(torch.randn((B, Tq, H * Dh), generator=g, device="cuda"), H)
        kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device="cuda")
        k, v = _split_heads(kv[..., : H * Dh], H), _split_heads(kv[..., H * Dh :], H)
        kv_valid = None
        if masked:  # the last keys of every batch row but the last are masked
            lengths = torch.tensor([Tk - 50 * (B - 1 - b) for b in range(B)], device="cuda")
            kv_valid = (torch.arange(Tk, device="cuda")[None] < lengths[:, None]).float()
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            args = (qd, kd, vd, kv_valid, masked)
            got = flash_attention(*args)
            want = flash_attention_reference(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).replace("torch.", "")
            # the library call with the same additive mask, as a yardstick
            mask = None
            if masked:
                mask = (padding_bias(kv_valid) + causal_bias(Tq, Tk, device="cuda")).to(dtype)
            lib = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
            lib_err = (lib().float() - want.float()).abs().max().item()
            # in turns: plain, kernel, kernel, plain
            p1 = _time_ms(lambda: flash_attention_reference(*args))
            k1 = _time_ms(lambda: flash_attention(*args))
            k2 = _time_ms(lambda: flash_attention(*args))
            p2 = _time_ms(lambda: flash_attention_reference(*args))
            l1 = _time_ms(lib)
            item = qd.element_size()
            nbytes = item * (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) + (4 * B * Tk if masked else 0)
            flops = 4.0 * B * H * Tq * Tk * Dh
            bound_ms, bound_by = _bound(nbytes, flops, name)
            bound_tc_ms, bound_tc_by = _bound(nbytes, flops, "tf32x3") if name == "float32" else (None, None)
            row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, kv_valid_causal=masked, dtype=name,
                       layout="strided views of [B, T, H*Dh]", split=fwd_split(B, H, Tq, Tk, Dh, dtype),
                       max_abs_err=err, tol=TOL[name], ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       library_ms=l1, library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
                       bound_tc_ms=bound_tc_ms, bound_tc_by=bound_tc_by)
            emit("kernel_vs_plain", kernel=flash_attn.BF16_NAME if name == "bfloat16" else flash_attn.NAME, **row)
            if not err <= TOL[name]:
                raise AssertionError(f"flash_attn_fwd disagrees with its plain version: {row}")
            if (B, H, Tq, Tk, Dh, masked) == MAIN_CASE and name == "float32":
                summary = row
    return summary


def _raster_inputs(assets, cams, motion):
    """[B = poses x cameras] projected vertices of the LBS-posed template."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.render.geometry import project_points

    verts = assets.lbs.pose(None, motion)  # [P, V, 3]
    pix, dep = [], []
    for c in cams.values():
        K = torch.as_tensor(np.asarray(c.K), device=verts.device)[None].expand(len(verts), 3, 3)
        Rt = torch.as_tensor(np.asarray(c.Rt), device=verts.device)[None].expand(len(verts), 3, 4)
        p, d = project_points(verts, K, Rt)
        pix.append(p)
        dep.append(d)
    # frame order: pose-major, camera-minor
    return torch.stack(pix, 1).flatten(0, 1).contiguous(), torch.stack(dep, 1).flatten(0, 1).contiguous()


def _raster_cost(pix, dep, faces, face_uv, H, W, emit_barys):
    """(bytes, flops, tests) of the function on these inputs: vertices, faces
    and corner UVs read once, every output plane written once; 17 f32
    operations per (pixel, face) test the function needs: the pixels of each
    face's bbox widened by one pixel and clipped to the image, the window
    where the plain version evaluates it.  Faces with |det| <= 1e-12, a
    non-finite corner or no pixel in the image need none."""
    import torch

    tri = pix[:, faces.long()]  # [B, F, 3, 2]
    xs, ys = tri[..., 0], tri[..., 1]
    det = (ys[..., 1] - ys[..., 2]) * (xs[..., 0] - xs[..., 2]) + (xs[..., 2] - xs[..., 1]) * (ys[..., 0] - ys[..., 2])
    lo_x, hi_x, lo_y, hi_y = xs.amin(-1), xs.amax(-1), ys.amin(-1), ys.amax(-1)
    need = ((det.abs() > 1e-12) & torch.isfinite(xs).all(-1) & torch.isfinite(ys).all(-1)
            & (hi_x >= 0) & (lo_x <= W - 1) & (hi_y >= 0) & (lo_y <= H - 1))
    span = lambda lo, hi, n: (hi.ceil() + 1).clamp(0, n - 1) - (lo.floor() - 1).clamp(0, n - 1) + 1  # noqa: E731
    window = span(lo_x, hi_x, W).double() * span(lo_y, hi_y, H).double()
    tests = float(torch.where(need, window, torch.zeros_like(window)).sum())
    B = pix.shape[0]
    per_pixel = 4 + 4 + (8 if face_uv is not None else 0) + (12 if emit_barys else 0)
    inputs = pix.numel() * 4 + dep.numel() * 4 + faces.numel() * faces.element_size()
    inputs += face_uv.numel() * 4 if face_uv is not None else 0
    return inputs + B * H * W * per_pixel, tests * RASTER_FLOPS_PER_TEST, tests


def _listed_tests(buf, B, F, H, W) -> float:
    """The (pixel, face) tests one kernel call listed: every in-image pixel of
    every tile of each face's rectangle, as the setup kernel wrote it into
    the call's scratch ``buf`` (a large face is tested at the tiles of its
    rectangle too)."""
    import torch

    from audio2photoreal_tpu_torch.kernels import raster

    g = raster.layout(B, F, H, W)
    r = raster.scratch_views(buf, B, F, H, W).rect.long()  # [B, F, 4]; (0, -1, 0, -1) where no tile

    def pixels_before(n, size):  # pixels in the image before tile k, k = 0..n
        per_tile = torch.clamp(size - torch.arange(n, device=buf.device) * g.tile, max=g.tile)
        return torch.cat([per_tile.new_zeros(1), per_tile.cumsum(0)])

    cx, cy = pixels_before(g.ntx, W), pixels_before(g.nty, H)
    reach = r[..., 0] <= r[..., 1]
    px = cx[(r[..., 1] + 1).clamp_min(0)] - cx[r[..., 0]]
    py = cy[(r[..., 3] + 1).clamp_min(0)] - cy[r[..., 2]]
    return float((px * py * reach).sum())


def _raster_compare(got, want) -> dict:
    import torch

    cov = want.face_index >= 0
    out = dict(ids_equal=bool(torch.equal(got.face_index, want.face_index)),
               coverage_equal=bool(torch.equal(got.face_index >= 0, cov)),
               covered_share=float(cov.float().mean()))
    errs = [(got.depth[cov] - want.depth[cov]).abs().max().item() if cov.any() else 0.0]
    for name in ("uv", "barys"):
        a, b = getattr(got, name), getattr(want, name)
        if a is not None and b is not None:
            errs.append((a - b).abs().max().item())
    out["max_abs_err"] = max(errs)
    out["ok"] = out["ids_equal"] and out["coverage_equal"] and out["max_abs_err"] <= RASTER_TOL
    return out


def _ragged_case(device):
    """Odd H and W, random faces partly off screen, a duplicated face and a
    face at the same places (exact depth ties), collinear and behind-camera
    faces."""
    import numpy as np
    import torch

    rng = np.random.RandomState(5)
    H, W = 61, 77
    pix = (rng.rand(2, 40, 2) * [W + 20, H + 20] - 10).astype(np.float32)
    dep = (rng.rand(2, 40) * 4 + 0.5).astype(np.float32)
    pix[:, 30:33] = [[3, 4], [50, 9], [20, 45]]
    pix[:, 33] = pix[:, 30]
    pix[:, 34:37] = [[10, 10], [20, 20], [40, 40]]
    dep[:, 30:37] = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    dep[:, 37:40] = -2.0
    faces = rng.randint(0, 30, (300, 3))
    faces[10] = faces[20] = [30, 31, 32]
    faces[15] = [33, 31, 32]
    faces[25] = [34, 35, 36]
    faces[26] = [37, 38, 39]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    face_uv = t(rng.rand(300, 3, 2).astype(np.float32))
    return t(pix), t(dep), t(faces.astype(np.int64)), face_uv, H, W


def crowded_tile_arrays(n_faces: int = 2000):
    """(pix, dep, faces, face_uv, H, W) in numpy: n_faces tiny faces in tile
    (1, 1) of a 48 x 48 image (more faces than one shared-memory stage
    holds), one face over every tile behind them, and faces with corners at
    +-1e30 or entirely off screen; frame 1 lists the triangles the other way
    round."""
    import numpy as np

    rng = np.random.RandomState(12)
    corner = rng.rand(n_faces, 1, 2) * 14 + 16.5
    tris = np.concatenate([
        corner + rng.rand(n_faces, 3, 2) * 3 - 1.5,
        [[[-100, -100], [200, -100], [-100, 200]],
         [[10, 10], [1e30, 12], [12, 30]], [[-1e30, -1e30], [20, 5], [5, 20]],
         [[1e30, 1e30], [2e30, 1e30], [1e30, 3e30]], [[-500, 10], [-300, 20], [-400, 40]]],
    ]).astype(np.float32)
    pix = np.stack([tris.reshape(-1, 2), tris[::-1].reshape(-1, 2)])
    dep = (rng.rand(2, pix.shape[1]) * 4 + 0.5).astype(np.float32)
    dep[:, 3 * n_faces:3 * n_faces + 3] = 9.0
    faces = np.arange(pix.shape[1]).reshape(-1, 3)
    face_uv = rng.rand(len(faces), 3, 2).astype(np.float32)
    return pix, dep, faces.astype(np.int64), face_uv, 48, 48


def _crowded_case(device):
    import torch

    pix, dep, faces, face_uv, H, W = crowded_tile_arrays()
    return (*(torch.from_numpy(a).to(device) for a in (pix, dep, faces, face_uv)), H, W)


def _raster_numbers(pix, dep, fc, fuv, h, w, barys) -> dict:
    """The bound of the function on these inputs, and the tests and scratch
    bytes of one more kernel call on them."""
    from audio2photoreal_tpu_torch.kernels import raster

    nbytes, flops, tests = _raster_cost(pix, dep, fc, fuv, h, w, barys)
    bound_ms, bound_by = _bound(nbytes, flops)
    _, buf = raster._launch(pix, dep, fc, h, w, fuv, barys)
    return dict(bound_ms=bound_ms, bound_by=bound_by, bound_tests=tests, bytes=nbytes,
                listed_tests=_listed_tests(buf, pix.shape[0], fc.shape[0], h, w), scratch_bytes=buf.numel())


def phase_raster(seed: int) -> dict:
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.kernels import raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    cfg = RendererConfig()
    H, W = cfg.image_height, cfg.image_width
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10).to("cuda")
    geo = assets.geo
    faces, face_uv = geo.faces, geo.uv_coords[geo.uv_faces].contiguous()
    cams = synthetic_rig((0.0, 0.0, 1.0), H, W)
    rng = np.random.RandomState(seed)
    motion = torch.from_numpy((rng.randn(4, 104) * 0.3).astype(np.float32)).to("cuda")
    pix8, dep8 = _raster_inputs(assets, cams, motion)  # [8, V, 2]: 4 poses x 2 cameras
    # the mesh_density=30 body (85,562 faces) in the same poses; its UV atlas
    # size does not reach the raster
    dense = make_synthetic_assets(RendererConfig(uv_size=256, upscale_size=512), seed=seed,
                                  mesh_density=30).to("cuda")
    dfaces, dface_uv = dense.geo.faces, dense.geo.uv_coords[dense.geo.uv_faces].contiguous()
    dpix8, ddep8 = _raster_inputs(dense, cams, motion)

    summary = {}
    ragged, crowded = _ragged_case("cuda"), _crowded_case("cuda")
    cases = [("ragged_ties", *ragged[:4], ragged[4], ragged[5], True),
             ("crowded_tile", *crowded, True),
             ("full_b2", pix8[:2], dep8[:2], faces, face_uv, H, W, True),
             ("full_b8", pix8, dep8, faces, face_uv, H, W, False),
             ("full_b2_dense", dpix8[:2], ddep8[:2], dfaces, dface_uv, H, W, False)]
    results = {}
    for name, pix, dep, fc, fuv, h, w, barys in cases:
        got = raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)
        want = raster.rasterize_reference(pix, dep, fc, h, w, fuv, emit_barys=barys)
        again = raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)
        torch.cuda.synchronize()
        cmp = _raster_compare(got, want)
        cmp["rerun_identical"] = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        cmp["ok"] = cmp["ok"] and cmp["rerun_identical"]
        results[name] = got
        B = pix.shape[0]
        call = lambda: raster.rasterize_cuda(pix, dep, fc, h, w, fuv, emit_barys=barys)  # noqa: E731
        plain = lambda: raster.rasterize_reference(pix, dep, fc, h, w, fuv, emit_barys=barys)  # noqa: E731
        # the plain version, warmed up by the comparison above, is slow (up to
        # 11 s a call) and 4-5 orders of magnitude from the kernel: one timed call
        p1 = _time_ms(plain, iters=1, warmup=0)
        k1 = _time_ms(call)
        k2 = _time_ms(call)
        row = dict(case=name, B=B, H=h, W=w, faces=int(fc.shape[0]), emit_barys=barys, **cmp,
                   tol=RASTER_TOL, ms=(k1 + k2) / 2, graph_ms=_graph_ms(call), plain_ms=p1,
                   library_ms=None, **_raster_numbers(pix, dep, fc, fuv, h, w, barys))
        emit("kernel_vs_plain", kernel=raster.NAME, **row)
        if not cmp["ok"]:
            raise AssertionError(f"{raster.NAME} disagrees with its plain version: {row}")
        if name == "full_b8":
            summary = row
    # the dense mesh at the main path's frame batch, kernel alone
    call = lambda: raster.rasterize_cuda(dpix8, ddep8, dfaces, H, W, dface_uv, emit_barys=False)  # noqa: E731
    emit("raster_alone", case="full_b8_dense", B=8, H=H, W=W, faces=int(dfaces.shape[0]), ms=_time_ms(call),
         graph_ms=_graph_ms(call), **_raster_numbers(dpix8, ddep8, dfaces, dface_uv, H, W, False))
    # frame batches the TPU kernel could not run, kernel alone: frame i is pose i % 8
    ref = results["full_b8"]
    for B in (16, 24, 32):
        idx = torch.arange(B, device="cuda") % 8
        pb, db = pix8[idx], dep8[idx]
        call = lambda: raster.rasterize_cuda(pb, db, faces, H, W, face_uv, emit_barys=False)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got, k), getattr(ref, k)[idx]) for k in ("face_index", "depth", "uv"))
        ms = _time_ms(call, iters=10)
        emit("raster_batch", B=B, H=H, W=W, frames_equal_batch8=same, ms=ms, ms_per_frame=ms / B,
             graph_ms=_graph_ms(call, iters=10), **_raster_numbers(pb, db, faces, face_uv, H, W, False))
        if not same:
            raise AssertionError(f"frame batch {B}: frames differ from the batch-8 result")
    return summary


def _pose_model(seed: int, **overrides):
    import torch

    from audio2photoreal_tpu_torch.core.config import DenoiserConfig
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    cfg = DenoiserConfig(data_format="pose", flash_attention=True, **overrides)
    model = FiLMDenoiser(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, model.eval()


def _face_model(seed: int, **overrides):
    """The face denoiser at the reference's face width: latent 512, 8
    layers, 4 heads (Dh 128), FF 1024, 256-d codes, with its lip regressor
    (wav2vec_large) and rotary cond-encoder; random weights from ``seed``."""
    import torch

    from audio2photoreal_tpu_torch.core.config import DenoiserConfig
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    cfg = DenoiserConfig(**{**FACE_WIDTH, **overrides})
    model = FiLMDenoiser(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, model.eval()


def phase_face_slice_parity(seed: int) -> None:
    """The full-width face model, card (kernels) against CPU (plain
    versions): encode 20 s of audio (wav2vec, lip regressor, cond-encoder),
    then cached CFG at the face guidance and DDIM-5 from one numpy x_T."""
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    cfg, model_cpu = _face_model(seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    rng = np.random.RandomState(seed + 3)
    B, T = 1, cfg.max_seq_length
    audio = rng.randn(B, T * 1600, 2).astype(np.float32)  # z-normed 48 kHz stereo
    x_T = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    sched = maybe_respaced("cosine", 1000, "ddim5")

    def run(model, device):
        with torch.no_grad():
            a = torch.from_numpy(audio).to(device)
            lip = model.lip_vertices(a)
            cond = model.encode_conditioning(a, lip_verts=lip)
            model_fn = cfg_model_fn_cached(model, cond, FACE_GUIDANCE)
            res = ddim_sample_loop(sched, "xstart", model_fn, torch.from_numpy(x_T).to(device))
        return lip.cpu().numpy(), cond.cond_tokens.cpu().numpy(), res.pred_xstart.cpu().numpy()

    before = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    gpu = run(model_gpu, "cuda")
    gpu_s = time.perf_counter() - t0
    launches = launch_counts[flash_attn.NAME] - before
    t0 = time.perf_counter()
    cpu = run(model_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    errs = [float(np.abs(g - c).max()) for g, c in zip(gpu, cpu)]
    scales = [float(np.abs(c).max()) for c in cpu]
    want_launches = cfg.cond_encoder_layers + cfg.num_layers * 2 * 5
    row = dict(steps=5, guidance=FACE_GUIDANCE, batch=B, latent=cfg.latent_dim, layers=cfg.num_layers,
               heads=cfg.num_heads, lip_max_abs_err=errs[0], lip_scale=scales[0],
               cond_tokens_max_abs_err=errs[1], cond_tokens_scale=scales[1], max_abs_err=errs[2],
               pred_scale=scales[2], rel_err=errs[2] / scales[2], rel_tol=FACE_SLICE_REL_TOL,
               kernel_launches=launches, expected_launches=want_launches,
               gpu_s=gpu_s, cpu_s=cpu_s, finite=bool(np.isfinite(gpu[2]).all()))
    emit("face_slice_parity", **row)
    if not (row["finite"] and row["rel_err"] <= FACE_SLICE_REL_TOL and launches == want_launches):
        raise AssertionError(f"card and CPU disagree on the face slice: {row}")


def phase_slice_parity(seed: int) -> None:
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    cfg, model_cpu = _pose_model(seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    rng = np.random.RandomState(seed)
    B, T = 1, cfg.max_seq_length
    inputs = [
        rng.randn(B, T * 1600, 2).astype(np.float32),  # z-normed 48 kHz stereo
        rng.randn(B, -(-T // cfg.keyframe_step), cfg.key_feature_dim).astype(np.float32),
        np.ones((B, -(-T // cfg.keyframe_step)), np.float32),
    ]
    x_T = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    sched = maybe_respaced("cosine", 1000, "ddim5")

    def run(model, device):
        audio, kf, kv = (torch.from_numpy(a).to(device) for a in inputs)
        with torch.no_grad():
            cond = model.encode_conditioning(audio, kf, kv)
            model_fn = cfg_model_fn_cached(model, cond, 2.0)
            res = ddim_sample_loop(sched, "xstart", model_fn, torch.from_numpy(x_T).to(device))
        return res.pred_xstart.cpu().numpy()

    before = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    gpu = run(model_gpu, "cuda")
    gpu_s = time.perf_counter() - t0
    launches = launch_counts[flash_attn.NAME] - before
    t0 = time.perf_counter()
    cpu = run(model_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu - cpu).max())
    row = dict(steps=5, guidance=2.0, batch=B, latent=cfg.latent_dim, layers=cfg.num_layers,
               max_abs_err=err, pred_scale=float(np.abs(cpu).max()), tol=SLICE_TOL, kernel_launches=launches,
               gpu_s=gpu_s, cpu_s=cpu_s, finite=bool(np.isfinite(gpu).all()))
    emit("slice_parity", **row)
    if not (row["finite"] and err <= SLICE_TOL and launches == cfg.num_layers * 2 * 5):
        raise AssertionError(f"card and CPU disagree on the pose slice: {row}")


def _avatar_state_dict(cfg, assets, seed: int):
    import torch

    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar

    model = BodyAvatar(cfg, assets)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.state_dict()


def phase_render_parity(seed: int) -> None:
    import numpy as np

    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    cfg = RendererConfig()
    t0 = time.perf_counter()
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10)
    sd = _avatar_state_dict(cfg, assets, seed)
    setup_s = time.perf_counter() - t0
    cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width)
    rng = np.random.RandomState(seed + 1)
    pose = (rng.randn(1, 104) * 0.3).astype(np.float32)
    face = (rng.randn(1, 256) * 0.3).astype(np.float32)
    out, secs = {}, {}
    for device in ("cuda", "cpu"):
        r = BodyRenderer(cfg, assets, sd, cams, frame_batch=1, device=device)
        t0 = time.perf_counter()
        out[device] = r.render_sequence_multicam(pose, face)
        secs[device] = time.perf_counter() - t0
        del r
    gpu, cpu = out["cuda"].astype(np.int32), out["cpu"].astype(np.int32)
    diff = np.abs(gpu - cpu)
    # coverage: a pixel is covered where a render is not background; the
    # 1-count share is read over the pixels that either render covers
    cov_g, cov_c = gpu.any(-1), cpu.any(-1)
    within = diff.max(-1) <= 1
    either = cov_g | cov_c
    row = dict(frames=1, cameras=2, shape=list(out["cuda"].shape), uv=cfg.uv_size, upscale=cfg.upscale_size,
               face_tex=cfg.face_tex_size, image=[cfg.image_height, cfg.image_width],
               within_1_count_covered=float(within[either].mean()) if either.any() else 0.0,
               within_1_count_all=float(within.mean()), max_count_diff=int(diff.max()),
               coverage_gpu=float(cov_g.mean()), coverage_cpu=float(cov_c.mean()),
               coverage_agree=float((cov_g == cov_c).mean()), setup_s=setup_s,
               gpu_s=secs["cuda"], cpu_s=secs["cpu"], cut=None)
    emit("render_parity", **row)
    if not (row["within_1_count_covered"] >= 0.999 and row["coverage_agree"] >= 0.9999
            and 0.02 <= row["coverage_gpu"] <= 0.9):
        raise AssertionError(f"card and CPU disagree on the render: {row}")


def _display_inputs(model, decoded, cams, frames: int):
    """The display pass's inputs on the render's own tensors: the raw 2048^2
    texture of the first camera, the seam-resampled shadow, the texture mean
    and std, as ``render_view`` hands them to the kernel."""
    import numpy as np
    import torch

    c = next(iter(cams.values()))
    campos = torch.as_tensor(np.asarray(c.campos), device="cuda")[None].expand(frames, 3)
    with torch.no_grad():
        view = model.decoder_view(decoded["geom"], decoded["tex_mean_rec"], campos, model.assets.geo)
        tex = model.upscale_tex(decoded["tex_mean_rec"], view["tex_view_rec"])
    return tex, decoded["shadow_seamed"], model.assets.tex_mean, model.assets.tex_std


def _display_compare(args) -> dict:
    """Kernel against plain: 8-bit values (planar and packed), tex_rec bit
    for bit, times of each mode and of the plain version, and the bound."""
    import torch

    from audio2photoreal_tpu_torch.kernels import display_pack

    tex = args[0]
    B, _, H, W = tex.shape
    got, rec = display_pack.finalize_display(*args)
    packed = display_pack.finalize_display_packed(*args)
    want, want_rec = display_pack.finalize_display_reference(*args)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    out = dict(B=B, H=H, W=W, exact_share=float((diff == 0).float().mean()), max_count_diff=int(diff.max()),
               max_abs_err=float(diff.max()), tex_rec_equal=bool(torch.equal(rec, want_rec)),
               packed_equal_planar=bool(torch.equal(packed, display_pack.pack_rgb8(got))),
               exact_bar=DISPLAY_EXACT_SHARE, count_bar=DISPLAY_MAX_COUNT)
    del got, rec, packed, want, want_rec, diff
    plain = lambda: display_pack.finalize_display_reference(*args)  # noqa: E731
    kern = lambda: display_pack.finalize_display(*args)  # noqa: E731
    # in turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = _time_ms(plain), _time_ms(kern), _time_ms(kern), _time_ms(plain)
    n = H * W
    values = B * 3 * n
    e = tex.element_size()  # tex, shadow and tex_rec in the texture's type; the mean and display f32
    read_bytes = e * (values + B * n) + 4 * 3 * n
    planar_bytes = read_bytes + 4 * values + e * values  # display and tex_rec written
    bound_ms, bound_by = _bound(planar_bytes, DISPLAY_FLOPS_PER_VALUE * values)
    out.update(dtype=str(tex.dtype).replace("torch.", ""), ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by, bytes=planar_bytes)
    # the same kernel without the tex_rec output, and in the packed mode
    out["no_tex_rec_ms"] = _time_ms(lambda: display_pack.finalize_display(*args, with_tex_rec=False))
    out["no_tex_rec_bound_ms"] = _bound(planar_bytes - e * values, DISPLAY_FLOPS_PER_VALUE * values)[0]
    out["packed_ms"] = _time_ms(lambda: display_pack.finalize_display_packed(*args))
    out["packed_bound_ms"] = _bound(read_bytes + 4 * B * n, DISPLAY_FLOPS_PER_VALUE * values)[0]
    out["ok"] = (out["exact_share"] >= DISPLAY_EXACT_SHARE and out["max_count_diff"] <= DISPLAY_MAX_COUNT
                 and out["tex_rec_equal"] and out["packed_equal_planar"])
    return out


def _render_views(renderer, pose, face, dtype):
    """decode_frame + one render_view a rig camera inside
    ``render_compute_dtype(dtype)``, as ``render_sequence_multicam`` runs
    them -> (uint8 frames [B, H, n*W, 3], geometry f32, tex_rec of each
    camera as f32), numpy."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.render.layers import render_compute_dtype

    m, dev, B = renderer.model, renderer.device, pose.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    with torch.no_grad(), render_compute_dtype(dtype):
        d = m.decode_frame(t(pose), face_embs=t(face), embs=renderer._template_embs[0].expand(B, -1), encode=False)
        views = [m.render_view(d, renderer._tensor(c.campos, B, dev), renderer._tensor(c.K, B, dev),
                               renderer._tensor(c.Rt, B, dev), render_display=True)
                 for c in renderer.cameras.values()]
    frames = torch.cat([v["rgb"] for v in views], dim=2).to(torch.uint8).cpu().numpy()
    return frames, d["geom"].float().cpu().numpy(), [v["tex_rec"].float().cpu().numpy() for v in views]


def phase_render_bf16_parity(seed: int) -> None:
    """The full-width avatar of ``phase_render_parity`` (1 frame x 2
    cameras) in f32 and in bf16 (``render_compute_dtype``) on the card and
    on the CPU: each camera's tex_rec and the geometry by the bf16 ratio
    bar, err(card bf16 vs CPU f32) <= 1.5 err(CPU bf16 vs CPU f32) + 1e-3
    scale; the card's bf16 render through the bf16 display instantiation
    (one launch a camera, none of the f32 one); the uint8 frames' share
    within one count and their largest difference, card bf16 against CPU
    bf16, printed."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer
    from audio2photoreal_tpu_torch.kernels import display_pack, launch_counts, raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    cfg = RendererConfig()
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10)
    sd = _avatar_state_dict(cfg, assets, seed)
    cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width)
    rng = np.random.RandomState(seed + 1)
    pose = (rng.randn(1, 104) * 0.3).astype(np.float32)
    face = (rng.randn(1, 256) * 0.3).astype(np.float32)
    out, secs, launches = {}, {}, {}
    for device in ("cuda", "cpu"):
        r = BodyRenderer(cfg, assets, sd, cams, frame_batch=1, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            key = (device, str(dtype).replace("torch.", ""))
            launch_counts.clear()
            t0 = time.perf_counter()
            out[key] = _render_views(r, pose, face, dtype)
            secs[key] = time.perf_counter() - t0
            launches[key] = {k: launch_counts[k] for k in (raster.NAME, display_pack.NAME, display_pack.BF16_NAME)}
        del r

    def ratio(pick):
        card, cpu16, cpu32 = (pick(out[k]) for k in (("cuda", "bfloat16"), ("cpu", "bfloat16"), ("cpu", "float32")))
        scale = float(np.abs(cpu32).max())
        e_card, e_cpu = float(np.abs(card - cpu32).max()), float(np.abs(cpu16 - cpu32).max())
        e32 = float(np.abs(pick(out[("cuda", "float32")]) - cpu32).max())
        return dict(err_card_bf16=e_card, err_cpu_bf16=e_cpu, err_card_f32=e32, scale=scale,
                    bar=BF16_RATIO * e_cpu + BF16_SLACK * scale, ok=e_card <= BF16_RATIO * e_cpu + BF16_SLACK * scale)

    rows = {"geom": ratio(lambda o: o[1])}
    rows.update({f"tex_rec_cam{i}": ratio(lambda o, i=i: o[2][i]) for i in range(len(cams))})
    card, cpu = out[("cuda", "bfloat16")][0].astype(np.int32), out[("cpu", "bfloat16")][0].astype(np.int32)
    diff = np.abs(card - cpu).max(-1)
    covered = card.any(-1) | cpu.any(-1)
    per_cam = len(cams)
    checks = {name: row["ok"] for name, row in rows.items()}
    checks.update(
        card_bf16_launched_the_bf16_display=launches[("cuda", "bfloat16")] == {
            raster.NAME: per_cam, display_pack.NAME: 0, display_pack.BF16_NAME: per_cam},
        card_f32_launched_the_f32_display=launches[("cuda", "float32")] == {
            raster.NAME: per_cam, display_pack.NAME: per_cam, display_pack.BF16_NAME: 0},
        cpu_launched_nothing=all(sum(launches[("cpu", d)].values()) == 0 for d in ("float32", "bfloat16")))
    emit("render_bf16_parity", frames=1, cameras=per_cam, uv=cfg.uv_size, upscale=cfg.upscale_size,
         image=[cfg.image_height, cfg.image_width], **rows,
         frames_within_1_count_covered_card_vs_cpu_bf16=float((diff <= 1)[covered].mean()) if covered.any() else 0.0,
         frames_max_count_diff_card_vs_cpu_bf16=int(diff.max()),
         coverage_agree_card_vs_cpu_bf16=float((card.any(-1) == cpu.any(-1)).mean()),
         seconds={f"{d}_{t}": s for (d, t), s in secs.items()},
         launches={f"{d}_{t}": n for (d, t), n in launches.items()}, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the card's bf16 render fails the bf16 bar: {checks}")


RENDER_GROUPS = (  # kernel-name words (lowercase) of each group, first match wins
    ("raster", ("raster",)),
    ("display", ("display_pack",)),
    ("cudnn_transposes", ("transpose", "nchwtonhwc", "nhwctonchw")),
    ("convs", ("conv", "implicit_gemm", "cudnn", "xmma", "wgrad", "dgrad", "fprop", "gemm", "winograd", "fft",
               "sm90_")),
)


def _profile_groups(fn) -> dict:
    """``fn`` once under torch.profiler -> device ms by kernel group
    (``RENDER_GROUPS``, the rest "other"), launches, wall ms and the top
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
    total = sum(per.values())
    if total == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    groups = {name: 0.0 for name, _ in RENDER_GROUPS}
    groups["other"] = 0.0
    for k, v in per.items():
        name = next((g for g, words in RENDER_GROUPS if any(w in k.lower() for w in words)), "other")
        groups[name] += v
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_ms=wall_ms, device_ms=total, device_idle_share=1.0 - total / wall_ms, launches=launches,
                ms_by_group=groups, top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_main_path_render_bf16(seed: int, smi: str) -> dict:
    """Phase 8's renderer bundle (full width, 2 cameras, frame batch 8)
    through ``render_sequence_multicam`` on 64 frames, in f32 and then
    inside ``render_compute_dtype(torch.bfloat16)`` on the same weights,
    each after one warm-up batch: frames/s, launches (the raster and the
    display instantiation of each dtype, one a frame batch and camera),
    peak GB; one more batch of each profiled, decode_frame and the two
    views apart (device ms by kernel group: convs, cuDNN's layout
    transposes, raster, display); the frames' share within one count of
    the f32 render, printed.  Then the bf16 display instantiation against
    its plain version on the render's own bf16 tensors (frame batch 8,
    2048^2) and on the ragged H 200 x W 2047 case."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, launch_counts, raster
    from audio2photoreal_tpu_torch.render.layers import render_compute_dtype

    renderer = load_body_renderer(os.path.join(WORK, "renderer"), frame_batch=RENDER_BATCH, device="cuda")
    m, fb, n = renderer.model, RENDER_BATCH, RENDER_FRAMES
    rng = np.random.RandomState(seed + 5)
    pose = (rng.randn(n, 104) * 0.05).astype(np.float32)
    face = (rng.randn(n, 256) * 0.05).astype(np.float32)
    per_view = (n // fb) * len(renderer.cameras)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # its start-up, outside the readings
        torch.ones(1 << 20, device="cuda").sum()
        torch.cuda.synchronize()
    runs, frames = {}, {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        with render_compute_dtype(dtype):
            renderer.render_sequence_multicam(pose[:fb], face[:fb])  # warm-up: cuDNN's plans for this dtype
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launch_counts.clear()
            t0 = time.perf_counter()
            frames[name] = renderer.render_sequence_multicam(pose, face)
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
            launches = {k: launch_counts[k] for k in (raster.NAME, display_pack.NAME, display_pack.BF16_NAME,
                                                      flash_attn.NAME, flash_attn.BF16_NAME)}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            motion = torch.from_numpy(pose[:fb]).cuda()
            codes = torch.from_numpy(face[:fb]).cuda()
            embs = renderer._template_embs[0].expand(fb, -1)
            with torch.no_grad():
                held = {}
                decode = _profile_groups(lambda: held.update(
                    d=m.decode_frame(motion, face_embs=codes, embs=embs, encode=False)))
                views = _profile_groups(lambda: [
                    m.render_view(held["d"], renderer._tensor(c.campos, fb, "cuda"), renderer._tensor(c.K, fb, "cuda"),
                                  renderer._tensor(c.Rt, fb, "cuda"), render_display=True)
                    for c in renderer.cameras.values()])
                tex_dtype = str(held["d"]["tex_mean_rec"].dtype).replace("torch.", "")
                del held
        runs[name] = dict(render_s=render_s, frames_per_s=n / render_s, launches=launches, peak_gb=peak_gb,
                          texture_dtype=tex_dtype, decode_frame_profile=decode, views_profile=views)
    diff = np.abs(frames["bfloat16"].astype(np.int32) - frames["float32"].astype(np.int32)).max(-1)
    covered = frames["float32"].any(-1)
    checks = {
        "frames_shape": all(list(f.shape) == [n, m.cfg.image_height, 2 * m.cfg.image_width, 3]
                            and f.dtype == np.uint8 for f in frames.values()),
        "bf16_texture": runs["bfloat16"]["texture_dtype"] == "bfloat16" and runs["float32"]["texture_dtype"] == "float32",
        "f32_launches": runs["float32"]["launches"] == {raster.NAME: per_view, display_pack.NAME: per_view,
                                                        display_pack.BF16_NAME: 0, flash_attn.NAME: 0,
                                                        flash_attn.BF16_NAME: 0},
        "bf16_launches": runs["bfloat16"]["launches"] == {raster.NAME: per_view, display_pack.NAME: 0,
                                                          display_pack.BF16_NAME: per_view, flash_attn.NAME: 0,
                                                          flash_attn.BF16_NAME: 0},
        "coverage_in_range": bool(0.02 <= covered.mean() <= 0.9),
    }
    emit("main_path_render_bf16", nvidia_smi=smi, frames=n, frame_batch=fb, cameras=len(renderer.cameras),
         uv=m.cfg.uv_size, upscale=m.cfg.upscale_size, image=[m.cfg.image_height, m.cfg.image_width],
         faces=int(m.assets.geo.faces.shape[0]), **runs,
         bf16_over_f32_frames_per_s=runs["bfloat16"]["frames_per_s"] / runs["float32"]["frames_per_s"],
         frames_within_1_count_of_f32_covered=float((diff <= 1)[covered].mean()),
         frames_max_count_diff_vs_f32=int(diff.max()), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (bf16 render) checks failed: {checks}")

    # the bf16 display instantiation against its plain version, on the render's own bf16 tensors
    with torch.no_grad(), render_compute_dtype(torch.bfloat16):
        decoded = m.decode_frame(torch.from_numpy(pose[:fb]).cuda(), face_embs=torch.from_numpy(face[:fb]).cuda(),
                                 embs=renderer._template_embs[0].expand(fb, -1), encode=False)
        args = _display_inputs(m, decoded, renderer.cameras, fb)
    del decoded
    summary = _display_compare(args)
    emit("kernel_vs_plain", kernel=display_pack.BF16_NAME, case="render_b8", **summary)
    g = torch.Generator(device="cuda").manual_seed(seed)
    ragged = ((torch.randn((3, 3, 200, 2047), generator=g, device="cuda") * 0.3).to(torch.bfloat16),
              torch.rand((3, 1, 200, 2047), generator=g, device="cuda").to(torch.bfloat16),
              torch.rand((3, 200, 2047), generator=g, device="cuda") * 200.0, 35.0)
    row = _display_compare(ragged)
    emit("kernel_vs_plain", kernel=display_pack.BF16_NAME, case="ragged_h200_w2047", **row)
    for r in (summary, row):
        if not (r["ok"] and r["dtype"] == "bfloat16"):
            raise AssertionError(f"{display_pack.BF16_NAME} disagrees with its plain version: {r}")
    return {"launches": {name: r["launches"] for name, r in runs.items()}, "display": summary}


def _guide_models(seed: int):
    """The guide LM at ``GuideConfig()`` and the VQ codec at ``VQConfig()``'s
    widths, random weights from ``seed`` (the codebooks he-uniform, as the
    JAX package's ``VQState.create`` draws them with ``kmeans_init=False``),
    eval mode."""
    import torch

    from audio2photoreal_tpu_torch.core.config import GuideConfig, VQConfig
    from audio2photoreal_tpu_torch.models.guide import GuideTransformer
    from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec

    guide = GuideTransformer(GuideConfig())
    guide.reset_parameters(torch.Generator().manual_seed(seed))
    codec = TemporalVertexCodec(VQConfig(kmeans_init=False))
    codec.reset_parameters(torch.Generator().manual_seed(seed + 1))
    return guide.eval(), codec.eval()


def _guide_dirs(seed: int) -> tuple:
    """``_guide_models`` saved as the checkpoint directories ``generate
    --resume_trans / --resume_vq`` read (``config.json`` + ``model.pt``)."""
    import torch

    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE
    from audio2photoreal_tpu_torch.core.config import save_config

    guide, codec = _guide_models(seed)
    dirs = os.path.join(WORK, "guide_model"), os.path.join(WORK, "vq_model")
    for d, model, section in zip(dirs, (guide, codec), (dict(guide=guide.cfg), dict(vq=codec.cfg))):
        save_config(d, **section)
        torch.save(model.state_dict(), os.path.join(d, MODEL_FILE))
    return dirs


def phase_guide_parity(seed: int) -> None:
    """The full-width guide and VQ, card against CPU (phase 7 of the head
    note); the cached decode against the uncached one on the card."""
    import copy

    import numpy as np
    import torch

    guide_cpu, codec_cpu = _guide_models(seed)
    guide_gpu, codec_gpu = copy.deepcopy(guide_cpu).cuda(), copy.deepcopy(codec_cpu).cuda()
    rng = np.random.RandomState(seed + 5)
    B, frames, n_kf = 2, 600, 20
    depth, vocab = codec_cpu.cfg.depth, guide_cpu.cfg.tokens
    audio = torch.from_numpy(rng.randn(B, frames * 1600, 2).astype(np.float32))
    tokens = torch.from_numpy(rng.randint(0, vocab, (B, n_kf * depth + 1)))
    tokens[:, 0] = guide_cpu.start_token
    codes = torch.from_numpy(rng.randint(0, vocab, (B, n_kf, depth)))

    def logits(model, device):
        with torch.no_grad():
            cond = model.encode_conditioning(audio.to(device))
            return cond.cond_tokens.shape[1], model.decode_logits(tokens.to(device), cond).cpu().numpy()

    t0 = time.perf_counter()
    n_cond, got = logits(guide_gpu, "cuda")
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, want = logits(guide_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        kf_gpu = codec_gpu.decode(codes.cuda()).cpu().numpy()
        kf_cpu = codec_cpu.decode(codes).numpy()
    decoded, walls = {}, {}
    for use_cache in (True, False):
        g = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoded[use_cache] = guide_gpu.generate(audio.cuda(), n_kf * depth, g, 0.94, use_cache).cpu().numpy()
        walls[use_cache] = time.perf_counter() - t0
    scale, kf_scale = float(np.abs(want).max()), float(np.abs(kf_cpu).max())
    row = dict(batch=B, seconds=frames / 30, cond_tokens=n_cond, decoded_tokens=n_kf * depth,
               latent=guide_cpu.cfg.latent_dim, layers=guide_cpu.cfg.num_layers, heads=guide_cpu.cfg.num_heads,
               vocab=vocab, logits_max_abs_err=float(np.abs(got - want).max()), logits_scale=scale,
               vq_max_abs_err=float(np.abs(kf_gpu - kf_cpu).max()), vq_scale=kf_scale, rel_tol=GUIDE_REL_TOL,
               cached_equals_uncached=bool(np.array_equal(decoded[True], decoded[False])),
               tokens_in_range=bool(((decoded[True] >= 0) & (decoded[True] < vocab)).all()),
               cached_generate_s=walls[True], uncached_generate_s=walls[False], gpu_s=gpu_s, cpu_s=cpu_s,
               finite=bool(np.isfinite(got).all() and np.isfinite(kf_gpu).all()))
    emit("guide_parity", **row)
    if not (row["finite"] and row["cached_equals_uncached"] and row["tokens_in_range"]
            and row["logits_max_abs_err"] <= GUIDE_REL_TOL * scale
            and row["vq_max_abs_err"] <= GUIDE_REL_TOL * kf_scale):
        raise AssertionError(f"the guide disagrees, card against CPU or cached against uncached: {row}")


def _profile_guide(guide_dir: str, vq_dir: str, seed: int, num_keyframes: int = 20) -> dict:
    """One keyframer call (2 clips of 20 s) on models loaded as generate
    loads them, after a warm-up: its wall, then under torch.profiler its
    device-busy time and launches, and the audio encode's launches alone,
    so that the decode's launches a token step are (all - encode) / steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.apps.generate import GuideKeyframer

    keyframer = GuideKeyframer(guide_dir, vq_dir, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    audio = torch.randn((2, 600 * 1600, 2), generator=g, device="cuda")
    steps = num_keyframes * keyframer.codec.cfg.depth
    run = lambda: keyframer(audio, num_keyframes, g)  # noqa: E731
    encode = lambda: keyframer.guide.encode_conditioning(audio)  # noqa: E731

    @torch.no_grad()
    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    call_ms, encode_ms = wall_ms(run), wall_ms(encode)

    def device_events(fn):
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3

    launches, busy_ms = device_events(run)
    encode_launches, encode_busy_ms = device_events(encode)
    if busy_ms == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(guide_call_ms=call_ms, guide_device_ms=busy_ms, guide_idle_share=1.0 - busy_ms / call_ms,
                guide_encode_ms=encode_ms, guide_encode_device_ms=encode_busy_ms,
                guide_device_launches=launches, guide_encode_launches=encode_launches, guide_token_steps=steps,
                guide_launches_per_token_step=(launches - encode_launches) / steps,
                guide_decode_ms_per_token_step=(call_ms - encode_ms) / steps,
                guide_decode_device_ms_per_token_step=(busy_ms - encode_busy_ms) / steps)


def _is_gemm(kernel: str) -> bool:
    """A cuBLAS / cuBLASLt matrix product's kernel, by name (``nvjet_*`` on
    the H100 under CUDA 12.8, ``*gemm*`` / ``*xmma*`` elsewhere)."""
    k = kernel.lower()
    return "gemm" in k or "xmma" in k or k.startswith("nvjet")


def _profile_ddim(model_dir: str, guidance: float, seed: int, steps: int = 5) -> dict:
    """``steps`` DDIM steps of generate's loop (cached CFG, 2 clips of 20 s,
    random z-normed audio) on a model loaded as generate loads it: the wall
    per step without the profiler (after a warm-up loop), then the same loop
    under torch.profiler for the device-busy time, launches and the
    attention kernel's share per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.apps.generate import load_model
    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    model = load_model(model_dir, "cuda")
    c = model.cfg
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, T = 2, c.max_seq_length
    audio = torch.randn((B, T * 1600, 2), generator=g, device="cuda")
    kf = kv = None
    if c.data_format == "pose":
        kf = torch.randn((B, -(-T // c.keyframe_step), c.key_feature_dim), generator=g, device="cuda")
        kv = torch.ones(kf.shape[:2], device="cuda")
    x_T = torch.randn((B, T, c.nfeats), generator=g, device="cuda")
    sched = maybe_respaced("cosine", 1000, f"ddim{steps}")
    with torch.no_grad():
        fn = cfg_model_fn_cached(model, model.encode_conditioning(audio, kf, kv), guidance)
        run = lambda: ddim_sample_loop(sched, "xstart", fn, x_T)  # noqa: E731
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    per = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3 / steps
            launches += e.count
    busy = sum(per.values())
    if busy == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    attn = sum(v for k, v in per.items() if "attn_fwd_" in k)
    gemm = sum(v for k, v in per.items() if _is_gemm(k))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return dict(profiled_steps=steps, step_wall_ms=wall_ms, step_device_ms=busy,
                step_idle_share=1.0 - busy / wall_ms, step_device_launches=launches / steps,
                step_attn_fwd_ms=attn, step_gemm_ms=gemm, step_top_kernels_ms=[[k[:80], v] for k, v in top])


def phase_main_path(seed: int, smi: str) -> dict:
    """The face generate, the pose generate, and the render of the two
    (phase 8 of the head note); the display kernel against its plain
    version on the render's tensors."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, find_stats, generate
    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
    from audio2photoreal_tpu_torch.core.config import DataConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, launch_counts, raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, save_renderer_bundle, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    shutil.rmtree(WORK, ignore_errors=True)
    person, num_samples, steps = "SYNTH01", 2, 500
    t0 = time.perf_counter()
    make_synthetic_person(WORK, person, num_scenes=8, frames_per_scene=600, seed=seed)
    dirs, cfgs = {}, {}
    for fmt, build in (("face", _face_model), ("pose", _pose_model)):
        cfgs[fmt], model = build(seed)
        dirs[fmt] = os.path.join(WORK, f"{fmt}_model")
        save_config(dirs[fmt], denoiser=cfgs[fmt], diffusion=DiffusionConfig(),
                    data=DataConfig(person=person, data_format=fmt, max_seq_length=cfgs[fmt].max_seq_length))
        torch.save(model.state_dict(), os.path.join(dirs[fmt], MODEL_FILE))
        del model
    fcfg, cfg = cfgs["face"], cfgs["pose"]
    guide_dir, vq_dir = _guide_dirs(seed)
    setup_s = time.perf_counter() - t0
    T = cfg.max_seq_length
    audio_s = num_samples * T / 30.0

    # --- face: generate ---------------------------------------------------
    timings: dict = {}
    launch_counts.clear()
    t0 = time.perf_counter()
    face_path = generate(dirs["face"], WORK, num_samples=num_samples, guidance_param=FACE_GUIDANCE,
                         timestep_respacing=f"ddim{steps}", device="cuda", timings=timings)
    face_s = time.perf_counter() - t0
    face_attn = launch_counts[flash_attn.NAME]
    face_res = np.load(face_path, allow_pickle=True).item()
    face_prof = _profile_ddim(dirs["face"], FACE_GUIDANCE, seed)
    face_checks = {
        "motions_shape": list(face_res["motions"].shape) == [num_samples, fcfg.nfeats, 1, T],
        "motions_finite": bool(np.isfinite(face_res["motions"]).all()),
        "keys": sorted(face_res) == ["audio", "gt", "lengths", "motions"],
        # the cond-encoder's self-attentions once, then 8 layers x 2 attentions x 500 steps
        "attention_launches": face_attn == fcfg.cond_encoder_layers + fcfg.num_layers * 2 * steps,
    }
    emit("main_path_face", nvidia_smi=smi, samples=num_samples, ddim_steps=steps, guidance=FACE_GUIDANCE,
         latent=fcfg.latent_dim, layers=fcfg.num_layers, heads=fcfg.num_heads, ff=fcfg.ff_size,
         encode_s=timings["encode_s"], lip_s=timings["lip_s"], ddim_s=timings["ddim_s"],
         ddim_step_ms=1e3 * timings["ddim_s"] / steps, generate_s=face_s, audio_s=audio_s,
         audio_s_per_wall_s=audio_s / face_s, kernel_launches=face_attn,
         motions_shape=list(face_res["motions"].shape), **face_prof, checks=face_checks)
    if not all(face_checks.values()):
        raise AssertionError(f"main path (face) checks failed: {face_checks}")

    # --- pose: generate on the guide's keyframes -----------------------------
    from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
    from audio2photoreal_tpu_torch.models import guide as guide_module

    sampled = []  # the guide's tokens, read from its generate as generate calls it
    guide_generate = guide_module.GuideTransformer.generate

    def recording_generate(self, *args, **kwargs):
        out = guide_generate(self, *args, **kwargs)
        sampled.append(out.cpu().numpy())
        return out

    timings = {}
    launch_counts.clear()
    guide_module.GuideTransformer.generate = recording_generate
    try:
        t0 = time.perf_counter()
        path = generate(dirs["pose"], WORK, num_samples=num_samples, guidance_param=2.0,
                        timestep_respacing=f"ddim{steps}", guide_path=guide_dir, vq_path=vq_dir, device="cuda",
                        timings=timings)
        total_s = time.perf_counter() - t0
    finally:
        guide_module.GuideTransformer.generate = guide_generate
    attn_launches = launch_counts[flash_attn.NAME]

    res = np.load(path, allow_pickle=True).item()
    stats = find_stats(os.path.join(WORK, person))
    ds = SocialDataset(load_local_data(WORK, person), stats,
                       DataConfig(person=person, max_seq_length=T), "test")
    dataset_kf = stats.inv_pose(np.stack([ds.get_chunk(i)["keyframes"] for i in range(num_samples)]))
    n_kf = -(-T // cfg.keyframe_step)
    guide_prof = _profile_guide(guide_dir, vq_dir, seed, n_kf)
    pose_prof = _profile_ddim(dirs["pose"], 2.0, seed)
    tokens = np.concatenate(sampled) if sampled else np.zeros((0, 0), np.int64)
    checks = {
        "motions_shape": list(res["motions"].shape) == [num_samples, cfg.nfeats, 1, T],
        "motions_finite": bool(np.isfinite(res["motions"]).all()),
        "keys": all(k in res for k in ("gt", "audio", "lengths", "keyframes")),
        "attention_launches": attn_launches == cfg.num_layers * 2 * steps,
        # face and pose runs were made from the same audio (sample/generate.py:187-189)
        "face_audio_equal": bool(np.array_equal(face_res["audio"], res["audio"])),
        "guide_tokens_shape": list(tokens.shape) == [num_samples, n_kf * 4],
        "guide_tokens_in_range": tokens.size > 0 and bool(((tokens >= 0) & (tokens < 1024)).all()),
        "keyframes_shape": list(res["keyframes"].shape) == [num_samples, n_kf, cfg.key_feature_dim],
        "keyframes_finite": bool(np.isfinite(res["keyframes"]).all()),
        "keyframes_not_the_datasets": dataset_kf.shape == res["keyframes"].shape
        and not np.allclose(dataset_kf, res["keyframes"], atol=1e-3),
    }
    emit("main_path_generate", nvidia_smi=smi, samples=num_samples, ddim_steps=steps, guidance=2.0,
         latent=cfg.latent_dim, layers=cfg.num_layers, heads=cfg.num_heads, keyframes="guide", top_p=0.94,
         setup_s=setup_s, guide_s=timings["guide_s"], guide_tokens=int(tokens.size),
         guide_tokens_per_s=tokens.size / timings["guide_s"], encode_s=timings["encode_s"], ddim_s=timings["ddim_s"],
         generate_s=total_s, audio_s=audio_s, audio_s_per_wall_s=audio_s / total_s,
         kernel_launches=attn_launches, motions_shape=list(res["motions"].shape),
         keyframes_shape=list(res["keyframes"].shape), **guide_prof, **pose_prof, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (pose) checks failed: {checks}")

    # --- render: a full-width renderer bundle, loaded as a user would --------
    t0 = time.perf_counter()
    rcfg = RendererConfig()
    bundle_assets = make_synthetic_assets(rcfg, seed=seed, mesh_density=10)
    # the rig frames the person where its root stands on average (pose[0:3])
    cams = synthetic_rig(stats.pose_mean[:3] + np.array([0.0, 0.0, 1.0]), rcfg.image_height, rcfg.image_width)
    bundle = save_renderer_bundle(os.path.join(WORK, "renderer"), rcfg,
                                  _avatar_state_dict(rcfg, bundle_assets, seed), cams,
                                  seed=seed, mesh_density=10)
    del bundle_assets
    renderer = load_body_renderer(bundle, frame_batch=RENDER_BATCH, device="cuda")
    render_setup_s = time.perf_counter() - t0
    n = RENDER_FRAMES
    # sample 0's pose and its face model's codes, as generate --plot pairs them
    body = res["motions"][0].transpose(2, 0, 1)[:n, :, 0]
    face = face_res["motions"][0].transpose(2, 0, 1)[:n, :, 0]

    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = renderer.render_sequence_multicam(body, face)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    raster_launches = launch_counts[raster.NAME]
    display_launches = launch_counts[display_pack.NAME]
    render_attn = launch_counts[flash_attn.NAME]
    t0 = time.perf_counter()
    video = renderer.render_full_video(
        {"audio": res["audio"][0][: n * 1600], "body_motion": body, "face_motion": face},
        os.path.join(WORK, "sample00_rep00"))
    video_s = time.perf_counter() - t0
    covered = (frames.reshape(n, rcfg.image_height, 2, rcfg.image_width, 3).any(-1)).mean(axis=(1, 3))
    per_view = (n // RENDER_BATCH) * len(cams)
    checks = {
        "face_codes_from_face_model": face_res["motions"].shape[1] == fcfg.nfeats,
        "frames_shape": list(frames.shape) == [n, rcfg.image_height, 2 * rcfg.image_width, 3],
        "frames_uint8": frames.dtype == np.uint8,
        "coverage_in_range": bool(0.02 <= covered.mean() <= 0.9),
        "raster_launches": raster_launches == per_view,
        "display_pack_launches": display_launches == per_view,
        "no_attention_in_render": render_attn == 0,
        "video_written": os.path.exists(video),
    }
    emit("main_path_render", nvidia_smi=smi, frames=n, frame_batch=RENDER_BATCH, cameras=len(cams),
         uv=rcfg.uv_size, upscale=rcfg.upscale_size, image=[rcfg.image_height, rcfg.image_width],
         faces=int(renderer.model.assets.geo.faces.shape[0]), setup_s=render_setup_s,
         render_s=render_s, frames_per_s=n / render_s, video=os.path.relpath(video, ROOT), video_s=video_s,
         kernel_launches={raster.NAME: raster_launches, display_pack.NAME: display_launches},
         covered_share_mean=float(covered.mean()), covered_share_min=float(covered.min()),
         covered_share_max=float(covered.max()), frames_shape=list(frames.shape), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (render) checks failed: {checks}")

    # --- the display kernel against its plain version, on the render's own
    # tensors (frame batch 8, 2048^2), and on a ragged case
    m = renderer.model
    with torch.no_grad():
        codes = torch.from_numpy(np.ascontiguousarray(face[:RENDER_BATCH])).cuda()
        motion = torch.from_numpy(np.ascontiguousarray(body[:RENDER_BATCH])).cuda()
        decoded = m.decode_frame(motion, face_embs=codes, embs=m.template_body_embs().expand(RENDER_BATCH, -1),
                                 encode=False)
    args = _display_inputs(m, decoded, cams, RENDER_BATCH)
    del decoded
    summary = _display_compare(args)
    emit("kernel_vs_plain", kernel=display_pack.NAME, case="render_b8", **summary)
    g = torch.Generator(device="cuda").manual_seed(seed)
    ragged = (torch.randn((3, 3, 200, 2047), generator=g, device="cuda") * 0.3,
              torch.rand((3, 1, 200, 2047), generator=g, device="cuda"),
              torch.rand((3, 200, 2047), generator=g, device="cuda") * 200.0, 35.0)
    row = _display_compare(ragged)
    emit("kernel_vs_plain", kernel=display_pack.NAME, case="ragged_h200_w2047", **row)
    for r in (summary, row):
        if not r["ok"]:
            raise AssertionError(f"{display_pack.NAME} disagrees with its plain version: {r}")
    return {"face": face_attn, flash_attn.NAME: attn_launches, raster.NAME: raster_launches,
            display_pack.NAME: display_launches, "display": summary}


def _attn_inputs(g, B, H, Tq, Tk, Dh, masked):
    import torch

    q, k, v, do = (torch.randn((B, H, T, Dh), generator=g, device="cuda") for T in (Tq, Tk, Tk, Tq))
    kv_valid = None
    if masked:  # the last keys of every batch row but the last are masked
        lengths = torch.tensor([Tk - 50 * (B - 1 - b) for b in range(B)], device="cuda")
        kv_valid = (torch.arange(Tk, device="cuda")[None] < lengths[:, None]).float()
    return q, k, v, do, kv_valid


def phase_train_kernels(seed: int) -> dict:
    """The dropout forward and the backward kernels against their plain
    versions at the trainer's shapes (phase 9 of the head note)."""
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels.flash_attn import (
        dropout_mask,
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from audio2photoreal_tpu_torch.ops.attention import causal_bias, padding_bias

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    summary = {}
    for B, H, Tq, Tk, Dh, masked in TRAIN_KERNEL_CASES:
        q, k, v, do, kv_valid = _attn_inputs(g, B, H, Tq, Tk, Dh, masked)
        dseed = 1_000_003 + Tq + Tk
        # the mask, exactly: at rate 0.5 in f32 one wrong element moves an
        # output by ~p*v, above the f32 bar
        got = flash_attention(q, k, v, kv_valid, masked, 0.5, dseed)
        want = flash_attention_reference(q, k, v, kv_valid, masked, 0.5, dseed)
        torch.cuda.synchronize()
        mask_err = (got - want).abs().max().item()
        del got, want
        if not mask_err <= TOL["float32"]:
            raise AssertionError(f"the dropout forward disagrees with the explicit mask: {mask_err}")
        # the mask alone: its plain version builds the [B, H, Tq, Tk] multiplier,
        # whose least cost is writing it once; in the kernels it is never stored
        it = dict(iters=5, warmup=1) if B * Tk >= 64 * 2000 else {}
        mask_plain_ms = _time_ms(lambda: dropout_mask(B, H, Tq, Tk, TRAIN_DROPOUT, dseed, None, "cuda"), **it)
        mask_bound_ms = _bound(4.0 * B * H * Tq * Tk, 0.0)[0]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            args = (kv_valid, masked, TRAIN_DROPOUT, dseed)
            qg, kg, vg = (x.clone().requires_grad_() for x in (qd, kd, vd))
            out = flash_attention(qg, kg, vg, *args)
            grads = torch.autograd.grad(out, (qg, kg, vg), dod, retain_graph=True)
            again = torch.autograd.grad(out, (qg, kg, vg), dod, retain_graph=True)
            want_out = flash_attention_reference(qd, kd, vd, *args)
            want = flash_attention_bwd_reference(qd, kd, vd, dod, *args)
            torch.cuda.synchronize()
            fwd_err = (out.detach().float() - want_out.float()).abs().max().item()
            scale = max(w.float().abs().max().item() for w in want)
            err = max((a.float() - w.float()).abs().max().item() for a, w in zip(grads, want))
            identical = all(torch.equal(a, b) for a, b in zip(grads, again))
            del want_out, want, again, grads
            # the library's backward with the same mask at rate 0, as a yardstick
            mask = None
            if masked:
                mask = (padding_bias(kv_valid) + causal_bias(Tq, Tk, device="cuda")).to(dtype)
            ql, kl, vl = (x.clone().requires_grad_() for x in (qd, kd, vd))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
            bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dod, retain_graph=True)  # noqa: E731
            plain = lambda: flash_attention_bwd_reference(qd, kd, vd, dod, *args)  # noqa: E731
            fwd = lambda: flash_attention(qd, kd, vd, *args)  # noqa: E731
            fwd_nodrop = lambda: flash_attention(qd, kd, vd, kv_valid, masked)  # noqa: E731
            fwd_plain = lambda: flash_attention_reference(qd, kd, vd, *args)  # noqa: E731
            lib = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dod, retain_graph=True)  # noqa: E731
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = _time_ms(plain, **it), _time_ms(bwd), _time_ms(bwd), _time_ms(plain, **it)
            fp1, fk1, fk2, fp2 = _time_ms(fwd_plain, **it), _time_ms(fwd), _time_ms(fwd), _time_ms(fwd_plain, **it)
            fn1, fn2 = _time_ms(fwd_nodrop), _time_ms(fwd_nodrop)
            l1 = _time_ms(lib)
            del out, lib_out
            item = qd.element_size()
            # each input read once (q, k, v, dO, O, lse, kv_valid), each gradient written once
            nbytes = (item * (3 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) + 4 * B * H * Tq
                      + item * (B * H * Tq * Dh + 2 * B * H * Tk * Dh) + (4 * B * Tk if masked else 0))
            bound_ms, bound_by = _bound(nbytes, 10.0 * B * H * Tq * Tk * Dh, name)
            bound_tc_ms, bound_tc_by = (_bound(nbytes, 10.0 * B * H * Tq * Tk * Dh, "tf32x3") if name == "float32"
                                        else (None, None))
            row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, kv_valid_causal=masked, dtype=name, dropout=TRAIN_DROPOUT,
                       mask_rate05_max_abs_err=mask_err, fwd_max_abs_err=fwd_err, max_abs_err=err,
                       grad_scale=scale, tol=GRAD_TOL[name] * scale, bitwise_deterministic=identical,
                       ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=l1,
                       fwd_dropout_ms=(fk1 + fk2) / 2, fwd_dropout_plain_ms=(fp1 + fp2) / 2,
                       fwd_no_dropout_ms=(fn1 + fn2) / 2, mask_in_kernel_ms=(fk1 + fk2 - fn1 - fn2) / 2,
                       mask_plain_ms=mask_plain_ms, mask_bound_ms=mask_bound_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=bound_tc_ms, bound_tc_by=bound_tc_by)
            emit("kernel_vs_plain", kernel=("flash_attn_fwd_bf16+flash_attn_bwd_bf16" if name == "bfloat16"
                                            else "flash_attn_fwd+flash_attn_bwd"), **row)
            if not (err <= GRAD_TOL[name] * scale and fwd_err <= TOL[name] and identical):
                raise AssertionError(f"flash_attn_bwd disagrees with its plain version: {row}")
            if (B, H, Tq, Tk, Dh, masked) == TRAIN_MAIN_CASE and name == "float32":
                summary = row
            del qg, kg, vg, ql, kl, vl
        del q, k, v, do
        torch.cuda.empty_cache()
    return summary


def _dropout_forward_by_rows(q, k, v, rate: float, seed: int, rows: int = 4):
    """The plain forward with the explicit replayed mask, a few batch rows at
    a time with the mask's block ids of those rows: the [B, H, Tq, Tk] mask
    of a B64 1998 x 1998 call does not fit at once."""
    import torch

    from audio2photoreal_tpu_torch.kernels.flash_attn import hash_mask_mult, resolve_block_q

    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    bq = resolve_block_q(Tq, Tk)
    nj = -(-Tq // bq)
    i = torch.arange(Tq, device=q.device).reshape(1, 1, Tq, 1)
    j = torch.arange(Tk, device=q.device).reshape(1, 1, 1, Tk)
    out = []
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        bh = torch.arange(b0 * H, b1 * H, device=q.device).reshape(b1 - b0, H, 1, 1)
        mask = hash_mask_mult(seed, bh * nj + i // bq, i % bq, j, rate)
        logits = torch.matmul(q[b0:b1], k[b0:b1].transpose(-1, -2)) * (1.0 / Dh ** 0.5)
        out.append(torch.matmul(torch.softmax(logits, dim=-1) * mask, v[b0:b1]))
        del mask, logits
    return torch.cat(out)


def phase_train_kernels_face(seed: int) -> list:
    """The attention forward and backward at the face trainer's shapes (B64,
    H4, Dh 128, f32, dropout 0.1): the mask exact at B64 (forward at rate 0.5
    against the plain version row by row), forward and gradients against the
    plain versions at ``plain_B``, the backward twice bit for bit, times of
    the kernels at B64, of the plain versions at ``plain_B``, of SDPA's
    forward and backward at B64 and rate 0, and the backward's peak memory
    with its dQ-partial scratch."""
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels import flash_attn
    from audio2photoreal_tpu_torch.kernels.flash_attn import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
        resolve_block_q,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    rows = []
    for B, H, Tq, Tk, Dh, pB in TRAIN_FACE_KERNEL_CASES:
        q, k, v, do, _ = _attn_inputs(g, B, H, Tq, Tk, Dh, False)
        dseed = 2_000_003 + Tq + Tk
        got = flash_attention(q, k, v, None, False, 0.5, dseed)
        want = _dropout_forward_by_rows(q, k, v, 0.5, dseed)
        torch.cuda.synchronize()
        mask_err = (got - want).abs().max().item()
        del got, want
        if not mask_err <= TOL["float32"]:
            raise AssertionError(f"the dropout forward disagrees with the explicit mask at B{B}: {mask_err}")
        args = (None, False, TRAIN_DROPOUT, dseed)
        # against the plain versions at plain_B (the kernel's mask numbering at that batch)
        qp, kp, vp, dop = (x[:pB] for x in (q, k, v, do))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qp, kp, vp))
        out = flash_attention(qg, kg, vg, *args)
        grads = torch.autograd.grad(out, (qg, kg, vg), dop)
        want_out = flash_attention_reference(qp, kp, vp, *args)
        want = flash_attention_bwd_reference(qp, kp, vp, dop, *args)
        torch.cuda.synchronize()
        fwd_err = (out.detach() - want_out).abs().max().item()
        scale = max(w.abs().max().item() for w in want)
        err = max((a - w).abs().max().item() for a, w in zip(grads, want))
        del out, grads, want_out, want, qg, kg, vg
        torch.cuda.empty_cache()
        it = dict(iters=3, warmup=1)
        plain_fwd_ms = _time_ms(lambda: flash_attention_reference(qp, kp, vp, *args), **it)
        plain_bwd_ms = _time_ms(lambda: flash_attention_bwd_reference(qp, kp, vp, dop, *args), **it)
        torch.cuda.empty_cache()
        # the kernels at B64
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = flash_attention(qg, kg, vg, *args)
        bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first = bwd()
        torch.cuda.synchronize()
        bwd_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        identical = all(torch.equal(a, b) for a, b in zip(first, bwd()))
        del first
        scratch_gb = 4 * flash_attn.bwd_scratch_floats(B, H, Tq, Tk, Dh) / 1e9
        k1, k2 = _time_ms(bwd, **it), _time_ms(bwd, **it)
        fk1 = _time_ms(lambda: flash_attention(q, k, v, *args), **it)
        fk2 = _time_ms(lambda: flash_attention(q, k, v, *args), **it)
        fn = _time_ms(lambda: flash_attention(q, k, v), **it)
        del out, qg, kg, vg
        torch.cuda.empty_cache()
        ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        lib_bwd = _time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True), **it)
        lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), **it)
        del lib_out, ql, kl, vl
        # forward: q, k, v read, out written; backward: q, k, v, dO, O, lse read, dq, dk, dv written
        fwd_bytes = 4 * (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh)
        bwd_bytes = 4 * (3 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) + 4 * B * H * Tq + 4 * (
            B * H * Tq * Dh + 2 * B * H * Tk * Dh)
        fwd_bound, fwd_by = _bound(fwd_bytes, 4.0 * B * H * Tq * Tk * Dh, "tf32x3")
        bwd_bound, bwd_by = _bound(bwd_bytes, 10.0 * B * H * Tq * Tk * Dh, "tf32x3")
        bq = resolve_block_q(Tq, Tk)
        row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, dtype="float32", dropout=TRAIN_DROPOUT,
                   jax_block_q=bq, jax_q_blocks=-(-Tq // bq), fwd_split=flash_attn.fwd_split(B, H, Tq, Tk, Dh),
                   mask_rate05_max_abs_err_B64=mask_err, plain_B=pB, fwd_max_abs_err=fwd_err,
                   max_abs_err=err, grad_scale=scale, tol=GRAD_TOL["float32"] * scale,
                   bitwise_deterministic=identical, ms=(k1 + k2) / 2, plain_ms_at_plain_B=plain_bwd_ms,
                   library_ms=lib_bwd, fwd_dropout_ms=(fk1 + fk2) / 2, fwd_no_dropout_ms=fn,
                   fwd_plain_ms_at_plain_B=plain_fwd_ms, fwd_library_ms=lib_fwd,
                   bound_ms=bwd_bound, bound_by=bwd_by, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
                   bwd_peak_gb=bwd_peak_gb, dq_scratch_gb=scratch_gb)
        emit("kernel_vs_plain_face_train", kernel="flash_attn_fwd+flash_attn_bwd", **row)
        if not (err <= GRAD_TOL["float32"] * scale and fwd_err <= TOL["float32"] and identical):
            raise AssertionError(f"the attention kernels disagree at a face training shape: {row}")
        rows.append(row)
        del q, k, v, do, qp, kp, vp, dop
        torch.cuda.empty_cache()
    return rows


def _mask_check_bf16(B, H, Tq, Tk, Dh, dseed, rate: float = 0.5, rows: int = 4) -> dict:
    """The bf16 forward's replayed mask, exactly, at rate 0.5: with q = 0
    every probability is 1/Tk, and v_j the one-hot of column j mod Dh, so
    output (i, c) is mult/Tk times the kept keys of class c, a small count
    that bf16 holds to a fraction of one key's share mult/Tk.  The bar is
    0.4 of that share: one wrong mask element moves an output by all of it.
    The expected counts come from the explicit mask, a few batch rows at a
    time."""
    import torch

    from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, hash_mask_mult, resolve_block_q

    q = torch.zeros((B, H, Tq, Dh), dtype=torch.bfloat16, device="cuda")
    onehot = torch.nn.functional.one_hot(torch.arange(Tk, device="cuda") % Dh, Dh).to(torch.bfloat16)
    k = torch.zeros((B, H, Tk, Dh), dtype=torch.bfloat16, device="cuda")
    v = onehot.expand(B, H, Tk, Dh).contiguous()
    got = flash_attention(q, k, v, None, False, rate, dseed).float()
    bq = resolve_block_q(Tq, Tk)
    nj = -(-Tq // bq)
    i = torch.arange(Tq, device="cuda").reshape(1, 1, Tq, 1)
    j = torch.arange(Tk, device="cuda").reshape(1, 1, 1, Tk)
    err = 0.0
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        bh = torch.arange(b0 * H, b1 * H, device="cuda").reshape(b1 - b0, H, 1, 1)
        mask = hash_mask_mult(dseed, bh * nj + i // bq, i % bq, j, rate)
        want = torch.matmul(mask, onehot.float()) / Tk
        err = max(err, (got[b0:b1] - want).abs().max().item())
        del mask, want
    share = float(1.0 / (1.0 - rate)) / Tk
    return dict(mask_rate05_max_abs_err=err, mask_bar=0.4 * share, mask_one_key=share)


def phase_kernels_bf16(seed: int) -> dict:
    """The bf16 attention kernels (flash_attn_fwd_bf16.cu on wgmma + TMA,
    flash_attn_bwd_bf16.cu on warp-specialised wgmma + TMA) at the shapes of the
    bf16 generate and train paths, on the model's layout (strided head-split
    views): forward and backward against the plain versions (which round at
    the TPU kernel's points) within 1e-2 of the largest plain output /
    gradient, at the path's dropout; the mask exact at rate 0.5; the
    backward run twice bit for bit; times of the kernels, the plain versions
    (at ``plain_B``) and SDPA's forward and backward at rate 0 on the same
    bf16 inputs, the kernels at rate 0 too (the library's like for like; the
    dropout's share is the difference); bounds at the bf16 tensor-core rate;
    the backward's scratch (``dq_scratch_gb``: no dQ partials since the wgmma
    design, only its row planes)."""
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.kernels import flash_attn
    from audio2photoreal_tpu_torch.kernels.flash_attn import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    summary = {}
    for B, H, Tq, Tk, Dh, rate, pB in BF16_KERNEL_CASES:
        q = _split_heads(torch.randn((B, Tq, H * Dh), generator=g, device="cuda").to(bf16), H)
        kv = torch.randn((B, Tk, 2 * H * Dh), generator=g, device="cuda").to(bf16)
        k, v = _split_heads(kv[..., : H * Dh], H), _split_heads(kv[..., H * Dh:], H)
        do = torch.randn((B, H, Tq, Dh), generator=g, device="cuda").to(bf16)
        dseed = 3_000_017 + Tq + Tk + Dh
        row = dict(B=B, H=H, Tq=Tq, Tk=Tk, Dh=Dh, dtype="bfloat16", dropout=rate, plain_B=pB,
                   layout="strided views of [B, T, H*Dh]", fwd_split=flash_attn.fwd_split(B, H, Tq, Tk, Dh, bf16))
        if rate > 0.0:
            row.update(_mask_check_bf16(B, H, Tq, Tk, Dh, dseed))
        args = (None, False, rate, dseed)
        # against the plain versions at plain_B
        qp, kp, vp, dop = (x[:pB] for x in (q, k, v, do))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qp, kp, vp))
        out = flash_attention(qg, kg, vg, *args)
        grads = torch.autograd.grad(out, (qg, kg, vg), dop)
        want_out = flash_attention_reference(qp, kp, vp, *args)
        want = flash_attention_bwd_reference(qp, kp, vp, dop, *args)
        torch.cuda.synchronize()
        out_scale = want_out.float().abs().max().item()
        fwd_err = (out.detach().float() - want_out.float()).abs().max().item()
        scale = max(w.float().abs().max().item() for w in want)
        err = max((a.float() - w.float()).abs().max().item() for a, w in zip(grads, want))
        del out, grads, want_out, want, qg, kg, vg
        with torch.no_grad():  # the forward at rate 0 as well (generate's, and the summary line's)
            want_out = flash_attention_reference(qp, kp, vp).float()
            fwd0_err = (flash_attention(qp, kp, vp).float() - want_out).abs().max().item()
            fwd0_scale = want_out.abs().max().item()
        del want_out
        torch.cuda.empty_cache()
        it = dict(iters=3, warmup=1) if pB * Tq * Tk >= 16 * 1998 * 1998 else {}
        plain_fwd = _time_ms(lambda: flash_attention_reference(qp, kp, vp, *args), **it)
        plain_fwd0 = _time_ms(lambda: flash_attention_reference(qp, kp, vp), **it)
        plain_bwd = _time_ms(lambda: flash_attention_bwd_reference(qp, kp, vp, dop, *args), **it)
        torch.cuda.empty_cache()
        # the kernels at B
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = flash_attention(qg, kg, vg, *args)
        bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
        identical = all(torch.equal(a, b) for a, b in zip(bwd(), bwd()))
        kb1, kb2 = _time_ms(bwd), _time_ms(bwd)
        kf1, kf2 = _time_ms(lambda: flash_attention(q, k, v, *args)), _time_ms(lambda: flash_attention(q, k, v, *args))
        kf0 = _time_ms(lambda: flash_attention(q, k, v))
        # the card's time alone: one call captured in a CUDA graph and replayed
        # (back-to-back wrapper calls are bound by the host's launch work at
        # the generate shapes)
        o2, lse2 = flash_attn._launch_fwd(q, k, v, *args, None, True)
        fwd_graph = _graph_ms(lambda: flash_attn._launch_fwd(q, k, v, *args, None, False))
        fwd0_graph = _graph_ms(lambda: flash_attn._launch_fwd(q, k, v, None, False, 0.0, 0, None, False))
        bwd_graph = _graph_ms(lambda: flash_attn.flash_attention_bwd(q, k, v, o2, lse2, do, *args))
        # the backward at rate 0, on the rate-0 forward's lse: SDPA's like for like
        o0, lse0 = flash_attn._launch_fwd(q, k, v, None, False, 0.0, 0, None, True)
        bwd0 = lambda: flash_attn.flash_attention_bwd(q, k, v, o0, lse0, do)  # noqa: E731
        kb0 = _time_ms(bwd0)
        bwd0_graph = _graph_ms(bwd0)
        del out, qg, kg, vg, o2, lse2, o0, lse0
        torch.cuda.empty_cache()
        ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        lib_bwd = _time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True))
        lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        del lib_out, ql, kl, vl
        # forward: q, k, v read, out written; backward: q, k, v, dO, O read (bf16), lse (f32), dq, dk, dv written
        fwd_bytes = 2 * (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh)
        bwd_bytes = 2 * (3 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) + 4 * B * H * Tq + 2 * (
            B * H * Tq * Dh + 2 * B * H * Tk * Dh)
        fwd_bound, fwd_by = _bound(fwd_bytes, 4.0 * B * H * Tq * Tk * Dh, "bfloat16")
        bwd_bound, bwd_by = _bound(bwd_bytes, 10.0 * B * H * Tq * Tk * Dh, "bfloat16")
        row.update(fwd_max_abs_err=fwd_err, fwd_scale=out_scale, fwd_tol=BF16_TOL * out_scale,
                   fwd_rate0_max_abs_err=fwd0_err, fwd_rate0_scale=fwd0_scale,
                   fwd_rate0_plain_ms_at_plain_B=plain_fwd0,
                   max_abs_err=err, grad_scale=scale, tol=BF16_TOL * scale, bitwise_deterministic=identical,
                   fwd_ms=(kf1 + kf2) / 2, fwd_graph_ms=fwd_graph, fwd_rate0_ms=kf0, fwd_rate0_graph_ms=fwd0_graph,
                   fwd_plain_ms_at_plain_B=plain_fwd,
                   fwd_library_ms=lib_fwd, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
                   bwd_ms=(kb1 + kb2) / 2, bwd_graph_ms=bwd_graph, bwd_plain_ms_at_plain_B=plain_bwd,
                   bwd_rate0_ms=kb0, bwd_rate0_graph_ms=bwd0_graph, bwd_library_ms=lib_bwd,
                   bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by,
                   dq_scratch_gb=4 * flash_attn.bwd_scratch_floats(B, H, Tq, Tk, Dh, bf16) / 1e9)
        emit("kernels_bf16", kernel="flash_attn_fwd_bf16+flash_attn_bwd_bf16", **row)
        ok = (fwd_err <= BF16_TOL * out_scale and fwd0_err <= BF16_TOL * fwd0_scale and err <= BF16_TOL * scale
              and identical)
        if rate > 0.0:
            ok = ok and row["mask_rate05_max_abs_err"] <= row["mask_bar"]
        if not ok:
            raise AssertionError(f"the bf16 attention kernels disagree with their plain versions: {row}")
        if (B, H, Tq, Tk, Dh) == BF16_MAIN_CASE:
            summary = row
        del q, k, v, kv, do, qp, kp, vp, dop
        torch.cuda.empty_cache()
    return summary


def _train_batch(rng, B, T):
    import numpy as np

    mask = np.ones((B, T), np.float32)
    mask[-1, T - 150:] = 0.0
    kv = np.ones((B, -(-T // 30)), np.float32)
    kv[-1, -5:] = 0.0
    return {"motion": rng.randn(B, T, 104).astype(np.float32) * mask[..., None], "mask": mask,
            "audio": (rng.randn(B, T * 1600, 2) * 0.5).astype(np.float32),
            "keyframes": rng.randn(B, kv.shape[1], 104).astype(np.float32), "keyframe_valid": kv}


def _step_parity(phase: str, cfg, model_cpu, batch: dict, t, noise, want_launches: int) -> None:
    """One deterministic train step (fixed t and noise, dropout and guidance
    dropout off) from the same weights on the card (kernels) and on the CPU
    (plain versions): loss, every gradient, params after AdamW; the
    attention kernels' launches on the card."""
    import copy

    import torch

    from audio2photoreal_tpu_torch.core.config import DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    model_gpu = copy.deepcopy(model_cpu).cuda()
    dcfg = DiffusionConfig(cond_drop_prob=0.0)
    out, secs = {}, {}
    for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
        state = TrainState(model.eval(), TrainConfig(lr=LR))
        before = (launch_counts[flash_attn.NAME], launch_counts[flash_attn.BWD_NAME])
        t0 = time.perf_counter()
        metrics, _ = diffusion_train_step(
            state, make_schedule().to_device(device), dcfg, {k: torch.from_numpy(v).to(device) for k, v in
                                                             batch.items()},
            t=torch.from_numpy(t), noise=torch.from_numpy(noise).to(device))
        secs[device] = time.perf_counter() - t0
        launches = (launch_counts[flash_attn.NAME] - before[0], launch_counts[flash_attn.BWD_NAME] - before[1])
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        out[device] = (metrics, grads, params, launches)
    (mg, gg, pg, lg), (mc, gc, pc, lc) = out["cuda"], out["cpu"]
    loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    grad_rel = max((gg[n] - gc[n]).abs().max().item() / max(gc[n].abs().max().item(), 1e-30) for n in gc)
    d = torch.cat([(pg[n] - pc[n]).abs().flatten() for n in pc])
    row = dict(data_format=cfg.data_format, batch=len(t), latent=cfg.latent_dim, layers=cfg.num_layers,
               inputs=sorted(batch), t=t.tolist(), loss_gpu=mg["loss"], loss_cpu=mc["loss"], loss_rel_err=loss_rel,
               grad_max_rel_err=grad_rel, grads_compared=len(gc), same_grad_names=sorted(gg) == sorted(gc),
               param_max_abs_diff=d.max().item(), param_share_within_1e6=(d <= 1e-6).float().mean().item(),
               kernel_launches_fwd_bwd=list(lg), expected_launches=want_launches, cpu_launches=list(lc),
               gpu_s=secs["cuda"], cpu_s=secs["cpu"])
    emit(phase, **row)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and row["same_grad_names"] and d.max().item() <= 2 * LR
            and row["param_share_within_1e6"] >= 0.999 and lg == (want_launches,) * 2 and lc == (0, 0)):
        raise AssertionError(f"card and CPU disagree on the train step: {row}")


def phase_train_parity(seed: int) -> None:
    """One deterministic full-width pose train step, card against CPU (phase 11)."""
    import numpy as np

    cfg, model_cpu = _pose_model(seed, hash_dropout=True)
    rng = np.random.RandomState(seed + 2)
    B, T = 4, cfg.max_seq_length
    batch = _train_batch(rng, B, T)
    t = np.array([0, 250, 600, 999])
    noise = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    _step_parity("train_parity", cfg, model_cpu, batch, t, noise, 2 * cfg.num_layers)


def phase_train_parity_face(seed: int) -> None:
    """One deterministic full-width face train step at batch 4 on cached
    features (wav2vec features and per-frame lip vertices), card against CPU
    (phase 13): the cond-encoder's 2 and the decoder's 16 attentions through
    the kernels, forward and backward."""
    import numpy as np

    cfg, model_cpu = _face_model(seed, hash_dropout=True)
    rng = np.random.RandomState(seed + 6)
    B, T = 4, cfg.max_seq_length
    batch = _face_cached_batch(rng, B, T, cfg.nfeats)
    t = np.array([0, 250, 600, 999])
    noise = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    _step_parity("train_parity_face", cfg, model_cpu, batch, t, noise,
                 cfg.cond_encoder_layers + 2 * cfg.num_layers)


def _train_person(seed: int) -> str:
    """The trainers' synthetic person (``TRAIN_PERSON``), made once."""
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person

    root = os.path.join(WORK, "train_data")
    if not os.path.isdir(os.path.join(root, "SYNTH01")):
        make_synthetic_person(root, "SYNTH01", seed=seed, **TRAIN_PERSON)
    return root


def phase_feature_cache(seed: int):
    """The frozen-frontend feature cache of the full-width face model over
    the train split, built on the card (phase 12): scene 0 against the same
    build on the CPU (features, lip vertices, both silences, within
    ``CACHE_REL_TOL`` of their scale); a crop from mid-scene against the live
    frontend on that crop; MB and build seconds.  Returns (cache, index,
    stats) for the face trainer's profiled step."""
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import find_stats
    from audio2photoreal_tpu_torch.data.dataset import read_wav
    from audio2photoreal_tpu_torch.data.feature_cache import (
        build_audio_feature_cache,
        build_cache_for_index,
        make_frontend_apply,
        make_lip_apply,
        tokens_for_frames,
    )
    from audio2photoreal_tpu_torch.data.loader import SceneIndex

    root = _train_person(seed)
    cfg, model_cpu = _face_model(seed)
    model = copy.deepcopy(model_cpu).cuda()
    index = SceneIndex(root, "SYNTH01", "train")
    stats = find_stats(os.path.join(root, "SYNTH01"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = build_cache_for_index(index, stats.norm_audio, make_frontend_apply(model.audio_model),
                                  make_lip_apply(model.lip_model), verbose=False)
    build_s = time.perf_counter() - t0
    base, frames = index.entries[0]
    raw = read_wav(base + "_audio.wav")[: frames * 1600]
    t0 = time.perf_counter()
    cpu = build_audio_feature_cache(make_frontend_apply(model_cpu.audio_model), [raw], stats.norm_audio,
                                    lip_apply=make_lip_apply(model_cpu.lip_model), verbose=False)
    cpu_s = time.perf_counter() - t0

    def rel(a, b):  # of b's largest magnitude (an all-zero silence vector: absolute)
        return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))

    errs = {"features": rel(cache.features[0], cpu.features[0]), "lip": rel(cache.lip[0], cpu.lip[0]),
            "silence": rel(cache.silence, cpu.silence), "lip_silence": rel(cache.lip_silence, cpu.lip_silence)}
    # a crop from mid-scene against the live frontend on exactly that crop
    start, L = CACHE_CROP
    crop = stats.norm_audio(raw[start * 1600 : (start + L) * 1600]).astype(np.float32)
    with torch.no_grad():
        exact = model.audio_model(torch.from_numpy(crop[None]).cuda())[0].cpu().numpy()
    cached = cache.window(0, start, L, tokens_for_frames(L))
    a, b = cached.ravel(), exact.ravel()
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    ci, ei = cached[5:-2], exact[5:-2]
    nonzero = (ci != 0) | (ei != 0)
    median_rel = float(np.median(np.abs(ci - ei)[nonzero] / (np.abs(ei[nonzero]) + 1e-2)))
    row = dict(scenes=len(index.entries), frames=[f for _, f in index.entries],
               tokens=[int(f.shape[0]) for f in cache.features], cache_mb=cache.nbytes() / 1e6,
               build_s_card=build_s, scene0_build_s_cpu=cpu_s, rel_err=errs, rel_tol=CACHE_REL_TOL,
               crop=[start, L], crop_cosine=cos, crop_median_rel_err=median_rel,
               crop_nonzero_share=float(nonzero.mean()),
               crop_bar=[CACHE_CROP_COS, CACHE_CROP_MEDIAN_REL])
    emit("feature_cache", **row)
    if not (max(errs.values()) <= CACHE_REL_TOL and cos > CACHE_CROP_COS and median_rel < CACHE_CROP_MEDIAN_REL
            and cache.features[0].shape == cpu.features[0].shape):
        raise AssertionError(f"the feature cache checks failed: {row}")
    del model, model_cpu
    torch.cuda.empty_cache()
    return cache, index, stats


def _profile_step(state, sched, dcfg, batch) -> dict:
    """One more train step under torch.profiler: device time by kernel (the
    device-side events only; a host op's own row repeats its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        diffusion_train_step(state, sched, dcfg, batch, torch.Generator().manual_seed(7),
                             torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(per.values())
    if total == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    group = lambda pat: sum(v for k, v in per.items() if pat in k)  # noqa: E731
    top = sorted(per.items(), key=lambda kv: -kv[1])[:15]
    return dict(profiled_wall_ms=wall_ms, device_ms=total, device_idle_share=1.0 - total / wall_ms,
                device_launches=sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                attn_bwd_ms=group("attn_bwd_"), attn_bwd_share=group("attn_bwd_") / total,
                attn_fwd_ms=group("attn_fwd_"), attn_fwd_share=group("attn_fwd_") / total,
                gemm_ms=sum(v for k, v in per.items() if _is_gemm(k)),
                int64_elementwise_ms=group("<long"),  # the hash dropout masks' uint32-in-int64 math
                int64_elementwise_share=group("<long") / total,
                cudnn_conv_fprop_ms=group("fprop_implicit_gemm"), top_kernels_ms=[[k[:90], v] for k, v in top])


def _train_run(name: str, root: str, mcfg, datacfg, seed: int, cached: bool) -> dict:
    """``train()`` for ``TRAIN_STEPS`` steps from a clean save dir with the
    launch counts at 0; its checks and numbers.  The batches come through
    the fastdata reads."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.train_diffusion import train
    from audio2photoreal_tpu_torch.core.config import DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.train import checkpoints

    save_dir = os.path.join(WORK, name)
    shutil.rmtree(save_dir, ignore_errors=True)
    tcfg = TrainConfig(lr=LR, num_steps=TRAIN_STEPS, log_interval=1, save_interval=10**9, seed=seed)
    timings: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    t0 = time.perf_counter()
    state = train(root, save_dir, mcfg, DiffusionConfig(), datacfg, tcfg, cache_audio_features=cached,
                  device="cuda", timings=timings, reader="fastdata")
    train_s = time.perf_counter() - t0
    names = ((flash_attn.BF16_NAME, flash_attn.BF16_BWD_NAME) if mcfg.dtype == "bfloat16"
             else (flash_attn.NAME, flash_attn.BWD_NAME))
    fwd, bwd = launch_counts[names[0]], launch_counts[names[1]]
    others = sum(launch_counts.values()) - fwd - bwd
    logged = [json.loads(l) for l in open(os.path.join(save_dir, "log.jsonl"))]
    steady, waits = timings["step_s"][1:], timings["batch_s"][1:]
    per_step = (mcfg.cond_encoder_layers if mcfg.data_format == "face" else 0) + 2 * mcfg.num_layers
    checks = {
        "losses_finite": len(logged) == TRAIN_STEPS and all(np.isfinite(r["loss"]) for r in logged),
        "no_skipped_step": state.step == TRAIN_STEPS and all(r["skipped_nonfinite"] == 0 for r in logged),
        "checkpoint_written": checkpoints.latest_step(os.path.join(save_dir, "ckpt")) == TRAIN_STEPS
        and os.path.exists(os.path.join(save_dir, checkpoints.MODEL_FILE)),
        "attention_fwd_launches": fwd == per_step * TRAIN_STEPS,
        "attention_bwd_launches": bwd == per_step * TRAIN_STEPS,
        "no_other_kernel_launches": others == 0,
        "reader_fastdata": timings["reader"] == "fastdata",
    }
    return dict(state=state, save_dir=save_dir, fwd=fwd, bwd=bwd, checks=checks, numbers=dict(
        cached=cached, reader=timings["reader"], cache_s=timings.get("cache_s"), cache_mb=timings.get("cache_mb"),
        train_s=train_s,
        step_s=timings["step_s"], batch_s=timings["batch_s"], steady_step_ms=1e3 * sum(steady) / len(steady),
        steady_steps_per_s=len(steady) / sum(steady), steady_batch_share=sum(waits) / sum(steady),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, losses=[r["loss"] for r in logged],
        grad_norms=[r["grad_norm"] for r in logged], kernel_launches_fwd=fwd, kernel_launches_bwd=bwd,
        launches_per_step=per_step))


def _device_batch(batch: dict) -> dict:
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.asarray(v)).to("cuda") for k, v in batch.items()}


def phase_main_path_train(seed: int, smi: str) -> dict:
    """``train()`` at the reference's pose operating point (phase 14), on raw
    audio and on the feature cache; each checkpoint sampled; one more step of
    each under the profiler."""
    import dataclasses

    import numpy as np

    from audio2photoreal_tpu_torch.apps.generate import find_stats, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig
    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
    from audio2photoreal_tpu_torch.data.loader import FastLoader, SceneIndex
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule

    person, root = "SYNTH01", _train_person(seed)
    mcfg = DenoiserConfig(data_format="pose", flash_attention=True, hash_dropout=True)
    datacfg = DataConfig(person=person, batch_size=TRAIN_BATCH, max_seq_length=mcfg.max_seq_length)
    runs = {}
    for variant, cached in (("raw", False), ("cached", True)):
        runs[variant] = run = _train_run(f"train_run_{variant}", root, mcfg, datacfg, seed, cached)
        # the saved model samples: one DDIM-10 clip through generate
        res = np.load(generate(run["save_dir"], root, num_samples=1, timestep_respacing="ddim10", device="cuda",
                               output_dir=os.path.join(WORK, f"train_samples_{variant}")), allow_pickle=True).item()
        run["checks"]["generate_from_checkpoint"] = (
            list(res["motions"].shape) == [1, mcfg.nfeats, 1, mcfg.max_seq_length]
            and bool(np.isfinite(res["motions"]).all()))
        # one more step under the profiler, on a batch of the same shapes
        loader = FastLoader(SceneIndex(root, person), find_stats(os.path.join(root, person)), datacfg,
                            reader="fastdata")
        batch = loader.sample_batch(TRAIN_BATCH, np.random.RandomState(seed))
        if cached:  # features in place of the audio (their values do not change the work)
            del batch["audio"]
            batch["audio_features"] = np.random.RandomState(seed).rand(
                TRAIN_BATCH, tokens_for_frames(mcfg.max_seq_length), 1024).astype(np.float32)
        prof = _profile_step(run["state"], make_schedule().to_device("cuda"), DiffusionConfig(), _device_batch(batch))
        n = run["numbers"]
        emit("main_path_train", nvidia_smi=smi, variant=variant, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
             config=dataclasses.asdict(mcfg), **n,
             device_idle_share_of_steady_step=1.0 - prof["device_ms"] / n["steady_step_ms"], **prof,
             checks=run["checks"])
        if not all(run["checks"].values()):
            raise AssertionError(f"main path (train, {variant}) checks failed: {run['checks']}")
        del run["state"]
    emit("main_path_train_pose_steps_per_s", nvidia_smi=smi,
         raw=runs["raw"]["numbers"]["steady_steps_per_s"], cached=runs["cached"]["numbers"]["steady_steps_per_s"],
         raw_batch_share=runs["raw"]["numbers"]["steady_batch_share"],
         cached_batch_share=runs["cached"]["numbers"]["steady_batch_share"],
         cache_s=runs["cached"]["numbers"]["cache_s"])
    return {v: (r["fwd"], r["bwd"]) for v, r in runs.items()}


def phase_main_path_train_face(seed: int, smi: str, cache, index, stats):
    """``train()`` at the reference's face operating point (phase 15): the
    full face width, flash attention, hash dropout, f32, batch 64, cached
    features through the fastdata reads; 18 attention launches a step each
    way (2 cond-encoder, 8 layers x 2); a face ``generate`` (DDIM-10) from the
    checkpoint; one more step under the profiler on a batch from the feature
    cache phase's cache."""
    import dataclasses

    import numpy as np

    from audio2photoreal_tpu_torch.apps.generate import generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig
    from audio2photoreal_tpu_torch.data.loader import FastLoader
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule

    person, root = "SYNTH01", _train_person(seed)
    mcfg = DenoiserConfig(**FACE_WIDTH, hash_dropout=True)
    datacfg = DataConfig(person=person, data_format="face", batch_size=TRAIN_BATCH,
                         max_seq_length=mcfg.max_seq_length)
    run = _train_run("train_run_face", root, mcfg, datacfg, seed, cached=True)
    res = np.load(generate(run["save_dir"], root, num_samples=1, timestep_respacing="ddim10", device="cuda",
                           output_dir=os.path.join(WORK, "train_samples_face")), allow_pickle=True).item()
    run["checks"]["generate_from_checkpoint"] = (
        list(res["motions"].shape) == [1, mcfg.nfeats, 1, mcfg.max_seq_length]
        and bool(np.isfinite(res["motions"]).all()))
    loader = FastLoader(index, stats, datacfg, feature_cache=cache, reader="fastdata")
    t0 = time.perf_counter()
    batch = loader.sample_batch(TRAIN_BATCH, np.random.RandomState(seed))
    assemble_s = time.perf_counter() - t0
    host_mb = sum(v.nbytes for v in batch.values()) / 1e6
    prof = _profile_step(run["state"], make_schedule().to_device("cuda"), DiffusionConfig(), _device_batch(batch))
    n = run["numbers"]
    emit("main_path_train_face", nvidia_smi=smi, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         config=dataclasses.asdict(mcfg), **n, batch_host_mb=host_mb, batch_assemble_s=assemble_s,
         device_idle_share_of_steady_step=1.0 - prof["device_ms"] / n["steady_step_ms"], **prof,
         checks=run["checks"])
    if not all(run["checks"].values()):
        raise AssertionError(f"main path (train, face) checks failed: {run['checks']}")
    return run["fwd"], run["bwd"]


def phase_bf16_slice_parity(seed: int) -> None:
    """The full-width pose and face models in bf16 (f32 weights from one
    seed, ``dtype="bfloat16"``, the frontend in f32 as generate loads it):
    encode, cached CFG and DDIM-5 from one numpy x_T, run three ways: card
    bf16 (the bf16 kernels), CPU bf16 and CPU f32 (plain versions).  The
    card must be no less accurate than the CPU: err(card bf16 vs CPU f32) <=
    1.5 err(CPU bf16 vs CPU f32) + 1e-3 scale."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    sched = maybe_respaced("cosine", 1000, "ddim5")
    for name, build, guidance in (("pose", _pose_model, 2.0), ("face", _face_model, FACE_GUIDANCE)):
        cfg, model32 = build(seed)
        model16 = FiLMDenoiser(dataclasses.replace(cfg, dtype="bfloat16"))
        model16.load_state_dict(model32.state_dict(), strict=True)
        model16.eval()
        rng = np.random.RandomState(seed + 21)
        B, T = 1, cfg.max_seq_length
        audio = rng.randn(B, T * 1600, 2).astype(np.float32)
        kf = rng.randn(B, -(-T // cfg.keyframe_step), cfg.key_feature_dim).astype(np.float32)
        kv = np.ones(kf.shape[:2], np.float32)
        x_T = rng.randn(B, T, cfg.nfeats).astype(np.float32)

        def run(model, device):
            with torch.no_grad():
                a = torch.from_numpy(audio).to(device)
                if name == "pose":
                    cond = model.encode_conditioning(a, torch.from_numpy(kf).to(device), torch.from_numpy(kv).to(device))
                else:
                    cond = model.encode_conditioning(a, lip_verts=model.lip_vertices(a))
                res = ddim_sample_loop(sched, "xstart", cfg_model_fn_cached(model, cond, guidance),
                                       torch.from_numpy(x_T).to(device))
            return res.pred_xstart.float().cpu().numpy()

        launch_counts.clear()
        t0 = time.perf_counter()
        card = run(copy.deepcopy(model16).cuda(), "cuda")
        card_s = time.perf_counter() - t0
        launches = (launch_counts[flash_attn.BF16_NAME], launch_counts[flash_attn.NAME])
        t0 = time.perf_counter()
        cpu16 = run(model16, "cpu")
        cpu32 = run(model32, "cpu")
        cpu_s = time.perf_counter() - t0
        scale = float(np.abs(cpu32).max())
        e_card, e_cpu = float(np.abs(card - cpu32).max()), float(np.abs(cpu16 - cpu32).max())
        bar = BF16_RATIO * e_cpu + BF16_SLACK * scale
        want = (cfg.cond_encoder_layers if name == "face" else 0) + cfg.num_layers * 2 * 5
        row = dict(model=name, steps=5, guidance=guidance, batch=B, latent=cfg.latent_dim, layers=cfg.num_layers,
                   heads=cfg.num_heads, scale=scale, err_card_bf16_vs_cpu_f32=e_card,
                   err_cpu_bf16_vs_cpu_f32=e_cpu, err_card_vs_cpu_bf16=float(np.abs(card - cpu16).max()), bar=bar,
                   bf16_kernel_launches=launches[0], f32_kernel_launches=launches[1], expected_launches=want,
                   card_s=card_s, cpu_s=cpu_s, finite=bool(np.isfinite(card).all()))
        emit("bf16_slice_parity", **row)
        if not (row["finite"] and e_card <= bar and launches == (want, 0)):
            raise AssertionError(f"the bf16 {name} slice on the card is less accurate than on the CPU: {row}")
        del model16, model32
        torch.cuda.empty_cache()


def _grad_ratios(grads: dict, cpu16: dict, cpu32: dict) -> dict:
    """Each gradient tensor's error against the CPU f32 step over the ratio
    bar (1.5 times the CPU bf16 step's error + 1e-3), on the relative L2
    error (the gate) and on the largest error (scale: the f32 tensor's
    largest magnitude); the worst tensor of each."""
    worst = {"l2": (0.0, ""), "max": (0.0, "")}
    for n, g32 in cpu32.items():
        ref, scale = max(g32.norm().item(), 1e-30), g32.abs().max().item()
        r = {"l2": (grads[n] - g32).norm().item() / ref / (
                 BF16_RATIO * (cpu16[n] - g32).norm().item() / ref + BF16_SLACK),
             "max": (grads[n] - g32).abs().max().item() / max(
                 BF16_RATIO * (cpu16[n] - g32).abs().max().item() + BF16_SLACK * scale, 1e-30)}
        for k in worst:
            if r[k] > worst[k][0]:
                worst[k] = (r[k], n)
    return worst


def _adamw_sign_flips(card: dict, cpu16: dict, cpu32: dict, names) -> list:
    """The parameters that moved more than 2 lr apart, card bf16 against CPU
    bf16, after one AdamW step from zero state.  That step moves a parameter
    by lr g / (|g| + eps), so where the two bf16 gradients differ in sign the
    two land 2 lr apart, plus the f32 rounding of p - lr and p + lr: at most
    one ulp of the larger parameter.  For each: whether the signs differ,
    |g| of the CPU f32 step there, and the largest error the ratio rule
    admits in its tensor (BF16_RATIO times the CPU bf16 step's largest error
    against CPU f32, plus BF16_SLACK of the tensor's scale); a sign flip is
    rounding when |g_f32| lies below it."""
    import torch

    out = []
    for n in names:
        pc, pp = card["params"][n], cpu16["params"][n]
        over = ((pc - pp).abs() > 2 * LR).nonzero()
        if not len(over):
            continue
        g32 = cpu32["grads"][n]
        admitted = (BF16_RATIO * (cpu16["grads"][n] - g32).abs().max().item()
                    + BF16_SLACK * g32.abs().max().item())
        for idx in over.tolist():
            i = tuple(idx)
            a, b = pc[i].abs(), pp[i].abs()
            top = torch.maximum(a, b)
            gc, gp = card["grads"][n][i].item(), cpu16["grads"][n][i].item()
            out.append(dict(name=n, index=idx, d=(pc[i] - pp[i]).abs().item(), p_card=pc[i].item(),
                            p_cpu_bf16=pp[i].item(), ulp=(torch.nextafter(top, top + 1) - top).item(),
                            g_card_bf16=gc, g_cpu_bf16=gp, g_cpu_f32=g32[i].item(), abs_g_cpu_f32=abs(g32[i].item()),
                            flipped=(gc > 0) != (gp > 0), admitted_err=admitted))
    return out


def _bf16_step_parity(phase: str, cfg32, model32, batch: dict, t, noise, want_launches: int,
                      weight_seed: int) -> None:
    """One deterministic train step (fixed t and noise, dropout and guidance
    dropout off) from the same f32 weights four ways: card bf16 (the bf16
    kernels), card bf16 with cuBLAS's bf16 reduced-precision reduction off
    (a witness of what that flag costs; the port leaves it as it finds it),
    CPU bf16 and CPU f32 (plain versions).  The loss within 1e-2 relative of
    the CPU's bf16 step; each gradient tensor by the ratio rule on its
    relative L2 error against the CPU f32 step (the worst tensor's largest
    error is reported beside it); parameters after AdamW within 2 lr of the
    CPU's bf16 step; parameters and AdamW state f32."""
    import copy
    import dataclasses

    import torch

    from audio2photoreal_tpu_torch.core.config import DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16", frontend_dtype="bfloat16")
    model16 = FiLMDenoiser(cfg16)
    model16.load_state_dict(model32.state_dict(), strict=True)
    dcfg = DiffusionConfig(cond_drop_prob=0.0)
    matmul = torch.backends.cuda.matmul
    default_reduction = matmul.allow_bf16_reduced_precision_reduction
    out = {}
    for run, (device, model, reduction) in {
            "card16": ("cuda", copy.deepcopy(model16).cuda(), default_reduction),
            "card16_f32_reduction": ("cuda", copy.deepcopy(model16).cuda(), False),
            "cpu16": ("cpu", model16, default_reduction), "cpu32": ("cpu", model32, default_reduction)}.items():
        state = TrainState(model.eval(), TrainConfig(lr=LR))
        launch_counts.clear()
        matmul.allow_bf16_reduced_precision_reduction = reduction
        t0 = time.perf_counter()
        try:
            metrics, _ = diffusion_train_step(
                state, make_schedule().to_device(device), dcfg,
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                t=torch.from_numpy(t), noise=torch.from_numpy(noise).to(device))
        finally:
            matmul.allow_bf16_reduced_precision_reduction = default_reduction
        secs = time.perf_counter() - t0
        launches = (launch_counts[flash_attn.BF16_NAME], launch_counts[flash_attn.BF16_BWD_NAME],
                    launch_counts[flash_attn.NAME], launch_counts[flash_attn.BWD_NAME])
        grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters() if p.grad is not None}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        f32 = all(p.dtype == torch.float32 for p in model.parameters()) and all(
            v.dtype == torch.float32 for st in state.optimizer.state.values() for v in st.values()
            if isinstance(v, torch.Tensor) and v.dim() > 0)
        out[run] = dict(metrics=metrics, grads=grads, params=params, launches=launches, secs=secs, f32=f32)
        del state
    c16, p16, p32 = out["card16"], out["cpu16"], out["cpu32"]
    loss_rel = abs(c16["metrics"]["loss"] - p16["metrics"]["loss"]) / abs(p16["metrics"]["loss"])
    names = sorted(p32["grads"])
    flat = {k: torch.cat([out[k]["grads"][n].flatten() for n in names]) for k in out}
    ref = flat["cpu32"].norm().item()
    worst = {k: _grad_ratios(out[k]["grads"], p16["grads"], p32["grads"]) for k in ("card16", "card16_f32_reduction")}
    d = torch.cat([(c16["params"][n] - p16["params"][n]).abs().flatten() for n in names])
    flips = _adamw_sign_flips(c16, p16, p32, names)
    row = dict(data_format=cfg32.data_format, weight_seed=weight_seed, batch=len(t), latent=cfg32.latent_dim,
               layers=cfg32.num_layers, inputs=sorted(batch), t=t.tolist(), loss_card_bf16=c16["metrics"]["loss"],
               loss_cpu_bf16=p16["metrics"]["loss"], loss_cpu_f32=p32["metrics"]["loss"], loss_rel_err=loss_rel,
               grads_compared=len(names), cublas_bf16_reduced_precision_reduction=default_reduction,
               grad_rel_l2_cpu_bf16_vs_cpu_f32=(flat["cpu16"] - flat["cpu32"]).norm().item() / ref,
               **{f"grad_rel_l2_{k}_vs_cpu_f32": (flat[k] - flat["cpu32"]).norm().item() / ref for k in worst},
               **{f"worst_tensor_{m}_ratio_{k}": list(worst[k][m]) for k in worst for m in ("l2", "max")},
               same_grad_names=sorted(c16["grads"]) == names == sorted(p16["grads"]),
               param_max_abs_diff_card_vs_cpu_bf16=d.max().item(), params_and_adamw_state_f32=c16["f32"],
               params_past_2lr=flips,
               card_launches_bf16_fwd_bwd_f32_fwd_bwd=list(c16["launches"]), expected_launches=want_launches,
               card_s=c16["secs"], cpu_bf16_s=p16["secs"], cpu_f32_s=p32["secs"])
    emit(phase, **row)
    ok = (loss_rel <= 1e-2 and worst["card16"]["l2"][0] <= 1.0 and row["same_grad_names"]
          and all(f["flipped"] and f["d"] <= 2 * LR + f["ulp"] and f["abs_g_cpu_f32"] <= f["admitted_err"]
                  for f in flips)
          and c16["f32"] and c16["launches"] == (want_launches, want_launches, 0, 0)
          and p16["launches"] == (0, 0, 0, 0))
    if not ok:
        raise AssertionError(f"the bf16 train step on the card disagrees with the CPU's: {row}")


def phase_train_parity_bf16(seed: int, weight_seeds: int = 2) -> None:
    """One deterministic full-width bf16 train step at batch 4, card against
    CPU: pose on raw audio through the bf16 frontend, face on cached
    features; at weight seeds ``seed`` .. ``seed + weight_seeds - 1``, each
    gated."""
    for s in range(seed, seed + weight_seeds):
        _train_parity_bf16_seed(s)


def _train_parity_bf16_seed(seed: int) -> None:
    import numpy as np

    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames

    cfg, model = _pose_model(seed, hash_dropout=True)
    rng = np.random.RandomState(seed + 31)
    B, T = 4, cfg.max_seq_length
    batch = _train_batch(rng, B, T)
    t = np.array([0, 250, 600, 999])
    noise = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    _bf16_step_parity("train_parity_bf16", cfg, model, batch, t, noise, 2 * cfg.num_layers, seed)

    cfg, model = _face_model(seed, hash_dropout=True)
    rng = np.random.RandomState(seed + 32)
    lengths = np.array([T, T, 450, 333], np.int32)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    batch = {"motion": rng.randn(B, T, cfg.nfeats).astype(np.float32) * mask[..., None], "mask": mask,
             "lengths": lengths, "audio_features": rng.rand(B, tokens_for_frames(T), 1024).astype(np.float32),
             "lip_verts": rng.randn(B, T, 1014).astype(np.float32)}
    noise = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    _bf16_step_parity("train_parity_bf16", cfg, model, batch, t, noise,
                      cfg.cond_encoder_layers + 2 * cfg.num_layers, seed)


def phase_main_path_train_bf16(seed: int, smi: str) -> dict:
    """``train()`` at the JAX package's training point (BENCH_r05.json
    ``train_config``: flash attention, hash dropout, the feature cache, bf16
    compute and a bf16 frontend) for the pose and the face width, batch 64,
    4 steps (steady = steps 2-4): steps/s, the batch wait, peak memory, the
    bf16 cache's size and build time, one more step under the profiler for
    the device time by kernel; each checkpoint sampled (DDIM-10)."""
    import dataclasses

    import numpy as np

    from audio2photoreal_tpu_torch.apps.generate import find_stats, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig
    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
    from audio2photoreal_tpu_torch.data.loader import FastLoader, SceneIndex
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule

    person, root = "SYNTH01", _train_person(seed)
    point = dict(flash_attention=True, hash_dropout=True, dtype="bfloat16", frontend_dtype="bfloat16")
    launches = {}
    for fmt, mcfg in (("pose", DenoiserConfig(data_format="pose", **point)),
                      ("face", DenoiserConfig(**{**FACE_WIDTH, **point}))):
        datacfg = DataConfig(person=person, data_format=fmt, batch_size=TRAIN_BATCH,
                             max_seq_length=mcfg.max_seq_length)
        run = _train_run(f"train_run_{fmt}_bf16", root, mcfg, datacfg, seed, cached=True)
        res = np.load(generate(run["save_dir"], root, num_samples=1, timestep_respacing="ddim10", device="cuda",
                               output_dir=os.path.join(WORK, f"train_samples_{fmt}_bf16")), allow_pickle=True).item()
        run["checks"]["generate_from_checkpoint"] = (
            list(res["motions"].shape) == [1, mcfg.nfeats, 1, mcfg.max_seq_length]
            and bool(np.isfinite(res["motions"]).all()))
        run["checks"]["params_f32"] = all(p.dtype.is_floating_point and p.element_size() == 4
                                          for p in run["state"].model.parameters())
        loader = FastLoader(SceneIndex(root, person), find_stats(os.path.join(root, person)), datacfg,
                            reader="fastdata")
        batch = loader.sample_batch(TRAIN_BATCH, np.random.RandomState(seed))
        del batch["audio"]  # features in place of the audio (their values do not change the work)
        rng = np.random.RandomState(seed)
        batch["audio_features"] = rng.rand(TRAIN_BATCH, tokens_for_frames(mcfg.max_seq_length), 1024).astype(
            np.float32)
        if fmt == "face":
            batch["lip_verts"] = rng.randn(TRAIN_BATCH, mcfg.max_seq_length, 1014).astype(np.float32)
        prof = _profile_step(run["state"], make_schedule().to_device("cuda"), DiffusionConfig(), _device_batch(batch))
        n = run["numbers"]
        emit("main_path_train_bf16", nvidia_smi=smi, model=fmt, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
             config=dataclasses.asdict(mcfg), **n,
             device_idle_share_of_steady_step=1.0 - prof["device_ms"] / n["steady_step_ms"], **prof,
             checks=run["checks"])
        if not all(run["checks"].values()):
            raise AssertionError(f"main path (bf16 train, {fmt}) checks failed: {run['checks']}")
        launches[f"train_{fmt}_bf16"] = (run["fwd"], run["bwd"])
        del run["state"]
    return launches


def phase_main_path_generate_bf16(seed: int, smi: str) -> dict:
    """``generate()`` of bf16 models (configs with ``dtype`` and
    ``frontend_dtype`` bfloat16, as train() writes them at the JAX package's
    training point; generate runs the frontend in f32): the face model at
    DDIM-500, CFG 10.0, and the pose model on the guide's keyframes at
    DDIM-500, CFG 2.0, 2 clips of 20 s each; the bf16 kernel's launches;
    5 more DDIM steps of each timed and profiled."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts

    person, num_samples, steps = "SYNTH01", 2, 500
    if not os.path.isdir(os.path.join(WORK, person)):
        make_synthetic_person(WORK, person, num_scenes=8, frames_per_scene=600, seed=seed)
    guide_dir, vq_dir = _guide_dirs(seed)
    launches = {}
    for fmt, build, guidance in (("face", _face_model, FACE_GUIDANCE), ("pose", _pose_model, 2.0)):
        cfg, model = build(seed, dtype="bfloat16", frontend_dtype="bfloat16")
        d = os.path.join(WORK, f"{fmt}_model_bf16")
        save_config(d, denoiser=cfg, diffusion=DiffusionConfig(),
                    data=DataConfig(person=person, data_format=fmt, max_seq_length=cfg.max_seq_length))
        torch.save(model.state_dict(), os.path.join(d, MODEL_FILE))
        del model
        kw = dict(guide_path=guide_dir, vq_path=vq_dir) if fmt == "pose" else {}
        timings: dict = {}
        launch_counts.clear()
        t0 = time.perf_counter()
        path = generate(d, WORK, num_samples=num_samples, guidance_param=guidance, timestep_respacing=f"ddim{steps}",
                        device="cuda", timings=timings, output_dir=os.path.join(WORK, f"samples_{fmt}_bf16"), **kw)
        total_s = time.perf_counter() - t0
        bf16_launches, f32_launches = launch_counts[flash_attn.BF16_NAME], launch_counts[flash_attn.NAME]
        res = np.load(path, allow_pickle=True).item()
        prof = _profile_ddim(d, guidance, seed)
        want = (cfg.cond_encoder_layers if fmt == "face" else 0) + cfg.num_layers * 2 * steps
        audio_s = num_samples * cfg.max_seq_length / 30.0
        checks = {
            "motions_shape": list(res["motions"].shape) == [num_samples, cfg.nfeats, 1, cfg.max_seq_length],
            "motions_finite": bool(np.isfinite(res["motions"]).all()),
            "bf16_attention_launches": bf16_launches == want and f32_launches == 0,
        }
        emit("main_path_generate_bf16", nvidia_smi=smi, model=fmt, samples=num_samples, ddim_steps=steps,
             guidance=guidance, dtype=cfg.dtype, frontend_dtype_in_config=cfg.frontend_dtype,
             keyframes="guide" if fmt == "pose" else None, guide_s=timings["guide_s"], lip_s=timings["lip_s"],
             encode_s=timings["encode_s"], ddim_s=timings["ddim_s"], ddim_step_ms=1e3 * timings["ddim_s"] / steps,
             generate_s=total_s, audio_s=audio_s, audio_s_per_wall_s=audio_s / total_s,
             kernel_launches=bf16_launches, **prof, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"main path (bf16 generate, {fmt}) checks failed: {checks}")
        launches[f"{'generate' if fmt == 'pose' else 'face'}_bf16"] = bf16_launches
    return launches


# the demo server's requests: (seconds, sample rate, channels); the first rendered (the
# others' renders, each half a compressed .npz write without ffmpeg, repeat its path)
DEMO_REQUESTS = [(8, 16_000, 1), (8, 44_100, 2), (12, 48_000, 1)]
DEMO_BF16_REQUEST = (8, 16_000, 1)
DEMO_STEPS = 100  # the demo's DDIM-100
DEMO_PARITY_STEPS, DEMO_PARITY_SECONDS = 5, 4
# card vs CPU, of the output's largest magnitude (PERF.md §2's f32 slice bars)
DEMO_POSE_REL_TOL, DEMO_FACE_REL_TOL = 1e-3, 1e-4
REMAT_GRAD_TOL = 1e-6  # remat vs plain step, of each gradient tensor's largest element
REMAT_PARITY_BATCH, REMAT_STEPS = 4, 4
SAMPLER_STEPS = 10


def _demo_pose_dir(name: str, pose_dir: str, guide_dir: str, vq_dir: str) -> str:
    """A pose checkpoint dir as the demo reads it: ``pose_dir``'s config.json
    and model.pt, with the guide and VQ dirs as its ``guide/`` and ``vq/``."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in ("config.json", "model.pt"):
        os.symlink(os.path.join(pose_dir, f), os.path.join(d, f))
    os.symlink(guide_dir, os.path.join(d, "guide"))
    os.symlink(vq_dir, os.path.join(d, "vq"))
    return d


def _demo_wav(rng, seconds: int, sr: int, channels: int):
    import numpy as np

    wav = (rng.randn(seconds * sr, channels) * 0.1).astype(np.float32)
    return wav[:, 0] if channels == 1 else wav


def _demo_step_profile(pipe, audio_s: int, seed: int) -> dict:
    """One DDIM-100 step of each of the demo's models (cached CFG on a
    request's clip) under torch.profiler: device ms, idle share, launches."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.demo import prepare_audio
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    rng = np.random.RandomState(seed)
    audio = prepare_audio(_demo_wav(rng, audio_s, 48_000, 1), 48_000, seed)
    audio_n = torch.from_numpy(np.asarray(pipe.stats.norm_audio(audio), np.float32))[None].cuda()
    T = audio.shape[0] // 1600
    out = {}
    with torch.no_grad():
        for name, guidance in (("face", FACE_GUIDANCE), ("pose", 2.0)):
            entry = getattr(pipe, name)
            model, sched = entry["model"], entry["sched"]
            kf = kv = None
            if name == "pose":
                kf = torch.randn((1, -(-T // model.cfg.keyframe_step), model.cfg.key_feature_dim), device="cuda")
                kv = torch.ones(kf.shape[:2], device="cuda")
            fn = cfg_model_fn_cached(model, model.encode_conditioning(audio_n, kf, kv), guidance)
            x = torch.randn((1, T, model.cfg.nfeats), device="cuda")
            t = torch.tensor([int(sched.timestep_map[DEMO_STEPS // 2])], device="cuda")
            fn(x, t)  # warm
            out[name] = _profile_call(lambda: fn(x, t))
    return out


def phase_main_path_demo(seed: int, smi: str) -> dict:
    """The demo server (``apps/demo.py:DemoPipeline``) on phase 8's
    full-width face and pose models, the pose model's guide and VQ as its
    ``guide/`` and ``vq/``, and phase 8's renderer bundle (2 cameras):
    three requests (``DEMO_REQUESTS``: 8 s mono at 16 kHz, 8 s stereo at
    44.1 kHz, 12 s mono at 48 kHz), each at DDIM-100, the first rendered to
    a video; a fourth (``DEMO_BF16_REQUEST``) to a pipeline on phase 16's bf16
    checkpoints, not rendered.  Per request: wall, the face and pose DDIM,
    the guide, ``audio_s_per_wall_s`` (audio seconds over the generate
    wall), the render and frames/s, each kernel's launches (each must
    rise: the f32 or bf16 attention forward, the raster and the display
    pass); then one DDIM-100 step of each model profiled."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps import render_pipeline
    from audio2photoreal_tpu_torch.apps.demo import DemoPipeline
    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, launch_counts, raster

    person = "SYNTH01"
    guide_dir, vq_dir = os.path.join(WORK, "guide_model"), os.path.join(WORK, "vq_model")
    t0 = time.perf_counter()
    pose_dir = _demo_pose_dir("demo_pose_model", os.path.join(WORK, "pose_model"), guide_dir, vq_dir)
    pipe = DemoPipeline(os.path.join(WORK, "face_model"), pose_dir, WORK, person,
                        renderer_path=os.path.join(WORK, "renderer"), device="cuda")
    load_s = time.perf_counter() - t0
    fcfg, pcfg = pipe.face["model"].cfg, pipe.pose["model"].cfg
    kernels = (flash_attn.NAME, flash_attn.BF16_NAME, raster.NAME, display_pack.NAME)
    totals = dict.fromkeys(kernels, 0)
    rng = np.random.RandomState(seed + 70)

    def request(p, i, seconds, sr, channels, render):
        wav = _demo_wav(rng, seconds, sr, channels)
        timings: dict = {}
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = p.generate(wav, sr, seed=seed + i, timings=timings)
        generate_s = time.perf_counter() - t0
        video, render_s, written = None, 0.0, []
        if render:  # the video file's write timed apart (without ffmpeg: a compressed .npz of the frames)
            real_write = render_pipeline.write_video

            def timed_write(*args, **kwargs):
                t = time.perf_counter()
                out = real_write(*args, **kwargs)
                written.append(time.perf_counter() - t)
                return out

            render_pipeline.write_video = timed_write
            try:
                t1 = time.perf_counter()
                video = p.render_video(res, os.path.join(WORK, f"demo_request{i}"))
                render_s = time.perf_counter() - t1
            finally:
                render_pipeline.write_video = real_write
        wall_s = time.perf_counter() - t0
        launches = {k: launch_counts[k] for k in kernels}
        for k in kernels:
            totals[k] += launches[k]
        T = res["face"].shape[0]
        audio_s = T / 30.0
        fwd = flash_attn.BF16_NAME if p.face["model"].cfg.dtype == "bfloat16" else flash_attn.NAME
        want_attn = p.face["model"].cfg.cond_encoder_layers + 2 * DEMO_STEPS * (
            p.face["model"].cfg.num_layers + p.pose["model"].cfg.num_layers)
        per_view = -(-T // p.renderer.frame_batch) * len(p.renderer.cameras) if render else 0
        checks = {
            "face_shape": list(res["face"].shape) == [T, fcfg.nfeats],
            "pose_shape": list(res["pose"].shape) == [T, pcfg.nfeats],
            "audio_shape": list(res["audio"].shape) == [T * 1600, 2] and T == (seconds // 4) * 120,
            "finite": bool(np.isfinite(res["face"]).all() and np.isfinite(res["pose"]).all()),
            "attention_launches": launches[fwd] == want_attn
            and launches[flash_attn.NAME if fwd == flash_attn.BF16_NAME else flash_attn.BF16_NAME] == 0,
            "raster_launches": launches[raster.NAME] == per_view and (per_view > 0) == render,
            "display_pack_launches": launches[display_pack.NAME] == per_view,
        }
        if render:
            checks["video_written"] = os.path.exists(video)
        row = dict(request=i, seconds=seconds, sample_rate=sr, channels=channels, frames=T,
                   dtype=p.face["model"].cfg.dtype, wall_s=wall_s, generate_s=generate_s,
                   audio_s=audio_s, audio_s_per_wall_s=audio_s / generate_s,
                   audio_s_per_wall_s_with_render=audio_s / wall_s, face_encode_s=timings["face_encode_s"],
                   face_ddim_s=timings["face_ddim_s"], guide_s=timings["guide_s"],
                   pose_encode_s=timings["pose_encode_s"], pose_ddim_s=timings["pose_ddim_s"],
                   render_s=render_s, frames_per_s=(T / render_s) if render else None,
                   video_write_s=sum(written), frames_per_s_without_write=(T / (render_s - sum(written)))
                   if render else None,
                   video=os.path.relpath(video, ROOT) if video else None, kernel_launches=launches,
                   expected_attention_launches=want_attn, checks=checks)
        emit("main_path_demo", nvidia_smi=smi, ddim_steps=DEMO_STEPS, **row)
        if video:
            os.remove(video)  # the frames of a request: gigabytes without ffmpeg
        if not all(checks.values()):
            raise AssertionError(f"demo request {i} checks failed: {checks}")
        return row

    rows = [request(pipe, i, *r, render=i == 0) for i, r in enumerate(DEMO_REQUESTS)]
    prof = _demo_step_profile(pipe, DEMO_REQUESTS[0][0], seed)
    del pipe
    pose16 = _demo_pose_dir("demo_pose_model_bf16", os.path.join(WORK, "pose_model_bf16"), guide_dir, vq_dir)
    pipe16 = DemoPipeline(os.path.join(WORK, "face_model_bf16"), pose16, WORK, person, device="cuda")
    rows.append(request(pipe16, len(DEMO_REQUESTS), *DEMO_BF16_REQUEST, render=False))
    del pipe16
    emit("main_path_demo_summary", nvidia_smi=smi, load_s=load_s, kernel_launches=totals,
         warm_requests_wall_s=[r["wall_s"] for r in rows[1:3]],
         ddim100_step_face=prof["face"], ddim100_step_pose=prof["pose"])
    return totals


def phase_demo_parity(seed: int) -> None:
    """``DemoPipeline.generate`` on the card against the CPU at full width
    (phase 8's face and pose models, the guide and VQ loaded), DDIM-5, on
    one 4 s request at 16 kHz: the same x_T (``apps.demo.draw_noise``
    answered from numpy) and the same keyframes (the keyframer answered
    from numpy) on both; face within 1e-4 and pose within 1e-3 of the
    output's largest magnitude, the audio bit for bit."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps import demo

    rng = np.random.RandomState(seed + 71)
    wav = _demo_wav(rng, DEMO_PARITY_SECONDS, 16_000, 1)
    T = DEMO_PARITY_SECONDS * 30
    noise = {256: rng.randn(1, T, 256).astype(np.float32), 104: rng.randn(1, T, 104).astype(np.float32)}
    kf = rng.randn(1, -(-T // 30), 104).astype(np.float32)
    pose_dir = os.path.join(WORK, "demo_pose_model")
    real_draw = demo.draw_noise
    out, secs = {}, {}
    demo.draw_noise = lambda shape, generator, device: torch.from_numpy(noise[shape[-1]]).to(device)
    try:
        for device in ("cuda", "cpu"):
            pipe = demo.DemoPipeline(os.path.join(WORK, "face_model"), pose_dir, WORK, "SYNTH01",
                                     timestep_respacing=f"ddim{DEMO_PARITY_STEPS}", device=device)
            pipe.keyframer = lambda audio, k, generator, top_p: torch.from_numpy(kf).to(audio.device)
            t0 = time.perf_counter()
            out[device] = pipe.generate(wav, 16_000, seed=seed)
            secs[device] = time.perf_counter() - t0
            del pipe
    finally:
        demo.draw_noise = real_draw
    g, c = out["cuda"], out["cpu"]
    err = {k: float(np.abs(g[k] - c[k]).max()) for k in ("face", "pose")}
    scale = {k: float(np.abs(c[k]).max()) for k in ("face", "pose")}
    checks = {"face": err["face"] <= DEMO_FACE_REL_TOL * scale["face"],
              "pose": err["pose"] <= DEMO_POSE_REL_TOL * scale["pose"],
              "audio_equal": bool(np.array_equal(g["audio"], c["audio"]))}
    emit("demo_parity", ddim_steps=DEMO_PARITY_STEPS, seconds=DEMO_PARITY_SECONDS, sample_rate=16_000, frames=T,
         max_abs_err=err, scale=scale, rel_err={k: err[k] / scale[k] for k in err},
         rel_tol={"face": DEMO_FACE_REL_TOL, "pose": DEMO_POSE_REL_TOL}, gpu_s=secs["cuda"], cpu_s=secs["cpu"],
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the demo on the card disagrees with the CPU's: {checks}")


def _face_cached_batch(rng, B: int, T: int, nfeats: int) -> dict:
    """A face batch on cached features and lip vertices, ragged lengths and
    missing frames."""
    import numpy as np

    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames

    lengths = np.array([T, T, 450, 333] * (B // 4) + [T] * (B % 4), np.int32)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    mask[0, 100:140] = 0.0  # missing face frames inside the valid length
    return {"motion": rng.randn(B, T, nfeats).astype(np.float32) * mask[..., None], "mask": mask,
            "lengths": lengths, "audio_features": rng.rand(B, tokens_for_frames(T), 1024).astype(np.float32),
            "lip_verts": rng.randn(B, T, 1014).astype(np.float32)}


def _face_on_card(cfg, state_dict):
    """The face model of ``cfg`` built on the card (no CPU init) with
    ``state_dict``'s weights, in training mode."""
    import torch

    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    with torch.device("cuda"):
        model = FiLMDenoiser(cfg)
    model.load_state_dict(state_dict)
    return model.cuda().train()


def phase_remat(seed: int, smi: str) -> dict:
    """Gradient checkpointing of the decoder layers (``DenoiserConfig.remat``)
    on the full-width face model in training mode (hash dropout 0.1, the
    guidance drop 0.2), f32 and bf16: one step at batch 4 with and without
    remat from the same weights, batch and draws: gradients within 1e-6 of
    each tensor's largest element (bit-equal printed), the decoder's
    forward launches doubled (the recompute) and the backward's unchanged;
    then the face point at batch 64 for 4 steps each way: steps/s over
    steps 2-4 and peak GB."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.core.config import DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    sched, dcfg = make_schedule().to_device("cuda"), DiffusionConfig()
    cfg32, base = _face_model(seed, hash_dropout=True, dropout=TRAIN_DROPOUT)
    weights = {k: v.cuda() for k, v in base.state_dict().items()}
    del base
    launches = {}
    for dtype in ("float32", "bfloat16"):
        fwd_k, bwd_k = ((flash_attn.BF16_NAME, flash_attn.BF16_BWD_NAME) if dtype == "bfloat16"
                        else (flash_attn.NAME, flash_attn.BWD_NAME))
        cfg = dataclasses.replace(cfg32, dtype=dtype)
        plain, remat = (_face_on_card(dataclasses.replace(cfg, remat=r), weights) for r in (False, True))
        rng = np.random.RandomState(seed + 72)
        B, T = REMAT_PARITY_BATCH, cfg.max_seq_length
        batch = _device_batch(_face_cached_batch(rng, B, T, cfg.nfeats))
        t = torch.tensor([0, 250, 600, 999])
        noise = torch.from_numpy(rng.randn(B, T, cfg.nfeats).astype(np.float32)).cuda()
        out = {}
        for name, model in (("plain", plain), ("remat", remat)):
            state = TrainState(model, TrainConfig(lr=LR))
            launch_counts.clear()
            metrics, _ = diffusion_train_step(state, sched, dcfg, batch, torch.Generator().manual_seed(seed), t=t,
                                              noise=noise)
            out[name] = (metrics, {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                   if p.grad is not None}, launch_counts[fwd_k], launch_counts[bwd_k])
            launches[f"remat_{dtype}_{name}"] = (launch_counts[fwd_k], launch_counts[bwd_k])
        (mp, gp, fp, bp), (mr, gr, fr, br) = out["plain"], out["remat"]
        rel = {n: (gr[n] - gp[n]).abs().max().item() / max(gp[n].abs().max().item(), 1e-30) for n in gp}
        worst = max(rel, key=rel.get)
        decoder = 2 * cfg.num_layers  # the decoder's self- and cross-attention a layer
        checks = {"same_grad_names": sorted(gp) == sorted(gr), "gradients": rel[worst] <= REMAT_GRAD_TOL,
                  "loss": abs(mp["loss"] - mr["loss"]) <= REMAT_GRAD_TOL * abs(mp["loss"]),
                  "forward_launches": fp == cfg.cond_encoder_layers + decoder and fr == fp + decoder,
                  "backward_launches": br == bp == cfg.cond_encoder_layers + decoder}
        emit("remat", dtype=dtype, batch=B, loss_plain=mp["loss"], loss_remat=mr["loss"],
             grad_max_rel_err=rel[worst], grad_worst_tensor=worst, grads_compared=len(gp),
             grads_bit_equal=all(torch.equal(gp[n], gr[n]) for n in gp), tol=REMAT_GRAD_TOL,
             attention_fwd_launches={"plain": fp, "remat": fr}, attention_bwd_launches={"plain": bp, "remat": br},
             decoder_fwd_launches={"plain": decoder, "remat": fr - fp + decoder}, checks=checks)
        del plain, remat, out, gp, gr
        if not all(checks.values()):
            raise AssertionError(f"remat ({dtype}) checks failed: {checks}")

        # the face point at batch 64, each way
        rows = {}
        for name in ("plain", "remat"):
            model = _face_on_card(dataclasses.replace(cfg, remat=name == "remat"), weights)
            state = TrainState(model, TrainConfig(lr=LR))
            big = _device_batch(_face_cached_batch(np.random.RandomState(seed + 73), TRAIN_BATCH, T, cfg.nfeats))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_s = []
            for i in range(REMAT_STEPS):
                t0 = time.perf_counter()
                metrics, _ = diffusion_train_step(state, sched, dcfg, big, torch.Generator().manual_seed(seed + i),
                                                  torch.Generator(device="cuda").manual_seed(seed + i))
                step_s.append(time.perf_counter() - t0)  # the step ends in a read-back
            rows[name] = dict(**_steady(step_s), peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                              loss=metrics["loss"])
            del model, state, big
            torch.cuda.empty_cache()
        emit("remat_face_b64", nvidia_smi=smi, dtype=dtype, batch=TRAIN_BATCH, steps=REMAT_STEPS, **rows,
             steps_per_s_ratio=rows["remat"]["train_steps_per_s"] / rows["plain"]["train_steps_per_s"],
             peak_gb_saved=rows["plain"]["peak_memory_gb"] - rows["remat"]["peak_memory_gb"])
        if not all(math.isfinite(r["loss"]) for r in rows.values()):
            raise AssertionError(f"remat at batch 64 ({dtype}): a loss is not finite: {rows}")
    return launches


def phase_samplers(seed: int) -> None:
    """PLMS-10 (order 2, the reference's default) and ancestral-10 with the
    full-width pose model (cached CFG 2.0, one 20 s clip), card against CPU,
    the same x_T and (ancestral) the same step noise from numpy
    (``sampling.draw_step_noise`` answered): pred_xstart within the pose
    slice bar (1e-3)."""
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.core.config import DiffusionConfig
    from audio2photoreal_tpu_torch.diffusion import sampling
    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached

    cfg, model_cpu = _pose_model(seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    rng = np.random.RandomState(seed + 74)
    T = cfg.max_seq_length
    audio = (rng.randn(1, T * 1600, 2) * 0.5).astype(np.float32)
    kf = rng.randn(1, -(-T // 30), 104).astype(np.float32)
    x_T = rng.randn(1, T, cfg.nfeats).astype(np.float32)
    steps = [rng.randn(1, T, cfg.nfeats).astype(np.float32) for _ in range(SAMPLER_STEPS)]
    dcfg = DiffusionConfig()
    sched = maybe_respaced(dcfg.schedule, dcfg.steps, str(SAMPLER_STEPS))
    real_noise = sampling.draw_step_noise
    for name in ("plms", "ancestral"):
        out, secs = {}, {}
        for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            queue = list(steps)
            sampling.draw_step_noise = lambda shape, g, dev: torch.from_numpy(queue.pop(0)).to(dev)
            try:
                t0 = time.perf_counter()
                with torch.no_grad():
                    cond = model.encode_conditioning(*(torch.from_numpy(a).to(device)
                                                       for a in (audio, kf, np.ones((1, kf.shape[1]), np.float32))))
                    fn = cfg_model_fn_cached(model, cond, 2.0)
                    xt = torch.from_numpy(x_T).to(device)
                    if name == "plms":
                        res = sampling.plms_sample_loop(sched, dcfg.predict, fn, xt)
                    else:
                        res = sampling.p_sample_loop(sched, dcfg.predict, dcfg.var_type, fn, xt)
                out[device] = (res.pred_xstart.cpu(), res.sample.cpu(), len(steps) - len(queue))
                secs[device] = time.perf_counter() - t0
            finally:
                sampling.draw_step_noise = real_noise
        (gx, gs, gn), (cx, cs, cn) = out["cuda"], out["cpu"]
        err = (gx - cx).abs().max().item()
        checks = {"pred_xstart": err <= SLICE_TOL, "sample": (gs - cs).abs().max().item() <= SLICE_TOL,
                  "finite": bool(torch.isfinite(gx).all()),
                  "noise_draws": gn == cn == (SAMPLER_STEPS - 1 if name == "ancestral" else 0)}
        emit("samplers", sampler=name, steps=SAMPLER_STEPS, latent=cfg.latent_dim, layers=cfg.num_layers, frames=T,
             max_abs_err=err, sample_max_abs_err=(gs - cs).abs().max().item(), scale=cx.abs().max().item(),
             tol=SLICE_TOL, noise_draws=gn, gpu_s=secs["cuda"], cpu_s=secs["cpu"], checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"the {name} sampler on the card disagrees with the CPU's: {checks}")


VQ_BATCH, VQ_KEYFRAMES = 32, 20  # the JAX VQ CLI's batch; 20 keyframes = a 600-frame clip at 1 fps
VQ_REL_TOL = 1e-5  # loss (relative), codebooks (of their scale), card vs CPU
GUIDE_BATCH, GUIDE_FRAMES = 32, 240  # the JAX guide CLI's batch and max_seq_length (= min): 798 audio tokens
# most leaky ReLU slopes (of all a step computes) that the CPU's own pre-activations may flip
# against the card's, which the CPU step replays (``_slope_replay``)
SLOPE_FLIP_SHARE = 1e-6
VQ_GUIDE_TRAIN_STEPS = 4
CONVERT_DDIM = 50  # the converted checkpoints' generate, against the source modules'


def _profile_call(fn) -> dict:
    """``fn()`` once more under torch.profiler: wall, device-busy ms, idle
    share, kernels launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(profiled_wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1.0 - device_ms / wall_ms,
                device_launches=sum(e.count for e in events))


def _replayed_rows():
    """(rows, record, replay): stand-ins for ``vqvae.draw_rows``; ``record``
    draws as it does and keeps each draw in ``rows``, ``replay`` hands the
    same rows out again, in order, on the device asked for."""
    from audio2photoreal_tpu_torch.models import vqvae

    rows, real, served = [], vqvae.draw_rows, []

    def record(n, num, generator, device):
        r = real(n, num, generator, device)
        rows.append(r.cpu())
        return r

    def replay(n, num, generator, device):
        served.append(None)
        return rows[len(served) - 1].to(device)

    return rows, record, replay


def phase_vq_train_parity(seed: int) -> None:
    """One VQ step at ``VQConfig()`` (width 64, 1024 codes, depth 4, 10
    k-means iterations), batch 32 x 20 keyframes, k-means firing in it, on
    the card against the CPU with the same rows drawn: loss 1e-5 relative;
    codes equal, or each differing code a near-tie of its two best distances
    (counted); codebooks 1e-5 of their scale; gradients 1e-4 of their
    largest element; parameters after AdamW within 2 lr."""
    import copy

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.core.config import TrainConfig, VQConfig
    from audio2photoreal_tpu_torch.models import vqvae
    from audio2photoreal_tpu_torch.train.loops import vq_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    cfg = VQConfig()
    cpu = vqvae.TemporalVertexCodec(cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(seed))
    gpu = copy.deepcopy(cpu).cuda()
    kf = np.random.RandomState(seed + 41).randn(VQ_BATCH, VQ_KEYFRAMES, cfg.nfeats).astype(np.float32)
    rows, record, replay = _replayed_rows()
    draw_rows = vqvae.draw_rows
    seen = {}  # per device: [(embed before the update, residual)] of each depth
    ema = vqvae._ema_layer_update

    def spy(embed, embed_avg, cluster_size, x, onehot, c, generator):
        seen.setdefault(x.device.type, []).append((embed.detach().cpu(), x.detach().cpu()))
        return ema(embed, embed_avg, cluster_size, x, onehot, c, generator)

    out = {}
    vqvae._ema_layer_update = spy
    try:
        for device, model, draw in (("cpu", cpu, record), ("cuda", gpu, replay)):
            vqvae.draw_rows = draw
            codes = []
            hook = model.register_forward_hook(lambda m, i, o: codes.append(o.codes.cpu()))
            state = TrainState(model, TrainConfig(lr=1e-3))
            t0 = time.perf_counter()
            metrics = vq_train_step(state, {"keyframes": torch.from_numpy(kf).to(device)},
                                    torch.Generator(device=device).manual_seed(seed), cfg.commit_weight)
            secs = time.perf_counter() - t0
            hook.remove()
            books = [l._codebook for l in model.quantizer.layers]
            out[device] = dict(metrics=metrics, codes=codes[0], secs=secs,
                               grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                               params={n: p.detach().cpu() for n, p in model.named_parameters()},
                               state={n: torch.stack([getattr(b, n) for b in books]).cpu()
                                      for n in ("embed", "embed_avg", "cluster_size", "inited")})
    finally:
        vqvae._ema_layer_update = ema
        vqvae.draw_rows = draw_rows
    c, g = out["cpu"], out["cuda"]
    differ = (c["codes"] != g["codes"]).nonzero().tolist()  # [b, k, depth]
    ties, not_ties = 0, []
    for b, k, d in differ:  # the card's code against the CPU's, on the CPU's residual and codebook
        embed, x = seen["cpu"][d]
        r = x[b * VQ_KEYFRAMES + k]
        d2 = ((r[None] - embed) ** 2).sum(-1)
        gap = (d2[g["codes"][b, k, d]] - d2[c["codes"][b, k, d]]).abs().item()
        if gap <= 1e-5 * max(d2.min().item(), (r**2).sum().item(), 1e-30):
            ties += 1
        else:
            not_ties.append([b, k, d, gap])
    loss_rel = abs(g["metrics"]["loss"] - c["metrics"]["loss"]) / abs(c["metrics"]["loss"])
    state_err = {n: (g["state"][n] - c["state"][n]).abs().max().item() / max(c["state"][n].abs().max().item(), 1e-30)
                 for n in ("embed", "embed_avg", "cluster_size")}
    grad_rel = max((g["grads"][n] - c["grads"][n]).abs().max().item() / max(c["grads"][n].abs().max().item(), 1e-30)
                   for n in c["grads"])
    d = torch.cat([(g["params"][n] - c["params"][n]).abs().flatten() for n in c["params"]])
    row = dict(vectors=VQ_BATCH * VQ_KEYFRAMES, codes=cfg.code_dim, depth=cfg.depth, width=cfg.emb_width,
               kmeans_iters=cfg.kmeans_iters, rows_drawn=len(rows), loss_gpu=g["metrics"]["loss"],
               loss_cpu=c["metrics"]["loss"], loss_rel_err=loss_rel,
               metrics_gpu=g["metrics"], metrics_cpu=c["metrics"], codes_differing=len(differ),
               codes_differing_near_ties=ties, codes_differing_not_ties=not_ties, state_rel_err=state_err,
               codes_expired_share=float((c["state"]["cluster_size"] < cfg.threshold_ema_dead_code).float().mean()),
               inited=g["state"]["inited"].flatten().tolist(), grad_max_rel_err=grad_rel,
               param_max_abs_diff=d.max().item(), gpu_s=g["secs"], cpu_s=c["secs"], rel_tol=VQ_REL_TOL)
    emit("vq_train_parity", **row)
    if not (loss_rel <= VQ_REL_TOL and not not_ties and max(state_err.values()) <= VQ_REL_TOL
            and grad_rel <= 1e-4 and d.max().item() <= 2 * 1e-3 and all(v == 1.0 for v in row["inited"])
            and len(rows) == 2 * cfg.depth):
        raise AssertionError(f"the VQ step on the card disagrees with the CPU's: {row}")


def _guide_batch(rng, cached: bool, B: int, frames: int) -> dict:
    import numpy as np

    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames

    K = -(-frames // 30)
    kv = np.ones((B, K), np.float32)
    kv[-1, -3:] = 0.0
    b = {"keyframes": rng.randn(B, K, 104).astype(np.float32), "keyframe_valid": kv}
    if cached:
        b["audio_features"] = rng.rand(B, tokens_for_frames(frames), 1024).astype(np.float32)
    else:
        b["audio"] = (rng.randn(B, frames * 1600, 2) * 0.5).astype(np.float32)
    return b


def phase_guide_train_parity(seed: int) -> None:
    """One guide step at the JAX CLI's width (``GuideConfig()``: latent 512,
    6 layers; batch 32 x 240 frames, 798 audio tokens, 8 keyframes x 4 =
    32 tokens) on the trained-VQ's stand-in (``VQConfig()`` widths, random
    codebooks), raw audio and cached features, card against CPU, dropout
    out of the way (eval mode) and the conditioning dropout injected; the
    CPU step replays the card's leaky ReLU slopes (``_slope_replay``: the
    audio pre-net's 12 leaky ReLUs make its gradients jump where a
    pre-activation lies within rounding of 0), the flips its own
    pre-activations would take counted and held to ``SLOPE_FLIP_SHARE``:
    the train-parity f32 bars on every tensor (loss 1e-5 relative, each
    gradient 1e-4 of its largest element, parameters after AdamW within 2
    lr and 99.9% within 1e-6), accuracy and tokens equal."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.core.config import TrainConfig
    from audio2photoreal_tpu_torch.train.loops import guide_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    guide_cpu, codec_cpu = _guide_models(seed)
    codec_gpu = copy.deepcopy(codec_cpu).cuda()
    keep = torch.ones(GUIDE_BATCH, dtype=torch.bool)
    keep[::5] = False  # the conditioning of every fifth clip dropped
    real_lrelu = F.leaky_relu
    for cached in (False, True):
        batch = _guide_batch(np.random.RandomState(seed + 43 + cached), cached, GUIDE_BATCH, GUIDE_FRAMES)
        out = {}
        seen, F.leaky_relu = _slope_replay()
        try:
            for device, model, codec in (("cuda", copy.deepcopy(guide_cpu).cuda(), codec_gpu),
                                         ("cpu", copy.deepcopy(guide_cpu), codec_cpu)):
                state = TrainState(model.eval(), TrainConfig(lr=2e-4, grad_clip=1.0))
                t0 = time.perf_counter()
                metrics = guide_train_step(state, codec,
                                           {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                           None, keep_mask=keep.to(device))
                secs = time.perf_counter() - t0
                with torch.no_grad():
                    tokens = codec.encode(torch.from_numpy(batch["keyframes"]).to(device)).cpu()
                out[device] = dict(metrics=metrics, secs=secs, tokens=tokens,
                                   grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()
                                          if p.grad is not None},
                                   params={n: p.detach().cpu() for n, p in model.named_parameters()})
                del state, model
        finally:
            F.leaky_relu = real_lrelu
        g, c = out["cuda"], out["cpu"]
        loss_rel = abs(g["metrics"]["loss"] - c["metrics"]["loss"]) / abs(c["metrics"]["loss"])
        rels = sorted(((g["grads"][n] - c["grads"][n]).abs().max().item()
                       / max(c["grads"][n].abs().max().item(), 1e-30), n) for n in c["grads"])
        prenet = sorted(r for r in rels if r[1].startswith("pre_audio."))
        grad_rel = rels[-1][0]
        d = torch.cat([(g["params"][n] - c["params"][n]).abs().flatten() for n in c["params"]])
        past = sorted((((g["params"][n] - c["params"][n]).abs() > 1e-6).sum().item(), n) for n in c["params"])
        n_slopes = sum(m.numel() for m in seen["slopes"])
        row = dict(cached=cached, batch=GUIDE_BATCH, frames=GUIDE_FRAMES, latent=guide_cpu.cfg.latent_dim,
                   layers=guide_cpu.cfg.num_layers, vocab=guide_cpu.cfg.tokens,
                   tokens_per_clip=int(g["tokens"][0].numel()), inputs=sorted(batch),
                   loss_gpu=g["metrics"]["loss"], loss_cpu=c["metrics"]["loss"], loss_rel_err=loss_rel,
                   acc_gpu=g["metrics"]["acc"], acc_cpu=c["metrics"]["acc"],
                   grad_norm_gpu=g["metrics"]["grad_norm"], grad_norm_cpu=c["metrics"]["grad_norm"],
                   tokens_equal=bool(torch.equal(g["tokens"], c["tokens"])), grads_compared=len(c["grads"]),
                   same_grad_names=sorted(g["grads"]) == sorted(c["grads"]), grad_max_rel_err=grad_rel,
                   worst_grad_tensors=rels[-3:], prenet_worst_grad_tensors=prenet[-3:],
                   leaky_relu_calls=len(seen["slopes"]), leaky_relu_calls_replayed=seen["replayed"],
                   leaky_relu_slopes=n_slopes, cpu_preactivation_slope_flips=seen["slope_flips"],
                   slope_flip_share_tol=SLOPE_FLIP_SHARE,
                   param_max_abs_diff=d.max().item(), param_share_within_1e6=(d <= 1e-6).float().mean().item(),
                   most_params_past_1e6=past[-3:], gpu_s=g["secs"], cpu_s=c["secs"])
        emit("guide_train_parity", **row)
        if not (loss_rel <= 1e-5 and row["acc_gpu"] == row["acc_cpu"] and row["tokens_equal"]
                and row["same_grad_names"] and grad_rel <= 1e-4 and prenet
                and d.max().item() <= 2 * 2e-4 and row["param_share_within_1e6"] >= 0.999
                and seen["replayed"] == len(seen["slopes"]) > 0
                and seen["slope_flips"] <= SLOPE_FLIP_SHARE * n_slopes):
            raise AssertionError(f"the guide step on the card disagrees with the CPU's: {row}")


def _steady(step_s) -> dict:
    steady = step_s[1:]
    return dict(step_s=step_s, steady_step_ms=1e3 * sum(steady) / len(steady),
                train_steps_per_s=len(steady) / sum(steady))


def phase_main_path_train_vq_guide(seed: int, smi: str) -> dict:
    """``train_vq`` (``VQConfig()``, batch 32, 600-frame windows, evaluate
    and ``ckpt_best`` at its last step) on the trainers' synthetic person,
    then ``train_guide`` (``GuideConfig()``, batch 32, 240 frames) on that
    VQ directory, raw and on the feature cache, ``VQ_GUIDE_TRAIN_STEPS``
    steps each; then ``generate`` of the pose model of phase 8 from the
    trained guide and VQ, 2 clips at DDIM-``CONVERT_DDIM``: the sampled
    keyframes are the trained VQ's decode of the guide's tokens.  Steps/s
    (steps 2-4), one more step of each profiled (device ms, idle,
    launches)."""
    import dataclasses

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps import train_guide, train_vq
    from audio2photoreal_tpu_torch.apps.generate import find_stats, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, GuideConfig, TrainConfig, VQConfig
    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
    from audio2photoreal_tpu_torch.data.loader import FastLoader, SceneIndex
    from audio2photoreal_tpu_torch.kernels import launch_counts
    from audio2photoreal_tpu_torch.models import guide as guide_module
    from audio2photoreal_tpu_torch.train.loops import guide_train_step, vq_train_step

    person, root = "SYNTH01", _train_person(seed)
    stats = find_stats(os.path.join(root, person))
    steps = VQ_GUIDE_TRAIN_STEPS
    launch_counts.clear()
    # --- the VQ ---------------------------------------------------------------
    vq_dir = os.path.join(WORK, "train_vq")
    shutil.rmtree(vq_dir, ignore_errors=True)
    vcfg, vdata = VQConfig(), DataConfig(person=person, batch_size=VQ_BATCH)
    timings: dict = {}
    t0 = time.perf_counter()
    vstate = train_vq.train(root, vq_dir, vcfg, vdata, TrainConfig(lr=1e-3, num_steps=steps, save_interval=steps,
                                                                 log_interval=1, warmup_steps=1000, seed=seed),
                            device="cuda", timings=timings, reader="fastdata")
    vq_train_s = time.perf_counter() - t0
    logged = [json.loads(l) for l in open(os.path.join(vq_dir, "log.jsonl"))]
    loader = FastLoader(SceneIndex(root, person), stats, vdata, reader="fastdata")
    kf = torch.from_numpy(loader.sample_batch(VQ_BATCH, np.random.RandomState(seed))["keyframes"]).cuda()
    vprof = _profile_call(lambda: vq_train_step(vstate, {"keyframes": kf}, torch.Generator(device="cuda").manual_seed(7),
                                                vcfg.commit_weight))
    vq_numbers = dict(**_steady(timings["step_s"]), eval_s=timings["eval_s"], train_s=vq_train_s, **vprof)
    vq_numbers["device_idle_share_of_steady_step"] = 1.0 - vprof["device_ms"] / vq_numbers["steady_step_ms"]
    val = [r for r in logged if "val_recon" in r]
    vq_checks = {
        "losses_finite": all(np.isfinite(r["loss"]) for r in logged if "loss" in r),
        "kmeans_inited": all(l._codebook.inited.item() == 1.0 for l in vstate.model.quantizer.layers),
        "evaluate_ran": len(val) == 1 and bool(np.isfinite([val[0]["val_recon"], val[0]["val_ppl"]]).all()),
        "ckpt_best_written": os.path.exists(os.path.join(vq_dir, train_vq.BEST_DIR, "model.pt")),
        "model_written": os.path.exists(os.path.join(vq_dir, "model.pt")),
    }
    emit("main_path_train_vq", nvidia_smi=smi, batch=VQ_BATCH, steps=steps, config=dataclasses.asdict(vcfg),
         losses=[r["loss"] for r in logged if "loss" in r], perplexity=[r["perplexity"] for r in logged
                                                                        if "perplexity" in r],
         val=val, **vq_numbers, checks=vq_checks)
    del vstate
    # --- the guide, raw and cached ----------------------------------------------
    gdata = DataConfig(person=person, batch_size=GUIDE_BATCH, max_seq_length=GUIDE_FRAMES,
                       min_seq_length=GUIDE_FRAMES)
    guide_numbers, guide_dirs, checks = {}, {}, dict(vq_checks)
    for cached in (False, True):
        variant = "cached" if cached else "raw"
        d = guide_dirs[variant] = os.path.join(WORK, f"train_guide_{variant}")
        shutil.rmtree(d, ignore_errors=True)
        timings = {}
        t0 = time.perf_counter()
        gstate = train_guide.train(root, d, vq_dir, GuideConfig(), gdata,
                                   TrainConfig(lr=2e-4, num_steps=steps, save_interval=10**9, log_interval=1,
                                               grad_clip=1.0, warmup_steps=1000, seed=seed),
                                   cache_audio_features=cached, device="cuda", timings=timings, reader="fastdata")
        train_s = time.perf_counter() - t0
        logged = [json.loads(l) for l in open(os.path.join(d, "log.jsonl"))]
        codec = train_guide.load_tokenizer(vq_dir, "cuda")
        b = FastLoader(SceneIndex(root, person), stats, gdata, reader="fastdata").sample_batch(
            GUIDE_BATCH, np.random.RandomState(seed))
        batch = {k: torch.from_numpy(b[k]).cuda() for k in ("keyframes", "keyframe_valid", "audio")}
        if cached:  # features in place of the audio (their values do not change the work)
            del batch["audio"]
            batch["audio_features"] = torch.rand((GUIDE_BATCH, tokens_for_frames(GUIDE_FRAMES), 1024),
                                                 device="cuda")
        gprof = _profile_call(lambda: guide_train_step(gstate, codec, batch, torch.Generator().manual_seed(7)))
        n = dict(**_steady(timings["step_s"]), cache_s=timings.get("cache_s"), train_s=train_s, **gprof)
        n["device_idle_share_of_steady_step"] = 1.0 - gprof["device_ms"] / n["steady_step_ms"]
        guide_numbers[variant] = n
        checks[f"guide_{variant}_losses_finite"] = (len(logged) == steps
                                                    and all(np.isfinite(r["loss"]) for r in logged))
        checks[f"guide_{variant}_saved"] = os.path.exists(os.path.join(d, "model.pt"))
        emit("main_path_train_guide", nvidia_smi=smi, variant=variant, batch=GUIDE_BATCH, frames=GUIDE_FRAMES,
             steps=steps, vocab=gstate.model.cfg.tokens, vq_depth=gstate.model.cfg.vq_depth,
             losses=[r["loss"] for r in logged], acc=[r["acc"] for r in logged], **n)
        del gstate
    # --- generate from the trained guide and VQ ------------------------------------
    sampled = []
    guide_generate = guide_module.GuideTransformer.generate

    def recording_generate(self, *args, **kwargs):
        out = guide_generate(self, *args, **kwargs)
        sampled.append(out)
        return out

    timings = {}
    guide_module.GuideTransformer.generate = recording_generate
    try:
        t0 = time.perf_counter()
        path = generate(os.path.join(WORK, "pose_model"), WORK, num_samples=2, guidance_param=2.0,
                        timestep_respacing=f"ddim{CONVERT_DDIM}", guide_path=guide_dirs["cached"], vq_path=vq_dir,
                        device="cuda", timings=timings, output_dir=os.path.join(WORK, "samples_trained_guide"))
        generate_s = time.perf_counter() - t0
    finally:
        guide_module.GuideTransformer.generate = guide_generate
    res = np.load(path, allow_pickle=True).item()
    codec = train_guide.load_tokenizer(vq_dir, "cuda")
    with torch.no_grad():
        # generate inverse-normalises by the statistics of its own data root
        want = find_stats(os.path.join(WORK, person)).inv_pose(
            codec.decode(sampled[0].reshape(2, -1, vcfg.depth)).cpu().numpy())
    got = res["keyframes"]
    checks.update(
        tokens_in_range=bool(((sampled[0] >= 0) & (sampled[0] < vcfg.code_dim)).all()),
        keyframes_decode_through_the_trained_vq=got.shape == want.shape
        and bool(np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)),
        motions_finite=bool(np.isfinite(res["motions"]).all()),
    )
    emit("main_path_train_vq_guide", nvidia_smi=smi, vq_train_steps_per_s=vq_numbers["train_steps_per_s"],
         guide_train_steps_per_s={k: v["train_steps_per_s"] for k, v in guide_numbers.items()},
         vq_device_ms_per_step=vq_numbers["device_ms"],
         guide_device_ms_per_step={k: v["device_ms"] for k, v in guide_numbers.items()},
         vq_launches_per_step=vq_numbers["device_launches"],
         guide_launches_per_step={k: v["device_launches"] for k, v in guide_numbers.items()},
         vq_idle_share=vq_numbers["device_idle_share_of_steady_step"],
         guide_idle_share={k: v["device_idle_share_of_steady_step"] for k, v in guide_numbers.items()},
         guide_s=timings["guide_s"], ddim_steps=CONVERT_DDIM, generate_s=generate_s,
         keyframes_shape=list(got.shape), port_kernel_launches=dict(launch_counts), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (train VQ -> guide -> generate) checks failed: {checks}")
    return dict(vq=vq_numbers, guide=guide_numbers)


def phase_convert_reference_tree(seed: int, smi: str) -> None:
    """A reference-layout checkpoint tree written from random full-width port
    modules (the pose denoiser at ``DenoiserConfig()``, the guide at
    ``GuideConfig()``, the VQ at ``VQConfig()``'s widths; the ``args.json``
    fields of the JAX package's CLI test, ``{"net": ...}``, ``{"model_state_dict":
    ...}`` with 1998 null rows, rotary tables and vq-wav2vec's other parts
    beside the denoiser's keys), converted by ``convert_person``; then
    ``generate`` on the card from the converted dirs and from the source
    modules' own dirs, same seed: results equal bit for bit.  The tree also
    holds a person's avatar at full width (``ca_body/data/<person>/``: a
    reference-layout ``static_assets.pt`` at UV 1024 / 2048 on the
    mesh_density=10 synthetic person, a ``body_dec.ckpt`` of a random
    ``RendererConfig()`` avatar under the reference's names, with a trained
    AutoEncoder's calibration and asset buffers beside them): its bundle,
    through ``load_body_renderer``, renders one frame on the card bit for bit
    as the source avatar on the converted assets does."""
    import dataclasses

    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.convert_checkpoint import convert_person, frontal_rig
    from audio2photoreal_tpu_torch.apps.render_pipeline import BodyRenderer, load_body_renderer
    from audio2photoreal_tpu_torch.render.assets import convert_static_assets, reference_static_assets
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig
    from audio2photoreal_tpu_torch.apps.generate import MODEL_FILE, generate
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, save_config
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser

    person = "SYNTH01"
    tree, out = os.path.join(WORK, "reference_tree"), os.path.join(WORK, "converted")
    for d in (tree, out):
        shutil.rmtree(d, ignore_errors=True)
    common = dict(max_seq_length=600, add_frame_cond=1, data_root=f"dataset/{person}")

    def args(d, **kw):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "args.json"), "w") as f:
            json.dump({**kw, **common}, f)

    t0 = time.perf_counter()
    mcfg = DenoiserConfig(data_format="pose")
    pose = FiLMDenoiser(mcfg)
    pose.reset_parameters(torch.Generator().manual_seed(seed + 51))
    guide, codec = _guide_models(seed + 52)
    src = {"pose": os.path.join(WORK, "source_pose")}
    save_config(src["pose"], denoiser=mcfg, diffusion=DiffusionConfig(),
                data=DataConfig(person=person, max_seq_length=600))
    torch.save(pose.state_dict(), os.path.join(src["pose"], MODEL_FILE))
    for name, model, section in (("guide", guide, dict(guide=guide.cfg)), ("vq", codec, dict(vq=codec.cfg))):
        src[name] = os.path.join(WORK, f"source_{name}")
        save_config(src[name], **section)
        torch.save(model.state_dict(), os.path.join(src[name], MODEL_FILE))
    d = os.path.join(tree, "diffusion", "c1_pose")
    args(d, data_format="pose", layers=mcfg.num_layers, heads=mcfg.num_heads, noise_schedule="cosine",
         sigma_small=True, lambda_vel=0.0, not_rotary=False)
    sd = dict(pose.state_dict(), **{"rotary.freqs": torch.zeros(32),
                                     "audio_model.feature_aggregator.conv_layers.0.1.weight": torch.zeros(4, 4, 2)})
    sd.update({f"seqTransDecoder.stack.{i}.rotary.freqs": sd["rotary.freqs"] for i in range(mcfg.num_layers)})
    torch.save(sd, os.path.join(d, "model000340000.pt"))
    vd = os.path.join(tree, "vq", "c1_vq")
    args(vd, nb_joints=104, output_emb_width=codec.cfg.emb_width, code_dim=codec.cfg.code_dim,
         depth=codec.cfg.depth, data_format="pose")
    torch.save({"net": codec.state_dict()}, os.path.join(vd, "net_iter300000.pth"))
    gd = os.path.join(tree, "guide", "c1_pose")
    args(gd, layers=guide.cfg.num_layers, dim=guide.cfg.latent_dim, num_audio_layers=2,
         resume_pth=os.path.join(vd, "net_iter300000.pth"), data_format="pose")
    gsd = guide.state_dict()
    gsd["null_cond_embed"] = gsd["null_cond_embed"][:, :1998].clone()
    os.makedirs(os.path.join(gd, "checkpoints"))
    torch.save({"model_state_dict": gsd}, os.path.join(gd, "checkpoints", "iter-0100000.pt"))
    rcfg = RendererConfig(**AVATAR_RENDERER)
    avatar_dir = os.path.join(tree, "ca_body", "data", person)
    os.makedirs(avatar_dir)
    sa = os.path.join(avatar_dir, "static_assets.pt")
    torch.save(reference_static_assets(rcfg, seed=seed, mesh_density=10), sa)
    real_assets = convert_static_assets(sa, rcfg)
    avatar = _avatar_model(dataclasses.replace(rcfg, n_cameras=AVATAR_CAMERAS), real_assets, seed + 53)
    avatar_sd = {k: v for k, v in avatar.state_dict().items() if k.split(".")[0] not in avatar.CALIBRATION}
    # a trained AutoEncoder's file: its calibration and asset buffers beside
    # the parameters, which the converter drops as JAX's does
    torch.save({"model_state_dict": dict(avatar.state_dict(), **_reference_avatar_buffers(rcfg, real_assets))},
               os.path.join(avatar_dir, "body_dec.ckpt"))
    del avatar
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv = convert_person(tree, person, out)
    convert_s = time.perf_counter() - t0
    results = {}
    for which, (m, g, v) in {"source": (src["pose"], src["guide"], src["vq"]),
                             "converted": (conv["c1_pose"], conv["guide_c1_pose"], conv["c1_vq"])}.items():
        path = generate(m, WORK, num_samples=2, guidance_param=2.0, timestep_respacing=f"ddim{CONVERT_DDIM}",
                        guide_path=g, vq_path=v, seed=seed, device="cuda",
                        output_dir=os.path.join(WORK, f"samples_{which}"))
        results[which] = np.load(path, allow_pickle=True).item()
    s, c = results["source"], results["converted"]
    rng = np.random.RandomState(seed + 53)
    pose = (rng.randn(1, 104) * 0.3).astype(np.float32)
    face = (rng.randn(1, rcfg.n_face_embs) * 0.3).astype(np.float32)
    # cuDNN's default algorithms may differ in the last bit between two
    # renderer instances (a pixel a frame off by one count, PERF.md §6):
    # the comparison of the converter runs on its deterministic ones
    torch.backends.cudnn.deterministic = True
    try:
        frames = {
            "converted": load_body_renderer(conv["renderer"], frame_batch=1,
                                            device="cuda").render_sequence_multicam(pose, face),
            "source": BodyRenderer(rcfg, real_assets, avatar_sd,
                                   frontal_rig(real_assets.lbs.template_verts[0], rcfg), frame_batch=1,
                                   device="cuda").render_sequence_multicam(pose, face),
        }
    finally:
        torch.backends.cudnn.deterministic = False
    checks = {
        "families": sorted(conv) == ["c1_pose", "c1_vq", "guide_c1_pose", "renderer"],
        "avatar_frame_bit_equal": np.array_equal(frames["converted"], frames["source"]),
        "avatar_frame_covers": bool(0.0 < frames["converted"].any(-1).mean() < 0.9),
        "motions_bit_equal": np.array_equal(s["motions"], c["motions"]),
        "keyframes_bit_equal": np.array_equal(s["keyframes"], c["keyframes"]),
        "motions_finite": bool(np.isfinite(c["motions"]).all()),
    }
    emit("convert_reference_tree", nvidia_smi=smi, families=sorted(conv), write_s=write_s, convert_s=convert_s,
         ddim_steps=CONVERT_DDIM, motions_shape=list(c["motions"].shape),
         max_abs_diff=float(np.abs(s["motions"] - c["motions"]).max()),
         avatar_frame_shape=list(frames["converted"].shape),
         avatar_frame_coverage=float(frames["converted"].any(-1).mean()),
         avatar_faces=int(real_assets.geo.faces.shape[0]), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the converted tree's generate or render differs from the source modules': {checks}")


def _reference_avatar_buffers(cfg, assets) -> dict:
    """Broadcast stand-ins, at the shapes of ``assets``, for the buffers a
    ca_body AutoEncoder (mesh_vae_drivable.py) keeps in its state dict: the
    texture mean, masks, AO mean, and the geometry, seam and LBS modules
    under each submodule that holds them."""
    import torch

    S, U, V = cfg.uv_size, cfg.upscale_size, assets.lbs.template_verts.shape[1]
    geo = {"vi": tuple(assets.geo.faces.shape), "vt": tuple(assets.geo.uv_coords.shape),
           "vti": tuple(assets.geo.uv_faces.shape), "v2uv": tuple(assets.geo.v2uv.shape),
           "index_image": (S, S, 3), "bary_image": (S, S, 3), "face_index_image": (S, S)}
    seam = {"dst_ij": (500, 2), "src_ij": (500, 2), "uvs": (S, S, 2), "weights": (S, S)}
    shapes = {"tex_mean": (1, 3, U, U), "face_cond_mask": (1, 1, S // 16, S // 16), "meye_mask": (1, 1, U, U),
              "encoder.mask": (1, 1, cfg.encoder_in_size, cfg.encoder_in_size),
              "decoder.pose_cond_mask": (1, 98, S // 16, S // 16), "shadow_net.ao_mean": (1, 1, 256, 256),
              "lbs_fn.lbs_template_verts": (V, 3), "lbs_fn.lbs_scale": (1, 3), "lbs_fn.global_scaling": (1,)}
    for owner in ("", "decoder.", "decoder_view.", "encoder."):
        shapes.update({f"{owner}geo_fn.{k}": v for k, v in geo.items()})
    for owner in ("seam_sampler", "seam_sampler_2k", "decoder.seam_sampler", "decoder_view.seam_sampler"):
        shapes.update({f"{owner}.{k}": v for k, v in seam.items()})
    return {k: torch.zeros(()).expand(v) for k, v in shapes.items()}


AVATAR_CAMERAS = 4  # the synthetic capture rig of the avatar trainer's phases
AVATAR_ANGLES = (-30.0, 0.0, 20.0, 45.0)  # its cameras about the body's up axis, degrees
AVATAR_LR = 1e-3  # apps/train_avatar.py's default, the JAX CLI's
AVATAR_PARITY_BATCH, AVATAR_TRAIN_BATCH = 2, 4  # frame batches
AVATAR_TRAIN_STEPS, AVATAR_FILES = 5, 3  # then resumed to AVATAR_TRAIN_STEPS + 1; .npz frame batches
AVATAR_REL_TOL = 1e-5  # each loss part, card vs CPU, relative
AVATAR_RENDERER = {}  # RendererConfig fields over its defaults (none: full width)


def _avatar_cfg():
    from audio2photoreal_tpu_torch.render.mesh_vae import RendererConfig

    return RendererConfig(**{**AVATAR_RENDERER, "n_cameras": AVATAR_CAMERAS})


def _avatar_model(cfg, assets, seed: int):
    """A BodyAvatar with random weights from ``seed``: biases too (else the
    posteriors sit at N(0, 1) and their KL is rounding), the calibration
    off identity."""
    import torch

    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar

    model = BodyAvatar(cfg, assets)
    g = torch.Generator().manual_seed(seed)
    model.reset_parameters(g)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("bias") and n.split(".")[0] not in model.CALIBRATION:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
        for p, scale in ((model.cal.weight, 0.05), (model.cal.bias, 2.0), (model.learn_blur.weights, 1.0),
                         (model.pixel_cal.bias, 2.0)):
            p.add_(torch.randn(p.shape, generator=g) * scale)
    return model


def _avatar_frames(assets, cams: dict, cam_idx, rng, cfg) -> dict:
    """A frame batch (numpy, the port's layout: ao [B, 1, S, S]): frame b
    seen by camera ``cam_idx[b]``, its geometry the template posed by a
    random pose with a random offset, random face codes, AO and image."""
    import numpy as np
    import torch

    B = len(cam_idx)
    names = list(cams)
    motion = (rng.randn(B, 104) * 0.3).astype(np.float32)
    offset = (0.01 * rng.randn(*assets.lbs.template_verts.shape[1:])).astype(np.float32)
    dev = assets.lbs.template_verts.device
    with torch.no_grad():
        geom = assets.lbs.pose(torch.from_numpy(offset)[None].to(dev), torch.from_numpy(motion).to(dev)).cpu().numpy()
    pick = lambda k: np.stack([np.asarray(getattr(cams[names[i]], k), np.float32) for i in cam_idx])  # noqa: E731
    return {"motion": motion, "geom": geom, "face_embs": (rng.randn(B, cfg.n_face_embs) * 0.3).astype(np.float32),
            "ao": rng.rand(B, 1, cfg.shadow_size, cfg.shadow_size).astype(np.float32),
            "campos": pick("campos"), "K": pick("K"), "Rt": pick("Rt"),
            "image": (rng.rand(B, cfg.image_height, cfg.image_width, 3) * 100).astype(np.float32),
            "cam_idx": np.asarray(cam_idx, np.int64)}


def _slope_replay():
    """(seen, slopes): a stand-in for ``F.leaky_relu`` that records the
    slopes a card run takes (``seen["slopes"]``, one mask a call) and replays
    them, in call order, in the CPU run that follows; ``seen["slope_flips"]``
    counts the CPU pre-activations that would have taken the other slope,
    ``seen["replayed"]`` the calls replayed."""
    import torch
    import torch.nn.functional as F

    real_lrelu, seen = F.leaky_relu, {"slopes": [], "slope_flips": 0, "replayed": 0}

    def slopes(x, negative_slope=0.01, inplace=False):
        if x.device.type == "cuda":
            seen["slopes"].append((x > 0).detach())
            return real_lrelu(x, negative_slope, inplace)
        keep = seen["slopes"][seen["replayed"]].cpu()
        seen["replayed"] += 1
        seen["slope_flips"] += int(((x > 0) != keep).sum())
        return torch.where(keep, x, x * negative_slope)

    return seen, slopes


def avatar_step_parity(model_cpu, batch: dict, noise, lr: float) -> dict:
    """One ``avatar_train_step`` from the same weights on the card (the
    raster kernel) and on the CPU (plain versions), the posterior noise
    ``noise`` (body, face; numpy) drawn on both.  The card step's raster is
    held to ``rasterize_reference`` on the same inputs (run on the card);
    the CPU step then takes the card's discrete decisions, so that a value
    differing by f32 rounding cannot flip one between the two and decide
    the gradient bar: the raster's outputs (an edge pixel), and the slope
    of every leaky ReLU (a pre-activation within rounding of 0; the
    avatar's untied per-pixel biases carry such a flip's gradient whole).
    The flips the CPU's own vertices and pre-activations would give are
    counted.  -> the numbers and the checks (loss parts, gradients, params
    after AdamW, the identity camera, the raster)."""
    import copy

    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.core.config import TrainConfig
    from audio2photoreal_tpu_torch.kernels import launch_counts, raster
    from audio2photoreal_tpu_torch.render import mesh_vae, rasterizer
    from audio2photoreal_tpu_torch.train.loops import avatar_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    real_draw, real_rasterize, real_lrelu = mesh_vae.draw_posterior_noise, rasterizer.rasterize, F.leaky_relu
    seen, slopes = _slope_replay()

    def draw(shape, generator, device):
        queue = seen.setdefault("noise", list(noise))
        return torch.from_numpy(queue.pop(0)).to(device)

    def recording(pix, depth, faces, height, width, face_uv=None, emit_barys=None):
        if pix.device.type == "cuda":
            out = real_rasterize(pix, depth, faces, height, width, face_uv, emit_barys)
            seen["card"] = (pix, depth, faces, height, width, face_uv, out)
            return out
        seen["cpu_pix"] = (pix, depth)
        return type(seen["card"][-1])(*(t.cpu() if t is not None else None for t in seen["card"][-1]))

    out, secs = {}, {}
    mesh_vae.draw_posterior_noise, rasterizer.rasterize, F.leaky_relu = draw, recording, slopes
    try:
        for device, model in (("cuda", copy.deepcopy(model_cpu).cuda()), ("cpu", model_cpu)):
            seen.pop("noise", None)
            state = TrainState(model, TrainConfig(lr=lr))
            before = launch_counts[raster.NAME]
            t0 = time.perf_counter()
            metrics = avatar_train_step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            secs[device] = time.perf_counter() - t0
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                     for n, p in model.named_parameters()}
            params = {n: p.detach().cpu() for n, p in model.named_parameters()}
            out[device] = (metrics, grads, params, launch_counts[raster.NAME] - before)
    finally:
        mesh_vae.draw_posterior_noise, rasterizer.rasterize, F.leaky_relu = real_draw, real_rasterize, real_lrelu
    pix, depth, faces, H, W, face_uv, got = seen["card"]
    want = raster.rasterize_reference(pix, depth, faces, H, W, face_uv, emit_barys=False)
    cov = got.face_index >= 0
    cpu_pix, cpu_depth = (t.cuda() for t in seen["cpu_pix"])
    own = raster.rasterize_reference(cpu_pix, cpu_depth, faces, H, W, face_uv, emit_barys=False)
    (mg, gg, pg, lg), (mc, gc, pc, lc) = out["cuda"], out["cpu"]
    parts = ("loss", "loss_rgb", "loss_geom", "loss_kl", "loss_shadow", "loss_blur_reg")
    loss_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in parts}
    grad_rel = {n: (gg[n] - gc[n]).abs().max().item() / max(gc[n].abs().max().item(), 1e-30) for n in gc}
    worst = max(grad_rel, key=grad_rel.get)
    d = torch.cat([(pg[n] - pc[n]).abs().flatten() for n in pc])
    ident = model_cpu.cal.identity_camera
    numbers = dict(
        batch=int(batch["motion"].shape[0]), cam_idx=batch["cam_idx"].tolist(), losses_gpu={k: mg[k] for k in parts},
        losses_cpu={k: mc[k] for k in parts}, loss_rel_err=loss_rel, grad_norm_gpu=mg["grad_norm"],
        grad_norm_cpu=mc["grad_norm"], grad_max_rel_err=grad_rel[worst], grad_worst_tensor=worst,
        grads_compared=len(gc), param_max_abs_diff=d.max().item(),
        param_share_within_1e6=(d <= 1e-6).float().mean().item(),
        raster_coverage=cov.float().mean().item(), raster_face_ids_equal=bool(torch.equal(got.face_index,
                                                                                         want.face_index)),
        raster_depth_max_abs_err=(got.depth[cov] - want.depth[cov]).abs().max().item() if cov.any() else 0.0,
        raster_uv_max_abs_err=(got.uv[cov] - want.uv[cov]).abs().max().item() if cov.any() else 0.0,
        cpu_vertices_coverage_flips=int(((own.face_index >= 0) != cov).sum().item()),
        leaky_relu_calls=len(seen["slopes"]), leaky_relu_slopes=sum(m.numel() for m in seen["slopes"]),
        cpu_preactivation_slope_flips=seen["slope_flips"],
        raster_launches_gpu=lg, raster_launches_cpu=lc, gpu_s=secs["cuda"], cpu_s=secs["cpu"])
    checks = {
        "losses": max(loss_rel.values()) <= AVATAR_REL_TOL,
        "gradients": grad_rel[worst] <= 1e-4 and sorted(gg) == sorted(gc),
        "params_within_2lr": d.max().item() <= 2 * lr,
        "params_999_within_1e6": numbers["param_share_within_1e6"] >= 0.999,
        "identity_camera_unmoved": all(torch.equal(p[f"cal.{k}"][ident], getattr(model_cpu.cal, k)[ident].detach())
                                       for p in (pg, pc) for k in ("weight", "bias")),
        "identity_camera_gradient_zero": not gg["cal.weight"][ident].any() and not gg["cal.bias"][ident].any(),
        "raster_face_ids_and_coverage": numbers["raster_face_ids_equal"],
        "raster_depth_uv": max(numbers["raster_depth_max_abs_err"], numbers["raster_uv_max_abs_err"]) <= RASTER_TOL,
        "raster_launched_once_on_the_card": lg == 1 and lc == 0,
        "slopes_replayed": seen.get("replayed") == len(seen["slopes"]) > 0,
        "slope_flips_rare": seen["slope_flips"] <= SLOPE_FLIP_SHARE * numbers["leaky_relu_slopes"],
        "finite": all(map(math.isfinite, (mg["loss"], mc["loss"], mg["grad_norm"]))),
    }
    return dict(numbers=numbers, checks=checks)


def phase_avatar_train_parity(seed: int) -> None:
    """One deterministic avatar step at full width (``RendererConfig()``,
    ``n_cameras`` 4), frame batch 2 (the identity camera among its
    cameras), card against CPU (``avatar_step_parity``)."""
    import numpy as np

    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig

    cfg = _avatar_cfg()
    t0 = time.perf_counter()
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10)
    model = _avatar_model(cfg, assets, seed + 60)
    cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width, angles=AVATAR_ANGLES)
    rng = np.random.RandomState(seed + 60)
    batch = _avatar_frames(assets, cams, [0, 2][:AVATAR_PARITY_BATCH], rng, cfg)
    noise = [rng.randn(AVATAR_PARITY_BATCH, n).astype(np.float32) for n in (cfg.n_embs, cfg.n_face_embs)]
    setup_s = time.perf_counter() - t0
    res = avatar_step_parity(model, batch, noise, AVATAR_LR)
    emit("avatar_train_parity", uv=cfg.uv_size, upscale=cfg.upscale_size, image=[cfg.image_height, cfg.image_width],
         n_cameras=cfg.n_cameras, faces=int(assets.geo.faces.shape[0]), lr=AVATAR_LR, setup_s=setup_s,
         **res["numbers"], checks=res["checks"])
    if not all(res["checks"].values()):
        raise AssertionError(f"card and CPU disagree on the avatar step: {res['checks']}")


def _profile_avatar_step(state, batch) -> dict:
    """One more avatar step under torch.profiler: device ms by kernel group
    (the raster, convolutions and GEMMs, the grid sampler's backward, the
    rest), idle share, launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.train.loops import avatar_train_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        avatar_train_step(state, batch, torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
    total = sum(per.values())
    if total == 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    conv_words = ("conv", "implicit_gemm", "cudnn", "xmma", "wgrad", "dgrad", "fprop", "gemm", "winograd", "fft")
    raster_ms = sum(v for k, v in per.items() if "raster" in k)
    conv_ms = sum(v for k, v in per.items() if "raster" not in k and any(w in k.lower() for w in conv_words))
    grid_bwd_ms = sum(v for k, v in per.items() if "grid_sampler_2d_backward" in k)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    return dict(profiled_wall_ms=wall_ms, device_ms=total, device_idle_share=1.0 - total / wall_ms,
                device_launches=launches, raster_ms=raster_ms, raster_share=raster_ms / total,
                conv_gemm_ms=conv_ms, grid_sampler_backward_ms=grid_bwd_ms,
                other_ms=total - raster_ms - conv_ms - grid_bwd_ms, top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_main_path_train_avatar(seed: int, smi: str) -> int:
    """``apps/train_avatar.py:train`` on a full-width renderer bundle
    (``n_cameras`` 4, synthetic assets at mesh_density 10) and
    ``AVATAR_FILES`` .npz batches of 4 frames, each frame with its own
    camera; the targets (image, mask, geometry) rendered by a second random
    avatar, AO random.  ``AVATAR_TRAIN_STEPS`` steps, then resumed for one
    more; then one frame x 4 cameras rendered through ``load_body_renderer``
    before and after.  Steps/s over steps 2-4, one more step profiled.
    -> the raster's launches on the trainer's path."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps import train_avatar
    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
    from audio2photoreal_tpu_torch.kernels import launch_counts, raster
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, save_renderer_bundle, synthetic_rig
    from audio2photoreal_tpu_torch.render.mesh_vae import BodyAvatar

    cfg = _avatar_cfg()
    bundle, data = os.path.join(WORK, "avatar_bundle"), os.path.join(WORK, "avatar_frames")
    for d in (bundle, data):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(data)
    t0 = time.perf_counter()
    assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10)
    cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width, angles=AVATAR_ANGLES)
    student = _avatar_model(cfg, assets, seed + 61).state_dict()
    save_renderer_bundle(bundle, cfg, {k: v for k, v in student.items()
                                       if k.split(".")[0] not in BodyAvatar.CALIBRATION}, cams,
                         seed=seed, mesh_density=10)
    teacher = _avatar_model(cfg, assets, seed + 62).cuda().eval()
    rng = np.random.RandomState(seed + 61)
    B = AVATAR_TRAIN_BATCH
    for f in range(AVATAR_FILES):
        fb = _avatar_frames(assets, cams, [(f * B + k) % AVATAR_CAMERAS for k in range(B)], rng, cfg)
        t = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
        with torch.no_grad():  # the teacher's posed geometry and linear render are the targets
            preds = teacher(t["motion"], t["campos"], geom=t["geom"], face_embs=t["face_embs"], K=t["K"], Rt=t["Rt"])
        np.savez(os.path.join(data, f"frames_{f:03d}.npz"), motion=fb["motion"], geom=preds["geom"].cpu().numpy(),
                 face_embs=fb["face_embs"], ao=fb["ao"].transpose(0, 2, 3, 1), campos=fb["campos"], K=fb["K"],
                 Rt=fb["Rt"], image=preds["rgb"].cpu().numpy(),
                 image_mask=(preds["pix_to_face"] >= 0)[..., None].float().cpu().numpy(),
                 cam_idx=fb["cam_idx"].astype(np.int32))
    del teacher, preds, t
    pose = (rng.randn(1, 104) * 0.3).astype(np.float32)
    face = (rng.randn(1, cfg.n_face_embs) * 0.3).astype(np.float32)
    untrained = load_body_renderer(bundle, frame_batch=1, device="cuda").render_sequence_multicam(pose, face)
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    timings, resumed = {}, {}
    t0 = time.perf_counter()
    train_avatar.train(bundle, data, num_steps=AVATAR_TRAIN_STEPS, lr=AVATAR_LR, save_interval=AVATAR_TRAIN_STEPS,
                       seed=seed, device="cuda", timings=timings)
    train_s = time.perf_counter() - t0
    state = train_avatar.train(bundle, data, num_steps=AVATAR_TRAIN_STEPS + 1, lr=AVATAR_LR,
                               save_interval=AVATAR_TRAIN_STEPS, seed=seed, device="cuda", timings=resumed)
    torch.cuda.synchronize()
    raster_launches = launch_counts[raster.NAME]
    other_launches = sum(launch_counts.values()) - raster_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logged = [json.loads(line) for line in open(os.path.join(bundle, train_avatar.LOG_DIR, "log.jsonl"))]
    steady = timings["step_s"][1:4]
    saved = torch.load(os.path.join(bundle, "model.pt"), map_location="cpu", weights_only=True)
    trained = load_body_renderer(bundle, frame_batch=1, device="cuda").render_sequence_multicam(pose, face)
    steps = AVATAR_TRAIN_STEPS + 1
    checks = {
        "steps": state.step == steps and len(timings["step_s"]) == AVATAR_TRAIN_STEPS
        and len(resumed["step_s"]) == 1,
        "losses_finite": [r["step"] for r in logged] == [0, AVATAR_TRAIN_STEPS - 1, steps - 1] and all(
            np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in logged),
        "checkpoints": sorted(os.listdir(os.path.join(bundle, train_avatar.CKPT_DIR)))
        == [f"step_{s:08d}.pt" for s in (AVATAR_TRAIN_STEPS, steps)],
        "model_pt_is_the_trained_state": all(torch.equal(saved[k], v.cpu()) for k, v in
                                             state.model.state_dict().items()),
        "raster_launches": raster_launches == steps,
        "no_other_kernel_launches": other_launches == 0,
        "trained_render_differs": trained.shape == untrained.shape
        == (1, cfg.image_height, AVATAR_CAMERAS * cfg.image_width, 3) and not np.array_equal(trained, untrained),
        "render_covers": bool(0.02 <= trained.any(-1).mean() <= 0.9),
    }
    prof = _profile_avatar_step(state, train_avatar.load_frame_batch(os.path.join(data, "frames_000.npz"), "cuda"))
    emit("main_path_train_avatar", nvidia_smi=smi, frame_batch=B, steps=steps, files=AVATAR_FILES,
         n_cameras=cfg.n_cameras, uv=cfg.uv_size, upscale=cfg.upscale_size, image=[cfg.image_height, cfg.image_width],
         faces=int(assets.geo.faces.shape[0]), lr=AVATAR_LR, setup_s=setup_s, train_s=train_s,
         step_s=timings["step_s"], resumed_step_s=resumed["step_s"], steady_step_ms=1e3 * sum(steady) / len(steady),
         avatar_train_steps_per_s=len(steady) / sum(steady), peak_memory_gb=peak_gb,
         first_loss=logged[0]["loss"], last_loss=logged[-1]["loss"], losses=[r["loss"] for r in logged],
         kernel_launches={raster.NAME: raster_launches}, **prof,
         device_idle_share_of_steady_step=1.0 - prof["device_ms"] / (1e3 * sum(steady) / len(steady)),
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path (avatar training) checks failed: {checks}")
    return raster_launches


# --------------------------------------------------------------------- #
# data parallelism: 2 ranks against 1 process (parallel/, train/loops.py)
# --------------------------------------------------------------------- #

DP_WORLD = 2
DP_BATCH = {"pose_f32": 8, "pose_bf16": 8, "vq": 32, "guide": GUIDE_BATCH, "avatar": AVATAR_TRAIN_BATCH}
DP_STEPS = 2  # steps of each parity case: the ranks' parameters bit-equal after them
DP_VQ_KEYFRAMES = 20
DP_TRAIN_STEPS, DP_TRAIN_RESUMED = 4, 6  # train(): 4 steps, then resumed to 6
DP_ALLREDUCE_REPEATS = 5
DP_RENDER_FRAMES = 16


def _dp_layout():
    """(backend, cards): NCCL with a card a rank when there are enough,
    else gloo with every rank on cuda:0 (NCCL refuses two ranks on one card)."""
    import torch

    n = torch.cuda.device_count()
    return ("nccl", DP_WORLD) if n >= DP_WORLD else ("gloo", 1)


def _dp_case(name: str, seed: int):
    """-> (model on the CPU, its TrainConfig, the global batch (numpy),
    step(state, batch, i, mesh) -> metrics, the kernels whose launches the
    step must show).  The same on every rank and in the 1-process run."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.core.config import DiffusionConfig, TrainConfig, VQConfig
    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.kernels import flash_attn, raster
    from audio2photoreal_tpu_torch.models.vqvae import TemporalVertexCodec
    from audio2photoreal_tpu_torch.render.assets import make_synthetic_assets, synthetic_rig
    from audio2photoreal_tpu_torch.train import loops

    B, rng = DP_BATCH.get(name, 8), np.random.RandomState(seed + 90)
    if name.startswith("pose"):  # pose_f32 (raw audio), pose_bf16 and pose_f32_cached (its f32 twin)
        extra = dict(dtype="bfloat16", frontend_dtype="bfloat16") if name == "pose_bf16" else {}
        cfg, model = _pose_model(seed + 90, dropout=TRAIN_DROPOUT, hash_dropout=True, **extra)
        batch = _train_batch(rng, B, cfg.max_seq_length)
        if name != "pose_f32":  # the feature cache's windows in place of the audio
            del batch["audio"]
            batch["audio_features"] = rng.rand(B, tokens_for_frames(cfg.max_seq_length), 1024).astype(np.float32)
        dcfg, sched = DiffusionConfig(), {}

        def step(state, b, i, mesh):
            dev = b["motion"].device
            sched.setdefault(dev, make_schedule().to_device(dev))
            s = _dp_seed(seed, i)
            return loops.diffusion_train_step(state, sched[dev], dcfg, b, torch.Generator().manual_seed(s),
                                              torch.Generator(device=dev).manual_seed(s), mesh=mesh)[0]

        names = (flash_attn.BF16_NAME, flash_attn.BF16_BWD_NAME) if name == "pose_bf16" else (
            flash_attn.NAME, flash_attn.BWD_NAME)
        return model.train(), TrainConfig(lr=LR), batch, step, names
    if name == "vq":
        model = TemporalVertexCodec(VQConfig())
        model.reset_parameters(torch.Generator().manual_seed(seed + 91))
        batch = {"keyframes": rng.randn(B, DP_VQ_KEYFRAMES, 104).astype(np.float32)}

        def step(state, b, i, mesh):
            dev = b["keyframes"].device
            return loops.vq_train_step(state, b, torch.Generator(device=dev).manual_seed(_dp_seed(seed, i)),
                                       mesh=mesh)

        return model.train(), TrainConfig(lr=1e-3), batch, step, ()
    if name == "guide":
        guide, codec = _guide_models(seed + 92)
        batch = _guide_batch(rng, True, B, GUIDE_FRAMES)

        def step(state, b, i, mesh):
            c = codec.to(b["keyframes"].device)
            return loops.guide_train_step(state, c, b, torch.Generator().manual_seed(_dp_seed(seed, i)),
                                          mesh=mesh)

        return guide.train(), TrainConfig(lr=2e-4, grad_clip=1.0), batch, step, ()
    if name == "avatar":
        cfg = _avatar_cfg()
        assets = make_synthetic_assets(cfg, seed=seed, mesh_density=10)
        model = _avatar_model(cfg, assets, seed + 93)
        cams = synthetic_rig((0.0, 0.0, 1.0), cfg.image_height, cfg.image_width, angles=AVATAR_ANGLES)
        batch = _avatar_frames(assets, cams, [k % AVATAR_CAMERAS for k in range(B)], rng, cfg)

        def step(state, b, i, mesh):
            dev = b["motion"].device
            return loops.avatar_train_step(state, b, torch.Generator(device=dev).manual_seed(_dp_seed(seed, i)),
                                           mesh=mesh)

        return model.train(), TrainConfig(lr=AVATAR_LR), batch, step, (raster.NAME,)
    raise ValueError(name)


def _dp_seed(seed: int, i: int) -> int:
    """The seed of step ``i``'s generators, the same in every run of a case."""
    from audio2photoreal_tpu_torch.data.loader import step_seed

    return step_seed(seed + 95, i)


def _dp_slopes(record: list, replay=None):
    """A stand-in for ``F.leaky_relu`` that records each call's slopes
    ((x > 0), on the card) into ``record`` or, given ``replay`` (the ranks'
    recorded slopes, one list a rank), replays them in call order: a call
    whose input holds the global batch takes the ranks' masks side by side
    on dim 0, a call without a batch axis rank 0's.  ``record`` then counts
    the 1-process pre-activations that would have taken the other slope."""
    import torch
    import torch.nn.functional as F

    real = F.leaky_relu

    def slopes(x, negative_slope=0.01, inplace=False):
        if replay is None:
            record.append((x > 0).detach())
            return real(x, negative_slope, inplace)
        i = len(record)
        parts = [r[i] for r in replay]
        keep = torch.cat(parts, 0) if sum(p.shape[0] for p in parts) == x.shape[0] else parts[0]
        keep = keep.to(x.device).reshape(x.shape)
        record.append(int(((x > 0) != keep).sum()))
        return torch.where(keep, x, x * negative_slope)

    return real, slopes


def _dp_raster(record: list, replay=None):
    """A stand-in for ``rasterizer.rasterize`` that records each call's
    outputs into ``record`` (on the host) or, given ``replay`` (the ranks'
    recorded outputs, one list a rank), hands out the ranks' outputs side
    by side on dim 0 in call order, as the 1-process step would see the
    ranks' rasters: the projected vertices come from the decoder, whose
    rounding moves with the batch, so an edge pixel can change face.
    ``record`` then counts the pixels whose face the 1-process raster
    would have changed."""
    import torch

    from audio2photoreal_tpu_torch.render import rasterizer

    real = rasterizer.rasterize

    def raster(pix, depth, faces, height, width, face_uv=None, emit_barys=None):
        out = real(pix, depth, faces, height, width, face_uv, emit_barys)
        if replay is None:
            record.append(type(out)(*(None if t is None else t.cpu() for t in out)))
            return out
        parts = [r[len(record)] for r in replay]
        got = type(out)(*(None if p[0] is None else torch.cat(p, 0).to(pix.device) for p in zip(*parts)))
        record.append(int((got.face_index != out.face_index).sum()))
        return got

    return real, raster


def _pack(masks) -> list:
    import numpy as np

    return [(tuple(m.shape), np.packbits(m.cpu().numpy().reshape(-1))) for m in masks]


def _unpack(packed) -> list:
    import numpy as np
    import torch

    return [torch.from_numpy(np.unpackbits(bits, count=int(np.prod(shape))).astype(bool).reshape(shape))
            for shape, bits in packed]


def _digest(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().view(-1).view(dtype=__import__("torch").uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _dp_run(name: str, seed: int, device, mesh) -> dict:
    """``DP_STEPS`` steps of case ``name`` on ``device``: the global batch
    (``mesh`` None) or ``mesh``'s rows of it; the metrics, the first step's
    gradients and parameters, the parameters' and buffers' digest after the
    last step, the kernels' launches."""
    import torch

    from audio2photoreal_tpu_torch.kernels import launch_counts
    from audio2photoreal_tpu_torch.parallel.sharding import shard_batch
    from audio2photoreal_tpu_torch.train.state import TrainState

    model, tcfg, batch, step, kernels = _dp_case(name, seed)
    state = TrainState(model.to(device), tcfg)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch = shard_batch(mesh, batch) if mesh is not None else {k: v.to(device) for k, v in batch.items()}
    out = {"metrics": [], "launches": {}}
    launch_counts.clear()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(DP_STEPS):
        out["metrics"].append(step(state, batch, i, mesh))
        if i == 0:
            out["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
            out["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
            out["buffers"] = {n: b.detach().cpu() for n, b in model.named_buffers()}
    torch.cuda.synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: launch_counts[k] for k in kernels}
    out["buffers_last"] = {n: b.detach().cpu() for n, b in model.named_buffers()}
    out["digest"] = _digest({**dict(model.named_parameters()), **dict(model.named_buffers())})
    return out


def _dp_rank(rank: int, world: int, flags: list, task: str, seed: int, out_dir: str) -> None:
    """One rank of the data-parallel phase (a spawned process): the group
    from the trainer flags ``flags``, then ``task``; its results to
    ``out_dir/<task>_rank<rank>.pt``."""
    sys.path.insert(0, ROOT)
    import argparse

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from audio2photoreal_tpu_torch.parallel import distributed as dist

    p = argparse.ArgumentParser()
    dist.add_distributed_args(p)
    args = p.parse_args(flags + ["--process_id", str(rank)])
    dist.initialize_from_args(args)
    dev = dist.local_device()
    torch.cuda.set_device(dev)
    try:
        res = {"parity": _dp_parity_rank, "train": _dp_train_rank, "seq_shard": _seq_shard_rank}[task](seed, dev)
        res.update(rank=rank, device=str(dev), backend=torch.distributed.get_backend())
        torch.save(res, os.path.join(out_dir, f"{task}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _dp_parity_rank(seed: int, dev) -> dict:
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.parallel.mesh import data_mesh

    from audio2photoreal_tpu_torch.render import rasterizer

    res = {}
    for name in DP_BATCH:
        slopes, rasters = [], []
        real, F.leaky_relu = _dp_slopes(slopes)
        real_raster, rasterizer.rasterize = _dp_raster(rasters)
        try:
            res[name] = _dp_run(name, seed, dev, data_mesh(DP_BATCH[name], dev))
        finally:
            F.leaky_relu, rasterizer.rasterize = real, real_raster
        if name in ("guide", "avatar"):
            res[name]["slopes"] = _pack(slopes)
        if rasters:
            res[name]["rasters"] = rasters
        del slopes, rasters
    return res


def _dp_train_rank(seed: int, dev) -> dict:
    """``train()`` at the JAX training point on this rank's rows:
    ``DP_TRAIN_STEPS`` steps from a clean dir (rank 0 then lists what was
    written), one more DDP step profiled, the gradients' all-reduce timed,
    then ``train()`` again to ``DP_TRAIN_RESUMED``: a fresh model resumed
    from the checkpoint."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio2photoreal_tpu_torch.apps.train_diffusion import train
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.data.feature_cache import tokens_for_frames
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.kernels import flash_attn, launch_counts
    from audio2photoreal_tpu_torch.parallel import collectives, sharding
    from audio2photoreal_tpu_torch.parallel.mesh import data_mesh
    from audio2photoreal_tpu_torch.train import checkpoints
    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step

    root, save_dir = _train_person(seed), os.path.join(WORK, "dp_train")
    mcfg = DenoiserConfig(data_format="pose", flash_attention=True, hash_dropout=True, dtype="bfloat16",
                          frontend_dtype="bfloat16")
    datacfg = DataConfig(person="SYNTH01", data_format="pose", batch_size=TRAIN_BATCH,
                         max_seq_length=mcfg.max_seq_length)
    names = (flash_attn.BF16_NAME, flash_attn.BF16_BWD_NAME)

    def run(steps: int):
        tcfg = TrainConfig(lr=LR, num_steps=steps, log_interval=1, save_interval=10**9, seed=seed)
        timings: dict = {}
        launch_counts.clear()
        t0 = time.perf_counter()
        state = train(root, save_dir, mcfg, DiffusionConfig(), datacfg, tcfg, cache_audio_features=True,
                      timings=timings, reader="fastdata")
        return state, dict(train_s=time.perf_counter() - t0, step_s=timings["step_s"], batch_s=timings["batch_s"],
                           cache_s=timings.get("cache_s"), step=state.step,
                           launches={k: launch_counts[k] for k in names},
                           other_launches=sum(launch_counts.values()) - sum(launch_counts[k] for k in names),
                           digest=_digest(dict(state.model.named_parameters())))

    state, out = run(DP_TRAIN_STEPS)  # train() returns once every rank has, the checkpoint written
    if torch.distributed.get_rank() == 0:
        log = os.path.join(save_dir, "log.jsonl")
        out["written"] = dict(log_lines=sum(1 for _ in open(log)),
                              event_files=sum(f.startswith("events.") for f in os.listdir(save_dir)),
                              ckpts=sorted(os.listdir(os.path.join(save_dir, "ckpt"))),
                              latest_ckpt_step=checkpoints.latest_step(os.path.join(save_dir, "ckpt")))
    # one more DDP step on this rank's rows, profiled; then the gradients' all-reduce alone
    mesh = data_mesh(TRAIN_BATCH, dev)
    local = TRAIN_BATCH // mesh.size
    rng = np.random.RandomState(seed + 97 + mesh.index)
    batch = _train_batch(rng, local, mcfg.max_seq_length)
    del batch["audio"]
    batch["audio_features"] = rng.rand(local, tokens_for_frames(mcfg.max_seq_length), 1024).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    sched = make_schedule().to_device(dev)
    torch.distributed.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        diffusion_train_step(state, sched, DiffusionConfig(), batch, torch.Generator().manual_seed(7),
                             torch.Generator(device=dev).manual_seed(7), mesh=mesh)
        torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
    n_floats = sum(g.numel() for g in grads)
    ms = []
    with sharding.bind(mesh):
        for _ in range(DP_ALLREDUCE_REPEATS):
            torch.distributed.barrier()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            collectives.psum_tensors(grads, mesh.axis)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t1) * 1e3)
    out.update(profiled_step_wall_ms=wall_ms, profiled_step_device_ms=dev_ms,
               device_idle_share=1.0 - dev_ms / wall_ms, allreduce_ms=ms, allreduce_floats=n_floats,
               allreduce_mb=4 * n_floats / 1e6)
    del state, grads, batch
    torch.distributed.barrier()
    _, out["resumed"] = run(DP_TRAIN_RESUMED)
    return out


def _dp_spawn(task: str, seed: int, backend: str) -> list:
    """The ranks of ``task`` as spawned processes, joined through a file
    store; -> each rank's results."""
    import torch
    import torch.multiprocessing as mp

    out_dir = os.path.join(WORK, "dp")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, f"store_{task}")
    for f in (store, *(os.path.join(out_dir, f"{task}_rank{r}.pt") for r in range(DP_WORLD))):
        if os.path.exists(f):
            os.remove(f)
    flags = ["--coordinator_address", f"file://{store}", "--num_processes", str(DP_WORLD), "--dist_backend", backend]
    mp.start_processes(_dp_rank, args=(DP_WORLD, flags, task, seed, out_dir), nprocs=DP_WORLD, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"{task}_rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]


def _dp_reference(name: str, seed: int, ranks: list) -> dict:
    """The 1-process run of case ``name`` on cuda:0, replaying the ranks'
    leaky ReLU slopes where they recorded them."""
    import torch
    import torch.nn.functional as F

    from audio2photoreal_tpu_torch.render import rasterizer

    replay = [_unpack(r[name]["slopes"]) for r in ranks] if "slopes" in ranks[0][name] else None
    rasters = [r[name]["rasters"] for r in ranks] if "rasters" in ranks[0][name] else None
    flips: list = []
    moved: list = []
    real, real_raster = F.leaky_relu, rasterizer.rasterize
    if replay is not None:
        _, F.leaky_relu = _dp_slopes(flips, replay)
    if rasters is not None:
        _, rasterizer.rasterize = _dp_raster(moved, rasters)
    try:
        ref = _dp_run(name, seed, torch.device("cuda", 0), None)
    finally:
        F.leaky_relu, rasterizer.rasterize = real, real_raster
    if replay is not None:
        ref.update(slope_calls=len(replay[0]), slope_calls_replayed=len(flips),
                   slopes=sum(m.numel() for r in replay for m in r), slope_flips=sum(flips))
    if rasters is not None:
        ref.update(raster_calls=len(rasters[0]), raster_calls_replayed=len(moved), raster_face_changes=moved)
    return ref


def _dp_check(name: str, ref: dict, ranks: list, ref32: dict = None) -> tuple:
    """The train-parity bars (PERF.md section 2) of rank 0's first step
    against the 1-process step, the ranks' digests after ``DP_STEPS``
    steps, their launches -> (numbers, checks)."""
    import torch

    r0 = ranks[0][name]
    lr = {"vq": 1e-3, "guide": 2e-4, "avatar": AVATAR_LR}.get(name, LR)
    bf16 = name == "pose_bf16"
    loss_rel = [abs(r[name]["metrics"][i]["loss"] - ref["metrics"][i]["loss"]) / abs(ref["metrics"][i]["loss"])
                for r in ranks for i in range(DP_STEPS)]
    rels = sorted(((r0["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                  for n, g in ref["grads"].items())
    d = torch.cat([(r0["params"][n] - p).abs().flatten() for n, p in ref["params"].items()])
    nums = dict(batch=DP_BATCH[name], steps=DP_STEPS, loss_1proc=[m["loss"] for m in ref["metrics"]],
                loss_ranks=[[m["loss"] for m in r[name]["metrics"]] for r in ranks], loss_max_rel_err=max(loss_rel),
                grad_norm_1proc=ref["metrics"][0]["grad_norm"], grad_norm_rank0=r0["metrics"][0]["grad_norm"],
                grads_compared=len(ref["grads"]), grad_max_rel_err=rels[-1][0], worst_grad_tensors=rels[-3:],
                param_max_abs_diff=d.max().item(), param_share_within_1e6=(d <= 1e-6).float().mean().item(),
                launches_by_rank=[r[name]["launches"] for r in ranks], seconds_1proc=ref["seconds"],
                seconds_ranks=[r[name]["seconds"] for r in ranks],
                **{k: ref[k] for k in ("slope_calls", "slope_calls_replayed", "slopes", "slope_flips", "raster_calls",
                                       "raster_calls_replayed", "raster_face_changes") if k in ref})
    checks = {
        "ranks_bit_equal_after_steps": len({r[name]["digest"] for r in ranks}) == 1,
        "same_grad_names": sorted(r0["grads"]) == sorted(ref["grads"]),
        "every_rank_launched_its_kernels": all(n > 0 for r in ranks for n in r[name]["launches"].values())
        and all(r[name]["launches"] == ref["launches"] for r in ranks[1:]),
    }
    if bf16:
        ratios = _grad_ratios(r0["grads"], ref["grads"], ref32["grads"])
        flips = _adamw_sign_flips(r0, ref, ref32, ref["params"])
        nums.update(grad_ratio_l2=ratios["l2"], grad_ratio_max=ratios["max"], params_past_2lr=len(flips),
                    params_past_2lr_flipped_within_admitted=sum(
                        f["flipped"] and f["abs_g_cpu_f32"] <= f["admitted_err"] and f["d"] <= 2 * lr + f["ulp"]
                        for f in flips))
        checks.update(loss=max(loss_rel) <= 1e-2, grads_ratio_rule=ratios["l2"][0] <= 1.0,
                      params_within_2lr=nums["params_past_2lr"] == nums["params_past_2lr_flipped_within_admitted"])
    else:
        checks.update(loss=max(loss_rel) <= 1e-5, grads=rels[-1][0] <= 1e-4,
                      params_within_2lr=d.max().item() <= 2 * lr, params_99_9_within_1e6=nums[
                          "param_share_within_1e6"] >= 0.999)
    if name == "vq":  # the EMA codebooks after each step: the global batch's, summed over the ranks' rows
        errs = []
        for key in ("buffers", "buffers_last"):
            for n, b in ref[key].items():
                if "_codebook." in n and b.is_floating_point():
                    errs.append((r0[key][n] - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
        nums.update(codebook_max_rel_err=max(errs), perplexity_1proc=[m["perplexity"] for m in ref["metrics"]],
                    perplexity_ranks=[[m["perplexity"] for m in r[name]["metrics"]] for r in ranks])
        checks["codebooks"] = max(errs) <= VQ_REL_TOL
    if "raster_calls" in ref:
        checks["rasters_replayed"] = ref["raster_calls_replayed"] == ref["raster_calls"] == DP_STEPS
    if "slopes" in ref:
        checks["slopes_replayed"] = ref["slope_calls_replayed"] == ref["slope_calls"] > 0
        checks["slope_flips"] = ref["slope_flips"] <= SLOPE_FLIP_SHARE * ref["slopes"]
    return nums, checks


def phase_data_parallel(seed: int, smi: str) -> dict:
    """Two ranks (``parallel/``, ``train/loops.py``) against one process, on
    the card: NCCL with a card a rank when there are two cards, else gloo
    with both ranks on cuda:0; the VQ step in a 1-rank NCCL group in this
    process too.
    (a) step parity: ``DP_STEPS`` steps of each case on each rank's rows of
    the global batch against the same steps on the whole batch: pose f32
    (raw audio, hash dropout 0.1, batch 8), pose bf16 (cached, batch 8),
    the VQ at ``VQConfig()`` (batch 32: k-means, then the EMA), the guide at
    ``GuideConfig()`` (cached, batch 32, Bernoulli dropout 0.1) and the
    avatar at ``RendererConfig(n_cameras=4)`` (frame batch 4); the
    1-process guide and avatar replay the ranks' leaky ReLU slopes, the
    avatar their rasters.  (b)
    ``train()`` through the trainer's distributed flags at the JAX training
    point (bf16 pose, cached, global batch 64), 4 steps, then resumed to 6;
    steps/s, the ranks' device ms of one more step, the gradients'
    all-reduce.  (c) the 2-device renderer against the 1-device one at the
    same frames a call.
    -> launches by path: train_ddp (each kernel, summed over the ranks of
    (a)), render_ddp."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.apps.render_pipeline import load_body_renderer
    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, launch_counts, raster
    from audio2photoreal_tpu_torch.parallel import collectives, sharding
    from audio2photoreal_tpu_torch.parallel.mesh import data_mesh
    from audio2photoreal_tpu_torch.train import checkpoints

    backend, cards = _dp_layout()
    t_phase = time.perf_counter()
    emit("data_parallel", nvidia_smi=smi, backend=backend, world_size=DP_WORLD,
         gpus_visible=torch.cuda.device_count(), ranks_per_card=DP_WORLD // cards,
         note=None if cards == DP_WORLD else "one card visible: both ranks share cuda:0 over gloo, so times "
         "below are not a scaling figure")

    # (a) step parity
    t0 = time.perf_counter()
    ranks = _dp_spawn("parity", seed, backend)
    spawn_s = time.perf_counter() - t0
    launches = {}
    failed = []
    for name in DP_BATCH:
        ref = _dp_reference(name, seed, ranks)
        ref32 = _dp_run("pose_f32_cached", seed, torch.device("cuda", 0), None) if name == "pose_bf16" else None
        nums, checks = _dp_check(name, ref, ranks, ref32)
        emit("data_parallel_step_parity", case=name, backend=backend, world_size=DP_WORLD, **nums, checks=checks)
        if not all(checks.values()):
            failed.append((name, checks))
        for r in ranks:
            for k, n in r[name]["launches"].items():
                launches[k] = launches.get(k, 0) + n
        del ref, ref32
    emit("data_parallel_ranks", spawn_and_run_s=spawn_s, devices=[r["device"] for r in ranks],
         backends=[r["backend"] for r in ranks])
    pose_floats = sum(g.numel() for g in ranks[0]["pose_bf16"]["grads"].values())
    del ranks
    if failed:
        raise AssertionError(f"2 ranks disagree with 1 process: {failed}")

    # the VQ step in a 1-rank NCCL group in this process: NCCL's init and all-reduce on the card, held
    # to the ungrouped step by the f32 bars; then the all-reduce of a buffer of the pose model's gradients
    store = os.path.join(WORK, "dp", "store_nccl1")
    if os.path.exists(store):
        os.remove(store)
    torch.distributed.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        alone = _dp_run("vq", seed, torch.device("cuda", 0), None)
        mesh = data_mesh(DP_BATCH["vq"], "cuda:0")
        grouped = _dp_run("vq", seed, torch.device("cuda", 0), mesh)
        nums, checks = _dp_check("vq", alone, [{"vq": grouped}])
        flat = torch.randn(pose_floats, device="cuda")
        ms = []
        with sharding.bind(mesh):
            for _ in range(DP_ALLREDUCE_REPEATS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                collectives.psum(flat, "data")
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
        nccl1 = dict(backend=torch.distributed.get_backend(), case="vq",
                     bit_equal_to_ungrouped=alone["digest"] == grouped["digest"],
                     allreduce_ms=ms, allreduce_mb=4 * pose_floats / 1e6,
                     **{k: nums[k] for k in ("loss_max_rel_err", "grad_max_rel_err", "param_max_abs_diff",
                                             "codebook_max_rel_err")})
    finally:
        torch.distributed.destroy_process_group()
    checks = {k: v for k, v in checks.items() if k != "ranks_bit_equal_after_steps"}  # one rank
    emit("data_parallel_nccl_one_rank", **nccl1, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the 1-rank NCCL step disagrees with the ungrouped step: {checks}")

    # (b) train() through the distributed flags, then resumed
    _train_person(seed)  # made here, once, before the ranks read it
    save_dir = os.path.join(WORK, "dp_train")
    shutil.rmtree(save_dir, ignore_errors=True)
    t0 = time.perf_counter()
    run = _dp_spawn("train", seed, backend)
    train_wall = time.perf_counter() - t0
    written = run[0]["written"]
    logged = [json.loads(l) for l in open(os.path.join(save_dir, "log.jsonl"))]
    resumed = [r["resumed"] for r in run]
    steady = [r["step_s"][1:] for r in run]
    per_step = 2 * 8  # the pose model's 8 layers, two attentions each
    checks = {
        "losses_finite": len(logged) == DP_TRAIN_RESUMED and all(np.isfinite(r["loss"]) for r in logged),
        "only_the_coordinator_wrote": written["log_lines"] == DP_TRAIN_STEPS and written["event_files"] == 1
        and len(written["ckpts"]) == 1 and written["latest_ckpt_step"] == DP_TRAIN_STEPS,
        "ranks_bit_equal": len({r["digest"] for r in run}) == 1 and len({r["digest"] for r in resumed}) == 1,
        "every_rank_launched_the_bf16_kernels": all(
            r["launches"] == {flash_attn.BF16_NAME: per_step * DP_TRAIN_STEPS,
                              flash_attn.BF16_BWD_NAME: per_step * DP_TRAIN_STEPS} and r["other_launches"] == 0
            for r in run),
        "resumed": all(r["step"] == DP_TRAIN_RESUMED for r in resumed)
        and checkpoints.latest_step(os.path.join(save_dir, "ckpt")) == DP_TRAIN_RESUMED
        and all(r["launches"][flash_attn.BF16_NAME] == per_step * (DP_TRAIN_RESUMED - DP_TRAIN_STEPS)
                for r in resumed),
    }
    emit("data_parallel_train", nvidia_smi=smi, backend=backend, world_size=DP_WORLD, global_batch=TRAIN_BATCH,
         steps=DP_TRAIN_STEPS, wall_s=train_wall, train_s=[r["train_s"] for r in run],
         resumed_train_s=[r["train_s"] for r in resumed],
         steady_steps_per_s=[len(s) / sum(s) for s in steady],
         steady_step_ms=[1e3 * sum(s) / len(s) for s in steady], batch_s=[r["batch_s"] for r in run],
         cache_s=[r["cache_s"] for r in run], profiled_step_wall_ms=[r["profiled_step_wall_ms"] for r in run],
         profiled_step_device_ms=[r["profiled_step_device_ms"] for r in run],
         device_idle_share=[r["device_idle_share"] for r in run], allreduce_ms=[r["allreduce_ms"] for r in run],
         allreduce_mb=run[0]["allreduce_mb"], losses=[r["loss"] for r in logged],
         launches_by_rank=[r["launches"] for r in run], written=written,
         scaling_note=None if cards == DP_WORLD else "both ranks share one card: steps/s is not a scaling figure",
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"data-parallel train() checks failed: {checks}")
    for r in (*run, *resumed):
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n

    # (c) the renderer on 2 devices against 1 at the same frames a call (cuDNN's algorithms, and so the
    # rounding, move with the batch: the 1-device render at the whole frame batch is printed beside it)
    devices = [f"cuda:{i % cards}" for i in range(DP_WORLD)]
    rng = np.random.RandomState(seed + 98)
    pose = (rng.randn(DP_RENDER_FRAMES, 104) * 0.05).astype(np.float32)
    face = (rng.randn(DP_RENDER_FRAMES, 256) * 0.05).astype(np.float32)
    bundle = os.path.join(WORK, "renderer")
    two = load_body_renderer(bundle, frame_batch=RENDER_BATCH, devices=devices)
    one = load_body_renderer(bundle, frame_batch=RENDER_BATCH // DP_WORLD, device="cuda")
    whole = load_body_renderer(bundle, frame_batch=RENDER_BATCH, device="cuda")
    t0 = time.perf_counter()
    want = one.render_sequence_multicam(pose, face)
    one_s = time.perf_counter() - t0
    launch_counts.clear()
    t0 = time.perf_counter()
    got = two.render_sequence_multicam(pose, face)
    two_s = time.perf_counter() - t0
    render = {k: launch_counts[k] for k in (raster.NAME, display_pack.NAME)}
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    diff_whole = np.abs(got.astype(np.int32) - whole.render_sequence_multicam(pose, face).astype(np.int32))
    checks = {"shape": got.shape == want.shape and got.shape[0] == DP_RENDER_FRAMES,
              "within_1_count": bool(diff.max() <= 1),
              "every_replica_launched": render[raster.NAME] == 2 * len(one.cameras) * DP_RENDER_FRAMES // RENDER_BATCH}
    emit("data_parallel_render", devices=devices, replicas_share_a_card=cards < DP_WORLD, frames=DP_RENDER_FRAMES,
         frame_batch=two.frame_batch, frames_a_call=RENDER_BATCH // DP_WORLD, one_device_s=one_s,
         two_device_s=two_s, max_count_diff=int(diff.max()), share_differing=float((diff > 0).mean()),
         max_count_diff_vs_one_device_at_frame_batch_8=int(diff_whole.max()),
         share_differing_vs_one_device_at_frame_batch_8=float((diff_whole > 0).mean()), launches=render,
         checks=checks, phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise AssertionError(f"the 2-device renderer disagrees with the 1-device one: {checks}")
    return {"train_ddp": launches, "render_ddp": render}


SEQ_SHARD_SAMPLES = 60 * 16_000  # a 60 s clip at 16 kHz: 5,998 frames, 3x the denoisers' 20 s
SEQ_SHARD_REL_TOL = 1e-5  # 2 ranks vs 1 process, of the output's largest magnitude


def _seq_shard_inputs(seed: int, dev):
    """The full-width vq-wav2vec extractor (weights from ``seed``) and the
    60 s clip [1, S] on ``dev``."""
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.models.audio_encoder import ConvFeatureExtractor

    torch.manual_seed(seed)
    fe = ConvFeatureExtractor().eval()
    wav = (np.random.RandomState(seed + 60).randn(1, SEQ_SHARD_SAMPLES) * 0.1).astype(np.float32)
    return fe.to(dev), torch.from_numpy(wav).to(dev)


def _timed_extract(fn, dev) -> tuple:
    """``fn()`` once to warm up (cuDNN's plans), then timed from a
    synchronized start -> (output on the CPU, wall s, peak GB of the timed
    call)."""
    import torch

    from audio2photoreal_tpu_torch.parallel import distributed as dist

    with torch.no_grad():
        fn()
        torch.cuda.synchronize(dev)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return out.cpu(), wall, torch.cuda.max_memory_allocated(dev) / 1e9


def _seq_shard_rank(seed: int, dev) -> dict:
    """One rank of ``phase_seq_shard``: its window of the 60 s clip through
    ``seq_sharded_extract`` on the ``seq`` axis of every rank."""
    from audio2photoreal_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from audio2photoreal_tpu_torch.parallel.seq_shard import seq_sharded_extract

    fe, wav = _seq_shard_inputs(seed, dev)
    mesh = create_mesh(MeshSpec((-1,), ("seq",)), dev)
    out, wall, peak = _timed_extract(lambda: seq_sharded_extract(lambda w, ctx: fe(w, ctx), wav, mesh), dev)
    return dict(out=out, wall_s=wall, peak_gb=peak, mesh=[mesh.size, mesh.index, mesh.axis])


def phase_seq_shard(seed: int, smi: str) -> None:
    """The sequence-sharded vq-wav2vec frontend (``parallel/seq_shard.py``):
    two ranks, laid out as ``phase_data_parallel``'s (gloo with both on
    cuda:0 when one card is visible, NCCL with a card each when two are),
    each computing its window of a 60 s clip at 16 kHz with the full-width
    extractor, its group norms' moments summed over the ranks, the frames
    gathered; against the 1-process extractor on the card within 1e-5 of
    scale; both walls (a warm-up call first) and each rank's peak GB."""
    import torch

    backend, cards = _dp_layout()
    fe, wav = _seq_shard_inputs(seed, torch.device("cuda", 0))
    want, one_s, one_gb = _timed_extract(lambda: fe(wav), torch.device("cuda", 0))
    del fe, wav
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _dp_spawn("seq_shard", seed, backend)
    spawn_s = time.perf_counter() - t0
    errs = [float((r["out"] - want).abs().max()) for r in ranks]
    scale = float(want.abs().max())
    n_out = (SEQ_SHARD_SAMPLES - 465) // 160 + 1
    checks = {
        "shape": all(list(r["out"].shape) == [1, n_out, 512] for r in ranks) and list(want.shape) == [1, n_out, 512],
        "finite": bool(torch.isfinite(want).all()) and all(bool(torch.isfinite(r["out"]).all()) for r in ranks),
        "ranks_equal": all(torch.equal(r["out"], ranks[0]["out"]) for r in ranks),
        "within_tol": max(errs) <= SEQ_SHARD_REL_TOL * scale,
        "seq_axis": all(r["mesh"] == [DP_WORLD, i, "seq"] for i, r in enumerate(ranks)),
    }
    emit("seq_shard", nvidia_smi=smi, backend=backend, world_size=DP_WORLD, ranks_per_card=DP_WORLD // cards,
         samples=SEQ_SHARD_SAMPLES, frames=n_out, channels=512, one_process_wall_s=one_s, one_process_peak_gb=one_gb,
         rank_wall_s=[r["wall_s"] for r in ranks], rank_peak_gb=[r["peak_gb"] for r in ranks],
         spawn_and_run_s=spawn_s, max_abs_err=errs, scale=scale, rel_tol=SEQ_SHARD_REL_TOL,
         note=None if cards == DP_WORLD else "both ranks share cuda:0 over gloo: the walls are not a scaling figure",
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the sequence-sharded frontend disagrees with the 1-process extractor: {checks}")


PHASE_S: dict = {}  # wall seconds of each phase that main() ran


def _timed(fn):
    """``fn`` with its wall seconds recorded in ``PHASE_S``."""
    def run(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            PHASE_S[fn.__name__] = time.perf_counter() - t0
    return run


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        raise SystemExit(f"{PKG}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)

    smi = _timed(phase_device)()
    from audio2photoreal_tpu_torch.kernels import display_pack, flash_attn, raster

    _timed(phase_build)()
    _timed(phase_sass)()
    attn = _timed(phase_kernels)(args.seed)
    ras = _timed(phase_raster)(args.seed)
    _timed(phase_slice_parity)(args.seed)
    _timed(phase_face_slice_parity)(args.seed)
    _timed(phase_render_parity)(args.seed)
    _timed(phase_render_bf16_parity)(args.seed)
    _timed(phase_guide_parity)(args.seed)
    launches = _timed(phase_main_path)(args.seed, smi)
    render16 = _timed(phase_main_path_render_bf16)(args.seed, smi)
    gen16 = _timed(phase_main_path_generate_bf16)(args.seed, smi)
    demo = _timed(phase_main_path_demo)(args.seed, smi)
    _timed(phase_demo_parity)(args.seed)
    _timed(phase_samplers)(args.seed)
    bwd = _timed(phase_train_kernels)(args.seed)
    _timed(phase_train_kernels_face)(args.seed)
    _timed(phase_train_parity)(args.seed)
    cache, index, stats = _timed(phase_feature_cache)(args.seed)
    _timed(phase_train_parity_face)(args.seed)
    train = _timed(phase_main_path_train)(args.seed, smi)
    train["face"] = _timed(phase_main_path_train_face)(args.seed, smi, cache, index, stats)
    del cache
    train_fwd = {path: counts[0] for path, counts in train.items()}
    train_bwd = {path: counts[1] for path, counts in train.items()}
    bf16 = _timed(phase_kernels_bf16)(args.seed)
    _timed(phase_bf16_slice_parity)(args.seed)
    _timed(phase_train_parity_bf16)(args.seed)
    train16 = _timed(phase_main_path_train_bf16)(args.seed, smi)
    remat = _timed(phase_remat)(args.seed, smi)
    # the remat phase's steps: the plain and the checkpointed step, forward and backward launches
    remat_fwd = {dt: sum(remat[f"remat_{dt}_{w}"][0] for w in ("plain", "remat")) for dt in ("float32", "bfloat16")}
    remat_bwd = {dt: sum(remat[f"remat_{dt}_{w}"][1] for w in ("plain", "remat")) for dt in ("float32", "bfloat16")}
    train_fwd["remat"], train_bwd["remat"] = remat_fwd["float32"], remat_bwd["float32"]
    fwd16 = {**gen16, **{path: counts[0] for path, counts in train16.items()},
             "demo_bf16": demo[flash_attn.BF16_NAME], "remat": remat_fwd["bfloat16"]}
    bwd16 = {**{path: counts[1] for path, counts in train16.items()}, "remat": remat_bwd["bfloat16"]}
    if min(fwd16.values()) < 1 or min(bwd16.values()) < 1:
        raise AssertionError(f"a bf16 path launched no bf16 attention kernel: {fwd16}, {bwd16}")
    _timed(phase_vq_train_parity)(args.seed)
    _timed(phase_guide_train_parity)(args.seed)
    _timed(phase_main_path_train_vq_guide)(args.seed, smi)
    _timed(phase_avatar_train_parity)(args.seed)
    train_avatar = _timed(phase_main_path_train_avatar)(args.seed, smi)
    _timed(phase_convert_reference_tree)(args.seed, smi)
    ddp = _timed(phase_data_parallel)(args.seed, smi)
    train_ddp, render_ddp = ddp["train_ddp"], ddp["render_ddp"]
    ddp_fwd = {"train_ddp": train_ddp.get(flash_attn.NAME, 0)}
    ddp_bwd = {"train_ddp": train_ddp.get(flash_attn.BWD_NAME, 0)}
    fwd16["train_ddp"], bwd16["train_ddp"] = train_ddp[flash_attn.BF16_NAME], train_ddp[flash_attn.BF16_BWD_NAME]
    if min(ddp_fwd["train_ddp"], ddp_bwd["train_ddp"], train_ddp[raster.NAME], render_ddp[raster.NAME],
           render_ddp[display_pack.NAME]) < 1:
        raise AssertionError(f"a data-parallel path launched no kernel: {train_ddp}, {render_ddp}")
    _timed(phase_seq_shard)(args.seed, smi)
    r16, disp16 = render16["launches"], render16["display"]

    import torch

    emit("phase_seconds", total_s=sum(PHASE_S.values()), **PHASE_S)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the f32 attention rows' bound is that of the arithmetic they do: 3xTF32
    attn_keys = ("max_abs_err", "ms", "plain_ms", "library_ms")
    tc = lambda row: {"bound_ms": row["bound_tc_ms"], "bound_by": row["bound_tc_by"]}  # noqa: E731
    disp = launches["display"]
    print(json.dumps({"kernels": [
        {"name": flash_attn.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/flash_attn_fwd.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:124",
         "launches": launches[flash_attn.NAME] + launches["face"] + demo[flash_attn.NAME] + sum(train_fwd.values())
         + ddp_fwd["train_ddp"],
         "launches_by_path": {"generate": launches[flash_attn.NAME], "face": launches["face"],
                              "demo": demo[flash_attn.NAME], **{f"train_{path}": n for path, n in train_fwd.items()},
                              **ddp_fwd},
         "dropout": "replayed hash mask in the kernel (training); these numbers are at rate 0",
         "arithmetic": "3xTF32 on mma.sync m16n8k8 (f32); bound_ms at 495/3 TFLOP/s",
         **{k: attn[k] for k in attn_keys}, **tc(attn)},
        {"name": flash_attn.BWD_NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/flash_attn_bwd.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:157",
         "launches": sum(train_bwd.values()) + ddp_bwd["train_ddp"],
         "launches_by_path": {**{f"train_{path}": n for path, n in train_bwd.items()}, **ddp_bwd},
         "dropout": bwd["dropout"], "shape": [
             bwd[k] for k in ("B", "H", "Tq", "Tk", "Dh")],
         "arithmetic": "3xTF32 on mma.sync m16n8k8 (f32); bound_ms at 495/3 TFLOP/s",
         **{k: bwd[k] for k in attn_keys}, **tc(bwd)},
        {"name": flash_attn.BF16_NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/flash_attn_fwd_bf16.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:124", "launches": sum(fwd16.values()),
         "launches_by_path": fwd16, "shape": [bf16[k] for k in ("B", "H", "Tq", "Tk", "Dh")],
         "dropout": "replayed hash mask in the kernel (training); these numbers are at rate 0",
         "arithmetic": "bf16 wgmma m64nNk16 (f32 accumulate), TMA; bound_ms at 989 TFLOP/s",
         "max_abs_err": bf16["fwd_rate0_max_abs_err"], "ms": bf16["fwd_rate0_ms"],
         "graph_ms": bf16["fwd_rate0_graph_ms"], "plain_ms": bf16["fwd_rate0_plain_ms_at_plain_B"],
         "library_ms": bf16["fwd_library_ms"],
         "bound_ms": bf16["fwd_bound_ms"], "bound_by": bf16["fwd_bound_by"]},
        {"name": flash_attn.BF16_BWD_NAME, "route": "cuda",
         "source": f"{PKG}/kernels/csrc/flash_attn_bwd_bf16.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/flash.py:157", "launches": sum(bwd16.values()),
         "launches_by_path": bwd16, "shape": [bf16[k] for k in ("B", "H", "Tq", "Tk", "Dh")],
         "dropout": bf16["dropout"], "library_dropout": 0.0,
         "arithmetic": "bf16 wgmma m64nNk16 (f32 accumulate), TMA into an mbarrier ring fed by a producer "
                       "warpgroup (setmaxnreg); a key-stationary dK/dV kernel and a query-stationary dQ kernel "
                       "(14 B·H·Tq·Tk·Dh flops); bound_ms: the function's 10 B·H·Tq·Tk·Dh at 989 TFLOP/s",
         "max_abs_err": bf16["max_abs_err"], "ms": bf16["bwd_ms"], "graph_ms": bf16["bwd_graph_ms"],
         "rate0_ms": bf16["bwd_rate0_ms"], "rate0_graph_ms": bf16["bwd_rate0_graph_ms"],
         "dq_scratch_gb": bf16["dq_scratch_gb"],
         "plain_ms": bf16["bwd_plain_ms_at_plain_B"], "library_ms": bf16["bwd_library_ms"],
         "bound_ms": bf16["bwd_bound_ms"], "bound_by": bf16["bwd_bound_by"]},
        {"name": raster.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/raster.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas_raster.py:143",
         "launches": launches[raster.NAME] + demo[raster.NAME] + train_avatar + train_ddp[raster.NAME]
         + render_ddp[raster.NAME] + r16["float32"][raster.NAME] + r16["bfloat16"][raster.NAME],
         "launches_by_path": {"render": launches[raster.NAME], "demo": demo[raster.NAME], "train_avatar": train_avatar,
                              "train_ddp": train_ddp[raster.NAME], "render_ddp": render_ddp[raster.NAME],
                              "render_bf16_phase_f32": r16["float32"][raster.NAME],
                              "render_bf16": r16["bfloat16"][raster.NAME]},
         "shape": [ras[k] for k in ("B", "H", "W", "faces")], "graph_ms": ras["graph_ms"],
         **{k: ras[k] for k in keys}},
        {"name": display_pack.NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/display_pack.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/display_pack.py:56",
         "launches": launches[display_pack.NAME] + demo[display_pack.NAME] + render_ddp[display_pack.NAME]
         + r16["float32"][display_pack.NAME],
         "launches_by_path": {"render": launches[display_pack.NAME], "demo": demo[display_pack.NAME],
                              "render_ddp": render_ddp[display_pack.NAME],
                              "render_bf16_phase_f32": r16["float32"][display_pack.NAME]},
         "shape": [disp[k] for k in ("B", "H", "W")], "exact_share": disp["exact_share"],
         "no_tex_rec_ms": disp["no_tex_rec_ms"], "packed_ms": disp["packed_ms"], **{k: disp[k] for k in keys}},
        {"name": display_pack.BF16_NAME, "route": "cuda", "source": f"{PKG}/kernels/csrc/display_pack.cu",
         "replaces": "audio2photoreal_tpu/ops/pallas/display_pack.py:56",
         "launches": r16["bfloat16"][display_pack.BF16_NAME],
         "launches_by_path": {"render_bf16": r16["bfloat16"][display_pack.BF16_NAME]},
         "dtype": "bfloat16 texture, shadow and tex_rec; f32 mean and display values",
         "shape": [disp16[k] for k in ("B", "H", "W")], "exact_share": disp16["exact_share"],
         "no_tex_rec_ms": disp16["no_tex_rec_ms"], "packed_ms": disp16["packed_ms"],
         **{k: disp16[k] for k in keys}},
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
