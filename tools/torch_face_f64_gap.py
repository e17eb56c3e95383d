#!/usr/bin/env python3
"""How far f32 rounding alone moves the face slice: the full-width random
face model of ``chip_smoke.py`` (``_face_model``: latent 512, 8 layers, 4
heads, lip regressor, rotary cond-encoder) run on the CPU in float64 and in
float32 from the same weights, audio and x_T (chip_smoke's
``phase_face_slice_parity`` inputs): encode 20 s of audio, cached CFG at
guidance 10.0, DDIM-5.  Prints one JSON line with max |f32 - f64| and the
f64 output's largest magnitude at each stage (lip vertices, cond tokens,
pred_xstart).

    python3 tools/torch_face_f64_gap.py [--seed N]

The f64 run casts the weights with ``Module.double()``.  The port casts to
f32 in two places (attention logits, ``ops/attention.py``; the wav2vec
extractor's output, ``models/audio_encoder.py``); here ``Tensor.float``
leaves a float64 tensor as it is, and the f32 tables that enter a layer as
its input (the lip regressor's position table, the timestep embedding) are
cast to the run's dtype, so the f64 run stays f64 throughout.
Constant tables built in f32 (rotary, positional encodings, the nearest
resize index) are the same in both runs.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced
    from audio2photoreal_tpu_torch.diffusion.sampling import ddim_sample_loop
    from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached
    from chip_smoke import FACE_GUIDANCE, _face_model

    from audio2photoreal_tpu_torch.models import film_transformer, lip_regressor

    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 else to_f32(self, *a, **k)
    # f32 tables that enter a layer as its input (the lip regressor's decoder
    # queries, the timestep embedding) are cast to the run's dtype
    run_dtype = [torch.float32]
    for mod, name in ((lip_regressor, "absolute_pos_encoding"), (film_transformer, "sinusoidal_pos_emb")):
        fn = getattr(mod, name)
        setattr(mod, name, lambda *a, _fn=fn, **k: _fn(*a, **k).to(run_dtype[0]))

    cfg, model32 = _face_model(args.seed)
    model64 = copy.deepcopy(model32).double()
    rng = np.random.RandomState(args.seed + 3)  # phase_face_slice_parity's inputs
    B, T = 1, cfg.max_seq_length
    audio = rng.randn(B, T * 1600, 2).astype(np.float32)
    x_T = rng.randn(B, T, cfg.nfeats).astype(np.float32)
    sched = maybe_respaced("cosine", 1000, "ddim5")

    def run(model, dtype):
        run_dtype[0] = dtype
        with torch.no_grad():
            a = torch.from_numpy(audio).to(dtype)
            lip = model.lip_vertices(a)
            cond = model.encode_conditioning(a, lip_verts=lip)
            fn = cfg_model_fn_cached(model, cond, FACE_GUIDANCE)
            res = ddim_sample_loop(sched, "xstart", fn, torch.from_numpy(x_T).to(dtype))
        outs = (lip, cond.cond_tokens, res.pred_xstart)
        return [o.double().numpy() for o in outs], [str(o.dtype) for o in outs]

    t0 = time.perf_counter()
    f64, dt64 = run(model64, torch.float64)
    s64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32, dt32 = run(model32, torch.float32)
    s32 = time.perf_counter() - t0
    row = {"tool": "torch_face_f64_gap", "device": "cpu", "seed": args.seed, "steps": 5,
           "guidance": FACE_GUIDANCE, "latent": cfg.latent_dim, "layers": cfg.num_layers,
           "heads": cfg.num_heads, "dtypes_f64_run": dt64, "dtypes_f32_run": dt32,
           "f64_s": s64, "f32_s": s32}
    for name, a, b in zip(("lip", "cond_tokens", "pred_xstart"), f32, f64):
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        row.update({f"{name}_f32_vs_f64_max_abs": err, f"{name}_scale": scale, f"{name}_rel": err / scale})
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
