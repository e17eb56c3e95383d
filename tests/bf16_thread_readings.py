"""How ``test_torch_bf16.py::test_bf16_encode_cfg_ddim_matches_jax[face]``
reads at other CPU thread counts, and why.

    JAX_PLATFORMS=cpu python tests/bf16_thread_readings.py [--threads 1 2 3 4] [--flips 12]

1. The test's face DDIM-10 output (the port in bf16) against JAX's strict
   bf16 build, at each torch thread count: the distance, the test's bar
   (2e-2 of JAX f32's scale), and the distance from the first count's
   output.
2. Every aten op of the encode and one cached CFG step at the second count
   (a dispatch mode), rerun on one thread on the same inputs: the ops whose
   output changes.
3. The bf16 ``addmm`` alone at that op's shape and three others, at each
   count: outputs that differ from the correctly rounded exact product, and
   from the first count's output.
4. On one thread, one-ulp flips planted at random in 1e-4 of the condition
   projection's bf16 outputs (``--flips`` draws): the same reading as 1,
   over the bar.

Not a test (pytest collects ``test_*.py`` only); it imports both packages,
as the tests do.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

import test_torch_bf16 as t  # noqa: E402
from audio2photoreal_tpu.core import config as j_config  # noqa: E402
from audio2photoreal_tpu.diffusion import respace as j_respace  # noqa: E402
from audio2photoreal_tpu.diffusion import sampling as j_sampling  # noqa: E402
from audio2photoreal_tpu.models.cfg import cfg_model_fn_cached as j_cfg_cached  # noqa: E402
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser  # noqa: E402
from audio2photoreal_tpu_torch.diffusion import respace, sampling  # noqa: E402
from audio2photoreal_tpu_torch.models import audio_encoder  # noqa: E402
from audio2photoreal_tpu_torch.models.cfg import cfg_model_fn_cached  # noqa: E402

CFG = {**t.FACE, "flash_attention": False}
COND_IN = 1024 + 1014  # the face model's condition projection's input width


def _inputs():
    """The test's weights and inputs (tests/test_torch_bf16.py)."""
    params = t._jax_params(CFG, 11)
    Tm, nf, B = CFG["max_seq_length"], CFG["nfeats"], 2
    rng = np.random.RandomState(4)
    feats = rng.rand(B, audio_encoder.feature_frames(Tm * 1600 // 3), 1024).astype(np.float32)
    x_T = rng.randn(B, Tm, nf).astype(np.float32)
    rng.randn(B, 5, 104)  # the pose keyframes' draw, kept so lip is the test's
    lip = rng.randn(B, Tm, 1014).astype(np.float32)
    return params, feats, x_T, lip


def _jax_ddim(params, feats, x_T, lip, dtype, strict):
    jm = JDenoiser(j_config.DenoiserConfig(**{**CFG, "dtype": dtype}))

    def run(f, x, v):
        cond = jm.apply(params, None, None, None, audio_features=f, lip_verts=v,
                        method=JDenoiser.encode_conditioning)
        fn = j_cfg_cached(jm, params, cond, 2.0)
        sched = j_respace.maybe_respaced("cosine", 1000, "ddim10")
        return j_sampling.ddim_sample_loop(sched, "xstart", fn, x, jax.random.PRNGKey(0)).pred_xstart

    return np.asarray(t._run(run, *(jnp.asarray(a) for a in (feats, x_T, lip)), strict=strict))


def _port_ddim(pm, feats, x_T, lip):
    with torch.no_grad():
        cond = pm.encode_conditioning(None, lip_verts=torch.from_numpy(lip), audio_features=torch.from_numpy(feats))
        sched = respace.maybe_respaced("cosine", 1000, "ddim10")
        return sampling.ddim_sample_loop(sched, "xstart", cfg_model_fn_cached(pm, cond, 2.0),
                                         torch.from_numpy(x_T)).pred_xstart.numpy()


class _OpsThatMove(TorchDispatchMode):
    """Each op run again on one thread on the same inputs; prints the first
    call of each (op, shapes) whose output changes."""

    def __init__(self, n):
        super().__init__()
        self.n, self.seen = n, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        torch.set_num_threads(1)
        ref = func(*args, **kwargs)
        torch.set_num_threads(self.n)
        for x, y in zip(tree_flatten(out)[0], tree_flatten(ref)[0]):
            if isinstance(x, torch.Tensor) and x.is_floating_point() and not torch.equal(x, y):
                shapes = str([(tuple(v.shape), str(v.dtype)) for v in tree_flatten((args, kwargs))[0]
                              if isinstance(v, torch.Tensor)])
                if (str(func), shapes) not in self.seen:
                    self.seen.add((str(func), shapes))
                    print(f"  moves at {self.n} threads: {func} {shapes}, largest change "
                          f"{(x.float() - y.float()).abs().max().item()}", flush=True)
        return out


def _flip_one_ulp(seed):
    """F.linear whose bf16 output of the condition projection has one-ulp
    flips in 1e-4 of its elements, drawn from ``seed``."""
    lin = F.linear

    def flipped(x, w, b=None):
        y = lin(x, w, b)
        if w.shape[1] != COND_IN or y.dtype != torch.bfloat16:
            return y
        g = torch.Generator().manual_seed(seed)
        pick = torch.rand(y.shape, generator=g) < 1e-4
        step = torch.where(torch.rand(y.shape, generator=g) < 0.5, 1, -1).to(torch.int16)
        bits = y.view(torch.int16)
        return torch.where(pick, bits + step, bits).view(torch.bfloat16)

    return flipped


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--flips", type=int, default=12)
    args = p.parse_args()
    params, feats, x_T, lip = _inputs()
    scale = np.abs(_jax_ddim(params, feats, x_T, lip, "float32", False)).max()
    strict = _jax_ddim(params, feats, x_T, lip, "bfloat16", True)
    bar = t.DIRECT * scale
    pm = t._port(CFG, params, dtype="bfloat16")

    print(f"1. DDIM-10 against JAX strict bf16, bar {bar} (2e-2 x {scale})")
    first = None
    for n in args.threads:
        torch.set_num_threads(n)
        out = _port_ddim(pm, feats, x_T, lip)
        first = out if first is None else first
        print(f"  {n} threads: {np.abs(out - strict).max()} ({np.abs(out - strict).max() / bar} of the bar), "
              f"{np.abs(out - first).max()} from {args.threads[0]} threads", flush=True)

    n = args.threads[1] if len(args.threads) > 1 else 2
    print(f"2. ops of the encode and one CFG step whose output moves between 1 and {n} threads")
    torch.set_num_threads(n)
    with torch.no_grad(), _OpsThatMove(n):
        cond = pm.encode_conditioning(None, lip_verts=torch.from_numpy(lip), audio_features=torch.from_numpy(feats))
        cfg_model_fn_cached(pm, cond, 2.0)(torch.from_numpy(x_T), torch.tensor([500, 500]))

    print("3. bf16 addmm against the correctly rounded exact product")
    torch.manual_seed(0)
    for M, K, N in [(856, COND_IN, 64), (856, 1024, 64), (256, COND_IN, 64), (856, COND_IN, 128)]:
        a, b = torch.randn(M, K).bfloat16(), (torch.randn(K, N) / K**0.5).bfloat16()
        c = torch.randn(N).bfloat16()
        exact = (c.double() + a.double() @ b.double()).bfloat16().double()
        base = None
        for k in args.threads:
            torch.set_num_threads(k)
            r = torch.addmm(c, a, b)
            base = r if base is None else base
            print(f"  {M}x{K}x{N}, {k} threads: share off the rounded exact "
                  f"{(r.double() != exact).double().mean().item():.2e}, share off {args.threads[0]} threads' "
                  f"{(r != base).double().mean().item():.2e}", flush=True)

    print(f"4. one thread, one-ulp flips in 1e-4 of the condition projection's outputs, {args.flips} draws")
    torch.set_num_threads(1)
    real = F.linear
    readings = []
    for seed in range(args.flips):
        torch.nn.functional.linear = _flip_one_ulp(seed)
        try:
            out = _port_ddim(pm, feats, x_T, lip)
        finally:
            torch.nn.functional.linear = real
        readings.append(np.abs(out - strict).max() / bar)
        print(f"  draw {seed}: {readings[-1]} of the bar", flush=True)
    print(f"  range {min(readings)}-{max(readings)}, {sum(r > 1 for r in readings)} of {len(readings)} above")


if __name__ == "__main__":
    main()
