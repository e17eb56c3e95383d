"""The sequence-sharded vq-wav2vec frontend, alone or as one rank of a
``seq`` group, for ``tests/test_torch_seq_shard.py``.

Imports torch and the port only, so the rank processes never load JAX.  Run
as a script it is one rank:

    python tests/torch_seq_shard_ranks.py RANK WORLD INIT_URL OUT

which joins the gloo group at ``INIT_URL`` (a ``file://`` store), runs
``parallel/seq_shard.py:seq_sharded_extract`` over the ``seq`` axis of
every process for each case of ``CASES`` and saves the outputs to ``OUT``.
The test runs the same cases in its own process without a group
(``run(None)``: one window, the unsharded extractor) and holds both to the
JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio2photoreal_tpu_torch.models.audio_encoder import ConvFeatureExtractor  # noqa: E402
from audio2photoreal_tpu_torch.parallel import distributed as dist  # noqa: E402
from audio2photoreal_tpu_torch.parallel.mesh import MeshSpec, create_mesh  # noqa: E402
from audio2photoreal_tpu_torch.parallel.seq_shard import seq_sharded_extract  # noqa: E402

# name: (batch, samples, signal seed, compute dtype); the JAX package's own
# lengths (tests/test_seq_shard.py): 321 frames, and a length that leaves the
# last window padded
CASES = {
    "f32": (2, 160 * 320 + 465, 1, "float32"),
    "f32_ragged": (1, 160 * 301 + 465 + 37, 2, "float32"),
    "bf16": (2, 160 * 320 + 465, 1, "bfloat16"),
}


def extractor(dtype: str = "float32") -> ConvFeatureExtractor:
    """The full-width vq-wav2vec extractor, weights from a fixed seed and the
    group norms' affine moved off 1 and 0."""
    torch.manual_seed(0)
    fe = ConvFeatureExtractor(compute_dtype=dtype)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for p in fe.parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    return fe.eval()


def signal(name: str) -> np.ndarray:
    B, S, seed, _ = CASES[name]
    return (np.random.RandomState(seed).randn(B, S) * 0.1).astype(np.float32)


def run(mesh) -> dict:
    out = {}
    for name, (_, _, _, dtype) in CASES.items():
        fe = extractor(dtype)
        with torch.no_grad():
            out[name] = seq_sharded_extract(lambda w, ctx: fe(w, ctx), torch.from_numpy(signal(name)), mesh)
    return out


if __name__ == "__main__":
    rank, world, init, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.initialize(init, world, rank, backend="gloo")
    try:
        torch.save(run(create_mesh(MeshSpec((-1,), ("seq",)), "cpu")), path)
    finally:
        torch.distributed.destroy_process_group()
