"""Collectives over the bound data axis.

Counterpart of ``audio2photoreal_tpu/parallel/collectives.py`` (reference:
``all_reduce``, utils/misc.py:67-135; the VQ codebook sync,
model/vqvae.py:148-167; the loss-aware sampler's all_gather,
diffusion/resample.py:97-118).  Each acts over the process group while a
step has bound ``axis`` (``parallel/sharding.py:bind``) and a group is
initialised, and is the identity otherwise, as the JAX wrappers are outside
``shard_map``: the same model code runs alone in the tests.  An untiled
``all_gather`` then returns ``x[None]``.

gloo reduces host memory, so on gloo a tensor on the card is staged through
the host; NCCL reduces on the card.  The result is the same on every rank.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as tdist

from audio2photoreal_tpu_torch.parallel import sharding


def _active(axis: str) -> bool:
    return sharding.bound_mesh(axis) is not None and tdist.is_available() and tdist.is_initialized()


def _staged(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` that the backend can reduce in place."""
    if x.is_cuda and tdist.get_backend() == "gloo":
        return x.detach().cpu()
    return x.detach().clone()


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    if not _active(axis):
        return x
    y = _staged(x)
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM)
    return y.to(x.device)


def pmean(x: torch.Tensor, axis: str) -> torch.Tensor:
    if not _active(axis):
        return x
    return psum(x, axis) / tdist.get_world_size()


def all_gather(x: torch.Tensor, axis: str, tiled: bool = False) -> torch.Tensor:
    """[N, *x.shape] in rank order, or along dim 0 when ``tiled``."""
    if not _active(axis):
        return x if tiled else x[None]
    y = _staged(x).contiguous()
    out = [torch.empty_like(y) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, y)
    out = [o.to(x.device) for o in out]
    return torch.cat(out, 0) if tiled else torch.stack(out, 0)


def psum_tensors(tensors: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """``psum`` of each tensor (one dtype) by one all-reduce of a flat buffer."""
    if not _active(axis):
        return list(tensors)
    flat = psum(torch.cat([t.reshape(-1) for t in tensors]), axis)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process ``src``'s ``x`` on every process of the group."""
    y = _staged(x)
    tdist.broadcast(y, src)
    return y.to(x.device)
