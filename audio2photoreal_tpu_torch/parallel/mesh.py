"""The data-parallel group, described as the JAX package describes its mesh.

Counterpart of ``audio2photoreal_tpu/parallel/mesh.py``.  The JAX package
shards its global batch over the ``data`` axis of a ``jax.sharding.Mesh``;
here one process drives one device, so a mesh is the process group as this
process sees it (``DataMesh``: the group's size, this process's index in it
and its device) and a batch axis is sharded by giving each process its own
rows.  The canonical axis names and ``MeshSpec.resolve`` are kept.  One
axis spans the processes: the ``data`` axis (every trainer), or the ``seq``
axis alone (``MeshSpec((-1,), ("seq",))``: the sequence-sharded frontend,
``parallel/seq_shard.py``, where each process holds one window of the
signal); a spec that asks for a larger ``model`` axis, or for both, raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from audio2photoreal_tpu_torch.parallel import distributed

# Canonical axis names, the JAX package's.
DATA_AXIS = "data"  # batch / data parallel
MODEL_AXIS = "model"  # tensor parallel (width)
SEQ_AXIS = "seq"  # sequence parallel (time)


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape by axis name; -1 means 'all remaining devices'."""

    shape: Tuple[int, ...] = (-1,)
    axes: Tuple[str, ...] = (DATA_AXIS,)

    def resolve(self, n_devices: int) -> Tuple[int, ...]:
        shape = list(self.shape)
        known = math.prod(s for s in shape if s != -1)
        if -1 in shape:
            if n_devices % max(known, 1) != 0:
                raise ValueError(f"{n_devices} devices not divisible by {known}")
            shape[shape.index(-1)] = n_devices // max(known, 1)
        if math.prod(shape) != n_devices:
            raise ValueError(f"mesh shape {tuple(shape)} != {n_devices} devices")
        return tuple(shape)


@dataclass(frozen=True)
class DataMesh:
    """``size`` processes share ``axis``; this one is ``index`` and runs on
    ``device``.  On the data axis a global batch of B rows gives rank r its
    rows r·B/size .. (r + 1)·B/size; on the seq axis rank r holds window r
    of the time axis."""

    size: int
    index: int
    device: torch.device
    axis: str = DATA_AXIS

    def rows(self, local_rows: int) -> Tuple[int, int]:
        """(this rank's first global row, the global row count) for a local
        batch of ``local_rows``."""
        return self.index * local_rows, self.size * local_rows


def create_mesh(spec: MeshSpec = MeshSpec(), device: Optional[Union[str, torch.device]] = None) -> DataMesh:
    """The group as a mesh of ``spec``'s shape over every process, one
    device each, on the axis the processes span (the ``seq`` axis for a
    spec that names it and not ``data``, at one process too); ``device``
    defaults to this process's card (``distributed.local_device``)."""
    index, count = distributed.process_counts()
    shape = spec.resolve(count)
    sharded = [(axis, n) for axis, n in zip(spec.axes, shape) if n != 1]
    for axis, n in sharded:
        if axis not in (DATA_AXIS, SEQ_AXIS) or len(sharded) > 1:
            raise ValueError(f"axis {axis!r} of size {n}: only the {DATA_AXIS!r} axis is sharded, "
                             f"or the {SEQ_AXIS!r} axis alone")
    if sharded:
        axis = sharded[0][0]
    else:
        axis = SEQ_AXIS if SEQ_AXIS in spec.axes and DATA_AXIS not in spec.axes else DATA_AXIS
    dev = torch.device(device) if device is not None else distributed.local_device()
    return DataMesh(count, index, dev, axis)


def local_mesh(device: Optional[Union[str, torch.device]] = None) -> DataMesh:
    """Every process on the ``data`` axis."""
    return create_mesh(MeshSpec(), device)


def data_mesh(batch_size: int, device: Optional[Union[str, torch.device]] = None) -> DataMesh:
    """The data-parallel mesh for a global batch of ``batch_size`` rows.  It
    spans every process, so the batch must divide the process count (the JAX
    package's multi-process branch, mesh.py:74-78; with one device a process
    its single-process device subset has no counterpart)."""
    _, count = distributed.process_counts()
    if batch_size % count != 0:
        raise ValueError(f"global batch {batch_size} does not divide over {count} processes")
    return create_mesh(MeshSpec((count,), (DATA_AXIS,)), device)
