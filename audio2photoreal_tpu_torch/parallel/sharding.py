"""Replicated parameters, row-sharded batches, and the binding of the data
axis during a step.

Counterpart of ``audio2photoreal_tpu/parallel/sharding.py``.  In the JAX
package a jitted step whose batch is sharded over the ``data`` axis computes
the global step: global positions, global draws, global means, with the
gradient sum inserted by XLA.  Here each process runs its own rows, so the
step binds its mesh (``bind``) for the time it runs, and the code inside
reads the binding:

- a random draw over the batch is made for the global batch from the
  step's generator, on every rank alike, and cut to this rank's rows
  (``draw_global``), so rank r sees rows r·B/N .. of the draw the
  1-process step makes;
- a position hash over the batch (the hash dropout) is offset by this
  rank's first row (``rows``);
- the collectives (``parallel/collectives.py``) act on the bound axis and
  are the identity outside a binding.

Outside a binding ``rows`` is (0, local rows) and ``draw_global`` is the
plain draw: every model runs as it did before this layer existed.  The JAX
``with_shardings`` (jit with sharding constraints, no caller in the JAX
package) has no eager counterpart.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from audio2photoreal_tpu_torch.parallel.mesh import DATA_AXIS, DataMesh

_BOUND: contextvars.ContextVar[Optional[DataMesh]] = contextvars.ContextVar("bound_data_mesh", default=None)


@contextlib.contextmanager
def bind(mesh: Optional[DataMesh]):
    """Bind ``mesh``'s data axis for the code inside (None binds nothing)."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_mesh(axis: str = DATA_AXIS) -> Optional[DataMesh]:
    """The mesh bound to ``axis`` here, or None."""
    mesh = _BOUND.get()
    return mesh if mesh is not None and mesh.axis == axis else None


def rows(local_rows: int, axis: str = DATA_AXIS) -> Tuple[int, int]:
    """(this rank's first global row, global rows) of a batch of
    ``local_rows`` on the bound axis; (0, ``local_rows``) unbound."""
    mesh = bound_mesh(axis)
    return (0, local_rows) if mesh is None else mesh.rows(local_rows)


def draw_global(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int], dim: int = 0,
                axis: str = DATA_AXIS) -> torch.Tensor:
    """``draw(shape)`` with ``shape[dim]`` this rank's rows: the draw is
    made at the global row count and this rank's rows are cut from it, so
    the generator moves as the 1-process step's does and every rank holds
    its slice of one global draw."""
    shape = tuple(shape)
    start, total = rows(shape[dim], axis)
    if total == shape[dim]:
        return draw(shape)
    full = draw(shape[:dim] + (total,) + shape[dim + 1:])
    return full.narrow(dim, start, shape[dim])


def replicated(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` made equal to process
    ``src``'s (a broadcast; nothing without a process group)."""
    if tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1:
        from audio2photoreal_tpu_torch.parallel.collectives import broadcast

        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                t.copy_(broadcast(t, src))
    return module


def batch_sharding(mesh: DataMesh, n_rows: int) -> slice:
    """The rows of a global batch of ``n_rows`` that ``mesh``'s rank holds."""
    if n_rows % mesh.size != 0:
        raise ValueError(f"batch of {n_rows} rows does not divide over {mesh.size} processes")
    local = n_rows // mesh.size
    return slice(mesh.index * local, (mesh.index + 1) * local)


def shard_batch(mesh: DataMesh, batch: Any) -> Any:
    """A global batch (a dict of tensors or arrays, batch on dim 0) → this
    rank's rows of it on its device."""
    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return x[batch_sharding(mesh, x.shape[0])].to(mesh.device)

    return {k: put(v) for k, v in batch.items()}
