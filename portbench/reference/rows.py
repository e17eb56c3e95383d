"""Which rows of the batch the reference is computing.

The reference runs a training step in blocks of rows so that its plain
attention and its dropout masks fit on the card.  Every draw over the batch
is made for the whole batch and cut to the block's rows (``draw_global``),
and a position hash over the batch is offset by the block's first row
(``rows``), so a block computes exactly its rows of the whole batch's step.
Outside ``block`` the whole batch is one block.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Tuple

import torch

_BLOCK: contextvars.ContextVar[Optional[Tuple[int, int]]] = contextvars.ContextVar("row_block", default=None)


@contextlib.contextmanager
def block(start: int, total: int):
    """Compute rows ``start`` .. of a batch of ``total`` rows inside."""
    token = _BLOCK.set((start, total))
    try:
        yield
    finally:
        _BLOCK.reset(token)


def rows(local_rows: int) -> Tuple[int, int]:
    """(first row of the block, rows of the whole batch)."""
    b = _BLOCK.get()
    return (0, local_rows) if b is None else b


def draw_global(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """``draw`` made at the whole batch's size along ``dim``, cut to the block's rows."""
    shape = tuple(shape)
    start, total = rows(shape[dim])
    if total == shape[dim]:
        return draw(shape)
    full = draw(shape[:dim] + (total,) + shape[dim + 1:])
    return full.narrow(dim, start, shape[dim])
