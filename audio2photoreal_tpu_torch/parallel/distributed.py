"""Multi-process bootstrap on ``torch.distributed``.

Counterpart of ``audio2photoreal_tpu/parallel/distributed.py``.  One
process drives one device:

- ``initialize()`` starts the process group (NCCL between cards, gloo
  between CPU processes or processes sharing a card) from explicit
  arguments or from a launcher's environment (torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without either it does
  nothing, and the process trains alone.
- per-process batch slicing: each process loads only its
  ``local_batch_size`` rows of the global batch, its random windows drawn
  from its own process-folded seed (``per_process_seed``).
- ``shard_batch_global`` moves those rows to the process's device; the
  step (``train/loops.py``) treats them as rows r·B/N .. (r + 1)·B/N of
  the global batch.
- ``is_coordinator``: only process 0 writes configs, logs and checkpoints.

With one process every helper is the trivial slice, and a trainer takes the
same steps it took before this layer existed.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as tdist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")  # torchrun's


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Start the process group; returns True when more than one process
    takes part.  ``coordinator_address`` is ``host:port`` of process 0 (or
    an init-method URL such as ``file:///path``), with ``num_processes`` and
    ``process_id``; without it the launcher's environment is read, and
    without that this is a no-op.  ``backend`` defaults to NCCL when a card
    is visible, else gloo; NCCL refuses two processes on one card, which
    then take gloo.  Call before any device query."""
    if tdist.is_initialized():
        return tdist.get_world_size() > 1
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif all(os.environ.get(k) for k in LAUNCHER_ENV):
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":  # the card this rank's collectives run on, before the group starts
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    tdist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return world > 1


def process_counts() -> Tuple[int, int]:
    """(process_index, process_count) of the current group; (0, 1) without one."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def local_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK}`` under a launcher, else the
    process index modulo the visible cards; raises when there is no such
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on the card by default; "
                           "pass device='cpu' to run it on the CPU")
    i = int(os.environ.get("LOCAL_RANK", process_counts()[0] % torch.cuda.device_count()))
    if i >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {i} has no card: {torch.cuda.device_count()} visible")
    return torch.device("cuda", i)


def barrier() -> None:
    """Wait for every process of the group (nothing without one)."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.barrier()


def local_batch_size(global_batch_size: int, process_count: Optional[int] = None) -> int:
    """Per-process share of the global batch; it must divide evenly."""
    pc = process_counts()[1] if process_count is None else process_count
    if global_batch_size % pc != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {pc} processes")
    return global_batch_size // pc


def slice_for_process(n: int, process_index: Optional[int] = None, process_count: Optional[int] = None) -> slice:
    """Contiguous shard of ``range(n)`` for this process: every item exactly
    once, the first ``n % count`` processes one item more (no padding, which
    would count an item twice)."""
    pi, pc = process_counts()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    base, extra = divmod(n, pc)
    start = pi * base + min(pi, extra)
    return slice(start, start + base + (1 if pi < extra else 0))


def per_process_seed(seed: int, process_index: Optional[int] = None) -> int:
    """This process's window-sampling seed: the process index folded into
    the base seed with a large odd stride (the JAX package's formula)."""
    pi = process_counts()[0] if process_index is None else process_index
    return (int(seed) + pi * 0x9E3779B1) % (2**31 - 1)


def shard_batch_global(mesh, batch: Any) -> Any:
    """This process's local rows (a dict of tensors or arrays) on its device;
    the step reads them as its slice of the global batch.  A pinned tensor
    is copied without blocking."""
    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return x.to(mesh.device, non_blocking=True)

    return {k: put(v) for k, v in batch.items()}


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and logs (index 0)."""
    return process_counts()[0] == 0


def add_distributed_args(p) -> None:
    """The trainers' multi-process flags, the JAX CLIs' set."""
    p.add_argument("--distributed", action="store_true",
                   help="multi-process: start the process group from the launcher's environment "
                        "(torchrun); each process loads its 1/process_count slice of the batch")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (explicit bootstrap without a launcher)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend (default: nccl with a card, gloo without; gloo lets "
                        "several processes share one card)")


def initialize_from_args(args) -> bool:
    """Bootstrap from the trainer flags; True when multi-process.  Call
    before any device query.  A trainer on ``--device cpu`` takes gloo."""
    backend = getattr(args, "dist_backend", None)
    if backend is None and str(getattr(args, "device", None) or "").startswith("cpu"):
        backend = "gloo"
    if getattr(args, "coordinator_address", None):
        return initialize(args.coordinator_address, args.num_processes, args.process_id, backend)
    if getattr(args, "distributed", False):
        return initialize(backend=backend)
    return False
