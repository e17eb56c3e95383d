"""Device choice for the port's entry points: the card unless the caller asks."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as given, or ``cuda`` when it is None; with None and no
    CUDA device this raises instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by default; "
            "pass device='cpu' to run it on the CPU"
        )
    return torch.device("cuda")
