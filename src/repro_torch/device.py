"""Device resolution: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a usable card raises:
    the port never falls back to the CPU on its own. ``cpu`` and ``meta``
    are taken as given (tests, shape-only builds)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev

