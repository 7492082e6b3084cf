"""Device resolution for the port's entry points.

Everything runs on ``cuda`` unless the caller asks for the CPU
explicitly (``device="cpu"``, or ``TORCH_DEVICE=cpu`` for the server —
the counterpart of ``JAX_PLATFORMS``). A CUDA request on a machine with
no card raises: nothing here moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Returns a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no card is present and
    ``ValueError`` for any device type other than cuda/cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (TORCH_DEVICE=cpu) to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev!s}: use cuda or cpu")


def device_count(device: Optional[torch.device]) -> int:
    """Devices of the serving type: CUDA cards, or 1 for the CPU."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device_count()
    return 1
