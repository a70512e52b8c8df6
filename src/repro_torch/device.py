"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: the default
device is ``"cuda"``, and asking for CUDA on a machine without a CUDA device
raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and none is available; pass ``device="cpu"`` to run on the CPU.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
