"""Explicit torch device resolution.

The port runs on the card.  A missing card is an error, whether the
caller named a CUDA device or left the device to the default: nothing
moves to the CPU behind the caller's back, and the CPU is used only when
the caller asks for it (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """torch.device for ``device``.

    None means ``cuda``; ``None``, ``"cuda"`` or ``"cuda:N"`` raise when no
    card is present.  ``"cpu"`` is the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is present")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only {torch.cuda.device_count()} "
                "CUDA devices are present")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
