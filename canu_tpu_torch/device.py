"""Explicit torch device resolution.

A requested CUDA device that is not present is an error: nothing moves to
the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """torch.device for ``device``.

    None picks ``cuda`` when a card is visible and ``cpu`` otherwise;
    ``"cuda"`` (or ``"cuda:N"``) raises when no card is present.
    """
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
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
