"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card they raise: nothing falls back to the CPU on its own, so a run that
should have measured the card can never silently measure the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; raise if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False. Pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
