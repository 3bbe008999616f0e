"""Device selection.

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA they raise rather than fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises RuntimeError for a CUDA device when
    CUDA is absent (the CPU runs only when asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def canonical_device(device=None) -> torch.device:
    """``resolve_device`` with the card's index filled in (``cuda`` ->
    ``cuda:<current device>``), so that one card has one name in a
    device list."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
