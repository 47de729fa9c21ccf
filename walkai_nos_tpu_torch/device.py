"""The one device rule of the port: entry points run on `cuda` unless
the caller asks for the CPU, and never fall back to the CPU quietly."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means `cuda`. A CUDA device without a visible GPU raises
    (RuntimeError) instead of silently running on the CPU; `"cpu"` is
    always honoured (the tests' setting)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
