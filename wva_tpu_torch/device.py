"""Device resolution shared by the port's entry points.

Entry points take ``device=None``, which means the CUDA card. The port never
falls back to the CPU on its own: a caller that wants the CPU (the tests)
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present); any
    other value is passed through ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device required; pass device='cpu' explicitly")
        return torch.device("cuda")
    return torch.device(device)
