"""Device choice and the padding id shared by the port's kernels."""
from __future__ import annotations

import torch

__all__ = ["PAD_ID", "resolve_device"]

PAD_ID = 2**31 - 1  # int32 max: pads sorted id rows at the tail (kernels/segment_rf.py)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means ``"cuda"``.

    Asking for CUDA on a machine without a CUDA device raises ``RuntimeError``;
    nothing falls back to the CPU. The CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected a CUDA device or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
