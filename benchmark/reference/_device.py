"""Device helpers of the reference (copies of the program's two that the
frozen modules call)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The CPU unless the caller names another device."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def use_full_fp32() -> None:
    """Float32 products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
