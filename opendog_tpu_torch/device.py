"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and no card
    is present; there is no quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def use_full_fp32() -> None:
    """Keep float32 products in full float32 on the card (no TF32): the
    counterpart of the JAX package's ``precision="highest"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def use_cusolver() -> None:
    """Send the card's batched factorizations and solves to cuSOLVER and
    cuBLAS.  By default PyTorch sends a batched ``cholesky_solve``, and
    ``solve_ex`` / ``inv_ex`` over more than about a dozen matrices, to
    MAGMA, which a CUDA graph capture refuses.  A process-wide setting, as
    the TF32 flags of :func:`use_full_fp32` are."""
    torch.backends.cuda.preferred_linalg_library("cusolver")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (first card), to stand
    beside every time taken on it."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
