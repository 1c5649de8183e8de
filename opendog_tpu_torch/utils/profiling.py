"""Profiling and speed-of-light accounting.

The reference has no profiling beyond wall-clock prints
(``sim2real/run.py:347-351``, ``run_robot.py:263``).  Port of the JAX
package's ``utils/profiling.py``, on PyTorch:

* :func:`trace` — context manager around ``torch.profiler`` (the host and,
  where there is a card, CUDA) that writes a Chrome trace
  (``trace.json``) into a directory, viewable in Perfetto or
  ``chrome://tracing``.
* :func:`count_flops` — arithmetic-op count of a function from the aten
  ops it dispatches when run once (under a ``TorchDispatchMode``), with
  the JAX package's weights: elementwise ops by output size (transcendental
  ones weighted), products by 2mnk.
* :func:`roofline` — compares a measured runtime against the
  arithmetic-bound and memory-bound lower limits for a given chip.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA's data sheet for the H100 SXM (dense, at its 700 W limit): float32
# outside the tensor cores and HBM3.  Spec-sheet figures, not measurements.
CHIP_PEAKS = {
    "h100": dict(fp32_flops=67e12, hbm_bytes=3.35e12),
}

# the JAX package's weights (its ``_ELEMENTWISE_1`` / ``_ELEMENTWISE_N``),
# keyed by the aten op that computes each primitive
_ELEMENTWISE_1 = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "sign", "floor", "ceil", "round", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_xor", "logical_not", "where",
}
_ELEMENTWISE_N = {
    "sqrt": 4, "rsqrt": 4, "exp": 8, "log": 8, "sin": 8, "cos": 8,
    "tanh": 10, "sigmoid": 10, "pow": 10, "erf": 10,
}


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/prof") as prof: run_workload()`` writes
    ``<log_dir>/trace.json``; ``prof.key_averages()`` holds the sums by
    op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (tuple, list)):
        return sum(_numel(v) for v in x)
    return 0


class _FlopCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")   # add_ is add
        if name in ("mm", "bmm", "addmm", "baddbmm"):
            a, b = args[-2], args[-1]
            k = a.shape[-1]
            self.flops += 2.0 * out.numel() * k
            if name in ("addmm", "baddbmm"):
                self.flops += out.numel()   # the bias: JAX counts its add
        elif name in _ELEMENTWISE_1:
            self.flops += _numel(out)
        elif name in _ELEMENTWISE_N:
            self.flops += _ELEMENTWISE_N[name] * _numel(out)
        return out


def count_flops(fn, *args, **kwargs) -> float:
    """Flop estimate of ``fn(*args, **kwargs)``, which it runs once: every
    aten op it dispatches, weighted as the JAX package weights the
    primitives of a jaxpr.  ``mm`` / ``bmm`` count 2mnk; ``addmm`` /
    ``baddbmm`` 2mnk and the bias's add (JAX's ``x @ w + b`` is a
    ``dot_general`` and an ``add``)."""
    with torch.no_grad(), _FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.flops


@dataclass
class Roofline:
    measured_s: float
    flops: float
    bytes_moved: float
    flops_bound_s: float
    hbm_bound_s: float
    pct_of_compute_sol: float
    pct_of_hbm_sol: float

    def report(self) -> str:
        return (
            f"measured {self.measured_s*1e6:.1f} us | "
            f"compute-bound floor {self.flops_bound_s*1e6:.1f} us "
            f"({self.pct_of_compute_sol:.1f}% of SoL) | "
            f"HBM floor {self.hbm_bound_s*1e6:.1f} us "
            f"({self.pct_of_hbm_sol:.1f}% of SoL)"
        )


def roofline(measured_s: float, flops: float, bytes_moved: float,
             chip: str = "h100",
             compute_key: str = "fp32_flops") -> Roofline:
    peaks: Dict[str, Any] = CHIP_PEAKS[chip]
    fb = flops / peaks[compute_key]
    hb = bytes_moved / peaks["hbm_bytes"]
    return Roofline(
        measured_s=measured_s, flops=flops, bytes_moved=bytes_moved,
        flops_bound_s=fb, hbm_bound_s=hb,
        pct_of_compute_sol=100.0 * fb / max(measured_s, 1e-12),
        pct_of_hbm_sol=100.0 * hb / max(measured_s, 1e-12),
    )
