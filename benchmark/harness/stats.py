"""The yardstick's arithmetic: percentiles, spreads, the union of device
intervals and the roofline bound."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

import numpy as np

# NVIDIA's published H100 SXM peaks (dense, no sparsity): float32 outside
# the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between
    ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] covered by at least one interval."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps_ns(intervals: Iterable[Tuple[int, int]], lo: int,
            hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end and s <= hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return out


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
