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
* :func:`event_ms` — a function's mean time on the card, by CUDA events.
* :func:`substep_bound` and :func:`substep_row` — a substep kernel's bound
  and its row of the ``kernels`` line that ``chip_smoke.py`` and the
  application scripts print.
* :func:`span` and :data:`SPANS` — the program's own spans: host time of
  each call on the profiler's clock and, inside a CUDA graph, device time
  that every replay records (see "Spans" below).
* :func:`counter` and :data:`COUNTERS` — the program's counters, which a
  CUDA graph's replay adds to as its eager call would (see "Counters").
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA's data sheet for the H100 SXM (dense, at its 700 W limit): float32
# outside the tensor cores and HBM3.  Spec-sheet figures, not measurements.
CHIP_PEAKS = {
    "h100": dict(fp32_flops=67e12, hbm_bytes=3.35e12),
}

# the substep of the kernels' design (the entry points are in
# substep_kernel.cu) and the TPU kernel it replaces, for the kernels' rows
SUBSTEP_SOURCE = "opendog_tpu_torch/csrc/substep_warp.cuh"
SUBSTEP_REPLACES = "opendog_tpu/ops/pallas_step.py:115"
# the rollouts' tracking cost (rollout_tracking_cost) and the step cost it
# computes, for its rows
COST_SOURCE = "opendog_tpu_torch/csrc/tracking_cost.cuh"
COST_REPLACES = "opendog_tpu/solvers/costs.py:37"

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


def event_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, timed with CUDA
    events after one warm-up call (``warm_up=False``: ``fn`` ran before)."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def substep_bound(model, dt: float, n_substeps: int, modes, args,
                  chip: str = "h100"):
    """(bound_ms, bound_by, ops, nbytes) of one substep kernel launch on
    ``args`` ((rows, K) tensors: qpos, qvel, ctrl and the mode's plane and
    payload rows; None for a row the mode lacks), ``modes`` = (with_plane,
    with_payload): the larger of its operations
    (``ops/scalar_core.count_substep_ops`` per lane and substep) over the
    chip's float32 peak and its bytes (each input read once, qpos and qvel
    written once) over its memory rate."""
    from opendog_tpu_torch.ops import scalar_core
    args = [a for a in args if a is not None]
    K = args[0].shape[-1]
    ops = scalar_core.count_substep_ops(model, dt, *modes) * K * n_substeps
    nbytes = 4 * (sum(a.numel() for a in args) + K * (model.nq + model.nv))
    peaks = CHIP_PEAKS[chip]
    t_ops, t_bytes = ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def substep_row(name: str, launches: int, max_abs_err: float, ms: float,
                plain_ms: float, bound) -> Dict[str, Any]:
    """A substep kernel's row of a ``kernels`` line: ``bound`` is
    :func:`substep_bound`'s; no library call computes the step."""
    return {"name": name, "route": "cuda", "source": SUBSTEP_SOURCE,
            "replaces": SUBSTEP_REPLACES, "launches": int(launches),
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def tracking_cost_bound(model, lanes: int, chip: str = "h100"):
    """(bound_ms, bound_by, ops, nbytes) of one launch of the rollouts'
    tracking-cost kernel over ``lanes`` lanes: the larger of its bytes
    (qpos rows 2 .. nq-1, qvel rows 0, 1 and 5, the control and the
    previous control read, the total read and written; float32) over the
    chip's memory rate and its operations over its float32 peak, the
    transcendentals weighted 8 as :func:`count_flops` weights them (roll
    and pitch 17 and two transcendentals, the velocity, yaw-rate, height,
    upright and lateral terms 18, the posture and rate sums 3 a term and
    their weights, the sum of the seven terms, the discount and the
    total)."""
    nbytes = 4 * lanes * ((model.nq - 2) + 3 + 2 * model.nu + 2)
    ops = lanes * (17 + 2 * 8 + 18 + 3 * (model.nq - 7) + 1 + 3 * model.nu
                   + 1 + 6 + 2)
    peaks = CHIP_PEAKS[chip]
    t_ops, t_bytes = ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def cost_row(name: str, launches: int, max_abs_err: float, ms: float,
             op_ms: float, bound) -> Dict[str, Any]:
    """The tracking-cost kernel's row of a ``kernels`` line: ``bound`` is
    :func:`tracking_cost_bound`'s, ``op_ms`` the op path's step (the plain
    version); no library call computes the cost."""
    return {"name": name, "route": "cuda", "source": COST_SOURCE,
            "replaces": COST_REPLACES, "launches": int(launches),
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": op_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


# -- Spans -------------------------------------------------------------------
#
# ``with span("mppi.rollout"): ...`` records the host's start and end of the
# block with ``time.time_ns()``, the clock that ``torch.profiler`` stamps its
# events with, so a span and a trace of the same process line up.  While a
# profiler session is active the span also opens ``record_function(name)``,
# so the range shows in the trace; while none is, it makes no dispatcher
# call.  Inside a capture that :func:`capture_events` collects
# (``solvers.graph.GraphedTick``'s), the span also records a pair of timing
# events on the current stream: they become event-record nodes of the graph
# and fire on every replay, which is how a stage's device time survives the
# replay, where no Python runs between stages.  The graph's owner reads the
# pairs after a replay into :data:`SPANS` (``device``).  With the spans off
# (:func:`set_spans`) a span costs one flag check and records nothing, and a
# graph captured then holds no event node.

SPAN_RING = 8192   # records kept per name, the newest


class SpanStore:
    """The spans of a process, by name: ``host(name)`` -> [(start ns, end
    ns)] of each call (eager, or the Python pass of a capture);
    ``device(name)`` -> [(host start ns of the replay, device ms)], one row
    per read replay of a graph that holds the span (the sum of its pairs
    there) and, from ``GraphedTick``, ``graph.replay`` (the replay's device
    span) and ``graph.period`` (from the previous replay's start on the
    device to this one's).  Every graph of the process writes under these
    names: a reader of one graph's rows replays that graph alone, as the
    benchmark's ranks do.  Oldest first; :data:`SPAN_RING` rows per name
    at most."""

    def __init__(self):
        self._host: Dict[str, collections.deque] = {}
        self._device: Dict[str, collections.deque] = {}

    @staticmethod
    def _add(rings: Dict[str, collections.deque], name: str, row) -> None:
        ring = rings.get(name)
        if ring is None:
            ring = rings[name] = collections.deque(maxlen=SPAN_RING)
        ring.append(row)

    def add_host(self, name: str, start_ns: int, end_ns: int) -> None:
        self._add(self._host, name, (start_ns, end_ns))

    def add_device(self, name: str, replay_ns: int, ms: float) -> None:
        self._add(self._device, name, (replay_ns, ms))

    def host(self, name: str) -> List[Tuple[int, int]]:
        return list(self._host.get(name, ()))

    def device(self, name: str) -> List[Tuple[int, float]]:
        return list(self._device.get(name, ()))

    def clear(self) -> None:
        self._host.clear()
        self._device.clear()


SPANS = SpanStore()
_on = True
# (name, start event, end event) of the spans of the capture in progress,
# or None (capture_events)
_pairs: Optional[list] = None


def set_spans(on: bool) -> bool:
    """Turns the spans on or off (on by default); returns the old setting."""
    global _on
    old, _on = _on, bool(on)
    return old


def spans_on() -> bool:
    return _on


@contextlib.contextmanager
def capture_events():
    """Around a CUDA-graph capture: yields the list that the spans opened
    inside it fill with ``(name, start event, end event)``, the timing
    events they record into the graph."""
    global _pairs
    outer, _pairs = _pairs, []
    try:
        yield _pairs
    finally:
        _pairs = outer


class _Span:
    __slots__ = ("name", "start", "_range", "_event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._event = self._range = None
        # a capture in progress, on this thread's stream (not another's)
        if _pairs is not None and torch.cuda.is_current_stream_capturing():
            self._event = torch.cuda.Event(enable_timing=True, external=True)
            self._event.record()
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._event is not None:
            stop = torch.cuda.Event(enable_timing=True, external=True)
            stop.record()
            _pairs.append((self.name, self._event, stop))
        SPANS.add_host(self.name, self.start, end)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records the block as a span of ``name`` in
    :data:`SPANS` (see "Spans" above); a no-op while the spans are off."""
    return _Span(name) if _on else _OFF


# -- Counters ----------------------------------------------------------------
#
# The program's counters that Python bumps as it issues work (the substep
# kernels' ``ops.cuda_step.LAUNCHES``, the collectives'
# ``parallel.collectives.TRAFFIC``), each made by :func:`counter`.  A CUDA
# graph's capture issues nothing that runs, and a replay issues everything
# the capture did without running Python, so ``solvers.graph.GraphedTick``
# takes each counter's counts out of its capture and adds them back on every
# replay.

COUNTERS: List[collections.Counter] = []


def counter() -> collections.Counter:
    """A new program counter, kept in :data:`COUNTERS`."""
    c = collections.Counter()
    COUNTERS.append(c)
    return c
