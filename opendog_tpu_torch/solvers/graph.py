"""CUDA-graph replay of a control tick: the port's counterpart of ``jax.jit``.

The JAX package compiles its control tick once and donates the carry
(``jax.jit(..., donate_argnums=0)``, ``opendog_tpu/solvers/mpc.py:236-260``),
so a tick costs one dispatch.  Run eagerly, the same tick issues a few
thousand small PyTorch launches from the host, and the host's issue, not the
card, sets its time.  :class:`GraphedTick` records one call of a tick into a
``torch.cuda.CUDAGraph`` over static input buffers and replays it: the host
then issues a few input copies and one graph launch per tick.
"""
from __future__ import annotations

import collections
import gc
from typing import Callable, Sequence

import torch

from ..ops import cuda_step
from ..utils import profiling

# With the spans on, one replay in every READ_EVERY has its device times
# read: the first and every READ_EVERY-th after it.  A read waits for its
# events on the host before the next launch (a query and an elapsed_time a
# pair, 2-8 us each on an H100's host: ~45 us a Go1 tick, 1% of the
# K=256 tick), so reading every replay would put that on every tick; read
# so, it falls on one tick in READ_EVERY, which a 95th percentile of the
# ticks still holds.
READ_EVERY = 8


class GraphedTick:
    """``fn(*inputs)`` captured once in a CUDA graph and replayed.

    ``example_inputs`` (tensors) give the inputs' shapes and dtypes: they
    are copied into static input buffers on ``device`` (``inputs``).  ``fn``
    then runs once eagerly on a side stream, so that every kernel it holds
    is loaded (and the substep kernels' shared-memory opt-in made) before
    the capture, and one call of it is captured.  ``fn`` must be a function
    of its input tensors alone: it reads nothing from the host, draws no
    random numbers (pass the normals in) and writes none of its inputs.

    ``__call__(*inputs)`` copies each input into its static buffer (a
    buffer passed as itself is not copied; a pinned host tensor is copied
    without blocking), replays the graph on the current stream and returns
    ``fn``'s outputs as captured.  They are static tensors that the next
    call overwrites: clone what you keep.

    Only on CUDA: another device raises, and nothing falls back to an eager
    call.  A capture error propagates as it is.

    Each program counter (``utils.profiling.COUNTERS``:
    ``cuda_step.LAUNCHES``, ``collectives.TRAFFIC``) counts in Python, so
    the capture would count work that never ran and a replay none.  The
    capture's counts are taken out of each counter (:meth:`count_of`;
    ``launches`` is LAUNCHES') and added back on every replay: a replay
    counts as the eager call does.

    Spans (``utils.profiling``), while they are on: the capture collects the
    timing-event pairs of the spans that ``fn`` opens (``pairs``; they fire
    on every replay), and a host span ``graph.replay`` covers each call
    (the input copies and the launch).  Every :data:`READ_EVERY`-th
    replay is read: a pair of timing events around it on the stream gives
    the graph's device span, and one at the start of the replay before it
    the device's tick period; its events are read at the next call, before
    that replay launches, where they have fired by then (``query()``; one
    still running is not read), and stored with the host start of its
    ``graph.replay``.  :meth:`flush` waits for a read replay and reads it.
    The replays are timed on the stream that was current when the graph
    was made, where every caller replays it.  Every graph of a process
    stores under the same names: a reader of one graph's times replays
    that graph alone.

    Python's cyclic garbage collector is held off during the capture: a
    collection there may free an unreachable object that owns another CUDA
    graph, and destroying a graph while a stream captures invalidates the
    capture (PyTorch no longer collects before a capture).

    The graph keeps ``fn`` (``self.fn``), and through it every tensor that
    ``fn`` reads without taking it as an input (a kernel's model table, a
    cost's constants): the graph holds their device addresses, and were
    they freed, the allocator would hand their memory to other tensors
    while replays still read it.
    """

    def __init__(self, fn: Callable, example_inputs: Sequence[torch.Tensor],
                 device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.fn = fn
        self.inputs = tuple(torch.empty_like(x, device=device).copy_(x)
                            for x in example_inputs)
        with torch.cuda.device(device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn(*self.inputs)
            current.wait_stream(side)
            # keep_graph: the captured graph stays readable (its node
            # count, raw_cuda_graph) after instantiation
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            counters = list(profiling.COUNTERS)
            before = [collections.Counter(c) for c in counters]
            collecting = gc.isenabled()
            gc.disable()
            try:
                with profiling.capture_events() as pairs, \
                        torch.cuda.graph(self.graph):
                    self.outputs = fn(*self.inputs)
            finally:
                if collecting:
                    gc.enable()
                self._counters = counters
                self._counts = [c - b for c, b in zip(counters, before)]
                for c, b in zip(counters, before):
                    c.clear()
                    c.update(b)
        self.pairs = tuple(pairs)
        self._stream = current
        # around the read replay (its start and end) and the start of the one
        # before it, for the period
        self._start, self._end, self._before = (
            torch.cuda.Event(enable_timing=True) for _ in range(3))
        self._timed = 0           # replays with the spans on so far
        self._last_timed = False  # the last call was one of them
        # (host start, whether the call before it was timed) of the read
        # replay, until it is read
        self._unread = None

    def count_of(self, counter: collections.Counter) -> collections.Counter:
        """What one replay adds to ``counter``, a program counter."""
        return next(n for c, n in zip(self._counters, self._counts)
                    if c is counter)

    @property
    def launches(self) -> collections.Counter:
        """Substep launches of one replay, by kernel and shape."""
        return self.count_of(cuda_step.LAUNCHES)

    def __call__(self, *inputs):
        if len(inputs) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(inputs)}")
        if not profiling.spans_on():
            self._last_timed = False
            self._replay(inputs, None)
            return self.outputs
        self._read(wait=False)
        k = self._timed % READ_EVERY
        with profiling.span("graph.replay") as sp:
            self._replay(inputs, k)
        if k == 0:
            self._unread = (sp.start, self._last_timed)
        self._last_timed = True
        self._timed += 1
        return self.outputs

    def _replay(self, inputs, k) -> None:
        """Copies the inputs in and replays; ``k``: the replay's place in
        the cycle of READ_EVERY (0: the read one), None with the spans
        off."""
        for i, (buf, x) in enumerate(zip(self.inputs, inputs)):
            if x is buf:
                continue
            if x.shape != buf.shape:
                raise ValueError(f"input {i} has shape {tuple(x.shape)}, the "
                                 f"graph's {tuple(buf.shape)}")
            buf.copy_(x, non_blocking=True)
        if k == 0:
            self._start.record(self._stream)
        elif k == READ_EVERY - 1:
            self._before.record(self._stream)
        self.graph.replay()
        if k == 0:
            self._end.record(self._stream)
        for c, n in zip(self._counters, self._counts):
            c.update(n)

    def _read(self, wait: bool) -> None:
        """The read replay's device times into ``profiling.SPANS``: its
        span, its period and each span's sum over its pairs."""
        if self._unread is None:
            return
        (at, chained), self._unread = self._unread, None
        if wait:
            self._end.synchronize()
        elif not self._end.query():
            return
        store = profiling.SPANS
        store.add_device("graph.replay", at,
                         self._start.elapsed_time(self._end))
        if chained:
            store.add_device("graph.period", at,
                             self._before.elapsed_time(self._start))
        sums = {}
        for name, a, b in self.pairs:
            sums[name] = sums.get(name, 0.0) + a.elapsed_time(b)
        for name, ms in sums.items():
            store.add_device(name, at, ms)

    def flush(self) -> None:
        """Waits for the last read replay, if it is not read yet, and reads
        its device times."""
        self._read(wait=True)
