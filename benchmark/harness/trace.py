"""The traced sub-window: ``torch.profiler`` over a few tens of ticks in the
middle of a ``--trace 1`` run, reduced in memory to what the per-layer
readers and the ledger's breakdown need.  Nothing is written to disk."""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import stats

WINDOW = "bench.window"


class TraceData:
    """Device activities (``kind``, ``name``, start and end in ns) and the
    harness's own host ranges (``bench.*``) of ``ticks`` profiled ticks,
    all on the profiler's clock; ``lo`` / ``hi`` bound the window (the
    ``bench.window`` range)."""

    def __init__(self, device: List[Tuple[str, str, int, int]],
                 host: List[Tuple[str, int, int]], lo: int, hi: int,
                 ticks: int):
        self.device, self.host = device, host
        self.lo, self.hi, self.ticks = lo, hi, ticks

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return stats.union_ns([(s, e) for _, _, s, e in self.device],
                              self.lo, self.hi) * 1e-9

    def kernels(self, pred: Callable[[str], bool]):
        return [(n, s, e) for k, n, s, e in self.device
                if k == "kernel" and pred(n)]

    def seconds(self, pred: Callable[[str], bool]) -> float:
        return sum(e - s for _, s, e in self.kernels(pred)) * 1e-9

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and idle time by the
        harness range (or ``host``) that ran at each gap's middle."""
        ops = collections.Counter()
        for _, name, s, e in self.device:
            ops[name] += (e - s) * 1e-9
        idle = collections.Counter()
        ranges = sorted(self.host, key=lambda r: r[2] - r[1])
        for a, b in stats.gaps_ns([(s, e) for _, _, s, e in self.device],
                                  self.lo, self.hi):
            mid = (a + b) // 2
            label = next((n for n, s, e in ranges if s <= mid <= e
                          and n != WINDOW), "host")
            idle[label] += (b - a) * 1e-9
        return {"device_ops": [[n[:120], t] for n, t in ops.most_common(top)],
                "idle_gaps": [[n, t] for n, t in idle.most_common(top)]}


def reduce(events: Iterable[Tuple[str, bool, int, int]],
           ticks: int) -> Optional[TraceData]:
    """The traced window from the profiler's events, each ``(name, on the
    device, start ns, end ns)``.  A range a host thread opened
    (``record_function``: the harness's ``bench.*``, or any the program
    opens) shows on the device too, under its own name; a device event
    that bears the name of a host event of the same trace is such a range,
    not work, and is left out.  Device work is a kernel, or a copy or a
    fill by its name.  None where the trace holds no window or no work."""
    events = list(events)
    host_names = {n for n, dev, _, _ in events if not dev}
    device, host, lo, hi = [], [], None, None
    for name, on_device, s, e in events:
        if on_device:
            if name in host_names:
                continue
            low = name.lower()
            kind = ("memcpy" if low.startswith("memcpy") else "memset"
                    if low.startswith("memset") else "kernel")
            device.append((kind, name, s, e))
        elif name == WINDOW:
            lo, hi = s, e
        elif name.startswith("bench."):
            host.append((name, s, e))
    if lo is None or not device:
        return None
    return TraceData(device, host, lo, hi, ticks)


class Profiler:
    """``start()`` before the first profiled tick, ``stop(ticks)`` after the
    last one has synchronised."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._range = record_function
        self._window = None
        self.running = False

    @staticmethod
    def warm_up(tick: Callable) -> None:
        """One profiled tick, thrown away: the profiler's first start loads
        and initialises its tracing library, which would otherwise land in
        the window."""
        p = Profiler()
        p.start()
        tick()
        p.stop(1)

    def start(self) -> None:
        self.running = True
        self._prof.start()
        self._window = self._range(WINDOW)
        self._window.__enter__()

    def label(self, name: str):
        """A host range that names what the harness does (``bench.*``)."""
        return self._range(name)

    def stop(self, ticks: int) -> Optional[TraceData]:
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.running = False
        events = [(ev.name(), "CUDA" in str(ev.device_type()),
                   ev.start_ns(), ev.end_ns())
                  for ev in self._prof.profiler.kineto_results.events()]
        self._prof = None
        return reduce(events, ticks)
