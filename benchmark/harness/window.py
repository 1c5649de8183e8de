"""One rank's run of a cell: the driver's set-up, its warm-up, the measured
window, the traced sub-window of a ``--trace 1`` run, and the rank's
per-layer readings.  With one chip the harness calls :func:`run_rank` in
its own process; with more, each rank is a process of its own
(:mod:`.ranks`) and :func:`merge` joins their windows."""
from __future__ import annotations

import math
import time
import types
from typing import Dict, List, Optional

import numpy as np

from . import spec


def seed_for(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (the same seed
    gives the same inputs; uses do not share streams)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, purpose])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sample_ticks(seed: int, n_est: int, count: int) -> List[int]:
    """``count`` distinct window ticks drawn from the seed, all within the
    first third of the ticks the warm-up's rate promises: a window reaches
    them unless it runs three times slower than its warm-up, and a traced
    run, whose window lasts until its traced ticks (from the third on) are
    done, always does."""
    rng = np.random.default_rng(seed_for(seed, 3))
    hi = max(count, n_est // 3)
    return sorted(int(i) for i in rng.choice(hi, size=count, replace=False))


def run_rank(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, start_wall: float, rank: int = 0, world: int = 1,
             addr: Optional[str] = None,
             overrides: Optional[Dict] = None) -> Dict:
    """Set-up, warm-up, window and readings of one rank; returns what the
    harness merges and judges (``records``: the sampled ticks' inputs and
    outputs, on the CPU)."""
    traffic = dict(cell.traffic, **(overrides or {}))
    drv = cell.driver().Driver(cell.config, traffic, seed, device, rank,
                               world, addr)
    setup = drv.setup()
    # warm-up: the card runs its first seconds of sustained load slower
    # (up to 8% on an H100, at the same reported clocks), so the window
    # opens after ``warmup_s`` of back-to-back ticks; a count of ticks
    # that every rank agrees on
    warm = [drv.tick(record=False, index=-2)[0]
            for _ in range(traffic.get("estimate_ticks", 10))]
    n_warm = math.ceil(traffic["warmup_s"] / float(np.median(warm)))
    n_warm = drv.agree_max(n_warm) if world > 1 else n_warm
    warm += [drv.tick(record=False, index=-2)[0] for _ in range(n_warm)]
    n_est = max(1, math.ceil(seconds / float(np.median(warm[-50:]))))
    n_fixed = drv.agree_max(n_est) if world > 1 else None
    n_plan = n_fixed or n_est
    samples = set(sample_ticks(seed, n_plan, traffic["check_ticks"]))
    t_lo = n_plan // 3
    t_hi = t_lo + cell.config["trace_ticks"]
    if n_fixed and trace:
        n_fixed = max(n_fixed, t_hi)
    prof = counters = tdata = None
    if trace:
        from .trace import Profiler
        Profiler.warm_up(lambda: drv.tick(record=False, index=-2))
        prof = Profiler()
    lat, bad = [], []
    drv.barrier()
    t_start = time.perf_counter()
    window_wall = time.time()
    i = 0
    try:
        while (i < n_fixed if n_fixed else
               prof is not None or time.perf_counter() - t_start < seconds):
            if prof is not None and i == t_lo:
                counters0 = drv.counters()
                prof.start()
                drv.label = prof.label
            dt, failed = drv.tick(record=i in samples, index=i)
            lat.append(dt)
            bad.append(failed)
            i += 1
            if prof is not None and i == t_hi:
                drv.label = None
                tdata = prof.stop(t_hi - t_lo)
                prof = None
                counters = {k: (v - counters0.get(k, 0)) / (t_hi - t_lo)
                            for k, v in drv.counters().items()}
    finally:
        if prof is not None and prof.running:
            prof.stop(0)
    window_s = time.perf_counter() - t_start
    memory = drv.memory_peak()
    per_layer = {}
    if trace:
        ctx = types.SimpleNamespace(trace=tdata, counters=counters,
                                    facts=drv.facts(), setup=setup)
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                per_layer[m["name"]] = float(value)
    out = dict(rank=rank, latencies=lat, failed=bad, window_s=window_s,
               failures=drv.failures,
               setup_s=window_wall - start_wall, memory=memory,
               per_layer=per_layer, setup=setup, records=drv.records(),
               kind=drv.device_name(),
               busy_s=tdata.busy_s() if tdata else None,
               traced_s=tdata.window_s if tdata else None,
               breakdown=tdata.breakdown() if tdata else None)
    drv.close()
    return out


def merge(ranks: List[Dict], cell: spec.Cell) -> Dict:
    """One window from the ranks' windows: a tick counts at its slowest
    rank, fails where it fails on any, and the window ends with the
    slowest rank; per-layer readings combine as each reader says."""
    n = min(len(r["latencies"]) for r in ranks)
    lat = np.max([r["latencies"][:n] for r in ranks], axis=0)
    failed = np.any([r["failed"][:n] for r in ranks], axis=0)
    per_layer = {}
    for m in cell.per_layer:
        vals = [r["per_layer"][m["name"]] for r in ranks
                if m["name"] in r["per_layer"]]
        if len(vals) == len(ranks):
            how = getattr(spec.reader(m["name"]), "ACROSS", "mean")
            per_layer[m["name"]] = float({"mean": np.mean, "max": np.max,
                                          "min": np.min}[how](vals))
    busy = [r["busy_s"] for r in ranks]
    return dict(
        ticks=n, latencies=lat.tolist(), failed=int(failed.sum()),
        window_s=max(r["window_s"] for r in ranks),
        setup_s=max(r["setup_s"] for r in ranks),
        memory=max(r["memory"] for r in ranks), per_layer=per_layer,
        kind=ranks[0]["kind"],
        busy_s=(float(np.mean(busy)) if all(b is not None for b in busy)
                else None),
        traced_s=ranks[0]["traced_s"], breakdown=ranks[0]["breakdown"])
