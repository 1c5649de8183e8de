"""The readers of the program's span store (``benchmark/metrics/_spans.py``
and the eight metrics on it) on a synthetic store and trace: ten replays,
the profiler's window over three of them, whose readings differ so that
taking one of them in shows; and None where the program has no store."""
import types

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import TraceData
from opendog_tpu_torch.utils import profiling

MS = 1_000_000   # ns
LO, HI = 4 * MS, 6 * MS + MS // 2      # traced: the replays at 4, 5, 6 ms
STAGES = {"mppi.sample": 0.05, "mppi.rollout": 0.5, "mppi.update": 0.1,
          "mpc.plant": 0.3, "collectives.all_reduce": 0.02}
READERS = {"sample_ms_per_tick": "mppi.sample",
           "rollout_ms_per_tick": "mppi.rollout",
           "update_ms_per_tick": "mppi.update",
           "plant_ms_per_tick": "mpc.plant",
           "allreduce_ms_per_tick": "collectives.all_reduce"}


def _store():
    """Replays every ms from 0 to 9 ms: on the host ``graph.replay`` takes
    0.2 ms (traced: 0.5 ms); on the device the graph 1 ms, the period 1.25
    ms and each stage its STAGES value (traced: ten times as much)."""
    s = profiling.SpanStore()
    for i in range(10):
        at = i * MS
        traced = LO <= at <= HI
        k = 10.0 if traced else 1.0
        s.add_host("graph.replay", at, at + (MS // 2 if traced else MS // 5))
        s.add_device("graph.replay", at, 1.0 * k)
        if i:
            s.add_device("graph.period", at, 1.25 * k)
        for name, ms in STAGES.items():
            s.add_device(name, at, ms * k)
    return s


def _trace():
    """Device work in the traced window: from 0.3 ms into each replay to
    its end, 1 ms after its start; so each tick has a 0.3 ms gap at its
    start (inside the 0.5 ms ``graph.replay`` span) and none after."""
    dev = [("kernel", "k", at + 3 * MS // 10, at + MS)
           for at in (4 * MS, 5 * MS, 6 * MS)]
    return TraceData(dev, [], LO, HI, 3)


def _ctx(trace):
    return types.SimpleNamespace(trace=trace, counters={}, facts=dict(
        robot="go1", world=4, collective_bytes_per_tick=0), setup={})


@pytest.fixture
def store(monkeypatch):
    s = _store()
    monkeypatch.setattr(profiling, "SPANS", s)
    return s


def read(name, ctx):
    return spec.reader(name).read(ctx)


def test_stage_readers_take_the_median_of_the_untraced_replays(store):
    ctx = _ctx(_trace())
    for name, span in READERS.items():
        assert read(name, ctx) == pytest.approx(STAGES[span]), name


def test_replay_launch_and_off_graph(store):
    ctx = _ctx(_trace())
    assert read("replay_launch_ms_per_tick", ctx) == pytest.approx(0.2)
    assert read("off_graph_pct", ctx) == pytest.approx(100 * (1 - 1 / 1.25))


def test_launch_idle_pct_counts_the_gaps_inside_a_replay_span(
        store, monkeypatch):
    # the window's gaps: 0.3 ms at the start of each of the three traced
    # replays, each inside its 0.5 ms replay span; none after the last
    # kernel, which ends past the window
    assert read("launch_idle_pct", _ctx(_trace())) == pytest.approx(100.0)
    # the last replay's span cut to 0.1 ms: its gap's midpoint falls out
    shorter = profiling.SpanStore()
    for at in (4 * MS, 5 * MS):
        shorter.add_host("graph.replay", at, at + MS // 2)
    shorter.add_host("graph.replay", 6 * MS, 6 * MS + MS // 10)
    monkeypatch.setattr(profiling, "SPANS", shorter)
    assert read("launch_idle_pct", _ctx(_trace())) == pytest.approx(200 / 3)


def test_no_store_or_no_trace_reads_nothing(monkeypatch, store):
    names = list(READERS) + ["replay_launch_ms_per_tick", "off_graph_pct",
                             "launch_idle_pct"]
    for name in names:
        assert read(name, _ctx(None)) is None, name
    monkeypatch.delattr(profiling, "SPANS")
    for name in names:
        assert read(name, _ctx(_trace())) is None, name
    monkeypatch.setattr(profiling, "SPANS", profiling.SpanStore(),
                        raising=False)
    for name in names:
        assert read(name, _ctx(_trace())) is None, name
