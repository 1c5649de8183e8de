"""BENCHMARK.json against the contract and against the files it names, and
the harness's arithmetic on synthetic inputs.  Run from the repository
root: ``python -m pytest benchmark/tests -q``."""
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import types

import pytest

from benchmark.harness import spec, stats, trace
from benchmark.harness.trace import TraceData

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = spec.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    entries = MAN[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        texts = ["why", "layer"] + (["source"] if kind == "configs" else [])
        for key in (k for k in texts if k in e):
            assert 1 <= len(e[key]) <= 200, (key, e[key])
            assert "\n" not in e[key] and "\t" not in e[key]


def test_configs_files_and_reductions():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        importlib.import_module("benchmark.drivers."
                                + spec.module_name(conf["driver"]))
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


def test_cells():
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.Cell(w["name"], MAN)   # traffic, limits, config load
        assert cell.traffic["num_samples"] > 0
        assert set(cell.limits) >= {"ctrl_gap", "nominal_gap", "qpos_gap",
                                    "qvel_gap"}
        assert cell.config.get("ranks", 1) == w["chips"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
    n4 = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert 1 <= n4 <= max(1, len(MAN["workloads"]) // 4)


def test_metrics_entries_and_readers():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for m in MAN["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    q1, med, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0], n=4)
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (q3 - q1) / med)


def test_union_and_gaps():
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (70, 200)]
    assert stats.union_ns(iv, 0, 100) == 20 + 10 + 30
    assert stats.gaps_ns(iv, 0, 100) == [(0, 10), (30, 40), (50, 70)]
    assert stats.union_ns([], 0, 100) == 0
    assert stats.gaps_ns([], 0, 100) == [(0, 100)]


def test_trace_readers_on_a_synthetic_tick():
    # two ticks of 1 ms each: 25 substep launches of 10 us and 100 op
    # kernels of 2 us, one NCCL kernel of 5 us
    dev, t = [], 0
    for _ in range(2):
        for _ in range(25):
            dev.append(("kernel", "substep_flat", t, t + 10_000))
            t += 12_000
        for _ in range(100):
            dev.append(("kernel", "elementwise_kernel", t, t + 2_000))
            t += 3_000
        dev.append(("kernel", "ncclDevKernel_AllReduce", t, t + 5_000))
        t = (t // 1_000_000 + 1) * 1_000_000
    tr = TraceData(dev, [("bench.tick", 0, 2_000_000)], 0, 2_000_000, 2)
    ctx = types.SimpleNamespace(
        trace=tr, counters={"launches substep_flat K=4096 x2": 25.0},
        facts=dict(robot="go1", world=4, collective_bytes_per_tick=4864),
        setup={"capture_s": 1.5})
    read = lambda name: spec.reader(name).read(ctx)
    assert read("op_kernels_per_tick") == 100
    assert read("op_kernels_ms_per_tick") == pytest.approx(0.2)
    assert read("substep_ms_per_tick") == pytest.approx(0.25)
    assert read("nccl_ms_per_tick") == pytest.approx(0.005)
    assert read("collective_bytes_per_tick") == 4864
    busy = 2 * (25 * 10_000 + 100 * 2_000 + 5_000) * 1e-9
    assert read("idle_pct") == pytest.approx(100 * (1 - busy / 2e-3))
    ops = 49085 * 4096 * 2
    least = max(ops / stats.PEAK_FP32_FLOPS,
                4 * 4096 * (49 + 37) / stats.PEAK_HBM_BYTES)
    assert read("substep_roofline") == pytest.approx(
        100 * 25 * least / 250e-6)
    assert read("capture_s") == 1.5
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "substep_flat"
    assert b["idle_gaps"][0][0] == "bench.tick"


def _synthetic_events(program_range: bool):
    """Profiler events of two 1 ms ticks (name, on the device, start, end):
    the harness's window and tick ranges on the host and their device
    sides, 5 substep launches and 20 op kernels a tick, and with
    ``program_range`` a range the program opens around its kernels."""
    ev = [("bench.window", False, 0, 2_000_000),
          ("bench.window", True, 0, 2_000_000)]
    t = 0
    for tick in range(2):
        ev += [("bench.tick", False, t, t + 50_000),
               ("bench.tick", True, t + 10_000, t + 900_000)]
        if program_range:
            ev += [("program.rollout", False, t + 1_000, t + 40_000),
                   ("program.rollout", True, t + 10_000, t + 990_000)]
        k = t + 20_000
        for _ in range(5):
            ev.append(("substep_flat", True, k, k + 40_000))
            k += 50_000
        for _ in range(20):
            ev.append(("void at::native::elementwise_kernel", True, k,
                       k + 3_000))
            k += 5_000
        ev.append(("Memcpy DtoH (Device -> Pinned)", True, k, k + 2_000))
        t += 1_000_000
    return ev


def test_a_program_range_is_not_device_work():
    """A ``record_function`` range the program opens shows on the device
    too; the readers count the same with it as without it."""
    plain = trace.reduce(_synthetic_events(False), 2)
    ranged = trace.reduce(_synthetic_events(True), 2)
    assert len(ranged.device) == len(plain.device) == 2 * 26
    assert ranged.busy_s() == plain.busy_s()
    assert {k for k, *_ in plain.device} == {"kernel", "memcpy"}
    ctx = lambda tr: types.SimpleNamespace(trace=tr, counters={}, facts=dict(
        robot="go1", world=1, collective_bytes_per_tick=0), setup={})
    for name in ("op_kernels_per_tick", "op_kernels_ms_per_tick",
                 "substep_ms_per_tick", "idle_pct"):
        read = spec.reader(name).read
        assert read(ctx(ranged)) == read(ctx(plain)), name
    assert spec.reader("op_kernels_per_tick").read(ctx(plain)) == 20
    assert spec.reader("idle_pct").read(ctx(plain)) == pytest.approx(
        100 * (1 - 2 * (5 * 40_000 + 20 * 3_000 + 2_000) / 2_000_000))
    assert trace.reduce([("bench.window", False, 0, 10)], 1) is None


@pytest.mark.gpu
def test_a_program_range_on_the_card_is_not_device_work():
    import contextlib
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")

    def work(ranged):
        with (torch.profiler.record_function("program.stage") if ranged
              else contextlib.nullcontext()):
            for _ in range(10):
                x.mul_(1.0001)
        torch.cuda.synchronize()

    trace.Profiler.warm_up(lambda: work(False))
    counts = {}
    for ranged in (False, True):
        p = trace.Profiler()
        p.start()
        work(ranged)
        counts[ranged] = len(p.stop(1).kernels(lambda name: True))
    assert counts[True] == counts[False] == 10, counts


def test_no_trace_reads_nothing():
    ctx = types.SimpleNamespace(trace=None, counters={}, facts=dict(
        robot="go1", world=1, collective_bytes_per_tick=0),
        setup={"capture_s": 1.0})
    for name in ("op_kernels_per_tick", "substep_roofline",
                 "idle_pct", "nccl_ms_per_tick", "collective_bytes_per_tick"):
        assert spec.reader(name).read(ctx) is None


def test_end_to_end_readers():
    w = dict(ticks=200, window_s=2.0, latencies=[0.01] * 190 + [0.02] * 10,
             setup_s=12.5)
    ctx = types.SimpleNamespace(window=w)
    assert spec.reader("solves_per_s").read(ctx) == 100.0
    assert spec.reader("tick_p95_ms").read(ctx) == pytest.approx(
        1e3 * stats.percentile(w["latencies"], 95))
    assert spec.reader("setup_s").read(ctx) == 12.5


def test_no_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not reachable")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "go1_trot_k256",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "go1_trot_k256",
         "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"
    assert math.isfinite(out["metrics"]["substep_roofline"]["value"])
