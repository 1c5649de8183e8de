"""bench_torch.py, the port's counterpart of bench.py's ``main``: the
pipeline depth against bench.py's formula, the record of a short run on
the CPU (bench.py's fields where they apply, none of its XLA-cache or
tunnel fields), and no run without a card unless the CPU is asked for: no
fallback, in particular not bench.py's to BENCH_VALIDATED.json."""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {
    "metric", "value", "unit", "vs_baseline", "host_loop_p99_latency_ms",
    "host_loop_median_latency_ms", "host_loop_max_latency_ms",
    "host_loop_mean_latency_ms", "host_loop_meets_50hz_budget",
    "host_loop_control_delay_ticks", "host_loop_overruns",
    "host_loop_sync_p99_ms", "sync_tick_median_ms", "on_device_solve_ms",
    "rollouts_per_tick", "horizon_s", "capture_s", "first_exec_s",
    "controller_start_s", "plant_healthy", "final_x"}


@pytest.mark.parametrize("median_ms", [5.0, 20.0, 45.0, 200.0])
def test_lag_for_matches_bench_formula(median_ms):
    """bench.py:127: min(5, max(1, ceil(rtt / 20 ms) + 1))."""
    tick_s = 0.02
    want = int(min(5, max(1, np.ceil(median_ms / (tick_s * 1e3)) + 1)))
    assert bench_torch.lag_for(median_ms) == want
    assert want == min(5, max(1, math.ceil(median_ms / 20.0) + 1))


def test_bench_record_on_cpu(monkeypatch):
    """The whole benchmark on the CPU at K=16, H=4 (the plain kernel, eager
    ticks) with 2 blocking, 2 paced and 2 timed ticks, the pipeline held at
    one tick (the CPU's ~2 s tick would give lag 5 and eight priming
    ticks): bench.py's keys that apply, with the metric per GPU, and no
    XLA, cache, tunnel or degraded-mode key."""
    monkeypatch.setattr(bench_torch, "lag_for", lambda median_ms: 1)
    rec = bench_torch.run(torch.device("cpu"), num_samples=16, horizon=4,
                          sync_ticks=2, paced_ticks=2, solve_ticks=1, reps=1)
    assert set(rec) == FIELDS
    assert rec["metric"] == "mpc_solves_per_sec_per_gpu"
    assert rec["unit"] == "solves/s/gpu"
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 50.0, abs=1e-3)
    assert rec["rollouts_per_tick"] == 16
    assert rec["horizon_s"] == pytest.approx(4 * 2 * 0.01)
    assert rec["host_loop_control_delay_ticks"] == 1
    assert rec["host_loop_overruns"] == 2  # a CPU tick is past 20 ms
    assert not rec["host_loop_meets_50hz_budget"]
    assert rec["plant_healthy"]
    assert all(np.isfinite(v) for v in rec.values()
               if isinstance(v, float))
    for word in ("xla", "cache", "tunnel", "lower", "compile", "live",
                 "degraded"):
        assert not any(word in k for k in rec), word


def test_no_card_exits_nonzero_and_never_reads_the_validated_record(
        tmp_path):
    """With ``torch.cuda.is_available`` False and no ``--device cpu``,
    bench_torch.py exits non-zero without opening any file named
    BENCH_VALIDATED.json, and its source names no such fallback."""
    marker = tmp_path / "opened"
    code = f"""
import builtins, runpy, sys, torch
torch.cuda.is_available = lambda: False
real_open = builtins.open
def guarded(file, *a, **k):
    if "BENCH_VALIDATED" in str(file):
        real_open({str(marker)!r}, "w").close()
    return real_open(file, *a, **k)
builtins.open = guarded
sys.argv = ["bench_torch.py"]
runpy.run_path("bench_torch.py", run_name="__main__")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not r.stdout.strip()
    assert not marker.exists()
    with open(os.path.join(REPO, "bench_torch.py")) as f:
        assert "BENCH_VALIDATED" not in f.read()
