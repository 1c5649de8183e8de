#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: MPC solves per second on one
card and the host-blocking time of a 50 Hz control loop, for the Go1
12-DoF trot (the counterpart of bench.py's ``main``).

The configuration is bench.py's (BASELINE.json config 2): Go1 flat,
``trot_cost(..., legs="go1")`` at 0.5 m/s and 0.265 m, MPPI with K=256
rollouts over H=25 steps of 2 x 10 ms substeps (0.5 s), sigma 0.12,
temperature 0.3, on the substep kernel (K1); the plant integrates 10
substeps of 2 ms per 50 Hz tick.  Phases:

  (a) the host loop: a blocking reference of 50 ticks (the tick replayed
      from its CUDA graph, then a blocking copy of the control), whose
      median sets the controller's pipeline depth (``lag_for``); then
      ``RealtimeController`` at that lag, primed for lag + 3 ticks at pace,
      and 250 ticks paced at 20 ms: the host-blocking time of each;
  (b) solve throughput: 100 replayed ticks of warm-up, then 5 x 100 timed,
      ``torch.cuda.synchronize()`` before each clock read.

On the card every tick replays one CUDA graph; there is no fallback: with
no card (and no ``--device cpu``) or a failed phase the run exits non-zero.
On the CPU (``--device cpu``) the kernel's plain version runs eagerly.  Run
from the repository root:

    python3 bench_torch.py                 # the card
    python3 bench_torch.py --device cpu    # the CPU (tens of minutes)

Progress goes to stderr; the record is one JSON line, the last of stdout
(``device``: the card's name and power limit, or ``cpu``).
"""
import argparse
import json
import math
import sys
import time

import numpy as np

TICK_S = 0.02          # the 50 Hz tick
SYNC_TICKS = 50        # blocking reference ticks (bench.py's n2)
PACED_TICKS = 250      # paced host-loop ticks (bench.py's n)
SOLVE_TICKS = 100      # ticks per timed run (bench.py's run(c, 100))
SOLVE_REPS = 5


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def sync(dev):
    """Waits for the card before a clock read; nothing on the CPU."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trot_setup(model, num_samples=256, horizon=25):
    """bench.py's cost and MPPIConfig on ``model`` (Go1): the trot at 0.5
    m/s and 0.265 m, ``num_samples`` rollouts over ``horizon`` steps of 2 x
    10 ms, sigma 0.12, temperature 0.3, the kernel engine."""
    from opendog_tpu_torch.solvers import MPPIConfig, costs
    params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265)
    cost = costs.trot_cost(model, params, model.key_qpos[0, 7:], legs="go1")
    cfg = MPPIConfig(horizon=horizon, num_samples=num_samples, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.12, temperature=0.3,
                     engine="kernel")
    return cost, cfg


def lag_for(median_ms, tick_s=TICK_S):
    """The controller's pipeline depth from the blocking reference's median
    tick (bench.py:127): ceil(median / tick) + 1 ticks, within [1, 5]."""
    return int(min(5, max(1, math.ceil(median_ms / (tick_s * 1e3)) + 1)))


def blocking_reference(tick, carry, n):
    """``n`` ticks, each the dispatch plus a blocking copy of its control to
    the host: (carry, host seconds per tick)."""
    lat = np.zeros(n)
    for i in range(n):
        t0 = time.perf_counter()
        carry, out = tick(carry)
        out["ctrl"].cpu()
        lat[i] = time.perf_counter() - t0
    return carry, lat


def prime(rtc, state, lag, tick_s=TICK_S):
    """Starts ``rtc`` from ``state`` (on the card: the capture of its tick),
    one tick to warm it, then lag + 3 ticks at pace to fill the pipeline.
    Returns the seconds ``start`` took."""
    t0 = time.perf_counter()
    rtc.start(state)
    sync(rtc.device)
    start_s = time.perf_counter() - t0
    rtc.tick()
    for _ in range(lag + 3):
        time.sleep(tick_s)
        rtc.tick()
    return start_s


def paced_loop(rtc, n, tick_s=TICK_S):
    """``n`` calls of ``rtc.tick()`` paced at ``tick_s``: the host-blocking
    seconds of each, the controls (n, nu) and the ticks that overran."""
    lat = np.zeros(n)
    ctrls, overruns = [], 0
    next_t = time.perf_counter()
    for i in range(n):
        next_t += tick_s
        t0 = time.perf_counter()
        ctrls.append(rtc.tick())
        lat[i] = time.perf_counter() - t0
        rest = next_t - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        else:
            overruns += 1
            next_t = time.perf_counter()
    return lat, np.array(ctrls), overruns


def loop_fields(lat, overruns, lag, tick_s=TICK_S):
    """bench.py's host-loop fields of a paced loop's blocking times [s]."""
    p99 = float(np.percentile(lat, 99) * 1e3)
    return {
        "host_loop_p99_latency_ms": p99,
        "host_loop_median_latency_ms": float(np.median(lat) * 1e3),
        "host_loop_max_latency_ms": float(lat.max() * 1e3),
        "host_loop_mean_latency_ms": float(lat.mean() * 1e3),
        "host_loop_meets_50hz_budget": bool(p99 < tick_s * 1e3),
        "host_loop_control_delay_ticks": lag,
        "host_loop_overruns": overruns,
    }


def solve_throughput(tick, carry, ticks, reps):
    """``ticks`` ticks of warm-up, then ``reps`` x ``ticks`` timed: (solves
    per second, the last carry)."""
    dev = carry.plant.qpos.device
    for _ in range(ticks):
        carry, _ = tick(carry)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps * ticks):
        carry, _ = tick(carry)
    sync(dev)
    return reps * ticks / (time.perf_counter() - t0), carry


def run(dev, num_samples=256, horizon=25, sync_ticks=SYNC_TICKS,
        paced_ticks=PACED_TICKS, solve_ticks=SOLVE_TICKS, reps=SOLVE_REPS):
    """The benchmark on ``dev``: its record, without ``device``."""
    import torch
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import (RealtimeController, graph_tick,
                                           make_mpc)
    model = load_go1("flat", device=dev)
    cost, cfg = trot_setup(model, num_samples, horizon)
    init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10, device=dev)
    carry = init(torch.Generator(device=dev).manual_seed(0),
                 make_state(model, "home"))
    t0 = time.perf_counter()
    if dev.type == "cuda":
        tick = graph_tick(tick, carry, torch.zeros(
            (cfg.num_samples, cfg.horizon, model.nu), device=dev))
    sync(dev)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry, _ = tick(carry)
    sync(dev)
    first_exec_s = time.perf_counter() - t0
    log(f"tick captured in {capture_s:.3f} s, first replay "
        f"{first_exec_s:.3f} s")

    # (a) the host loop at the 50 Hz budget
    carry, lat_sync = blocking_reference(tick, carry, sync_ticks)
    sync_median_ms = float(np.median(lat_sync) * 1e3)
    lag = lag_for(sync_median_ms)
    log(f"blocking tick median {sync_median_ms:.3f} ms -> lag {lag}")
    rtc = RealtimeController(model, cost, cfg, lag=lag, plant_substeps=10,
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(0))
    start_s = prime(rtc, make_state(model, "home"), lag)
    log(f"controller started in {start_s:.3f} s; running the paced loop")
    lat, ctrls, overruns = paced_loop(rtc, paced_ticks)
    rtc.drain()
    if not (ctrls.shape == (paced_ticks, model.nu)
            and np.isfinite(ctrls).all()):
        raise RuntimeError("the paced loop returned a control that is not "
                           f"finite or of shape ({model.nu},)")
    fields = loop_fields(lat, overruns, lag)
    log(f"host loop done: p99 {fields['host_loop_p99_latency_ms']:.3f} ms")

    # (b) solve throughput, the tick replayed back to back
    solves_per_sec, carry = solve_throughput(tick, carry, solve_ticks, reps)
    qpos = carry.plant.qpos.cpu().numpy()
    if not np.isfinite(qpos).all():
        raise RuntimeError("the plant state is not finite")
    log(f"{solves_per_sec:.2f} solves/s")
    return {
        "metric": "mpc_solves_per_sec_per_gpu",
        "value": round(float(solves_per_sec), 2),
        "unit": "solves/s/gpu",
        "vs_baseline": round(float(solves_per_sec) / 50.0, 3),
        **fields,
        "host_loop_sync_p99_ms": float(np.percentile(lat_sync, 99) * 1e3),
        "sync_tick_median_ms": sync_median_ms,
        "on_device_solve_ms": 1e3 / float(solves_per_sec),
        "rollouts_per_tick": cfg.num_samples,
        "horizon_s": cfg.horizon * cfg.n_substeps * cfg.rollout_dt,
        "capture_s": capture_s,
        "first_exec_s": first_exec_s,
        "controller_start_s": start_s,
        "plant_healthy": bool(0.12 < qpos[2] < 0.5),
        "final_x": round(float(qpos[0]), 3),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    from opendog_tpu_torch.device import card_line, resolve_device
    from opendog_tpu_torch.device import use_full_fp32
    start = time.perf_counter()
    dev = resolve_device(args.device)
    use_full_fp32()
    line = card_line() if dev.type == "cuda" else "cpu"
    log(f"device {dev}: {line}")
    result = run(dev)
    result.update(device=line, seconds=time.perf_counter() - start)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
