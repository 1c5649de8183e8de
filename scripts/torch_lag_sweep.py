#!/usr/bin/env python
"""The price of pipelining lag on the port: the counterpart of
scripts/lag_sweep.py.

bench.py's host loop runs ``lag=3`` ticks deep (it acts on a plan three
ticks old, 60 ms of control delay).  This script measures that price: the
bench-config Go1 trot MPC (K=256, a 0.5 s horizon, the substep kernel K1
for the rollouts and the plant) runs ``--ticks`` 50 Hz ticks at each lag,
the plant applying the solve of ``lag`` ticks ago
(``make_mpc(ctrl_lag=...)``, the RealtimeController's pipeline), with
``--compensate`` solving from the state predicted through the queued
controls.  Per lag: distance covered, velocity-tracking error, falls over
the seeds, mean solve cost and solves per second (a second run, timed).

Run from the repository root:

    python3 scripts/torch_lag_sweep.py [--compensate]      # the card
    python3 scripts/torch_lag_sweep.py --device cpu --smoke --ticks 2

Writes the JAX script's summary (plus ``seconds``; ``device`` is the
card's name and power limit, or ``cpu``) to ``--out`` (default
``runs/torch_lag_sweep/metrics.json``, or ``metrics_compensated.json``
with ``--compensate``, kept out of git).  On the card every tick replays
one CUDA graph, captured once per lag.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (mpc_tick, open_device,  # noqa: E402
                              run_ticks, write_metrics)

CONFIG = dict(horizon=25, num_samples=256, n_substeps=2, rollout_dt=0.01,
              noise_sigma=0.12, temperature=0.3, engine="kernel")
SMOKE = dict(CONFIG, horizon=3, num_samples=8, n_substeps=1)
KEYS = ("qpos", "qvel", "mean_cost")


def lag_params():
    from opendog_tpu_torch.solvers import costs
    return costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                target_height=0.265)


def lag_cost(model):
    from opendog_tpu_torch.solvers import costs
    return costs.trot_cost(model, lag_params(), model.key_qpos[0, 7:],
                           legs="go1")


def make_lag_mpc(model, config, lag, compensate):
    """(init, tick) of the bench-config MPC at ``lag``."""
    from opendog_tpu_torch.solvers import MPPIConfig, make_mpc
    init, tick, _ = make_mpc(model, lag_cost(model), MPPIConfig(**config),
                             plant_substeps=10, ctrl_lag=lag,
                             lag_compensation=compensate,
                             device=model.device)
    return init, tick


def run(model, config, lag, compensate, ticks, seed, normals=None,
        graphs=None, built=None):
    """One seed's run at ``lag``: numpy qpos (ticks, nq), qvel and
    mean_cost (ticks,), and ``built``, the MPC's (init, tick): pass it back
    to reuse the tick and its graph.  ``normals`` (ticks, K, H, nu) injects
    every solve's draw; otherwise a generator seeded with ``seed`` on the
    device draws them."""
    import torch
    from opendog_tpu_torch.physics import make_state
    init, tick = built or make_lag_mpc(model, config, lag, compensate)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    carry = init(gen, make_state(model, "home"))
    if built is None:
        tick = mpc_tick(tick, carry, (config["num_samples"],
                                      config["horizon"], model.nu), graphs)
    _, traj = run_ticks(tick, carry, ticks, normals, KEYS)
    return {k: v.cpu().numpy() for k, v in traj.items()}, (init, tick)


def lag_record(lag, ticks, trajs, t_solve, desired_vx):
    """The JAX script's per-lag record of the seeds' trajectories
    (``trajs``: dicts of numpy qpos, qvel, mean_cost)."""
    finals, vel_errs, costs_mean, falls = [], [], [], 0
    for tr in trajs:
        qpos, qvel = tr["qpos"], tr["qvel"]
        z = qpos[:, 2]
        falls += bool((z < 0.12).any() or (z > 0.5).any())
        finals.append(float(qpos[-1, 0]))
        vel_errs.append(float(np.sqrt(np.mean(
            (qvel[:, 0] - desired_vx) ** 2))))
        costs_mean.append(float(np.asarray(tr["mean_cost"]).mean()))
    return {
        "lag": lag,
        "ticks": ticks,
        "seeds": len(trajs),
        "final_x_mean": round(float(np.mean(finals)), 3),
        "final_x_min": round(float(np.min(finals)), 3),
        "vx_rmse": round(float(np.mean(vel_errs)), 4),
        "mean_cost": round(float(np.mean(costs_mean)), 2),
        "fall_rate": round(falls / len(trajs), 3),
        "solves_per_sec": round(1.0 / t_solve, 1) if t_solve else None,
    }


def summarize(results, engine, device, compensated):
    """The JAX script's summary of the per-lag records."""
    base = next((r for r in results if r["lag"] == 0), results[0])
    x3 = next((r["final_x_mean"] for r in results if r["lag"] == 3), None)
    return {
        "metric": "lag_sweep",
        "engine": engine,
        "device": device,
        "compensated": bool(compensated),
        "results": results,
        "final_x_lag3_vs_lag0": (
            round(x3 / max(1e-9, base["final_x_mean"]), 3)
            if x3 is not None else None),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--lags", type=int, nargs="+", default=[0, 1, 2, 3, 5])
    p.add_argument("--out", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny config for CPU plumbing tests (K=8, H=3, one "
                        "substep)")
    p.add_argument("--compensate", action="store_true",
                   help="delay compensation: solve from the state predicted "
                        "through the queued controls")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    import torch
    from opendog_tpu_torch.assets import load_go1

    start = time.perf_counter()
    dev, line = open_device(args.device)
    model = load_go1("flat", device=dev)
    cfg = SMOKE if args.smoke else CONFIG
    desired_vx = lag_params().desired_vel_xy[0]
    results = []
    for lag in args.lags:
        trajs, t_solve, built = [], None, None
        for seed in range(args.seeds):
            tr, built = run(model, cfg, lag, args.compensate, args.ticks,
                            seed, built=built)
            trajs.append(tr)
            if seed == 0:
                # a second run, timed, once the first has built the tick
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(model, cfg, lag, args.compensate, args.ticks, 99,
                    built=built)
                t_solve = (time.perf_counter() - t0) / args.ticks
        rec = lag_record(lag, args.ticks, trajs, t_solve, desired_vx)
        print(f"[lag_sweep] {json.dumps(rec)}", file=sys.stderr, flush=True)
        results.append(rec)
    summary = summarize(results, "kernel", line, args.compensate)
    summary["seconds"] = time.perf_counter() - start
    name = "metrics_compensated.json" if args.compensate else "metrics.json"
    write_metrics(args.out or os.path.join("runs", "torch_lag_sweep", name),
                  summary)


if __name__ == "__main__":
    main()
