#!/usr/bin/env python
"""OpenDOG trot-MPC sweep on the port: the counterpart of
scripts/opendog_walk_sweep.py.

The gait reference is recentred away from the home keyframe (whose thigh,
2.356 rad, sits at the bottom edge of the thigh ctrlrange [2.36, 2.8]); for
each gait centre the stance height is found by settling the plant on the
centre pose, and the sweep varies amplitude, period, knee lift, noise and
velocity target, measuring each configuration's plant distance over
``--ticks`` 50 Hz ticks.  MPPI at K=256 runs on the substep kernel (K1) and
the plant is the kernel at K=1; on the card every tick replays one CUDA
graph, captured once per configuration.  Run from the repository root:

    python3 scripts/torch_opendog_walk_sweep.py [--full | --refine]
    python3 scripts/torch_opendog_walk_sweep.py --device cpu --smoke --ticks 2

Writes the JAX script's summary (plus ``seconds``; ``device`` is the
card's name and power limit, or ``cpu``) to ``--out`` (default
``runs/torch_opendog_sweep/metrics.json``, kept out of git).
"""
import argparse
import itertools
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (hold_ctrl, mpc_tick, open_device,  # noqa
                              run_ticks, write_metrics)

GRIDS = {
    "smoke": dict(thigh_center=[2.58], thigh_amp=[0.20],
                  knee_center=[-1.5], knee_lift=[0.25],
                  period_s=[0.4], noise_sigma=[0.10],
                  vx=[0.15], w_gait=[8.0]),
    "full": dict(thigh_center=[2.50, 2.58, 2.66],
                 thigh_amp=[0.14, 0.20, 0.22],
                 knee_center=[-1.55, -1.45],
                 knee_lift=[0.2, 0.3],
                 period_s=[0.3, 0.4, 0.5],
                 noise_sigma=[0.08, 0.12],
                 vx=[0.12, 0.18],
                 w_gait=[8.0, 16.0]),
    # around the CPU ranking's winner (amp .2 > .14, lift .2 > .3, period
    # .4 > .3, vx .18 > .12): each winning direction pushed further
    "refine": dict(thigh_center=[2.58],
                   thigh_amp=[0.20, 0.22],
                   knee_center=[-1.5],
                   knee_lift=[0.12, 0.2],
                   period_s=[0.4, 0.5],
                   noise_sigma=[0.10],
                   vx=[0.18, 0.28],
                   w_gait=[8.0]),
    "default": dict(thigh_center=[2.58],
                    thigh_amp=[0.14, 0.20],
                    knee_center=[-1.5],
                    knee_lift=[0.2, 0.3],
                    period_s=[0.3, 0.4],
                    noise_sigma=[0.10],
                    vx=[0.12, 0.18],
                    w_gait=[8.0]),
}


def combos(grid):
    keys = list(grid)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


def stance_height(model, thigh_center, knee_center, ticks=50):
    """The trunk height after ``ticks`` ticks (10 substeps each) of the
    op-graph plant holding the gait centre's pose from home."""
    import torch
    from opendog_tpu_torch.physics import dynamics, make_state
    idx = model.numpy("actuator_qposadr").astype(np.int64) - 7
    cj = np.zeros(8, np.float32)
    cj[np.array([0, 2, 4, 6])] = thigh_center
    cj[np.array([1, 3, 5, 7])] = knee_center
    center = torch.from_numpy(cj[idx]).to(model.device)
    s = make_state(model, "home")
    for _ in range(ticks):
        s, _ = dynamics.step(model, s, center, None, n_substeps=10)
    return float(s.qpos[2])


def run_config(g, z_stance, ticks, samples, device, normals=None,
               graphs=None, smoke=False):
    """One configuration's run: the plant's qpos (ticks, nq), numpy, from
    home settled for 30 ticks under the clipped home control.  ``smoke``
    cuts the planner to H=3 and one substep and the settling to 3 ticks."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics, make_state
    from opendog_tpu_torch.rl.distill_zoo import trot_distill_setup
    from opendog_tpu_torch.solvers import make_mpc
    setup = trot_distill_setup(
        "opendog", engine="kernel", device=device,
        pc_overrides=dict(
            desired_vel_xy=(g["vx"], 0.0), target_height=z_stance,
            thigh_amp=g["thigh_amp"], knee_lift=g["knee_lift"],
            period_s=g["period_s"], w_gait=g["w_gait"]),
        gait_center=(g["thigh_center"], g["knee_center"]))
    cfg = replace(setup.mppi_config, num_samples=samples,
                  noise_sigma=g["noise_sigma"],
                  **(dict(horizon=3, n_substeps=1) if smoke else {}))
    m = setup.model
    init, tick, _ = make_mpc(m, setup.cost, cfg, plant_substeps=10,
                             device=device)
    s = make_state(m, "home")
    hold = hold_ctrl(m)
    for _ in range(3 if smoke else 30):
        s, _ = dynamics.step(m, s, hold, None, n_substeps=10)
    s = State(qpos=s.qpos, qvel=s.qvel, time=torch.zeros_like(s.time))
    carry = init(torch.Generator(device=device).manual_seed(0), s)
    tick = mpc_tick(tick, carry, (cfg.num_samples, cfg.horizon, m.nu),
                    graphs)
    return run_ticks(tick, carry, ticks, normals)[1]["qpos"].cpu().numpy()


def config_record(g, qpos, z_stance, wall):
    """The JAX script's record of one configuration's run."""
    z = qpos[:, 2]
    fell = bool((z < 0.03).any() or (z > 0.15).any()
                or not np.isfinite(qpos).all())
    return dict(g, final_x=round(float(qpos[-1, 0]), 4),
                z_stance=round(z_stance, 4), fell=fell,
                wall_s=round(wall, 1))


def summarize(results, ticks, n_configs, device):
    """The JAX script's summary of the configurations' records."""
    ok = [r for r in results if not r["fell"]]
    best = max(ok or results, key=lambda r: r["final_x"])
    return dict(
        metric="opendog_walk_sweep", engine="kernel", ticks=ticks,
        configs=n_configs, best=best,
        best_final_x=best["final_x"],
        projected_x_per_10s=round(best["final_x"] * (500 / ticks), 3),
        # the milestone: an upright configuration covering >= 1 m in 10 s
        # of sim time (500 ticks at 50 Hz), normalised when --ticks differs
        walks_1m_in_10s=bool(ok and ticks >= 500
                             and max(r["final_x"] * (500 / ticks)
                                     for r in ok) >= 1.0),
        results=results, device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--out", default="runs/torch_opendog_sweep/metrics.json")
    ap.add_argument("--smoke", action="store_true",
                    help="one configuration, 30 ticks, the planner at H=3 "
                         "and one substep, the stance and the start settled "
                         "for 5 and 3 ticks: the pipeline, no claim")
    ap.add_argument("--full", action="store_true",
                    help="wider grid (864 configurations)")
    ap.add_argument("--refine", action="store_true",
                    help="narrow grid around the CPU ranking's winner")
    ap.add_argument("--samples", type=int, default=None,
                    help="MPPI rollouts per tick (default 256; 64 with "
                         "--smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from opendog_tpu_torch.assets import load_opendog

    start = time.perf_counter()
    dev, line = open_device(args.device)
    ticks = 30 if args.smoke and args.ticks == 500 else args.ticks
    grid = GRIDS["smoke" if args.smoke else "full" if args.full
                 else "refine" if args.refine else "default"]
    todo = combos(grid)
    print(f"[opendog_sweep] {len(todo)} configs x {ticks} ticks",
          file=sys.stderr, flush=True)
    m = load_opendog("flat", device=dev)
    settle_cache, results = {}, []
    for ci, g in enumerate(todo):
        ck = (g["thigh_center"], g["knee_center"])
        if ck not in settle_cache:
            settle_cache[ck] = stance_height(m, *ck,
                                             5 if args.smoke else 50)
        t0 = time.perf_counter()
        qpos = run_config(g, settle_cache[ck], ticks, args.samples
                          or (64 if args.smoke else 256), dev,
                          smoke=args.smoke)
        rec = config_record(g, qpos, settle_cache[ck],
                            time.perf_counter() - t0)
        results.append(rec)
        print(f"[opendog_sweep] [{ci + 1}/{len(todo)}] {json.dumps(rec)}",
              file=sys.stderr, flush=True)
    summary = summarize(results, ticks, len(todo), line)
    summary["seconds"] = time.perf_counter() - start
    write_metrics(args.out, summary)


if __name__ == "__main__":
    main()
