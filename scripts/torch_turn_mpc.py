#!/usr/bin/env python
"""MPC turn-while-trotting on the port: the counterpart of
scripts/turn_mpc.py.

``TrotCostParams.desired_yaw`` steers the Go1 trot toward a commanded
heading (45 degrees) while it tracks a diagonal velocity command; the
wrap-safe yaw error avoids the 2 pi cliff.  MPPI at K=256 x H=25 on the
substep kernel (K1) plans, and the kernel at K=1 is the plant, for 250
ticks of 50 Hz.  On the CPU the same engine runs the kernel's plain
version.  Run from the repository root:

    python3 scripts/torch_turn_mpc.py                # the card
    python3 scripts/torch_turn_mpc.py --device cpu --smoke

Writes ``metrics.json`` (the JAX script's keys, plus ``device``: the card's
name and power limit, or ``cpu``, and ``seconds``: host, the whole run)
under ``--out`` (default ``runs/torch_turn_mpc``, kept out of git);
``--gif`` also renders ``turn.gif`` (needs matplotlib and imageio).
"""
import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (mpc_tick, open_device,  # noqa: E402
                              run_ticks, write_metrics)

TICKS = 250
CONFIG = dict(horizon=25, num_samples=256, n_substeps=2, rollout_dt=0.01,
              noise_sigma=0.12, temperature=0.3, engine="kernel")
SMOKE = dict(CONFIG, horizon=3, num_samples=8, n_substeps=1)


def turn_params():
    from opendog_tpu_torch.solvers import costs
    return costs.TrotCostParams(desired_vel_xy=(0.25, 0.25),
                                target_height=0.265,
                                desired_yaw=math.pi / 4, w_heading=10.0,
                                w_yaw_rate=0.5)


def turn_cost(model):
    """The script's cost: the Go1 trot toward a 45-degree heading."""
    from opendog_tpu_torch.solvers import costs
    return costs.trot_cost(model, turn_params(), model.key_qpos[0, 7:],
                           legs="go1")


def run(model, ticks, config=CONFIG, generator=None, normals=None,
        graphs=None):
    """``ticks`` MPC ticks from the home keyframe: the plant's qpos after
    each, (ticks, nq).  ``normals`` (ticks, K, H, nu) injects every solve's
    draw; otherwise ``generator`` draws them.  On the card each tick
    replays one CUDA graph (``graphs=False``: eager, the same bits)."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import MPPIConfig, make_mpc
    cfg = MPPIConfig(**config)
    init, tick, _ = make_mpc(model, turn_cost(model), cfg,
                             plant_substeps=10, device=model.device)
    carry = init(generator, make_state(model, "home"))
    tick = mpc_tick(tick, carry, (cfg.num_samples, cfg.horizon, model.nu),
                    graphs)
    return run_ticks(tick, carry, ticks, normals)[1]["qpos"]


def summarize(q, ticks):
    """The JAX script's record of a (ticks, nq) qpos trajectory."""
    import torch
    from opendog_tpu_torch.physics import spatial

    def euler(qq):
        return [float(v) for v in spatial.euler_from_quat(
            torch.from_numpy(np.asarray(qq[3:7], np.float32)))]

    q = np.asarray(q)
    yaw = np.array([euler(qq)[2] for qq in q[::25]])
    final = q[-1]
    r, pch, y = euler(final)
    return dict(ticks=ticks, yaw_target_deg=45.0,
                final_yaw_deg=round(float(np.degrees(y)), 1),
                yaw_traj_deg=[round(float(np.degrees(v)), 1) for v in yaw],
                final_xy=[round(float(final[0]), 2),
                          round(float(final[1]), 2)],
                trunk_z=round(float(final[2]), 3),
                upright=bool(abs(r) < 0.3 and abs(pch) < 0.3),
                all_finite=bool(np.isfinite(q).all()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/torch_turn_mpc")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="1 tick at K=8, H=3: the pipeline, no claim")
    ap.add_argument("--gif", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from opendog_tpu_torch.assets import load_go1

    start = time.perf_counter()
    dev, line = open_device(args.device)
    m = load_go1("flat", device=dev)
    ticks = 1 if args.smoke else TICKS
    q = run(m, ticks, SMOKE if args.smoke else CONFIG,
            torch.Generator(device=dev).manual_seed(0)).cpu().numpy()
    res = summarize(q, ticks)
    res.update(device=line, seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, "metrics.json"), res)
    if args.gif:
        from opendog_tpu_torch.physics import State
        from opendog_tpu_torch.utils.render import record_rollout
        qq = torch.from_numpy(q[::4])
        record_rollout(m.to("cpu"), State(
            qpos=qq, qvel=torch.zeros(qq.shape[0], m.nv),
            time=torch.zeros(qq.shape[0])),
            os.path.join(args.out, "turn.gif"), fps=12, plane="xz")


if __name__ == "__main__":
    main()
