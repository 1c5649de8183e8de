#!/usr/bin/env python
"""Contact-scheduled whole-body iLQR on the port (BASELINE config 3): the
counterpart of scripts/ilqr_gait.py.

Arms:
  trot     the Go1 trots under the 1 Hz-replan / 50 Hz-track iLQR cycle
           (``make_ilqr_tracker``) with a two-slot alternating-diagonal
           contact schedule (``costs.trot_schedule``);
  landing  the Go1 drops from the ``descent`` keyframe (z = 0.6) onto flat
           ground under a front-then-back landing schedule
           (``costs.landing_schedule``); the executed controls are replayed
           through the plant to time each paw's touchdown.

The solves and the plant run the op-graph step in full float32; on the card
each piece of the solve and the tracked tick replay CUDA graphs (the
tracker's default there).  Run from the repository root:

    python3 scripts/torch_ilqr_gait.py                 # the card
    python3 scripts/torch_ilqr_gait.py --device cpu --smoke

``--smoke`` cuts the horizons to 3 stages, one iteration and 3 tracked
ticks, and the trot to 2 cycles: the pipeline, no claim.  Writes
``metrics.json`` (the JAX script's keys, plus ``device``: the card's name
and power limit, or ``cpu``, and ``seconds``) under ``--out`` (default
``runs/torch_ilqr_gait``, kept out of git).
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import open_device, write_metrics  # noqa: E402

TROT = dict(horizon=25, n_substeps=2, rollout_dt=0.01, iterations=6)
LANDING = dict(horizon=40, n_substeps=2, rollout_dt=0.01, iterations=5)
SMOKE = dict(horizon=3, n_substeps=2, rollout_dt=0.01, iterations=1)
FOOT_NAMES = ("FR", "FL", "RR", "RL")


def trot_arm_cost(model):
    """The trot arm's cost: the trot schedule at 0.5 m/s."""
    from opendog_tpu_torch.solvers import costs
    pc = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0), target_height=0.265)
    return costs.contact_schedule_cost(
        model, costs.trot_schedule(pc, legs="go1"), pc,
        model.key_qpos[0, 7:], legs="go1")


def landing_arm_cost(model):
    """The landing arm's cost: ordered touchdown, then upright recovery."""
    from opendog_tpu_torch.solvers import costs
    pc = costs.TrotCostParams(desired_vel_xy=(0.0, 0.0), target_height=0.265,
                              knee_lift=0.5, w_gait=20.0, w_height=40.0,
                              w_upright=60.0)
    return costs.contact_schedule_cost(
        model, costs.landing_schedule(slot_dt=0.25), pc,
        model.key_qpos[0, 7:], legs="go1", w_stance_vel=0.1)


def tracker(model, cost, cfg, graphs=None):
    from opendog_tpu_torch.solvers import ILQRConfig, make_ilqr_tracker
    return make_ilqr_tracker(model, cost, ILQRConfig(**cfg),
                             track_ticks=cfg["horizon"], plant_substeps=10,
                             device=model.device, graphs=graphs)


def plan0(model, horizon):
    return model.key_ctrl[0][None].repeat(horizon, 1)


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def trot_arm(model, cycles, cfg=TROT, graphs=None):
    """``cycles`` replan + track cycles from the home stand settled for 200
    substeps: the JAX script's trot record."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics, make_state
    cycle = tracker(model, trot_arm_cost(model), cfg, graphs)
    s, _ = dynamics.step(model, make_state(model, "home"), model.key_ctrl[0],
                         None, n_substeps=200)
    s = State(qpos=s.qpos, qvel=s.qvel, time=torch.zeros((),
                                                         device=model.device))
    U = plan0(model, cfg["horizon"])
    t0 = time.perf_counter()
    plant, U, _ = cycle(s, U)
    sync(model.device)
    compile_s = time.perf_counter() - t0
    x_start = float(plant.qpos[0])
    zs = [float(plant.qpos[2])]
    t0 = time.perf_counter()
    for _ in range(cycles - 1):
        plant, U, _ = cycle(plant, U)
        zs.append(float(plant.qpos[2]))
    wall = time.perf_counter() - t0
    tracked_s = cfg["horizon"] * 10 * float(model.timestep)
    return trot_record(plant.qpos.cpu().numpy(), x_start, zs, cycles, wall,
                       compile_s, tracked_s)


def trot_record(q, x_start, zs, cycles, wall, compile_s, tracked_s=0.5):
    """The JAX script's trot record (``tracked_s``: the plant seconds of a
    cycle, 25 ticks of 20 ms)."""
    dist = float(q[0]) - x_start
    sim_s = tracked_s * (cycles - 1)
    per = wall / (cycles - 1)
    return dict(
        cycles=cycles,
        final_x=round(float(q[0]), 3),
        distance_m=round(dist, 3),
        sim_seconds=round(sim_s, 2),
        mean_speed_mps=round(dist / sim_s, 3),
        trunk_z_band=[round(min(zs), 3), round(max(zs), 3)],
        healthy=bool(all(0.15 < z < 0.4 for z in zs)),
        locomotes=bool(dist > 0.15),
        cycle_seconds=round(per, 3),
        realtime_factor=round(tracked_s / per, 2),
        compile_s=round(compile_s, 1),
    )


def landing_cycles(model, cfg=LANDING, graphs=None):
    """The landing arm's two cycles from ``descent``: (the final plant
    state, the compile-and-first-cycle seconds, the executed controls
    (T, nu) and the tracked qpos (T, nq) of both cycles)."""
    import torch
    from opendog_tpu_torch.physics import make_state
    cycle = tracker(model, landing_arm_cost(model), cfg, graphs)
    U = plan0(model, cfg["horizon"])
    t0 = time.perf_counter()
    plant, U, traj1 = cycle(make_state(model, "descent"), U)
    sync(model.device)
    compile_s = time.perf_counter() - t0
    plant, U, traj2 = cycle(plant, U)
    return (plant, compile_s, torch.cat([traj1["ctrl"], traj2["ctrl"]]),
            torch.cat([traj1["qpos"], traj2["qpos"]]))


def landing_arm(model, cfg=LANDING, graphs=None):
    """Two cycles from ``descent``, then the executed controls replayed
    through the plant: the JAX script's landing record."""
    import torch
    from opendog_tpu_torch.physics import dynamics, make_state
    plant, compile_s, ctrls, _ = landing_cycles(model, cfg, graphs)
    st, zs, ics = make_state(model, "descent"), [], []
    for c in ctrls:
        st, info = dynamics.step(model, st, c, None, n_substeps=10)
        zs.append(st.qpos[2])
        ics.append(dynamics.foot_contact_summary(model, info.contact)[2])
    return landing_record(plant.qpos.cpu().numpy(),
                          torch.stack(zs).cpu().numpy(),
                          torch.stack(ics).cpu().numpy(), compile_s)


def landing_record(q, zs, ics, compile_s):
    """The JAX script's landing record: the final state ``q``, the replayed
    trunk heights ``zs`` (T,) and paw contacts ``ics`` (T, 4)."""
    import torch
    from opendog_tpu_torch.physics import spatial
    touch = [float(np.argmax(ics[:, f]) * 0.02) if ics[:, f].any() else None
             for f in range(4)]
    front = [t for t in touch[:2] if t is not None]
    rear = [t for t in touch[2:] if t is not None]
    roll, pitch, _ = (float(v) for v in spatial.euler_from_quat(
        torch.from_numpy(np.asarray(q[3:7], np.float32))))
    return dict(
        drop_height_m=0.6,
        final_z=round(float(q[2]), 3),
        min_z=round(float(zs.min()), 3),
        final_roll_pitch=[round(roll, 3), round(pitch, 3)],
        upright=bool(abs(roll) < 0.3 and abs(pitch) < 0.3
                     and 0.2 < q[2] < 0.35),
        touchdown_s=dict(zip(FOOT_NAMES, touch)),
        front_before_rear=bool(
            front and rear and max(front) <= min(rear)
            and min(rear) > min(front)),
        compile_s=round(compile_s, 1),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="*", default=["trot", "landing"])
    ap.add_argument("--trot_cycles", type=int, default=6)
    ap.add_argument("--out", default="runs/torch_ilqr_gait")
    ap.add_argument("--smoke", action="store_true",
                    help="3-stage horizons, 1 iteration, 2 trot cycles")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from opendog_tpu_torch.assets import load_go1

    start = time.perf_counter()
    dev, line = open_device(args.device)
    m = load_go1("flat", device=dev)
    res = {}
    if "trot" in args.arms:
        res["trot"] = trot_arm(m, 2 if args.smoke else args.trot_cycles,
                               SMOKE if args.smoke else TROT)
        print({"arm": "trot", **res["trot"]}, flush=True)
    if "landing" in args.arms:
        res["landing"] = landing_arm(m, SMOKE if args.smoke else LANDING)
        print({"arm": "landing", **res["landing"]}, flush=True)
    res.update(device=line, seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, "metrics.json"), res)


if __name__ == "__main__":
    main()
