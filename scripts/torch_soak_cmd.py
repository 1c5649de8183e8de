#!/usr/bin/env python
"""Command-switching soak of the committed command-conditioned student on
the port: the counterpart of scripts/soak_cmd.py.

One network (the JAX package's ``runs/distill_cmd/student.msgpack``, read
by ``rl/distill_zoo.load_student``) drives the plant through a schedule of
velocity / heading commands (walk, stand, slow trot, turn, fast trot, and
probes between the curriculum's modes), 10 s a segment.  The plant is the
substep kernel K1 at K=1 (10 substeps of 2 ms a tick; K2 with
``--payload_kg``); on the card every tick (policy and plant) replays one
CUDA graph, and on the CPU the same engine runs the kernel's plain version.
The policy is deterministic: the same student on the same plant gives the
same segments.  Run from the repository root:

    python3 scripts/torch_soak_cmd.py                      # the card
    python3 scripts/torch_soak_cmd.py --device cpu --smoke

(On the CPU the plain version takes about 1.5 s a tick: the whole schedule,
9500 ticks, is for the card.)

Writes ``soak.json`` (the JAX script's keys, plus ``device``: the card's
name and power limit, or ``cpu``, and ``seconds``) under ``--out`` (default
``runs/torch_soak_cmd``, kept out of git).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (Replayed, hold_ctrl, open_device,  # noqa
                              settled, write_metrics)

# absolute (vx, vy, yaw_target) per segment: every curriculum mode, the
# transitions (stand -> fast, turn -> counter-turn) and, in the second
# half, probes between the curriculum's mode centres
SCHEDULE_BY_ROBOT = {
    "go1": [
        [0.5, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [0.25, 0.0, 0.0],
        [0.3, 0.0, 0.4],
        [0.6, 0.0, 0.4],    # keep heading while speeding up
        [0.0, 0.0, 0.0],    # stop from speed
        [0.0, 0.0, 0.5],    # turn in place
        [0.3, 0.0, -0.4],   # counter-turn while trotting
        [0.5, 0.0, -0.4],
        [0.25, 0.0, 0.0],   # slow home stretch
        [0.0, 0.0, 0.0],
        [0.5, 0.0, 0.0],
        # ---- interpolation probes (off the training grid) ----
        [0.35, 0.0, 0.0],
        [0.45, 0.0, 0.0],
        [0.35, 0.0, 0.25],
        [0.45, 0.0, -0.25],
        [0.0, 0.0, 0.25],   # gentle turn in place
        [0.55, 0.0, 0.0],
        [0.0, 0.0, 0.0],
    ],
    # the same shape scaled to the OpenDOG's calibrated envelope (ceiling
    # ~0.204 m/s)
    "opendog": [
        [0.17, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [0.1, 0.0, 0.0],
        [0.15, 0.0, 0.3],
        [0.2, 0.0, 0.3],
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 0.4],
        [0.15, 0.0, -0.3],
        [0.2, 0.0, -0.3],
        [0.1, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [0.17, 0.0, 0.0],
        [0.13, 0.0, 0.0],
        [0.19, 0.0, 0.0],
        [0.13, 0.0, 0.25],
        [0.19, 0.0, -0.25],
        [0.0, 0.0, 0.25],
        [0.21, 0.0, 0.0],
        [0.0, 0.0, 0.0],
    ],
}
PLANT_SUBSTEPS = 10


def soak_policy(robot, student, device):
    """(setup, policy) of the committed command student on the kernel
    engine."""
    from opendog_tpu_torch.rl.distill_zoo import (cmd_distill_setup,
                                                  load_student)
    setup = cmd_distill_setup(robot, engine="kernel", device=device)
    return setup, load_student(student, setup, command_dim=3)


def run(setup, policy, schedule, segment_ticks, payload_kg=0.0,
        graphs=None):
    """The schedule driven from the stand settled for 150 substeps: trunk
    xyz (T, 3) and quaternion (T, 4), numpy, T = segments x
    ``segment_ticks``."""
    import torch
    from opendog_tpu_torch.ops import cuda_step
    m = setup.model
    dev = m.device
    with_payload = payload_kg > 0.0
    sub = cuda_step.build_cuda_substep(m, m.timestep, PLANT_SUBSTEPS,
                                       device=dev, with_payload=with_payload)
    extra = ({"payload": torch.full((1, 1), float(payload_kg), device=dev)}
             if with_payload else {})
    dt_tick = PLANT_SUBSTEPS * float(m.timestep)

    def tick(qpos, qvel, t, prev, cmd):
        u = policy(qpos, qvel, t, prev, cmd)
        qp, qv = sub(qpos[:, None], qvel[:, None], u[:, None].contiguous(),
                     **extra)
        return qp[:, 0], qv[:, 0], t + dt_tick, u

    tick = Replayed(tick, dev, graphs)
    cmds = torch.tensor(np.repeat(np.asarray(schedule, np.float32),
                                  segment_ticks, axis=0), device=dev)
    s0 = settled(m)
    qpos, qvel, t, prev = s0.qpos, s0.qvel, s0.time, hold_ctrl(m)
    xyz, quat = [], []
    for cmd in cmds:
        qpos, qvel, t, prev = tick(qpos, qvel, t, prev, cmd)
        xyz.append(qpos[:3].clone())
        quat.append(qpos[3:7].clone())
    return torch.stack(xyz).cpu().numpy(), torch.stack(quat).cpu().numpy()


def summarize(robot, schedule, seg, xyz, quat, z_band):
    """The JAX script's per-segment records and whole-run health (the
    keys before ``engine``)."""
    import torch
    from opendog_tpu_torch.physics import spatial
    from opendog_tpu_torch.utils.cmd_tracking import segment_record
    yaws = spatial.euler_from_quat(torch.from_numpy(quat))[2].numpy()
    zs = xyz[:, 2]
    segs = []
    for i, c in enumerate(schedule):
        a, b = i * seg, (i + 1) * seg
        rec = segment_record(xyz[a:b, :2], yaws[b - 1], c)
        rec["z_min"] = round(float(zs[a:b].min()), 3)
        segs.append(rec)
    # a segment tracks only if both the speed and the heading are held
    thr_v = 0.15 if robot == "go1" else 0.15 * 0.28 / 0.5
    tracked = sum(1 for s in segs
                  if s["vx_err"] < thr_v and s["yaw_err"] < 0.25)
    T = xyz.shape[0]
    return dict(
        ticks=T,
        sim_minutes=round(T * 0.02 / 60.0, 2),
        segments=segs,
        segments_tracked=tracked,
        segments_total=len(segs),
        upright_all=bool((zs > z_band[0]).all() and (zs < z_band[1]).all()),
        all_finite=bool(np.isfinite(xyz).all()),
        final_xy=[round(float(v), 3) for v in xyz[-1, :2]],
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--student", default="runs/distill_cmd/student.msgpack")
    ap.add_argument("--out", default="runs/torch_soak_cmd")
    ap.add_argument("--robot", default="go1", choices=["go1", "opendog"])
    ap.add_argument("--segment_ticks", type=int, default=500)  # 10 s
    ap.add_argument("--payload_kg", type=float, default=0.0,
                    help="> 0 soaks with an unobserved trunk payload on the "
                         "plant (the kernel's payload mode, K2)")
    ap.add_argument("--smoke", action="store_true",
                    help="2 ticks of the first segment")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    start = time.perf_counter()
    dev, line = open_device(args.device)
    schedule = SCHEDULE_BY_ROBOT[args.robot]
    if args.smoke:
        args.segment_ticks, schedule = 2, schedule[:1]
    setup, policy = soak_policy(args.robot, args.student, dev)
    t0 = time.perf_counter()
    xyz, quat = run(setup, policy, schedule, args.segment_ticks,
                    args.payload_kg)
    wall = time.perf_counter() - t0
    res = summarize(args.robot, schedule, args.segment_ticks, xyz, quat,
                    setup.z_band)
    res.update(engine="kernel", payload_kg=float(args.payload_kg),
               student=args.student, wall_s=round(wall, 1), device=line,
               seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, "soak.json"), res)
    for s in res["segments"]:
        print(json.dumps(s), flush=True)


if __name__ == "__main__":
    main()
