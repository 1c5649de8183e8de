#!/usr/bin/env python
"""Calibration of the command gait's speed -> amplitude and turn laws on
the port: the counterpart of scripts/calibrate_cmd_gait.py.

``costs.trot_gait_ref_cmd`` is rolled open loop on the plant the distilled
student is evaluated on, the substep kernel K1 (flat ground, 10 substeps of
the model's timestep a tick), one lane per probe command: S lanes in one
launch per tick.  The script measures the realised heading-frame speed per
commanded stride scale and the yaw response per turn command, and fits the
inverse law (piecewise-linear knots for ``TrotCostParams.amp_knots``).  On
the CPU the same engine runs the kernel's plain version; on the card every
tick replays one CUDA graph.  Run from the repository root:

    python3 scripts/torch_calibrate_cmd_gait.py --robot opendog   # the card
    python3 scripts/torch_calibrate_cmd_gait.py --device cpu --ticks 4 \\
        --settle 2

Writes ``<robot>.json`` (the JAX script's keys, plus ``device``: the card's
name and power limit, or ``cpu``, and ``seconds``) under ``--out`` (default
``runs/torch_cmd_calibration``, kept out of git).  On the card it also logs
the kernel's record at this path's shape (K=S lanes x 10 substeps).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (Replayed, kernel_record,  # noqa: E402
                              open_device, settled, write_metrics)

PLANT_SUBSTEPS = 10


def probe_commands(robot, v_nom):
    """The probe grid: speed probes that sweep the current law's implied
    stride scale over [0.18, 1.5], then stand and trotting turns."""
    if robot == "opendog":
        speed_cmds = [round(s * v_nom, 4)
                      for s in (0.18, 0.3, 0.45, 0.6, 0.75, 0.9, 1.05,
                                1.2, 1.35, 1.5)]
        turn_cmds = [(0.0, 0.2), (0.0, 0.4), (0.0, -0.4), (0.0, 0.8),
                     (0.15, 0.3), (0.15, -0.3), (0.2, 0.2)]
    else:
        speed_cmds = [round(0.1 + 0.08 * i, 4) for i in range(10)]
        turn_cmds = [(0.0, 0.25), (0.0, 0.5), (0.0, -0.5), (0.0, 1.0),
                     (0.3, 0.4), (0.3, -0.4), (0.5, 0.2)]
    return ([[v, 0.0, 0.0] for v in speed_cmds]
            + [[v, 0.0, y] for v, y in turn_cmds])


def cost_params(setup):
    from opendog_tpu_torch.solvers import costs
    return costs.TrotCostParams(**{
        k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v)
        for k, v in setup.recipe["cost_params"].items()})


def implied_scales(model, pc, v_nom, cmds_list):
    """The stride scale the current law gives each probe command."""
    import torch
    from opendog_tpu_torch.solvers import costs
    knots = None
    if len(pc.amp_knots) > 0:
        knots = tuple(torch.tensor([k[i] for k in pc.amp_knots],
                                   dtype=torch.float32) for i in (0, 1))
    return [float(costs._cmd_stride_scales(
        pc, v_nom, torch.zeros(4), torch.tensor(c, dtype=torch.float32),
        None, knots)[0]) for c in cmds_list]


def run(setup, cmds, ticks, graphs=None):
    """``ticks`` open-loop ticks of S lanes from the settled stand, each
    lane under ``u_ref(t, its command)`` clipped into ctrlrange: xyz (T, S,
    3) and yaw (T, S), and the last tick's kernel inputs ((rows, S) qpos,
    qvel, ctrl) for the kernel's record."""
    import torch
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.physics import spatial
    m, u_ref = setup.model, setup.u_ref
    dev = m.device
    S = cmds.shape[0]
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    sub = cuda_step.build_cuda_substep(m, m.timestep,
                                       n_substeps=PLANT_SUBSTEPS, device=dev)
    dt_tick = PLANT_SUBSTEPS * float(m.timestep)

    def tick(qpos, qvel, t):
        ctrl = torch.clamp(u_ref(t, cmds), lo, hi)
        qp, qv = sub(qpos, qvel, ctrl.T.contiguous())
        yaw = spatial.euler_from_quat(qp[3:7].T)[2]
        return qp, qv, t + dt_tick, yaw

    tick = Replayed(tick, dev, graphs)
    s0 = settled(m)
    qpos = s0.qpos[:, None].repeat(1, S).contiguous()
    qvel = torch.zeros((m.nv, S), device=dev)
    t = torch.zeros(S, device=dev)
    xyz, yaws = [], []
    for _ in range(ticks):
        last = (qpos.clone(), qvel.clone(),
                torch.clamp(u_ref(t, cmds), lo, hi).T.contiguous())
        qpos, qvel, t, yaw = tick(qpos, qvel, t)
        xyz.append(qpos[:3].T.clone())
        yaws.append(yaw.clone())
    return (torch.stack(xyz).cpu().numpy(), torch.stack(yaws).cpu().numpy(),
            last)


def probe_records(xyz, yaws, cmds_list, scales, z_band, settle, ticks,
                  dt_tick):
    """The JAX script's per-probe records."""
    from opendog_tpu_torch.utils.cmd_tracking import heading_frame_vx
    per = []
    for i, c in enumerate(cmds_list):
        z = xyz[:, i, 2]
        upright = bool(((z > z_band[0]) & (z < z_band[1])).all())
        vx = float(heading_frame_vx(xyz[settle:, i, :2], c[2], dt_tick))
        rec = dict(cmd=[round(v, 3) for v in c],
                   scale=round(scales[i], 3),
                   realized_vx=round(vx, 4),
                   yaw_end=round(float(yaws[-1, i]), 3),
                   upright=upright,
                   z_min=round(float(z.min()), 3))
        if c[2] != 0.0:
            idx = np.linspace(0, ticks - 1, 9).astype(int)
            rec["yaw_traj"] = [round(float(yaws[k, i]), 3) for k in idx]
            rec["t_samples_s"] = [round(float(k * dt_tick), 2) for k in idx]
        per.append(rec)
    return per


def fit_law(per):
    """The JAX script's fit: the monotone envelope of the upright speed
    probes' (scale, speed) curve, cut at its maximum, as inverse-law knots
    (speed -> scale) and a linear fit."""
    sp = sorted((r["scale"], r["realized_vx"]) for r in per
                if r["cmd"][2] == 0.0 and r["upright"])
    if len(sp) < 3:
        return {}
    scales = np.array([s for s, _ in sp])
    vels = np.array([v for _, v in sp])
    k_max = int(np.argmax(vels))
    s_mono, v_mono = scales[:k_max + 1], vels[:k_max + 1]
    keep = [0]
    for j in range(1, len(v_mono)):
        if v_mono[j] > v_mono[keep[-1]] + 1e-4:
            keep.append(j)
    s_mono, v_mono = s_mono[keep], v_mono[keep]
    A = np.stack([s_mono, np.ones_like(s_mono)], 1)
    (slope, icept), *_ = np.linalg.lstsq(A, v_mono, rcond=None)
    return dict(
        v_max=round(float(vels.max()), 4),
        scale_at_v_max=round(float(scales[k_max]), 3),
        linear_v_per_scale=round(float(slope), 4),
        linear_intercept=round(float(icept), 4),
        amp_knots=[[0.0, 0.0]] + [[round(float(v), 4), round(float(s), 3)]
                                  for v, s in zip(v_mono, s_mono)],
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="opendog", choices=["go1", "opendog"])
    ap.add_argument("--ticks", type=int, default=400,
                    help="rollout length per probe (50 Hz ticks)")
    ap.add_argument("--settle", type=int, default=100,
                    help="transient ticks excluded from the speed window")
    ap.add_argument("--out", default="runs/torch_cmd_calibration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup

    start = time.perf_counter()
    dev, line = open_device(args.device)
    setup = cmd_distill_setup(args.robot, engine="kernel", device=dev)
    m = setup.model
    pc = cost_params(setup)
    v_nom = float(np.hypot(*pc.desired_vel_xy))
    cmds_list = probe_commands(args.robot, v_nom)
    S = len(cmds_list)
    cmds = torch.tensor(cmds_list, dtype=torch.float32, device=dev)
    scales = implied_scales(m, pc, v_nom, cmds_list)
    dt_tick = PLANT_SUBSTEPS * float(m.timestep)
    print(f"[calib] engine=kernel robot={args.robot} probes={S} "
          f"ticks={args.ticks}", flush=True)
    t0 = time.perf_counter()
    cuda_step.LAUNCHES.clear()
    xyz, yaws, last = run(setup, cmds, args.ticks)
    launches = dict(cuda_step.LAUNCHES)
    print(f"[calib] rollout done in {time.perf_counter() - t0:.0f}s; "
          f"kernel launches {launches}", flush=True)
    if dev.type == "cuda":
        rec = kernel_record("calibration plant", m, m.timestep,
                            PLANT_SUBSTEPS, *last, launches=launches.get(
                                cuda_step.launch_key(S, PLANT_SUBSTEPS), 0))
        print("[calib] kernel " + json.dumps(rec), file=sys.stderr,
              flush=True)
    per = probe_records(xyz, yaws, cmds_list, scales, setup.z_band,
                        args.settle, args.ticks, dt_tick)
    for rec in per:
        print(json.dumps(rec), flush=True)
    res = dict(robot=args.robot, engine="kernel", ticks=args.ticks,
               dt_tick=dt_tick, settle_ticks=args.settle,
               cost_params=setup.recipe["cost_params"],
               per_probe=per, fit=fit_law(per),
               wall_s=round(time.perf_counter() - t0, 1),
               device=line, seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, f"{args.robot}.json"), res)


if __name__ == "__main__":
    main()
