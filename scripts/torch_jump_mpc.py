#!/usr/bin/env python
"""MPC jump onto the cube on the port: the counterpart of
scripts/jump_mpc.py.

A time-phased MPPI cost drives the Go1 through crouch, launch and land
toward the jump scene's cube (a 0.8 m square platform, top at z = 0.18,
centred at x = 1).  The rollouts run the op-graph step (``engine="ops"``,
the JAX package's ``"xla"``): the substep kernel has no box contact.  The
plant is the op-graph step too, 10 substeps of 2 ms a tick.  Products stay
in full float32 (the JAX script's ``default_matmul_precision("highest")``).
On the card each tick (solve, plant step and the paws' contact) replays one
CUDA graph.  Run from the repository root:

    python3 scripts/torch_jump_mpc.py                 # the card
    python3 scripts/torch_jump_mpc.py --device cpu --smoke

Writes ``metrics.json`` (the JAX script's keys, plus ``device``: the card's
name and power limit, or ``cpu``, and ``seconds``) under ``--out`` (default
``runs/torch_jump_mpc``, kept out of git); ``--gif`` renders ``jump.gif``
(needs matplotlib and imageio).
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import Replayed, open_device, write_metrics  # noqa

CONFIG = dict(horizon=50, num_samples=512, n_substeps=2, rollout_dt=0.01,
              noise_sigma=0.28, temperature=0.25, smooth_alpha=0.5,
              engine="ops")
SMOKE = dict(horizon=5, num_samples=8, n_substeps=1, rollout_dt=0.01,
             engine="ops")


def jump_geometry(model):
    """(cube_top, cube_x, land_z): the platform's top (0.18), its centre's
    x and the trunk height standing on it."""
    cube_top = float(model.wbox_pos[0, 2] + model.wbox_size[0, 2])
    return cube_top, float(model.wbox_pos[0, 0]), cube_top + 0.27


def jump_cost(model, t_crouch=0.35, t_launch=0.75, vx=2.2, vz=3.0):
    """The script's time-phased cost ``step_cost(state, ctrl, prev_ctrl)``,
    batch-first: crouch, then track the ballistic takeoff velocity, then
    land on the near half of the platform, upright and calm."""
    import torch
    from opendog_tpu_torch.physics import spatial
    home_j = model.key_qpos[0, 7:]
    _, cube_x, land_z = jump_geometry(model)
    land_x = cube_x - 0.25

    def sq(x):
        return torch.square(x)

    def step_cost(st, ctrl, prev_ctrl):
        qpos, qvel, t = st.qpos, st.qvel, st.time
        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])
        up = sq(roll) + sq(pitch) + 0.3 * sq(yaw)
        joints_home = torch.sum(sq(qpos[..., 7:] - home_j), dim=-1)
        rate = torch.sum(sq(ctrl - prev_ctrl), dim=-1)
        c_crouch = (60.0 * sq(qpos[..., 2] - 0.16)
                    + 10.0 * sq(qpos[..., 0] - 0.25)
                    + 1.0 * joints_home)
        c_launch = (8.0 * sq(qvel[..., 0] - vx)
                    + 10.0 * sq(qvel[..., 2] - vz)
                    + 4.0 * sq(qvel[..., 1]))
        c_land = (40.0 * sq(qpos[..., 0] - land_x)
                  + 60.0 * sq(qpos[..., 2] - land_z)
                  + 10.0 * sq(qpos[..., 1])
                  + 1.0 * torch.sum(sq(qvel[..., :6]), dim=-1)
                  + 1.0 * joints_home)
        phase_cost = torch.where(t < t_crouch, c_crouch,
                                 torch.where(t < t_launch, c_launch, c_land))
        return phase_cost + 20.0 * up + 0.2 * rate

    return step_cost


def start_state(model):
    """Home, moved to x = 0.25 (0.35 m before the platform's edge)."""
    from opendog_tpu_torch.physics import make_state
    s0 = make_state(model, "home")
    s0.qpos[0] = 0.25
    return s0


def make_tick(model, cost, config, graphs=None):
    """``tick(qpos, qvel, time, nominal, normals) -> (qpos', qvel', time',
    nominal', any paw in contact)``: one solve and one plant step of 10
    substeps, replayed from a CUDA graph on the card."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    solve = mppi.make_solver(model, cost, MPPIConfig(**config),
                             device=model.device)

    def tick(qpos, qvel, time, nominal, normals):
        st = State(qpos=qpos, qvel=qvel, time=time)
        ctrl, ms, _ = solve(st, mppi.MPPIState(nominal=nominal), None,
                            normals)
        st, info = dynamics.step(model, st, ctrl, None, n_substeps=10)
        _, _, ic = dynamics.foot_contact_summary(model, info.contact)
        return st.qpos, st.qvel, st.time, ms.nominal, torch.any(ic)

    return Replayed(tick, model.device, graphs)


def run(model, ticks, config=CONFIG, generator=None, normals=None,
        graphs=None, cost=None):
    """``ticks`` ticks from :func:`start_state`: (qpos (ticks, nq), any paw
    in contact (ticks,)), numpy.  ``normals`` (ticks, K, H, nu) injects
    every solve's draw; otherwise ``generator`` draws them on the
    device."""
    import torch
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    cfg = MPPIConfig(**config)
    tick = make_tick(model, jump_cost(model) if cost is None else cost,
                     config, graphs)
    st = start_state(model)
    qpos, qvel, t = st.qpos, st.qvel, st.time
    nominal = mppi.init_state(model, cfg).nominal
    shape = (cfg.num_samples, cfg.horizon, model.nu)
    qs, contact = [], []
    for i in range(ticks):
        nrm = (normals[i] if normals is not None else torch.randn(
            shape, generator=generator, device=model.device))
        qpos, qvel, t, nominal, ic = tick(qpos, qvel, t, nominal, nrm)
        qs.append(qpos.clone())
        contact.append(ic.clone())
    return (torch.stack(qs).cpu().numpy(),
            torch.stack(contact).cpu().numpy())


def summarize(model, qps, contact, ticks, wall):
    """The JAX script's record of a run's qpos (ticks, nq) and paw contact
    (ticks,)."""
    import torch
    from opendog_tpu_torch.physics import spatial
    cube_top, cube_x, _ = jump_geometry(model)
    z, final = qps[:, 2], qps[-1]
    flight_ticks = int((~contact).sum())
    longest_flight = cur = 0
    for c in ~contact:
        cur = cur + 1 if c else 0
        longest_flight = max(longest_flight, cur)
    r, p, _ = (float(v) for v in spatial.euler_from_quat(
        torch.from_numpy(np.asarray(final[3:7], np.float32))))
    half = model.wbox_size[0].cpu().numpy()
    on_cube = (abs(final[0] - cube_x) < float(half[0])
               and abs(final[1]) < float(half[1])
               and final[2] > cube_top + 0.12)
    return dict(
        ticks=ticks, wall_s=round(wall, 1),
        peak_z=round(float(z.max()), 3),
        final_x=round(float(final[0]), 3),
        final_z=round(float(final[2]), 3),
        roll=round(float(r), 3), pitch=round(float(p), 3),
        flight_ticks_total=flight_ticks,
        longest_flight_ticks=longest_flight,
        landed_on_cube=bool(on_cube),
        upright=bool(abs(r) < 0.5 and abs(p) < 0.5),
        all_finite=bool(np.isfinite(qps).all()),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=90)
    ap.add_argument("--out", default="runs/torch_jump_mpc")
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config for CPU CI: exercises the full "
                         "pipeline, proves nothing about performance")
    ap.add_argument("--t_crouch", type=float, default=0.35)
    ap.add_argument("--t_launch", type=float, default=0.75)
    ap.add_argument("--vx", type=float, default=2.2)
    ap.add_argument("--vz", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch
    from opendog_tpu_torch.assets import load_go1

    start = time.perf_counter()
    dev, line = open_device(args.device)
    m = load_go1("jump", device=dev)
    cost = jump_cost(m, args.t_crouch, args.t_launch, args.vx, args.vz)
    if args.smoke:
        args.ticks = 3
    t0 = time.perf_counter()
    qps, contact = run(m, args.ticks, SMOKE if args.smoke else CONFIG,
                       torch.Generator(device=dev).manual_seed(0),
                       cost=cost)
    res = summarize(m, qps, contact, args.ticks, time.perf_counter() - t0)
    res.update(device=line, seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, "metrics.json"), res)
    if args.gif:
        from opendog_tpu_torch.physics import State
        from opendog_tpu_torch.utils.render import record_rollout
        qq = torch.from_numpy(qps[::2])
        record_rollout(m.to("cpu"), State(
            qpos=qq, qvel=torch.zeros(qq.shape[0], m.nv),
            time=torch.zeros(qq.shape[0])),
            os.path.join(args.out, "jump.gif"), fps=12)


if __name__ == "__main__":
    main()
