#!/usr/bin/env python
"""MPC landing on the port: the counterpart of scripts/landing_mpc.py.

The Go1 drops from the ``descent`` keyframe (trunk z = 0.6, legs tucked)
onto the landing scene's platform (0.8 m square, top z = 0.4), and MPPI
absorbs the impact and settles it upright: small base twist, the standing
height on the platform, joints near home.  Then a plain PD stand-hold at
the home control takes over for 50 ticks (the deployment pattern: MPC
absorbs the impact, the servos hold the stance).  The rollouts and the
plant run the op-graph step (``engine="ops"``, the JAX ``"xla"``: the
substep kernel has no box contact) in full float32.  On the card each tick
replays one CUDA graph.  Run from the repository root:

    python3 scripts/torch_landing_mpc.py                 # the card
    python3 scripts/torch_landing_mpc.py --device cpu --smoke

Writes ``metrics.json`` (the JAX script's keys, plus ``device``: the card's
name and power limit, or ``cpu``, and ``seconds``) under ``--out`` (default
``runs/torch_landing_mpc``, kept out of git); ``--gif`` renders
``landing.gif`` (needs matplotlib and imageio).
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import Replayed, open_device, write_metrics  # noqa

CONFIG = dict(horizon=30, num_samples=256, n_substeps=2, rollout_dt=0.01,
              noise_sigma=0.08, temperature=0.2, engine="ops")
SMOKE = dict(horizon=5, num_samples=8, n_substeps=1, rollout_dt=0.01,
             engine="ops")
HOLD_TICKS = 50


def platform_top(model):
    return float(model.wbox_pos[0, 2] + model.wbox_size[0, 2])


def landing_cost(model):
    """The script's cost ``step_cost(state, ctrl, prev_ctrl)``,
    batch-first."""
    import torch
    from opendog_tpu_torch.physics import spatial
    home_j = model.key_qpos[0, 7:]
    stand_z = platform_top(model) + 0.27
    sq = torch.square

    def step_cost(st, ctrl, prev_ctrl):
        qpos, qvel = st.qpos, st.qvel
        roll, pitch, yaw = spatial.euler_from_quat(qpos[..., 3:7])
        return (
            30.0 * (sq(roll) + sq(pitch))
            + 5.0 * sq(yaw)
            + 40.0 * sq(qpos[..., 2] - stand_z)
            + 10.0 * torch.sum(sq(qpos[..., :2]), dim=-1)
            + 4.0 * torch.sum(sq(qvel[..., :6]), dim=-1)   # soft touchdown
            + 1.5 * torch.sum(sq(qpos[..., 7:] - home_j), dim=-1)
            + 0.3 * torch.sum(sq(ctrl - prev_ctrl), dim=-1)
        )

    return step_cost


def run(model, ticks, hold_ticks, config=CONFIG, generator=None,
        normals=None, graphs=None):
    """``ticks`` MPC ticks from ``descent``, then ``hold_ticks`` ticks of
    the home control: numpy qpos (ticks + hold_ticks, nq), base twist
    (ticks + hold_ticks, 6) and the largest vertical paw force of each MPC
    tick (ticks,).  ``normals`` (ticks, K, H, nu) injects every solve's
    draw; otherwise ``generator`` draws them on the device."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics, make_state
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    cfg = MPPIConfig(**config)
    dev = model.device
    solve = mppi.make_solver(model, landing_cost(model), cfg, device=dev)
    home = model.key_ctrl[0]

    def tick(qpos, qvel, time, nominal, nrm):
        st = State(qpos=qpos, qvel=qvel, time=time)
        ctrl, ms, _ = solve(st, mppi.MPPIState(nominal=nominal), None, nrm)
        st, info = dynamics.step(model, st, ctrl, None, n_substeps=10)
        fw, _, _ = dynamics.foot_contact_summary(model, info.contact)
        return (st.qpos, st.qvel, st.time, ms.nominal,
                torch.max(torch.abs(fw[:, 2])))

    def hold(qpos, qvel, time):
        st, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=time),
                              home, None, n_substeps=10)
        return st.qpos, st.qvel, st.time

    tick, hold = Replayed(tick, dev, graphs), Replayed(hold, dev, graphs)
    st = make_state(model, "descent")
    qpos, qvel, t = st.qpos, st.qvel, st.time
    nominal = mppi.init_state(model, cfg, key_name="descent").nominal
    shape = (cfg.num_samples, cfg.horizon, model.nu)
    qs, tw, fmax = [], [], []
    for i in range(ticks):
        nrm = (normals[i] if normals is not None else torch.randn(
            shape, generator=generator, device=dev))
        qpos, qvel, t, nominal, f = tick(qpos, qvel, t, nominal, nrm)
        qs.append(qpos.clone())
        tw.append(qvel[:6].clone())
        fmax.append(f.clone())
    for _ in range(hold_ticks):
        qpos, qvel, t = hold(qpos, qvel, t)
        qs.append(qpos.clone())
        tw.append(qvel[:6].clone())
    return tuple(torch.stack(x).cpu().numpy() for x in (qs, tw, fmax))


def summarize(model, qps, tw, fmax, ticks, wall):
    """The JAX script's record of a run (qpos, base twist, paw forces)."""
    import torch
    from opendog_tpu_torch.physics import spatial
    top = platform_top(model)
    final = qps[-1]
    r, p, _ = (float(v) for v in spatial.euler_from_quat(
        torch.from_numpy(np.asarray(final[3:7], np.float32))))
    settled_twist = float(np.abs(tw[-10:]).max())
    return dict(
        ticks=ticks, wall_s=round(wall, 1),
        min_trunk_z=round(float(qps[:, 2].min()), 3),
        final_z=round(float(final[2]), 3),
        on_platform=bool(abs(final[0]) < 0.4 and abs(final[1]) < 0.4
                         and final[2] > top + 0.1),
        upright=bool(abs(r) < 0.3 and abs(p) < 0.3),
        peak_contact_force_n=round(float(fmax.max()), 1),
        settled_base_twist=round(settled_twist, 4),
        settled=bool(settled_twist < 0.5),
        all_finite=bool(np.isfinite(qps).all()),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=75)  # 1.5 s
    ap.add_argument("--out", default="runs/torch_landing_mpc")
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config for CPU CI: exercises the full "
                         "pipeline, proves nothing about performance")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch
    from opendog_tpu_torch.assets import load_go1

    start = time.perf_counter()
    dev, line = open_device(args.device)
    m = load_go1("landing", device=dev)
    if args.smoke:
        args.ticks = 3
    t0 = time.perf_counter()
    qps, tw, fmax = run(m, args.ticks, 3 if args.smoke else HOLD_TICKS,
                        SMOKE if args.smoke else CONFIG,
                        torch.Generator(device=dev).manual_seed(0))
    res = summarize(m, qps, tw, fmax, args.ticks, time.perf_counter() - t0)
    res.update(device=line, seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, "metrics.json"), res)
    if args.gif:
        from opendog_tpu_torch.physics import State
        from opendog_tpu_torch.utils.render import record_rollout
        qq = torch.from_numpy(qps[::2])
        record_rollout(m.to("cpu"), State(
            qpos=qq, qvel=torch.zeros(qq.shape[0], m.nv),
            time=torch.zeros(qq.shape[0])),
            os.path.join(args.out, "landing.gif"), fps=12)


if __name__ == "__main__":
    main()
