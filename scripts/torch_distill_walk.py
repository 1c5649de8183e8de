#!/usr/bin/env python
"""MPC -> policy distillation of the trot (BASELINE config 5) on the port:
the counterpart of scripts/distill_walk.py.

The trot-tracking MPPI expert of ``rl/distill_zoo.trot_distill_setup``
(S scenarios x K=512 x H=25 on the substep kernel, K1; with
``--payload_max`` each scenario carries an unobserved trunk payload and the
kernel is K2) is distilled into an MLP by DAgger with an aggregate buffer
(``rl/distill.py``'s ``collect`` / ``train_on``), then proved by a
student-only rollout: the policy must keep the robot upright for
``--eval_ticks`` ticks and carry it forward, while the expert labels the
student's own states for the imitation RMSE.  On the card each collect and
eval tick replays one CUDA graph; on the CPU the same engine runs the
kernel's plain version.  Run from the repository root:

    python3 scripts/torch_distill_walk.py [--robot opendog] [--payload_max 1]
    python3 scripts/torch_distill_walk.py --device cpu --smoke

Writes ``metrics.json`` (the JAX script's keys, plus ``device``: the card's
name and power limit, or ``cpu``, and ``seconds``) and ``student.pt`` (the
student's ``state_dict``) under ``--out`` (default
``runs/torch_distill_<robot>``, kept out of git), and for OpenDOG
``walk_distilled.json`` (the executed rollout through the sim -> real
calibration map); ``--gif`` renders ``student.gif``.  The JAX package's
``runs/distill_*/student.msgpack`` is never written.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import open_device, settled, write_metrics  # noqa

TRAIN_N = 8192   # rows per resample of the aggregate buffer
SMOKE_TRAIN_N = 512  # --smoke: one minibatch per epoch


def walk_setup(robot, device, pc=None, gait_center=None, sigma=None,
               smoke=False):
    """The distillation setup of ``robot`` on the kernel engine, with the
    script's overrides."""
    from dataclasses import replace
    from opendog_tpu_torch.rl.distill_zoo import trot_distill_setup
    from opendog_tpu_torch.solvers import MPPIConfig
    if pc and "desired_vel_xy" in pc:
        pc = dict(pc, desired_vel_xy=tuple(pc["desired_vel_xy"]))
    setup = trot_distill_setup(robot, engine="kernel", pc_overrides=pc,
                               gait_center=(tuple(gait_center)
                                            if gait_center else None),
                               device=device)
    if smoke:
        setup = setup._replace(mppi_config=MPPIConfig(
            horizon=3, num_samples=8, n_substeps=1, rollout_dt=0.01,
            engine="kernel"))
    if sigma is not None:
        setup = setup._replace(
            mppi_config=replace(setup.mppi_config, noise_sigma=sigma),
            recipe=dict(setup.recipe, noise_sigma=float(sigma)))
    return setup


def jitter(model, qpos, S, generator):
    """S start poses from one settled pose: joint noise of 0.03 rad and
    height noise of 1 cm, so the experts cover distinct state tubes."""
    import torch
    dev = qpos.device
    q = qpos[None].repeat(S, 1)
    q[:, 7:] += 0.03 * torch.randn((S, model.nq - 7), generator=generator,
                                   device=dev)
    q[:, 2] += 0.01 * torch.randn((S,), generator=generator, device=dev)
    return q


def walk_distiller(setup, S, ticks, rounds, payload_max, device):
    """(config, distiller): the script's DAgger distiller of ``setup``, S
    scenarios of ``ticks`` collect ticks, the plant 10 substeps a tick,
    with unobserved payloads in [0, ``payload_max``] kg where it is > 0."""
    from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
    dcfg = DistillConfig(num_scenarios=S, rollout_ticks=ticks, rounds=rounds,
                         lr=1e-3, batch_size=512, epochs_per_round=8,
                         beta_decay=0.8)
    return dcfg, make_distiller(
        setup.model, setup.cost, setup.obs_fn, setup.net,
        mppi_config=setup.mppi_config, config=dcfg, plant_substeps=10,
        action_ref_fn=setup.u_ref, with_prev_ctrl=True, device=device,
        payload_range=(0.0, payload_max) if payload_max > 0 else None)


def eval_record(out, z_band, eval_ticks):
    """The JAX script's proof numbers of a student-only rollout (``out``
    of ``eval_fn``)."""
    qpos_traj = out["qpos_traj"].cpu().numpy()        # (T, S, nq)
    z = qpos_traj[:, :, 2]
    upright = (z > z_band[0]) & (z < z_band[1])
    upright_ticks = int(upright.all(axis=1).cumprod().sum())
    fx = out["final_x"].cpu().numpy()
    return dict(
        action_rmse=float(out["action_rmse"]),
        eval_ticks=eval_ticks,
        upright_ticks_all_scenarios=upright_ticks,
        upright_full_run=bool(upright_ticks == eval_ticks),
        forward_x_mean=float(fx.mean()),
        forward_x_min=float(fx.min()),
        walks_1m_in_10s=bool(fx.min() >= 1.0
                             and upright_ticks == eval_ticks),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", choices=["go1", "opendog"], default="go1")
    ap.add_argument("--rounds", type=int, default=14)
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--eval_ticks", type=int, default=500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--payload_max", type=float, default=0.0,
                    help="randomize carried trunk payload in [0, max] kg")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (K=8, H=3, 2 scenarios, one round "
                         "of one tick, 1 eval tick, resamples of 512 "
                         "rows): pipeline exercise only")
    ap.add_argument("--pc", default=None,
                    help="JSON dict of TrotCostParams overrides")
    ap.add_argument("--gait_center", type=float, nargs=2, default=None,
                    metavar=("THIGH", "KNEE"))
    ap.add_argument("--sigma", type=float, default=None,
                    help="override MPPI noise_sigma")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch
    from opendog_tpu_torch.physics import State
    from opendog_tpu_torch.solvers import mppi

    start = time.perf_counter()
    dev, line = open_device(args.device)
    setup = walk_setup(args.robot, dev, json.loads(args.pc) if args.pc
                       else None, args.gait_center, args.sigma, args.smoke)
    if args.smoke:
        args.rounds, args.ticks, args.scenarios, args.eval_ticks = 1, 1, 2, 1
    m, mcfg, z_band = setup.model, setup.mppi_config, setup.z_band
    out_dir = args.out or f"runs/torch_distill_{args.robot}"
    S = args.scenarios
    dcfg, distiller = walk_distiller(setup, S, args.ticks, args.rounds,
                                     args.payload_max, dev)
    payload = args.payload_max > 0

    gen = torch.Generator(device=dev).manual_seed(7)
    s0 = settled(m)
    plants0 = State(qpos=jitter(m, s0.qpos, S, gen),
                    qvel=torch.zeros(S, m.nv, device=dev),
                    time=torch.zeros(S, device=dev))
    plants = plants0
    dstate = distiller.init(torch.Generator(device=dev).manual_seed(0), s0)
    rng = np.random.default_rng(0)
    train_n = SMOKE_TRAIN_N if args.smoke else TRAIN_N
    buf_obs, buf_lab = [], []
    t0 = time.perf_counter()

    def train(n):
        nonlocal dstate
        all_obs, all_lab = torch.cat(buf_obs), torch.cat(buf_lab)
        for _ in range(n):
            idx = torch.from_numpy(rng.integers(0, all_obs.shape[0],
                                                train_n)).to(dev)
            g = torch.Generator(device=dev).manual_seed(
                int(rng.integers(1 << 30)))
            dstate, loss = distiller.train_on(dstate, all_obs[idx],
                                              all_lab[idx], generator=g)
        return float(loss), all_obs.shape[0]

    for r in range(args.rounds):
        beta = dcfg.beta_decay ** r
        payloads = (torch.from_numpy(rng.uniform(0.0, args.payload_max, S)
                                     .astype(np.float32)).to(dev)
                    if payload else None)
        plants, _, _, obs, labels = distiller.collect(
            dstate, plants, mppi.init_state(m, mcfg, scenarios=S), beta,
            payloads)
        buf_obs.append(obs)
        buf_lab.append(labels)
        loss, n = train(3)
        print(f"round {r}: loss {loss:.4f} beta {beta:.3f} buffer {n} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if (r + 1) % 4 == 0:
            plants = plants0
    loss, _ = train(10)
    print(f"final fit loss {loss:.4f}", flush=True)

    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in dstate.params.items()},
               os.path.join(out_dir, "student.pt"))
    eval_payloads = (torch.linspace(0.0, args.payload_max, S, device=dev)
                     if payload else None)
    out = distiller.eval_fn(dstate, plants0, args.eval_ticks, eval_payloads)
    print("per-scenario fwd_x:", np.round(out["final_x"].cpu().numpy(), 2),
          flush=True)
    res = dict(rounds=args.rounds, payload_max_kg=args.payload_max,
               final_loss=loss, **eval_record(out, z_band, args.eval_ticks),
               wall_s=round(time.perf_counter() - t0, 1),
               recipe=setup.recipe, device=line,
               seconds=time.perf_counter() - start)
    write_metrics(os.path.join(out_dir, "metrics.json"), res)
    qpos_traj = out["qpos_traj"].cpu()
    if args.gif:
        from opendog_tpu_torch.utils.render import record_rollout
        qq = qpos_traj[::4, 0]
        record_rollout(m.to("cpu"), State(
            qpos=qq, qvel=torch.zeros(qq.shape[0], m.nv),
            time=torch.zeros(qq.shape[0])),
            os.path.join(out_dir, "student.gif"), fps=12)
    if args.robot == "opendog":
        # the student's executed rollout (scenario 0) as a deployable
        # walk.json through the sim -> real calibration map
        from opendog_tpu_torch.sim2real.calibration import Calibration
        from opendog_tpu_torch.sim2real.gait_json import save_gait
        cal = Calibration(m.to("cpu"))
        ctrl_traj = out["ctrl_traj"][:100, 0].cpu()
        deg = np.stack([np.asarray(cal.sim_rad_to_real_deg(
            cal.reorder_from_model(u))) for u in ctrl_traj])
        save_gait(os.path.join(out_dir, "walk_distilled.json"),
                  [0.02] * deg.shape[0], deg, cal.order)


if __name__ == "__main__":
    main()
