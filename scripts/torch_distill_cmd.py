#!/usr/bin/env python
"""Command-conditioned MPC -> policy distillation with a velocity-command
curriculum (BASELINE config 5) on the port: the counterpart of
scripts/distill_cmd.py.

One student learns the whole command family: each DAgger round gives every
scenario a command (vx, vy, yaw_target) from a widening discrete curriculum
(the nominal trot first, then other speeds, a stand and turns); the
anchored MPPI expert (``mppi.make_batched_solver(with_command=True,
u_ref_fn=trot_gait_ref_cmd, anchor_w=...)``) plans for its scenario's
command, and the student observes it.  Rounds append to an aggregate
buffer, and each is followed by three ``train_on`` calls on resamples of
``TRAIN_N`` rows.  The proof is a student-only rollout over a fixed
command grid.

Run from the repository root, on the card:

    python3 scripts/torch_distill_cmd.py --smoke          # a minute
    python3 scripts/torch_distill_cmd.py --robot go1      # the full run

``--device cpu`` runs the plain versions on the CPU (the op-graph engine,
as the JAX script picks on a CPU).  Writes ``student.pt`` (the student's
``state_dict``) and ``metrics.json`` under ``--out`` (default
``runs/torch_distill_cmd``, kept out of git); ``runs/distill_cmd/``, the
JAX package's artifact, is never written.
"""
import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# per-robot eval grid and curriculum, speeds scaled to each robot's nominal
# trot (go1 0.5 m/s; the 7 cm-tall opendog 0.28 m/s, whose open-loop
# command gait tops out near 0.21 m/s)
EVAL_CMDS_BY_ROBOT = {
    "go1": [
        [0.0, 0.0, 0.0],     # stand
        [0.25, 0.0, 0.0],    # slow trot
        [0.5, 0.0, 0.0],     # nominal trot
        [0.6, 0.0, 0.0],     # fast trot
        [0.3, 0.0, 0.4],     # trot + turn left
        [0.3, 0.0, -0.4],    # trot + turn right
        [0.0, 0.0, 0.5],     # turn in place
        [0.5, 0.0, 0.2],     # fast + slight turn
    ],
    "opendog": [
        [0.0, 0.0, 0.0],
        [0.1, 0.0, 0.0],
        [0.17, 0.0, 0.0],
        [0.22, 0.0, 0.0],
        [0.15, 0.0, 0.3],
        [0.15, 0.0, -0.3],
        [0.0, 0.0, 0.4],
        [0.2, 0.0, 0.2],
    ],
}

# curriculum modes (vx, yaw_target) in difficulty order: discrete modes
# with a small jitter, which concentrate the scenario-episodes per mode
CURRICULUM_BY_ROBOT = {
    "go1": [
        (0.5, 0.0), (0.25, 0.0), (0.6, 0.0), (0.0, 0.0),
        (0.3, 0.4), (0.3, -0.4), (0.5, 0.2), (0.0, 0.5),
    ],
    "opendog": [
        (0.17, 0.0), (0.1, 0.0), (0.22, 0.0), (0.0, 0.0),
        (0.15, 0.3), (0.15, -0.3), (0.2, 0.2), (0.0, 0.4),
    ],
}
TRAIN_N = 8192   # rows per resample of the aggregate buffer


def sample_commands(rng, S, frac, max_modes=None, curriculum=None,
                    jitter=0.05):
    """Widening discrete curriculum with balanced mode allocation: round
    fraction ``frac`` unlocks a prefix of the curriculum; the S scenarios
    are split evenly across the unlocked modes, with jitter on the moving
    ones.  (S, 3) float32 commands."""
    cur = CURRICULUM_BY_ROBOT["go1"] if curriculum is None else curriculum
    n_avail = 1 + int(round(frac * (len(cur) - 1)))
    if max_modes is not None:
        n_avail = min(n_avail, max_modes)
    modes = (np.arange(S) * n_avail) // S  # balanced, deterministic
    vx = np.array([cur[i][0] for i in modes])
    yaw = np.array([cur[i][1] for i in modes])
    moving = vx > 0.0
    vx = np.where(moving, vx + rng.uniform(-jitter, jitter, S), 0.0)
    yaw = yaw + np.where(moving, rng.uniform(-jitter, jitter, S), 0.0)
    return np.stack([vx, np.zeros(S), yaw], axis=1).astype(np.float32)


def jitter(torch, spatial, generator, qpos, S, yaw_range=0.0):
    """S start poses from one settled pose: joint and height noise, and a
    start yaw uniform in +-``yaw_range`` (training only: near-target and
    past-target headings become training data for every turning mode)."""
    dev = qpos.device
    q = qpos[None].repeat(S, 1)
    q[:, 7:] += 0.03 * torch.randn((S, q.shape[1] - 7), generator=generator,
                                   device=dev)
    q[:, 2] += 0.01 * torch.randn((S,), generator=generator, device=dev)
    a = yaw_range * (2.0 * torch.rand((S,), generator=generator, device=dev)
                     - 1.0)
    axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(S, 3)
    q[:, 3:7] = spatial.quat_mul(spatial.quat_from_axis_angle(axis, a),
                                 q[:, 3:7])
    return q


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--eval_ticks", type=int, default=400)
    ap.add_argument("--out", default="runs/torch_distill_cmd")
    ap.add_argument("--robot", default="go1", choices=["go1", "opendog"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max_modes", type=int, default=None,
                    help="clamp the curriculum to its first N modes")
    ap.add_argument("--anchor_w", type=float, default=15.0,
                    help="expert anchor weight on the plan's deviation from "
                         "u_ref(t, cmd) (0: a free expert)")
    ap.add_argument("--payload_hi", type=float, default=0.0,
                    help="> 0 also randomises an unobserved trunk payload "
                         "in [0, payload_hi] kg per scenario (kernel engine, "
                         "on the card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from opendog_tpu_torch.device import resolve_device
    from opendog_tpu_torch.physics import State, dynamics, make_state, spatial
    from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
    from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    from opendog_tpu_torch.utils.cmd_tracking import segment_record

    dev = resolve_device(args.device)
    engine = "kernel" if dev.type == "cuda" else "ops"
    setup = cmd_distill_setup(args.robot, engine=engine, device=dev)
    grid = EVAL_CMDS_BY_ROBOT[args.robot]
    curriculum = CURRICULUM_BY_ROBOT[args.robot]
    # per-robot tracking thresholds, scaled by the nominal trot speed
    v_scale = 1.0 if args.robot == "go1" else 0.28 / 0.5
    thr_vx, thr_stand, thr_yaw = 0.12 * v_scale, 0.07 * v_scale, 0.2
    jit_cmd = 0.05 * v_scale
    if args.smoke:
        args.rounds, args.ticks, args.eval_ticks = 1, 2, 3
        args.scenarios = min(args.scenarios, 2)
        setup = setup._replace(mppi_config=MPPIConfig(
            horizon=3, num_samples=8, n_substeps=1, rollout_dt=0.01,
            engine=engine))
    m, cost, u_ref, obs_fn, net = (setup.model, setup.cost, setup.u_ref,
                                   setup.obs_fn, setup.net)
    mcfg, z_band = setup.mppi_config, setup.z_band
    S = args.scenarios
    dcfg = DistillConfig(num_scenarios=S, rollout_ticks=args.ticks,
                         rounds=args.rounds, lr=1e-3, batch_size=512,
                         epochs_per_round=8, beta_decay=0.93)
    use_payload = args.payload_hi > 0.0
    if use_payload and engine != "kernel":
        raise SystemExit("--payload_hi rides the substep kernel's payload "
                         "rows: run it on the card")
    distiller = make_distiller(
        m, cost, obs_fn, net, mppi_config=mcfg, config=dcfg,
        plant_substeps=10, action_ref_fn=u_ref, with_prev_ctrl=True,
        command_dim=3, anchor_w=args.anchor_w, device=dev,
        payload_range=((0.0, args.payload_hi) if use_payload else None))
    recipe = dict(setup.recipe, anchor_w=float(args.anchor_w),
                  **(dict(payload_range=[0.0, float(args.payload_hi)])
                     if use_payload else {}))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng_ctrl = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng_ctrl[:, 0], rng_ctrl[:, 1])
    s0, _ = dynamics.step(m, make_state(m, "home"), hold, None,
                          n_substeps=150)
    s0 = State(qpos=s0.qpos, qvel=torch.zeros_like(s0.qvel),
               time=torch.zeros((), device=dev))

    def plants_from(q):
        return State(qpos=q, qvel=torch.zeros(S, m.nv, device=dev),
                     time=torch.zeros(S, device=dev))

    plants0 = plants_from(jitter(torch, spatial, gen, s0.qpos, S))
    plants = plants_from(jitter(torch, spatial, gen, s0.qpos, S,
                                yaw_range=0.6))
    dstate = distiller.init(gen, s0)

    rng = np.random.default_rng(args.seed)
    buf_obs, buf_lab = [], []
    t0 = time.time()
    loss = float("nan")
    for r in range(args.rounds):
        frac = r / max(1, args.rounds - 1)
        # the expert keeps driving at least 20% of the ticks
        beta = max(0.2, dcfg.beta_decay ** r)
        cmds = torch.from_numpy(sample_commands(
            rng, S, frac, args.max_modes, curriculum=curriculum,
            jitter=jit_cmd)).to(dev)
        payloads = (torch.from_numpy(rng.uniform(0.0, args.payload_hi, S)
                                     .astype(np.float32)).to(dev)
                    if use_payload else None)
        plants, _, _, obs, labels = distiller.collect(
            dstate, plants, mppi.init_state(m, mcfg, scenarios=S), beta,
            payloads, cmds)
        buf_obs.append(obs)
        buf_lab.append(labels)
        all_obs, all_lab = torch.cat(buf_obs), torch.cat(buf_lab)
        for _ in range(3):
            idx = torch.from_numpy(rng.integers(0, all_obs.shape[0],
                                                TRAIN_N)).to(dev)
            dstate, loss_t = distiller.train_on(dstate, all_obs[idx],
                                                all_lab[idx])
        loss = float(loss_t)
        print(f"round {r}: loss {loss:.4f} beta {beta:.3f} frac {frac:.2f} "
              f"cmds vx={np.round(cmds[:, 0].cpu().numpy(), 2).tolist()} "
              f"buffer {all_obs.shape[0]} ({time.time() - t0:.0f}s)",
              flush=True)
        if (r + 1) % 4 == 0:
            # fresh start-yaw draws each reset
            plants = plants_from(jitter(torch, spatial, gen, s0.qpos, S,
                                        yaw_range=0.6))
    for _ in range(20):
        idx = torch.from_numpy(rng.integers(0, all_obs.shape[0],
                                            TRAIN_N)).to(dev)
        dstate, loss_t = distiller.train_on(dstate, all_obs[idx],
                                            all_lab[idx])
    loss = float(loss_t)
    print(f"final fit loss {loss:.4f}", flush=True)

    # save the student before the eval
    os.makedirs(args.out, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in dstate.params.items()},
               os.path.join(args.out, "student.pt"))

    print("student-only eval over the command grid...", flush=True)
    eval_cmds = torch.tensor([grid[i % len(grid)] for i in range(S)],
                             device=dev)

    def eval_grid(payload):
        pl = (torch.full((S,), payload, device=dev)
              if payload is not None else None)
        out = distiller.eval_fn(dstate, plants0, args.eval_ticks, pl,
                                eval_cmds)
        qpos_traj = out["qpos_traj"].cpu().numpy()   # (T, S, nq)
        z = qpos_traj[:, :, 2]
        upright = ((z > z_band[0]) & (z < z_band[1])).all(axis=0)
        per = []
        for i, c in list(enumerate(eval_cmds.cpu().numpy()))[:len(grid)]:
            quat = torch.from_numpy(qpos_traj[-1, i, 3:7])
            yaw = float(spatial.euler_from_quat(quat)[2])
            rec = segment_record(qpos_traj[:, i, :2], yaw, c)
            rec["mean_vx"] = rec.pop("mean_vx_cmd_frame")
            rec["final_yaw"] = rec.pop("yaw_end")
            rec["upright"] = bool(upright[i])
            if payload is not None:
                rec["payload_kg"] = round(float(payload), 2)
            per.append(rec)
            print(json.dumps(rec), flush=True)
        speeds_tracked = sum(1 for p in per if p["upright"]
                             and p["cmd"][2] == 0.0 and p["vx_err"] < thr_vx)
        heading_ok = [p for p in per if p["cmd"][2] != 0.0
                      and p["upright"] and p["yaw_err"] < thr_yaw]
        return dict(
            per_command=per,
            action_rmse=float(out["action_rmse"]),
            speeds_tracked=speeds_tracked,
            headings_tracked=len(heading_ok),
            upright_all=bool(upright.all()),
            tracks_3_speeds_and_turns=bool(
                speeds_tracked >= 3
                and any(p["cmd"][0] == 0.0 and p["vx_err"] < thr_stand
                        and p["upright"] for p in per)
                and len(heading_ok) >= 2),
        )

    device = dict(platform=dev.type, kind=(torch.cuda.get_device_name(dev)
                                           if dev.type == "cuda" else "cpu"))
    if use_payload:
        levels = [0.0, args.payload_hi / 2, args.payload_hi]
        grids = {f"payload_{p:g}kg": eval_grid(p) for p in levels}
        res = dict(rounds=args.rounds, final_loss=loss,
                   eval_ticks=args.eval_ticks, payload_levels=levels, **grids,
                   tracks_grid_at_all_payloads=bool(all(
                       g["tracks_3_speeds_and_turns"]
                       for g in grids.values())),
                   upright_all=bool(all(g["upright_all"]
                                        for g in grids.values())))
    else:
        g = eval_grid(None)
        res = dict(rounds=args.rounds, final_loss=loss,
                   eval_ticks=args.eval_ticks, **g)
    res.update(wall_s=round(time.time() - t0, 1), recipe=recipe,
               device=device, smoke=bool(args.smoke))
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items() if k != "per_command"}),
          flush=True)
    if not (math.isfinite(loss) and all(
            math.isfinite(p["mean_vx"]) for p in res.get("per_command", []))):
        raise SystemExit("non-finite loss or trajectory")


if __name__ == "__main__":
    main()
