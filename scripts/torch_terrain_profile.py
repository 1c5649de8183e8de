#!/usr/bin/env python
"""The terrain MPC tick (bench 2c) taken apart on the port: the
counterpart of scripts/terrain_profile.py.

Each piece of the OpenDOG terrain tick (K=256, H=25, 2 x 10 ms rollouts on
the trunk's tangent plane, the exact bilinear plant of 10 x 2 ms) is timed
alone on the same card:

  full_tick_ms          the composed MPC tick (``make_mpc(terrain=...)``)
  solve_only_ms         the MPPI solve on the kernel's plane lanes (K3)
  plant_only_ms         one 50 Hz plant tick: 10 op-graph substeps on the
                        exact terrain
  plant_pallas_flat_ms  the plant on the flat kernel K1 at K=1 x 10 (the
                        JAX script's name for it)
  plane_only_ms         the tangent plane under the trunk
  flat_solve_only_ms    the same solve on flat ground (K1): the plane
                        lanes' cost is the difference

On the card each piece replays one CUDA graph and is timed with CUDA
events over ``--reps`` calls after ``torch.cuda.synchronize()``; on the CPU
the host clock times the plain versions.  Run from the repository root:

    python3 scripts/torch_terrain_profile.py              # the card
    python3 scripts/torch_terrain_profile.py --device cpu --smoke

Writes ``metrics.json`` (the JAX script's keys, plus ``device``: the
card's name and power limit, or ``cpu``, also in ``_provenance``, and
``seconds``) under ``--out`` (default ``runs/torch_terrain_profile``,
kept out of git).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (Replayed, mpc_tick, open_device,  # noqa
                              write_metrics)

CONFIG = dict(horizon=25, num_samples=256, n_substeps=2, rollout_dt=0.01,
              noise_sigma=0.08, engine="kernel")
SMOKE = dict(CONFIG, horizon=3, num_samples=8, n_substeps=1)
TERRAIN_SEED = 5
BASE_H = 0.151


def ms_per_call(fn, reps, device):
    """Mean milliseconds of ``fn()``: CUDA events on the card, the host
    clock elsewhere, after one warm-up call."""
    if device.type == "cuda":
        from opendog_tpu_torch.utils.profiling import event_ms
        return event_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def profile(dev, config=CONFIG, reps=50):
    """The six pieces' milliseconds."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.physics import State, dynamics, make_state
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc, mppi
    m = load_opendog("terrain", device=dev)
    mf = load_opendog("flat", device=dev)
    terr = terrain_lib.generate_terrain(
        m, torch.Generator().manual_seed(TERRAIN_SEED)).to(dev)
    cost = costs.standing_cost(m, 0.0694 + BASE_H, m.key_qpos[0, 7:])
    cfg = MPPIConfig(**config)
    s0 = make_state(m, "home")
    s0.qpos[2] += BASE_H
    shape = (cfg.num_samples, cfg.horizon, m.nu)
    normals = torch.randn(shape, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    out = {}

    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10, terrain=terr,
                             device=dev)
    carry = init(torch.Generator(device=dev).manual_seed(0), s0)
    gtick = mpc_tick(tick, carry, shape)
    out["full_tick_ms"] = ms_per_call(lambda: gtick(carry, normals), reps,
                                      dev)

    def solve_piece(model):
        solve = mppi.make_solver(model, cost, cfg, device=dev,
                                 terrain=terr if model is m else None)

        def fn(qpos, qvel, time, nominal, nrm):
            ctrl, ms, _ = solve(State(qpos=qpos, qvel=qvel, time=time),
                                mppi.MPPIState(nominal=nominal), None, nrm)
            return ctrl, ms.nominal

        return Replayed(fn, dev)

    ms0 = mppi.init_state(m, cfg).nominal
    args = (s0.qpos, s0.qvel, s0.time, ms0, normals)
    solve = solve_piece(m)
    out["solve_only_ms"] = ms_per_call(lambda: solve(*args), reps, dev)

    hold = m.key_ctrl[0]
    plant = Replayed(lambda qp, qv, t: dynamics.step(
        m, State(qpos=qp, qvel=qv, time=t), hold, terr,
        n_substeps=10)[0].qpos, dev)
    out["plant_only_ms"] = ms_per_call(
        lambda: plant(s0.qpos, s0.qvel, s0.time), reps, dev)

    psub = cuda_step.build_cuda_substep(mf, mf.timestep, n_substeps=10,
                                        device=dev)
    qp0, qv0 = s0.qpos[:, None].contiguous(), s0.qvel[:, None].contiguous()
    u0 = hold[:, None].contiguous()
    out["plant_pallas_flat_ms"] = ms_per_call(lambda: psub(qp0, qv0, u0),
                                              reps, dev)

    plane = Replayed(lambda qp: dynamics._terrain_height_normal(
        m, terr, qp[None, :2]), dev)
    out["plane_only_ms"] = ms_per_call(lambda: plane(s0.qpos), reps, dev)

    solve_f = solve_piece(mf)
    out["flat_solve_only_ms"] = ms_per_call(lambda: solve_f(*args), reps,
                                            dev)
    return out


def derive(out):
    """The JAX script's derived numbers."""
    return {
        "solves_per_s_full_tick": round(1e3 / out["full_tick_ms"], 1),
        "plant_share_of_tick": round(
            out["plant_only_ms"] / out["full_tick_ms"], 3),
        "plane_lane_overhead_ms": round(
            out["solve_only_ms"] - out["flat_solve_only_ms"], 3),
        "plant_xla_vs_pallas_ratio": round(
            out["plant_only_ms"] / max(out["plant_pallas_flat_ms"], 1e-9), 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/torch_terrain_profile")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="K=8, H=3, one substep, 1 rep")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    start = time.perf_counter()
    dev, line = open_device(args.device)
    out = {k: round(v, 3) for k, v in profile(
        dev, SMOKE if args.smoke else CONFIG,
        1 if args.smoke else args.reps).items()}
    out["derived"] = derive(out)
    out["_provenance"] = dict(recorded_at=time.strftime("%Y-%m-%dT%H:%M:%S"),
                              device=line)
    out.update(device=line, seconds=time.perf_counter() - start)
    write_metrics(os.path.join(args.out, "metrics.json"), out)


if __name__ == "__main__":
    main()
