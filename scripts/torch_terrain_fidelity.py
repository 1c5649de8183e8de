#!/usr/bin/env python
"""Terrain planning fidelity on the port: the counterpart of
scripts/terrain_fidelity.py.

The kernel's terrain MPC plans on tangent planes of the heightfield while
the plant integrates the exact bilinear terrain.  On the same rough
terrains (generated from ``torch.Generator`` seeds; a flat draw is skipped
by adding 100 to the seed), the OpenDOG trot MPC walks ``--ticks`` 50 Hz
ticks with the planner on

  * the exact terrain: op-graph rollouts (``engine="ops"``, the JAX
    ``"xla"``), bilinear contact;
  * the local tangent plane under the trunk, recomputed every solve: the
    substep kernel K3 (``engine="kernel"``, ``plane_mode="trunk"``);
  * each paw's own tangent plane: K4 (``plane_mode="per_geom"``);

or, with ``--plane_xla``, the exact arm and a static-plane arm (op-graph
rollouts on the tangent plane at the start, a cruder stand-in that bounds
the local-plane approximation from below).  The plant is always the
op-graph step on the exact terrain, 10 substeps of 2 ms.  Per arm and
seed: distance, the realised plant cost and success (the trunk within its
band above the terrain under it).  On the card each tick replays one CUDA
graph.  Run from the repository root:

    python3 scripts/torch_terrain_fidelity.py                # the card
    python3 scripts/torch_terrain_fidelity.py --device cpu --smoke

Writes the JAX script's summary (plus ``seconds``; ``device`` is the
card's name and power limit, or ``cpu``) to ``--out`` (default
``runs/torch_terrain_fidelity/metrics.json``, kept out of git).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (Replayed, hold_ctrl, open_device,  # noqa
                              write_metrics)

BASE_H = 0.151           # flat-episode terrain height (physics/terrain.py)
CONFIG = dict(horizon=25, num_samples=256, n_substeps=2, rollout_dt=0.01,
              noise_sigma=0.10, temperature=0.2)
SMOKE = dict(CONFIG, horizon=5, num_samples=16, n_substeps=1)
ARM_ENGINES = {"exact": ("ops", "trunk"), "static_plane": ("ops", "trunk"),
               "local_plane": ("kernel", "trunk"),
               "per_geom": ("kernel", "per_geom")}


def fidelity_params():
    from opendog_tpu_torch.solvers import costs
    return costs.TrotCostParams(desired_vel_xy=(0.2, 0.0),
                                target_height=0.0665 + BASE_H,
                                thigh_amp=0.12, knee_lift=0.25,
                                w_height=80.0)


def height_under(model, terr, xy):
    """Ground height under (n, 2) xy points, numpy."""
    import torch
    from opendog_tpu_torch.physics.dynamics import _terrain_height_normal
    h, _ = _terrain_height_normal(model, terr, torch.as_tensor(
        np.asarray(xy, np.float32), device=model.device))
    return h.cpu().numpy()


def fidelity_cost(model, terr):
    """The trot cost at the start's terrain height."""
    from dataclasses import replace
    from opendog_tpu_torch.solvers import costs
    h0 = float(height_under(model, terr, np.zeros((1, 2)))[0])
    return costs.trot_cost(model, replace(fidelity_params(),
                                          target_height=0.0665 + h0),
                           model.key_qpos[0, 7:], legs="opendog")


def rough_terrain(model, seed):
    """A non-flat generated terrain (relief > 5 cm): the seed's, else the
    seed plus 100, 200, ...; (terrain, seed used)."""
    import torch
    from opendog_tpu_torch.physics.terrain import generate_terrain
    k = seed
    while True:
        t = generate_terrain(model, torch.Generator().manual_seed(k))
        if float(t.height.max() - t.height.min()) > 0.05:
            return t, k
        k += 100


def static_plane(model, terr):
    """A 2 x 2 heightfield whose bilinear interpolation is the tangent
    plane of ``terr`` at the start (the origin)."""
    import torch
    from opendog_tpu_torch.physics import Terrain
    from opendog_tpu_torch.physics.dynamics import _terrain_height_normal
    h0, n = _terrain_height_normal(model, terr, torch.zeros(
        (1, 2), device=model.device))
    h0, n = float(h0[0]), n[0].cpu().numpy()
    dhdx, dhdy = -n[0] / n[2], -n[1] / n[2]
    sx, sy = (float(v) for v in model.numpy("hfield_size")[:2])
    xs, ys = np.array([-sx, sx]), np.array([-sy, sy])
    grid = h0 + dhdx * xs[None, :] + dhdy * ys[:, None]
    return Terrain(height=torch.tensor(grid, dtype=torch.float32,
                                       device=model.device))


def settled_start(model, terr):
    """Home placed 8 cm above the ground under the origin and settled for
    25 ticks under the held home control on the exact terrain."""
    from opendog_tpu_torch.physics import dynamics, make_state
    s = make_state(model, "home")
    s.qpos[2] = 0.08 + float(height_under(model, terr, np.zeros((1, 2)))[0])
    for _ in range(25):
        s, _ = dynamics.step(model, s, hold_ctrl(model), terr, n_substeps=10)
    return s


def run_arm(model, arm, terr, seed, cost, ticks, config=CONFIG,
            normals=None, graphs=None, start=None):
    """One arm on one terrain from ``start`` (default
    :func:`settled_start`): the plant's qpos (ticks, nq) and realised cost
    (ticks,), numpy.  ``normals`` (ticks, K, H, nu) injects every solve's
    draw; otherwise a generator seeded with ``seed`` draws them."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    engine, plane_mode = ARM_ENGINES[arm]
    cfg = MPPIConfig(engine=engine, **config)
    planner = static_plane(model, terr) if arm == "static_plane" else terr
    solve = mppi.make_solver(model, cost, cfg, device=model.device,
                             terrain=planner, plane_mode=plane_mode)

    def tick(qpos, qvel, time, nominal, prev, nrm):
        st = State(qpos=qpos, qvel=qvel, time=time)
        ctrl, ms, _ = solve(st, mppi.MPPIState(nominal=nominal), None, nrm)
        st2, _ = dynamics.step(model, st, ctrl, terr, n_substeps=10)
        return (st2.qpos, st2.qvel, st2.time, ms.nominal, ctrl,
                cost(st2, ctrl, prev))

    tick = Replayed(tick, model.device, graphs)
    s = settled_start(model, terr) if start is None else start
    qpos, qvel, t = s.qpos, s.qvel, s.time
    nominal, prev = mppi.init_state(model, cfg).nominal, hold_ctrl(model)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    shape = (cfg.num_samples, cfg.horizon, model.nu)
    qs, cs = [], []
    for i in range(ticks):
        nrm = normals[i] if normals is not None else torch.randn(
            shape, generator=gen, device=model.device)
        qpos, qvel, t, nominal, prev, c = tick(qpos, qvel, t, nominal, prev,
                                               nrm)
        qs.append(qpos.clone())
        cs.append(c.clone())
    return torch.stack(qs).cpu().numpy(), torch.stack(cs).cpu().numpy()


def arm_record(qpos, c_real, h_under):
    """The JAX script's record of one arm's run on one terrain."""
    rel_z = qpos[:, 2] - h_under
    success = bool(np.isfinite(qpos).all()
                   and (rel_z > 0.03).all() and (rel_z < 0.15).all())
    return dict(final_x=round(float(qpos[-1, 0]), 4),
                realized_cost_mean=round(float(c_real.mean()), 2),
                min_rel_z=round(float(rel_z.min()), 4),
                success=success)


def agg(rs):
    return dict(
        final_x_mean=round(float(np.mean([r["final_x"] for r in rs])), 4),
        realized_cost_mean=round(float(np.mean(
            [r["realized_cost_mean"] for r in rs])), 2),
        success_rate=round(float(np.mean([r["success"] for r in rs])), 3),
    )


def summarize(per_arm, arms, ticks, device):
    """The JAX script's summary of the arms' per-seed records."""
    plane_arm = arms[1]
    summary = {
        "metric": "terrain_planning_fidelity",
        "ticks": ticks,
        "plane_arm": plane_arm,
        "exact": agg(per_arm["exact"]),
        "per_seed": per_arm,
        "device": device,
    }
    for a in arms[1:]:
        summary[a] = agg(per_arm[a])
    e = summary["exact"]

    def ratio(arm, key):
        return (round(summary[arm][key] / e[key], 3) if e[key] else None)

    summary["distance_ratio_plane_vs_exact"] = ratio(plane_arm,
                                                     "final_x_mean")
    summary["cost_ratio_plane_vs_exact"] = ratio(plane_arm,
                                                 "realized_cost_mean")
    if "per_geom" in summary:
        summary["distance_ratio_pergeom_vs_exact"] = ratio(
            "per_geom", "final_x_mean")
        summary["cost_ratio_pergeom_vs_exact"] = ratio(
            "per_geom", "realized_cost_mean")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ticks", type=int, default=250)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 2, 4])
    p.add_argument("--out", default="runs/torch_terrain_fidelity/"
                                    "metrics.json")
    p.add_argument("--smoke", action="store_true",
                   help="3 ticks, one seed, K=16, H=5, one substep")
    p.add_argument("--plane_xla", action="store_true",
                   help="the static-plane op-graph arm in place of the "
                        "kernel arms")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    from opendog_tpu_torch.assets import load_opendog

    start = time.perf_counter()
    dev, line = open_device(args.device)
    m = load_opendog("terrain", device=dev)
    ticks = 3 if args.smoke else args.ticks
    seeds = args.seeds[:1] if args.smoke else args.seeds
    arms = (["exact", "static_plane"] if args.plane_xla
            else ["exact", "local_plane", "per_geom"])
    per_arm = {a: [] for a in arms}
    for seed in seeds:
        terr, k = rough_terrain(m, seed)
        terr = terr.to(dev)
        relief = float(terr.height.max() - terr.height.min())
        cost = fidelity_cost(m, terr)
        s0 = settled_start(m, terr)   # every arm starts from this stance
        for a in arms:
            qpos, c_real = run_arm(m, a, terr, seed, cost, ticks,
                                   SMOKE if args.smoke else CONFIG,
                                   start=s0)
            r = arm_record(qpos, c_real, height_under(m, terr,
                                                      qpos[:, :2]))
            r.update(seed=seed, terrain_key=k, relief=round(relief, 3))
            per_arm[a].append(r)
            print(f"[terrain_fidelity] {a} seed {seed}: {json.dumps(r)}",
                  file=sys.stderr, flush=True)
    summary = summarize(per_arm, arms, ticks, line)
    summary["seconds"] = time.perf_counter() - start
    write_metrics(args.out, summary)


if __name__ == "__main__":
    main()
