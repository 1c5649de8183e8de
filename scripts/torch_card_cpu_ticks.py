#!/usr/bin/env python
"""Where the card and the CPU part on the application scripts whose
outcome on the card differs from the JAX record.  Each arm runs one
script's path on the card and on the CPU in one process, from the same
start, the same parameters and the same draws (standard normals drawn once
on the CPU from a seed), and reports tick by tick the largest difference
of qpos between the two:

  jump     scripts/torch_jump_mpc.py's ``run`` at its defaults (K=512,
           H=50, the op-graph solve on the jump box) for 12 ticks;
  landing  scripts/torch_ilqr_gait.py's landing cycles at their defaults
           (H=40, 5 iterations, two cycles of 40 tracked ticks; no draws);
  payload  scripts/torch_distill_walk.py --payload_max 1's distiller (S=8
           experts at K=512, H=25 and the plant on the payload kernel, K2):
           5 ticks of round 0 (beta 1: the experts drive) from the
           script's start poses and payloads, then 5 student-only eval
           ticks of ``--payload_student`` (a ``student.pt`` that script
           wrote) with its eval payloads;
  trot     the same for the Go1 trot distillation without a payload (the
           flat kernel, K1) and ``--trot_student``.

On the CPU the kernel engine runs the kernel's plain version, which the CPU
tests hold to the JAX package.  A fault of the card's path shows as a gap
at the first tick; float32 rounding starts near 1e-7 and grows where the
task amplifies it.  Run from the repository root on a card (the CPU's side
takes most of the time: about 5 s a jump tick, 14 s a payload tick):

    python3 scripts/torch_card_cpu_ticks.py [--arms jump landing payload trot]

Prints one JSON line per arm (each pair of values: the card's, then the
CPU's) and writes them, with the card's name and power limit, to
``--out`` (default ``runs/torch_card_cpu_ticks/metrics.json``, kept out of
git).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import open_device, settled, write_metrics  # noqa

PAYLOAD_MAX = {"payload": 1.0, "trot": 0.0}  # kg, the records' --payload_max
S = 8               # the distillation script's scenarios
JUMP_TICKS = 12     # past the tick where the card and the CPU part
DISTILL_TICKS = 5   # collect and eval ticks: ~14 s each on the CPU


def parting(pair, **extra):
    """The record of two (T, ...) qpos trajectories, the card's and the
    CPU's: the largest |card - cpu| of each tick and the first tick
    (1-based) past 1e-4 and past 1e-2."""
    card, cpu = (np.asarray(q, np.float64) for q in pair)
    d = np.abs(card - cpu)
    d = d.reshape(d.shape[0], -1).max(axis=1)

    def first(tol):
        over = np.nonzero(d > tol)[0]
        return int(over[0]) + 1 if over.size else None

    return {"ticks": int(d.shape[0]),
            "max_abs_qpos_per_tick": [float(v) for v in d],
            "first_tick_over_1e-4": first(1e-4),
            "first_tick_over_1e-2": first(1e-2), **extra}


def jump_arm(devices, ticks, seed=0):
    import torch
    import torch_jump_mpc as jump
    from opendog_tpu_torch.assets import load_go1
    cfg = jump.CONFIG
    nu = load_go1("jump", device="cpu").nu
    normals = torch.randn((ticks, cfg["num_samples"], cfg["horizon"], nu),
                          generator=torch.Generator().manual_seed(seed))
    qps = [jump.run(load_go1("jump", device=dev), ticks, cfg,
                    normals=normals.to(dev))[0] for dev in devices]
    return parting(qps, normals_seed=seed,
                   final_qpos3=[q[-1, :3].tolist() for q in qps])


def landing_arm(devices):
    import torch_ilqr_gait as ilqr
    from opendog_tpu_torch.assets import load_go1
    qps, finals = [], []
    for dev in devices:
        plant, _, _, qpos = ilqr.landing_cycles(load_go1("flat", device=dev))
        qps.append(qpos.cpu().numpy())
        finals.append(plant.qpos[:3].cpu().tolist())
    return parting(qps, final_qpos3=finals)


def on(x, dev):
    return None if x is None else x.to(dev)


def distill_arm(devices, student, payload_max, collect_ticks, eval_ticks,
                seed=0):
    import torch
    import torch_distill_walk as walk
    from opendog_tpu_torch.physics import State
    from opendog_tpu_torch.solvers import mppi
    cpu = devices[-1]
    setup = walk.walk_setup("go1", cpu)
    m, mcfg = setup.model, setup.mppi_config
    s0 = settled(m)
    qpos0 = walk.jitter(m, s0.qpos, S, torch.Generator().manual_seed(7))
    payloads = eval_payloads = None
    if payload_max > 0:
        payloads = torch.from_numpy(np.random.default_rng(0).uniform(
            0.0, payload_max, S).astype(np.float32))
        eval_payloads = torch.linspace(0.0, payload_max, S)
    gen = torch.Generator().manual_seed(seed)
    shape = (S, mcfg.num_samples, mcfg.horizon, m.nu)
    normals = torch.randn((collect_ticks,) + shape, generator=gen)
    eval_normals = torch.randn((eval_ticks,) + shape, generator=gen)
    params = torch.load(student, map_location="cpu")
    out = []
    for dev in devices:
        setup = walk.walk_setup("go1", dev)
        _, d = walk.walk_distiller(setup, S, collect_ticks, 1, payload_max,
                                   dev)
        start = State(qpos=qpos0.to(dev), qvel=torch.zeros(S, m.nv,
                                                            device=dev),
                      time=torch.zeros(S, device=dev))
        dstate = d.init(None, State(qpos=s0.qpos.to(dev),
                                    qvel=s0.qvel.to(dev),
                                    time=s0.time.to(dev)), params=params)
        trace = {}
        d.collect(dstate, start, mppi.init_state(setup.model, mcfg,
                                                 scenarios=S), 1.0,
                  on(payloads, dev), normals=normals.to(dev),
                  drive=torch.ones((collect_ticks, S, 1), dtype=torch.bool,
                                   device=dev), trace=trace)
        ev = d.eval_fn(dstate, start, eval_ticks, on(eval_payloads, dev),
                       normals=eval_normals.to(dev))
        out.append(dict(collect=trace["qpos"].cpu().numpy(),
                        eval=ev["qpos_traj"].cpu().numpy(),
                        rmse=float(ev["action_rmse"])))
    return dict(student=student, payload_max_kg=payload_max,
                normals_seed=seed,
                collect=parting([o["collect"] for o in out]),
                eval=parting([o["eval"] for o in out],
                             action_rmse=[o["rmse"] for o in out]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="*",
                    default=["jump", "landing", "payload", "trot"])
    ap.add_argument("--payload_student",
                    default="runs/torch_distill_go1_payload/student.pt")
    ap.add_argument("--trot_student",
                    default="runs/torch_distill_go1/student.pt")
    ap.add_argument("--out",
                    default="runs/torch_card_cpu_ticks/metrics.json")
    args = ap.parse_args(argv)
    import torch
    start = time.perf_counter()
    card, line = open_device(None)
    devices = (card, torch.device("cpu"))
    res = dict(device=line, cpu_threads=torch.get_num_threads())
    for arm in args.arms:
        t0 = time.perf_counter()
        if arm == "jump":
            rec = jump_arm(devices, JUMP_TICKS)
        elif arm == "landing":
            rec = landing_arm(devices)
        elif arm in PAYLOAD_MAX:
            rec = distill_arm(devices, getattr(args, f"{arm}_student"),
                              PAYLOAD_MAX[arm], DISTILL_TICKS,
                              DISTILL_TICKS)
        else:
            raise SystemExit(f"unknown arm {arm}")
        res[arm] = dict(rec, seconds=time.perf_counter() - t0)
        print(json.dumps({"arm": arm, **res[arm]}), flush=True)
    res["seconds"] = time.perf_counter() - start
    write_metrics(args.out, res)


if __name__ == "__main__":
    main()
