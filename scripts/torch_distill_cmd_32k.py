#!/usr/bin/env python
"""One command-conditioned distill round at S = 32768 scenarios on one
card: the counterpart of scripts/distill_cmd_32k.py (BASELINE config 5's
scale axis).

One DAgger collect + train round of the command-conditioned distiller
(``rl/distill.py`` with ``rl/distill_zoo.cmd_distill_setup``) at S
scenarios, each with its own command from the whole curriculum
(``scripts/torch_distill_cmd.py``'s ``CURRICULUM_BY_ROBOT["go1"]``,
balanced over the scenarios), its own anchored MPPI expert and the student
trained on the round's (observation, label) set.  On the card the experts
keep the full 0.5 s horizon at K=16 samples: S x K = 524,288 rollout lanes
in one launch of the substep kernel K1 per rollout step, and the plant is
K1 at S lanes x 10 substeps; each collect tick replays one CUDA graph.  One
card, no mesh.  On the CPU (``--device cpu``) the experts are cut to K=8,
H=3, one substep and the plant to 5 substeps, as the JAX script's CPU
record is: plumbing, no performance claim.  Run from the repository root:

    python3 scripts/torch_distill_cmd_32k.py                 # the card
    python3 scripts/torch_distill_cmd_32k.py --device cpu --scenarios 4

Memory on the card at the defaults: the (S, K, H, nu) normals alone are
32768 x 16 x 25 x 12 x 4 B = 629 MB, and the solve holds about five such
arrays (normals, smoothed noise, candidates, the kernel's control rows).

Writes ``metrics.json`` under ``--out`` (default
``runs/torch_distill_cmd_32k``, kept out of git): the JAX script's record,
keyed by backend (``cuda`` or ``cpu``; records of the other backend already
there are kept), with ``device`` (the card's name and power limit, or
``cpu``) and ``seconds`` added.  On the card it also logs the records of
the kernel at this path's two shapes.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (kernel_record, open_device,  # noqa: E402
                              settled)
from torch_distill_cmd import CURRICULUM_BY_ROBOT  # noqa: E402

CURRICULUM = CURRICULUM_BY_ROBOT["go1"]


def curriculum_commands(S):
    """(S, 3) commands: the curriculum's modes balanced over the
    scenarios, no jitter."""
    modes = (np.arange(S) * len(CURRICULUM)) // S
    return np.stack(
        [np.array([CURRICULUM[i][0] for i in modes], np.float32),
         np.zeros(S, np.float32),
         np.array([CURRICULUM[i][1] for i in modes], np.float32)], axis=1)


def start_qpos(qpos, S, seed=0):
    """(S, nq) starts: the settled pose with joint noise of 0.03 rad and
    height noise of 1 cm, from a numpy generator."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(qpos, np.float32), (S, 1))
    q[:, 7:] += 0.03 * rng.standard_normal((S, q.shape[1] - 7))
    q[:, 2] += 0.01 * rng.standard_normal(S)
    return q.astype(np.float32)


def round_record(backend, S, ticks, mcfg, labels, t_collect, t_train, loss,
                 zs, provenance):
    """The JAX script's record of one round."""
    n = int(labels.shape[0])
    return dict(
        backend=backend,
        devices=1,
        scenarios=S,
        scenarios_per_device=S,
        ticks=ticks,
        expert_samples=mcfg.num_samples,
        horizon=mcfg.horizon,
        concurrent_rollout_lanes=S * mcfg.num_samples,
        labels_collected=n,
        collect_wall_s=round(t_collect, 2),
        labels_per_sec=round(n / t_collect, 1),
        train_wall_s=round(t_train, 2),
        distill_loss=round(loss, 4),
        all_finite=True,
        plants_upright_frac=round(float(((zs > 0.1) & (zs < 0.5)).mean()),
                                  3),
        provenance=provenance,
        recorded_at=time.strftime("%Y-%m-%dT%H:%M:%S"),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenarios", type=int, default=32768)
    ap.add_argument("--ticks", type=int, default=None,
                    help="collect ticks (default: 4 on the card, 2 on the "
                         "CPU)")
    ap.add_argument("--out", default="runs/torch_distill_cmd_32k")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch
    from dataclasses import replace
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.physics import State
    from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
    from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup
    from opendog_tpu_torch.solvers import MPPIConfig, mppi

    start = time.perf_counter()
    dev, line = open_device(args.device)
    on_card = dev.type == "cuda"
    S = args.scenarios
    ticks = args.ticks or (4 if on_card else 2)
    setup = cmd_distill_setup("go1", engine="kernel", device=dev)
    m = setup.model
    if on_card:
        # the full horizon at K = 16: S x K concurrent rollout lanes
        mcfg = replace(setup.mppi_config, num_samples=16)
        plant_substeps = 10
    else:
        mcfg = MPPIConfig(horizon=3, num_samples=8, n_substeps=1,
                          rollout_dt=0.01, noise_sigma=0.1, engine="kernel")
        plant_substeps = 5
    print(f"[32k] S={S} K={mcfg.num_samples} H={mcfg.horizon}: normals "
          f"{S * mcfg.num_samples * mcfg.horizon * m.nu * 4 / 1e6:.0f} MB",
          file=sys.stderr, flush=True)
    dcfg = DistillConfig(num_scenarios=S, rollout_ticks=ticks, rounds=1,
                         lr=1e-3, batch_size=4096, epochs_per_round=2)
    distiller = make_distiller(
        m, setup.cost, setup.obs_fn, setup.net, mppi_config=mcfg,
        config=dcfg, plant_substeps=plant_substeps,
        action_ref_fn=setup.u_ref, with_prev_ctrl=True, command_dim=3,
        anchor_w=15.0, device=dev)
    s0 = settled(m)
    plants = State(
        qpos=torch.from_numpy(start_qpos(s0.qpos.cpu().numpy(), S)).to(dev),
        qvel=torch.zeros(S, m.nv, device=dev),
        time=torch.zeros(S, device=dev))
    cmds = torch.from_numpy(curriculum_commands(S)).to(dev)
    mstates = mppi.init_state(m, mcfg, scenarios=S)
    dstate = distiller.init(torch.Generator(device=dev).manual_seed(0), s0)

    cuda_step.LAUNCHES.clear()
    t0 = time.perf_counter()
    plants2, _, _, obs, labels = distiller.collect(dstate, plants, mstates,
                                                   1.0, None, cmds)
    labels_np = labels.cpu().numpy()
    t_collect = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    if not (np.isfinite(labels_np).all()
            and bool(torch.isfinite(obs).all())):
        raise SystemExit("non-finite expert labels or observations")
    t1 = time.perf_counter()
    dstate, loss = distiller.train_on(
        dstate, obs, labels, generator=torch.Generator(device=dev)
        .manual_seed(1))
    loss = float(loss)
    t_train = time.perf_counter() - t1
    if not np.isfinite(loss):
        raise SystemExit(f"non-finite loss {loss}")
    print(f"[32k] kernel launches {launches}; collect {t_collect:.2f} s, "
          f"train {t_train:.2f} s", file=sys.stderr, flush=True)
    if on_card:
        print(f"[32k] peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              file=sys.stderr, flush=True)
        K = mcfg.num_samples

        def rows(x):
            """(S, n) per scenario -> (n, S K) per lane."""
            return x.repeat_interleave(K, 0).T.contiguous()

        # the expert's lanes: each scenario's state under its gait
        # reference with noise, as the solve's candidates are
        ref = setup.u_ref(plants2.time, cmds).repeat_interleave(K, 0)
        gen = torch.Generator(device=dev).manual_seed(2)
        ctrl = ref + 0.1 * torch.randn(ref.shape, generator=gen, device=dev)
        lim = m.actuator_ctrlrange
        ctrl = torch.clamp(ctrl, lim[:, 0], lim[:, 1]).T.contiguous()
        dt = mcfg.rollout_dt
        for rec in (
                kernel_record(
                    "32k expert", m, dt, mcfg.n_substeps, rows(plants2.qpos),
                    rows(plants2.qvel), ctrl, launches.get(
                        cuda_step.launch_key(S * K, mcfg.n_substeps), 0),
                    reps=5),
                kernel_record(
                    "32k plant", m, m.timestep, plant_substeps,
                    plants2.qpos.T.contiguous(),
                    plants2.qvel.T.contiguous(),
                    ctrl[:, ::K].contiguous(), launches.get(
                        cuda_step.launch_key(S, plant_substeps), 0))):
            print("[32k] kernel " + json.dumps(rec), file=sys.stderr,
                  flush=True)
    backend = "cuda" if on_card else "cpu"
    rec = round_record(
        backend, S, ticks, mcfg, labels_np, t_collect, t_train, loss,
        plants2.qpos[:, 2].cpu().numpy(),
        ("one card, full-horizon experts at K=16" if on_card else
         "CPU PLUMBING (tiny experts, no perf claim)"))
    rec.update(device=line, seconds=time.perf_counter() - start)
    print(json.dumps(rec), flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "metrics.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged[backend] = rec
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
