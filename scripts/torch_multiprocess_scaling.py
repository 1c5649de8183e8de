#!/usr/bin/env python
"""Multi-process weak scaling on the port: the counterpart of
scripts/multiprocess_scaling.py.

Starts N ranks (one process each, one card per rank over NCCL; ``--device
cpu``: gloo ranks on the CPU) through ``parallel.initialize_distributed``
and measures, per N, two sharded programs at a fixed amount of work per
rank (weak scaling):

  * mppi: sample-sharded MPPI (``mppi.make_solver(mesh=sample_mesh(N))``)
    on OpenDOG flat with ``standing_cost``, ``--samples`` (64) rollouts per
    rank, H = ``--horizon`` (10), 2 x 10 ms substeps on the substep kernel
    (K1), sigma 0.08.  Every rank takes the same global normals (a seeded
    generator on the CPU).  ``--ticks`` (10) receding solves are timed after
    one untimed window; on the card each solve replays one CUDA graph
    (``mppi.graph_solve``) that holds its NCCL all_reduces;
  * envs: 128 x N OpenDOG envs, each rank stepping
    its block (``parallel.shard_batch``) through the op-graph step for 10
    x 2 ms substeps a tick under the home control, ``--ticks`` ticks a
    window, each tick replayed from one CUDA graph on the card.  The
    program has no collective: a weak-scaling loss here is host or launch
    contention between ranks on one host, not communication.

A window is timed the same way on every rank (a barrier, the card
synchronised, the ticks, the card synchronised) and the slowest rank sets
the rate.  Run from the repository root:

    python3 scripts/torch_multiprocess_scaling.py            # 1, 2, 4 .. cards
    python3 scripts/torch_multiprocess_scaling.py --device cpu --nprocs 1 2

Writes ``metrics.json`` under ``--out`` (default
``runs/torch_multiprocess_scaling``, kept out of git): the JAX record's
keys (``mppi_weak_scaling`` and ``env_rollout_weak_scaling``: mode, nproc,
solves_per_sec or env_ticks_per_sec, samples_per_solve or envs,
best_cost, finite, weak_scaling_efficiency), plus ``device`` (the card's
name and power limit, or ``cpu``), ``backend``, ``host_cores`` and
``seconds``, and per entry each rank's CPU affinity and rank 0's kernel
launches over the timed window.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_multidev_common as common  # noqa: E402

SAMPLES = 64          # OPENDOG_SCALING_SAMPLES of the JAX worker
HORIZON = 10          # OPENDOG_SCALING_HORIZON
TICKS = 10            # solves or env ticks per window (the JAX N)
ENVS_PER_RANK = 128
ENV_SUBSTEPS = 10
TIMEOUT_S = 1200      # one case's ranks, rendezvous included
NOTE = ("N processes, one card each over NCCL (or gloo ranks on the CPU): "
        "sample-sharded MPPI (two all_reduces a solve, inside the replayed "
        "graph) and the dp-sharded env rollout (no collective: a loss there "
        "is host or launch contention between ranks on one host, not "
        "communication).  Each window ends in a synchronise of every "
        "rank's card and the slowest rank sets the rate.")


def mppi_setup(n, samples, horizon, device, mesh=None):
    """(model, config, solve) of the mppi mode at ``n`` ranks: OpenDOG flat,
    ``standing_cost(m, 0.0694, home joints)``, ``samples * n`` rollouts,
    sharded over ``mesh`` where one is given."""
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
    m = load_opendog("flat", device=device)
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=horizon, num_samples=samples * n, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.08)
    return m, cfg, mppi.make_solver(m, cost, cfg, device=device, mesh=mesh)


def mppi_normals(ticks, cfg, nu, seed=0):
    """The global (ticks, K, H, nu) normals, the same on every rank."""
    import torch
    return torch.randn((ticks, cfg.num_samples, cfg.horizon, nu),
                       generator=torch.Generator().manual_seed(seed))


def envs_start(model, B):
    """The envs mode's global start: the home qpos plus 0.02 standard
    normals of ``numpy.random.default_rng(0)`` (float32, as the JAX worker
    draws them), zero qvel and time, and the home control held."""
    import torch
    from opendog_tpu_torch.physics import State
    qpos = np.tile(model.numpy("key_qpos")[0].astype(np.float32), (B, 1))
    qpos += 0.02 * np.random.default_rng(0).standard_normal(
        qpos.shape).astype(np.float32)
    state = State(qpos=torch.from_numpy(qpos),
                  qvel=torch.zeros(B, model.nv), time=torch.zeros(B))
    return state, model.key_ctrl[0].cpu().expand(B, model.nu).clone()


def envs_tick(model):
    """One env tick: ``dynamics.step`` of every env for ENV_SUBSTEPS
    substeps under its control, on tensors (a CUDA graph's inputs)."""
    from opendog_tpu_torch.physics import State, dynamics

    def tick(qpos, qvel, time, ctrl):
        s, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=time),
                             ctrl, None, n_substeps=ENV_SUBSTEPS)
        return s.qpos, s.qvel, s.time
    return tick


def run_mppi(args, dev, n):
    """The mppi mode on this rank: (record, launches of the timed window,
    kernel rows)."""
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.parallel import sample_mesh
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import mppi
    mesh = sample_mesh(n, device=dev)
    m, cfg, solve = mppi_setup(n, args.samples, args.horizon, dev, mesh)
    state, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
    normals = mppi_normals(args.ticks, cfg, m.nu).to(dev)
    if dev.type == "cuda":
        solve = mppi.graph_solve(solve, state, ms0, normals[0])

    def solves():
        ms = ms0
        for x in normals:
            _, ms, stats = solve(state, ms, None, x)
        return stats["best_cost"]

    common.window(solves, mesh)      # untimed: loads, captures, warms
    cuda_step.LAUNCHES.clear()
    dt, best = common.window(solves, mesh)
    launches = dict(cuda_step.LAUNCHES)
    best = float(best.reshape(-1)[0])
    rec = dict(mode="mppi", nproc=n, solves_per_sec=args.ticks / dt,
               samples_per_solve=cfg.num_samples, best_cost=best,
               finite=bool(np.isfinite(best)))
    rows = []
    if dev.type == "cuda" and mesh.index == 0:
        rows.append(rollout_row(m, cfg, n, state, ms0, normals[0],
                                launches, "multiprocess mppi"))
    return rec, launches, rows


def rollout_row(m, cfg, n, state, ms0, normals, launches, label):
    """The ``kernels``-line row of K1 at this rank's rollout shape (K / n x
    n_substeps), on the first rollout step's inputs of rank 0's block."""
    import torch
    from opendog_tpu_torch.ops import cuda_step
    from torch_app_common import kernel_record
    K = cfg.num_samples // n
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    ctrl = torch.clamp(ms0.nominal[0] + cfg.noise_sigma * normals[:K, 0],
                       lo, hi)
    return kernel_record(
        label, m, cfg.rollout_dt, cfg.n_substeps,
        state.qpos[:, None].expand(m.nq, K).contiguous(),
        state.qvel[:, None].expand(m.nv, K).contiguous(),
        ctrl.T.contiguous(),
        launches.get(cuda_step.launch_key(K, cfg.n_substeps), 0))


def run_envs(args, dev, n):
    """The envs mode on this rank: (record, launches, no kernel rows)."""
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.parallel import env_mesh, shard_batch
    from torch_app_common import Replayed
    mesh = env_mesh(n, device=dev)
    m = load_opendog("flat", device=dev)
    B = ENVS_PER_RANK * n
    state, ctrl = envs_start(m, B)
    state, ctrl = shard_batch(mesh, (state, ctrl))
    tick = Replayed(envs_tick(m), dev)
    carry = [state.qpos, state.qvel, state.time]

    def ticks():
        nonlocal carry
        for _ in range(args.ticks):
            carry = tick(*carry, ctrl)
        return carry[0][0, 2]

    common.window(ticks, mesh)       # untimed: captures, warms
    cuda_step.LAUNCHES.clear()
    dt, z = common.window(ticks, mesh)
    launches = dict(cuda_step.LAUNCHES)
    z = float(z)
    return (dict(mode="envs", nproc=n, env_ticks_per_sec=B * args.ticks / dt,
                 envs=B, finite=bool(np.isfinite(z))), launches, [])


def rank_main(args):
    import torch.distributed as dist
    dev = common.join(args)
    run = run_mppi if args.mode == "mppi" else run_envs
    rec, launches, rows = run(args, dev, args.world)
    common.leave(args, dict(record=rec, launches=launches, kernels=rows,
                            backend=dist.get_backend(),
                            **common.host_record()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, nargs="*", default=None,
                    help="rank counts (default 1, 2, 4, .. up to the cards "
                         "present; on the CPU 1 and 2)")
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--horizon", type=int, default=HORIZON)
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--out", default="runs/torch_multiprocess_scaling")
    ap.add_argument("--mode", default=None, help=argparse.SUPPRESS)
    common.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    start = time.perf_counter()
    dev, line = common.prepare(args.device)
    cards = common.card_count(dev)
    nprocs = args.nprocs or ([1, 2] if cards == 0 else
                             [n for n in (1, 2, 4, 8, 16) if n <= cards])
    res = dict(provenance=dict(recorded_at=time.strftime("%Y-%m-%dT%H:%M:%S"),
                               plumbing_not_perf=dev.type != "cuda",
                               host_cores=os.cpu_count(), note=NOTE),
               device=line, backend=None, host_cores=os.cpu_count(),
               mppi_weak_scaling=[], env_rollout_weak_scaling=[], kernels=[])
    keys = dict(mppi="mppi_weak_scaling", envs="env_rollout_weak_scaling")
    for mode in ("mppi", "envs"):
        base = None
        for n in nprocs:
            child = ["--mode", mode, "--samples", str(args.samples),
                     "--horizon", str(args.horizon), "--ticks",
                     str(args.ticks)]
            if args.device is not None:
                child += ["--device", args.device]
            ranks = common.spawn(os.path.abspath(__file__), n, child,
                                 TIMEOUT_S)
            r = dict(ranks[0]["record"],
                     rank_affinity=[x["affinity"] for x in ranks],
                     launches=ranks[0]["launches"])
            res["backend"] = ranks[0]["backend"]
            res["kernels"] += ranks[0]["kernels"]
            metric = r.get("solves_per_sec") or r.get("env_ticks_per_sec")
            if mode == "envs":
                metric = metric / r["envs"]   # per-env rate (weak scaling)
            if base is None:
                base = metric
            r["weak_scaling_efficiency"] = metric / base
            res[keys[mode]].append(r)
            print(json.dumps(r), flush=True)
    res["seconds"] = time.perf_counter() - start
    common.write_metrics(os.path.join(args.out, "metrics.json"), res)


if __name__ == "__main__":
    main()
