#!/usr/bin/env python
"""Multi-device scaling efficiency on the port (BASELINE.md: at least 80%
efficiency from 1 card to N): the counterpart of scripts/scaling_bench.py.

Measures the WalkEnv rollout's throughput (OpenDOG flat, zero actions)
with the env batch sharded over ``parallel.env_mesh(n)``: ``--envs-per-device``
(64) envs per rank, ``--steps`` (20) steps timed after one untimed window of
as many, each step replayed from one CUDA graph on the card.  The resets
take injected ``WalkResetDraws`` from a numpy seed.

The JAX script runs every device count in one process.  Here one world of
the largest count runs (one rank per card over NCCL; ``--device cpu``:
gloo ranks on the CPU) and makes ``env_mesh(n)`` for each count inside it,
in the same order on every rank (a new group is collective); ranks outside
a mesh wait at the barrier.  The step has no collective, so a loss of
efficiency is contention between ranks on one host, not communication.
Run from the repository root:

    python3 scripts/torch_scaling_bench.py                  # 1, 2, all cards
    python3 scripts/torch_scaling_bench.py --device cpu --device-counts 1 2

Prints the JAX script's lines and JSON (``env_steps_per_sec`` and
``efficiency`` = thr / (base x n) for each n; on the CPU
``sharding_path_ok`` in place of the efficiency, as the JAX script does on a
virtual mesh) and writes it, with ``device``, ``backend``, ``host_cores``,
``seconds`` and ``meets_80pct_target``, to ``--out`` (default
``runs/torch_scaling_bench/metrics.json``, kept out of git).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_multidev_common as common  # noqa: E402

TARGET = 0.8   # BASELINE.md:34
TIMEOUT_S = 1200   # the ranks, rendezvous included


def reset_draws(model, B, seed=0):
    """The global batch's ``WalkResetDraws`` from ``numpy.random.default_rng
    (seed)`` (float32 uniforms on the CPU)."""
    import torch
    from opendog_tpu_torch.envs.walk import WalkResetDraws
    rng = np.random.default_rng(seed)
    return WalkResetDraws(
        qpos_u=torch.from_numpy(rng.random((B, model.nq), np.float32)),
        vel_u=torch.from_numpy(rng.random((B, 3), np.float32)))


def env_step(env, template):
    """``env.step`` on the flattened env state (a CUDA graph's inputs): the
    new state's tensors and the reward summed over the rank's envs."""
    from opendog_tpu_torch.envs.base import tree_leaves, tree_map

    def step(actions, *leaves):
        it = iter(leaves)
        state = tree_map(lambda _: next(it), template)
        state, trans = env.step(state, actions)
        return (*tree_leaves(state), trans.reward.sum())
    return step


def run(args, dev, mesh, n):
    """env-steps/s of ``n`` ranks (max over the ranks of a window's time),
    and the rank's launches over the timed window."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.envs import WalkEnv
    from opendog_tpu_torch.envs.base import tree_leaves
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.parallel import shard_batch
    from torch_app_common import Replayed
    model = load_opendog("flat", device=dev)
    env = WalkEnv(model)
    B = args.envs_per_device * n
    draws = shard_batch(mesh, reset_draws(model, B))
    with torch.no_grad():
        states, _ = env.reset(draws)
    actions = torch.zeros(B // n, model.nu, device=dev)
    step = Replayed(env_step(env, states), dev)
    carry = tree_leaves(states)

    def steps():
        nonlocal carry
        with torch.no_grad():
            for _ in range(args.steps):
                *carry, reward = step(actions, *carry)
        return reward

    common.window(steps, mesh)       # untimed: captures, warms
    cuda_step.LAUNCHES.clear()
    dt, reward = common.window(steps, mesh)
    return B * args.steps / dt, bool(torch.isfinite(reward)), \
        dict(cuda_step.LAUNCHES)


def rank_main(args):
    import torch.distributed as dist
    from opendog_tpu_torch.parallel import env_mesh
    dev = common.join(args)
    out = {}
    for n in args.device_counts:
        mesh = env_mesh(n, device=dev)
        if mesh is not None:
            thr, finite, launches = run(args, dev, mesh, n)
            out[str(n)] = dict(env_steps_per_sec=thr, finite=finite,
                               launches=launches)
        dist.barrier()
    common.leave(args, dict(results=out, backend=dist.get_backend(),
                            **common.host_record()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs-per-device", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device-counts", type=int, nargs="*", default=None,
                    help="default: 1, 2 and the cards present (on the CPU "
                         "1 and 2)")
    ap.add_argument("--out", default="runs/torch_scaling_bench")
    common.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    start = time.perf_counter()
    dev, line = common.prepare(args.device)
    cards = common.card_count(dev)
    counts = args.device_counts or (
        [1, 2] if cards == 0 else sorted({1, 2, cards} & set(
            range(1, cards + 1))))
    counts = sorted(set(counts))
    child = ["--envs-per-device", str(args.envs_per_device), "--steps",
             str(args.steps), "--device-counts", *map(str, counts)]
    if args.device is not None:
        child += ["--device", args.device]
    ranks = common.spawn(os.path.abspath(__file__), max(counts), child,
                         TIMEOUT_S)
    virtual = dev.type != "cuda"
    results = {"virtual_mesh": virtual}
    base, effs = None, []
    for n in counts:
        r = ranks[0]["results"][str(n)]
        thr = r["env_steps_per_sec"]
        if base is None:
            base = thr
        eff = thr / (base * n)
        entry = dict(env_steps_per_sec=thr)
        if virtual:
            entry["sharding_path_ok"] = r["finite"]
        else:
            entry["efficiency"] = eff
            if n > 1:
                effs.append(eff)
        results[str(n)] = entry
        label = ("path-ok (CPU ranks, efficiency n/a)" if virtual
                 else f"efficiency={eff:.1%}")
        print(f"devices={n}: {thr:,.0f} env-steps/s  {label}", flush=True)
    print(json.dumps(results), flush=True)
    record = dict(results, device=line, backend=ranks[0]["backend"],
                  host_cores=os.cpu_count(),
                  rank_affinity=[x["affinity"] for x in ranks],
                  finite=all(ranks[0]["results"][str(n)]["finite"]
                             for n in counts),
                  launches={str(n): ranks[0]["results"][str(n)]["launches"]
                            for n in counts},
                  target_efficiency=TARGET,
                  meets_80pct_target=(None if virtual or not effs
                                      else all(e >= TARGET for e in effs)),
                  seconds=time.perf_counter() - start)
    common.write_metrics(os.path.join(args.out, "metrics.json"), record)


if __name__ == "__main__":
    main()
