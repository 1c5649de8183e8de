#!/usr/bin/env python3
"""The terrain walk's autoreset on the card, two ways, in one call.

  A (the port's): one CUDA graph per rollout step that resets every env
    (a terrain per env and a 100-substep settle on it) and keeps the
    fresh state where the env is done, as the JAX rollout does
    (``opendog_tpu/rl/ppo.py:119-127``);
  B: one CUDA graph per step without the reset, then one read of ``done``
    to the host, and an eager reset of only the done rows (from their own
    draws), copied into the carry.

Both roll the terrain task's 1024-512 policy at its initialisation from
seed 0, from the same start on the same draws, for ``--steps`` steps at
``--envs`` envs, each twice (the first with its capture), and print ms per
step of the second run of each, the rows reset, the largest difference
of their final states (a row reset alone takes other BLAS paths than the
batch, so not bit for bit) and the card's name and power limit.

    python3 scripts/torch_ppo_reset_ab.py [--envs 16] [--steps 32]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=32)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.func import functional_call

    from opendog_tpu_torch.envs.base import tree_copy_, tree_leaves, tree_map
    from opendog_tpu_torch.rl.ppo import (PPOConfig, _Rollout, draw_chunk,
                                          make_ppo)
    from opendog_tpu_torch.train import build

    dev = torch.device("cuda", 0)
    B, T = args.envs, args.steps
    _, env, net = build("terrain", dev)
    cfg = PPOConfig(num_envs=B, n_steps=T, num_epochs=1,
                    minibatch_size=B * T, loss="plain")
    init, _ = make_ppo(env, net, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init(gen)
    draws = draw_chunk(env, cfg, gen, dev)

    def timed(run):
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out[1] / T * 1e3

    # ---- A: the port's rollout, its graph resetting every row ----
    ro = _Rollout(env, net, state.params, cfg, dev, True)

    def run_a():
        ro.load(state.env_states, state.last_obs, draws)
        for i in range(T):
            ro.run(i)

    ms_a = timed(run_a)
    final_a = tree_map(torch.clone, ro.carry)

    # ---- B: a graph without the reset, an eager reset of done rows ----
    carry = tree_map(torch.clone, (state.env_states, state.last_obs))
    t_buf = torch.zeros(1, dtype=torch.long, device=dev)
    steps = torch.arange(T, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    def step():
        env_states, obs = carry
        mean, log_std, _ = functional_call(net, state.params, (obs,))
        action = mean + torch.exp(log_std) * \
            draws.action_normals.index_select(0, t_buf)[0]
        nxt, trans = env.step(env_states, action)
        done.copy_(trans.done)
        tree_copy_(carry, (nxt, trans.obs))

    with torch.no_grad():
        saved = tree_map(torch.clone, carry)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        tree_copy_(carry, saved)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
    resets = []

    def run_b():
        tree_copy_(carry, (state.env_states, state.last_obs))
        resets.clear()
        with torch.no_grad():
            for i in range(T):
                t_buf.copy_(steps[i:i + 1])
                graph.replay()
                rows = torch.nonzero(done).flatten()   # the host read
                if len(rows):
                    resets.append(len(rows))
                    fresh, fresh_obs = env.reset(tree_map(
                        lambda x: x[i][rows], draws.reset_draws))
                    tree_map(lambda d, s: d.index_copy_(0, rows, s),
                             carry[0], fresh)
                    carry[1].index_copy_(0, rows, fresh_obs)

    ms_b = timed(run_b)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(final_a), tree_leaves(carry)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        envs=B, steps=T, graph_reset_all_ms_per_step=ms_a,
        graph_then_eager_done_rows_ms_per_step=ms_b,
        steps_with_a_reset=len(resets), rows_reset=sum(resets),
        final_state_max_abs_diff=diff, card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
