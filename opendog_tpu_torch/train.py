"""Training CLI: ``python -m opendog_tpu_torch.train <task>``.

Port of ``opendog_tpu/train.py``: both reference training entry points on
the port's stack, on one device (CUDA unless ``--device cpu``):
  * ``walk`` / ``turn`` / ``jump`` / ``landing`` -- the SB3 PPO
    configuration (clipped surrogate, lr 1e-4, batch 512, 10 epochs;
    reference ``train/train.py:90-130``) with batched on-device envs in
    place of SubprocVecEnv workers;
  * ``sym`` / ``terrain`` -- the custom sim2real stack (plain-PG loss,
    adaptive lr / entropy / action-std, periodic checkpoint and walk.json
    export; sim2real/train.py:498-598).

Every ``eval_interval`` chunks a deterministic eval episode runs on the
eval env (SB3 EvalCallback): its metrics go to JSONL / TensorBoard under
``eval/``, the best-return parameters are kept in ``<run>/best/`` and,
every ``video_interval`` evals, the episode is written as a GIF.  Every
``save_interval`` chunks the full train state goes to ``<run>/ckpt/``
(``--resume`` restarts from it).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch
from torch.func import functional_call

from .assets import load_go1, load_opendog
from .device import resolve_device
from .envs import (JumpEnv, LandingEnv, SymWalkEnv, TerrainWalkEnv, TurnEnv,
                   WalkEnv)
from .rl.adaptive import AdaptiveState
from .rl.evaluate import make_eval
from .rl.networks import MLPActorCritic
from .rl.ppo import Hyper, PPOConfig, make_ppo
from .sim2real import gait_json
from .utils.checkpoint import Checkpointer
from .utils.metrics import MetricsWriter

TASKS = {
    "walk": dict(model=lambda device: load_opendog("flat", device=device),
                 env=WalkEnv, action_dim=8, hidden=(64, 64), squash=False,
                 loss="clip"),
    "turn": dict(model=lambda device: load_opendog("flat", device=device),
                 env=TurnEnv, action_dim=8, hidden=(64, 64), squash=False,
                 loss="clip"),
    "jump": dict(model=lambda device: load_go1("jump", device=device),
                 env=JumpEnv, action_dim=12, hidden=(64, 64), squash=False,
                 loss="clip"),
    "landing": dict(model=lambda device: load_go1("landing", device=device),
                    env=LandingEnv, action_dim=12, hidden=(64, 64),
                    squash=False, loss="clip"),
    "sym": dict(model=lambda device: load_opendog("flat", device=device),
                env=SymWalkEnv, action_dim=4, hidden=(512, 256), squash=True,
                loss="plain"),
    "terrain": dict(model=lambda device: load_opendog("terrain",
                                                      device=device),
                    env=TerrainWalkEnv, action_dim=8, hidden=(1024, 512),
                    squash=True, loss="plain"),
}


def build(task: str, device=None):
    """(model, env, network) of a task on ``device``."""
    spec = TASKS[task]
    model = spec["model"](str(resolve_device(device)))
    env = spec["env"](model)
    net = MLPActorCritic(env.obs_size, spec["action_dim"],
                         hidden=spec["hidden"], squash_mean=spec["squash"],
                         device=model.device)
    return model, env, net


def _params_only(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def train(
    task: str = "walk",
    n_envs: int = 16,
    n_steps: int = 128,
    total_chunks: int = 100,
    out_dir: str = "runs",
    seed: int = 0,
    save_interval: int = 10,
    minibatch_size: int = 512,
    num_epochs: int = 10,
    eval_interval: int = 10,
    video_interval: int = 5,   # every Nth eval also records a GIF
    eval_steps: int = 500,
    resume: bool = False,      # restart from <run>/ckpt
    device=None,
):
    """Trains ``task`` for ``total_chunks`` chunks of ``n_envs`` x
    ``n_steps`` env steps and returns the final ``TrainState``.  The
    chunk draws come from a generator seeded with ``seed`` on the device,
    the eval episodes' from one seeded with ``seed + 1000``.  On CUDA the
    rollout and eval steps replay CUDA graphs."""
    device = resolve_device(device)
    spec = TASKS[task]
    model, env, net = build(task, device)
    cfg = PPOConfig(num_envs=n_envs, n_steps=n_steps, num_epochs=num_epochs,
                    minibatch_size=minibatch_size, loss=spec["loss"])
    init, chunk = make_ppo(env, net, cfg, device)
    state = init(torch.Generator(device=device).manual_seed(seed))

    run_dir = os.path.join(out_dir, f"{task}_{seed}")
    adaptive = AdaptiveState()
    step0 = 0  # checkpoint-step offset so resumed runs save fresh steps
    if resume:
        rck = Checkpointer(os.path.join(run_dir, "ckpt"))
        # Checkpointer.save skips steps already on disk; without the
        # offset a resumed run whose total_chunks <= the previous latest
        # step would never persist its new weights
        step0 = rck.latest_step() or 0
        prev = rck.restore()
        if prev is not None and "opt_state" in prev:
            state.load_state_dict(prev)
            print(f"resumed full state from {run_dir}/ckpt", flush=True)
        elif prev is not None:  # a params-only checkpoint
            with torch.no_grad():
                for k, v in state.params.items():
                    v.copy_(prev[k])
            print(f"resumed params from {run_dir}/ckpt", flush=True)
        apath = os.path.join(run_dir, "adaptive.json")
        if os.path.exists(apath):
            with open(apath) as f:
                d = json.load(f)
            adaptive.lr = d["lr"]
            adaptive.ent_coef = d["ent_coef"]
            adaptive.episodes_seen = d.get("episodes_seen", 0)
            print(f"resumed adaptive hypers lr={adaptive.lr:.2e}",
                  flush=True)
    writer = MetricsWriter(run_dir)
    ck = Checkpointer(os.path.join(run_dir, "ckpt"))
    ck_best = Checkpointer(os.path.join(run_dir, "best"), max_to_keep=1)
    use_adaptive = spec["loss"] == "plain"
    eval_fn = make_eval(env, net, eval_steps, device)
    eval_gen = torch.Generator(device=device).manual_seed(seed + 1000)
    best_return = -float("inf")
    n_evals = 0

    for i in range(total_chunks):
        hyper = Hyper(lr=adaptive.lr, ent_coef=adaptive.ent_coef)
        t0 = time.time()
        state, metrics = chunk(state, hyper)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["steps_per_sec"] = n_envs * n_steps / (time.time() - t0)
        metrics.update(chunk.times)  # rollout_s, update_s
        writer.write(i, metrics, prefix="train")
        if use_adaptive:
            shift = adaptive.record_episode(metrics["sum_reward_per_env"])
            if shift:
                log_std = state.params["log_std"]
                with torch.no_grad():
                    log_std.copy_(torch.clamp(log_std + shift,
                                              math.log(0.10),
                                              math.log(0.5)))
        print(f"chunk {i}: reward/env {metrics['sum_reward_per_env']:.2f} "
              f"lr {adaptive.lr:.1e}", flush=True)
        if eval_interval and (i + 1) % eval_interval == 0:
            emetrics, ephysics = eval_fn(state.params,
                                         env.draw_reset(eval_gen, 1))
            emetrics = {k: float(v) for k, v in emetrics.items()}
            writer.write(i, emetrics, prefix="eval")
            n_evals += 1
            print(f"  eval: return {emetrics['episode_return']:.2f} "
                  f"len {emetrics['episode_len']:.0f} "
                  f"fwd_x {emetrics['forward_x']:.3f} m", flush=True)
            if emetrics["episode_return"] > best_return:
                best_return = emetrics["episode_return"]
                ck_best.save(step0 + i + 1, _params_only(state.params),
                             force=True)
            if video_interval and n_evals % video_interval == 0:
                from .utils.render import record_rollout

                n_fr = max(1, int(emetrics["episode_len"]))
                frames = type(ephysics)(
                    qpos=ephysics.qpos[:n_fr][::4].cpu(),
                    qvel=ephysics.qvel[:n_fr][::4].cpu(),
                    time=ephysics.time[:n_fr][::4].cpu())
                record_rollout(model.to("cpu"), frames,
                               os.path.join(run_dir, f"eval_{i + 1}.gif"),
                               fps=12)
        if (i + 1) % save_interval == 0:
            # FULL-state checkpoint (params, optimizer, env states,
            # generator): a fresh process resumes the run exactly
            ck.save(step0 + i + 1, state)
            with open(os.path.join(run_dir, "adaptive.json"), "w") as f:
                json.dump(dict(lr=adaptive.lr, ent_coef=adaptive.ent_coef,
                               episodes_seen=adaptive.episodes_seen), f)
            if task == "sym":
                def policy(obs, _p=state.params):
                    return functional_call(net, _p, (obs,),
                                           {"value": False})[0]
                gait_json.generate_walk_json(
                    policy, env,
                    os.path.join(run_dir,
                                 f"walk_rl_sym_ep{step0 + i + 1}.json"))
    ck.save(step0 + total_chunks, state, force=True)
    writer.close()
    ck.close()
    ck_best.close()
    return state


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("task", choices=sorted(TASKS))
    p.add_argument("--n_envs", type=int, default=16)
    p.add_argument("--n_steps", type=int, default=128)
    p.add_argument("--chunks", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs")
    p.add_argument("--eval_interval", type=int, default=10)
    p.add_argument("--video_interval", type=int, default=5)
    p.add_argument("--eval_steps", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args()
    train(args.task, n_envs=args.n_envs, n_steps=args.n_steps,
          total_chunks=args.chunks, out_dir=args.out, seed=args.seed,
          eval_interval=args.eval_interval,
          video_interval=args.video_interval, eval_steps=args.eval_steps,
          resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
