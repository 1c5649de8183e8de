"""Evaluation CLI: ``python -m opendog_tpu_torch.eval <task> [--run runs/...]``.

Port of ``opendog_tpu/eval.py`` (the reference's ``test/test.py:12-43``:
load the best model, roll deterministic steps, show the 4 paw contact
forces, print each action in MuJoCo radians and real-robot degrees,
``ScaleActions.py:73-108``): restore the best, the latest or a given
checkpoint of a run of :mod:`.train`, run deterministic episodes
(:func:`.rl.evaluate.make_eval`), print the rad / deg action table and the
per-paw contact line, and optionally write the rollout GIF.  ``--ckpt``
also takes an ``.npz`` of flax parameters (``rl/policies/``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def load_params(run_dir: str, ckpt: str, device):
    """(params {name: tensor} or a flax tree, step label) of a run's
    ``best/`` (params only), ``ckpt/`` (full train states: their params)
    or an ``.npz`` of flax parameters."""
    from .rl.networks import read_npz_tree
    from .utils.checkpoint import Checkpointer

    if ckpt.endswith(".npz"):
        return read_npz_tree(ckpt), ckpt
    sub = "best" if ckpt == "best" else "ckpt"
    ck = Checkpointer(os.path.join(run_dir, sub))
    step = None if ckpt in ("best", "latest") else int(ckpt)
    raw = ck.restore(step=step, map_location=device)
    if raw is None:
        raise SystemExit(f"no checkpoint found under {run_dir}/{sub}")
    if "opt_state" in raw:
        # a full train state: its params must be there beside the optimizer
        if "params" not in raw:
            raise SystemExit(f"checkpoint has opt_state but no params "
                             f"(keys: {sorted(raw)})")
        raw = raw["params"]
    label = f"{run_dir}/{sub} (step {ck.latest_step() if step is None else step})"
    return raw, label


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("task", choices=["walk", "turn", "jump", "landing",
                                    "sym", "terrain"])
    p.add_argument("--run", default=None,
                   help="run dir (default runs/<task>_0)")
    p.add_argument("--ckpt", default="best",
                   help="'best', 'latest', a step number, or an .npz of "
                        "flax parameters")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gif", default=None)
    p.add_argument("--print_actions", type=int, default=5,
                   help="print the first N per-step action tables")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    import torch

    from .device import resolve_device
    from .physics import State, dynamics
    from .rl.evaluate import make_eval
    from .rl.networks import load_flax_params
    from .sim2real.calibration import Calibration
    from .train import build

    device = resolve_device(args.device)
    model, env, net = build(args.task, device)
    run_dir = args.run or os.path.join("runs", f"{args.task}_0")
    params, label = load_params(run_dir, args.ckpt, device)
    if args.ckpt.endswith(".npz"):
        load_flax_params(net, params)
        params = None
    print(f"loaded {label}")

    eval_fn = make_eval(env, net, args.steps, device)
    cal = Calibration(model) if model.nu == 8 else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = []
    for ep in range(args.episodes):
        metrics, phys = eval_fn(params, env.draw_reset(gen, 1))
        metrics = {k: float(v) for k, v in metrics.items()}
        out.append(metrics)
        print(f"episode {ep}: return {metrics['episode_return']:.2f} "
              f"len {metrics['episode_len']:.0f} "
              f"fwd_x {metrics['forward_x']:.3f} m "
              f"terminated {bool(metrics['terminated'])}")
        n = max(1, int(metrics["episode_len"]))
        if ep == 0:
            # action table parity with test/test.py: MuJoCo rad + real deg
            qpos = phys.qpos.cpu().numpy()
            for t in range(min(args.print_actions, n)):
                joints = qpos[t, 7:7 + model.nu]
                line = f"  t={t}: rad {np.round(joints, 3)}"
                if cal is not None:
                    deg = cal.sim_rad_to_real_deg(
                        cal.reorder_from_model(joints))
                    line += f" | deg {np.round(deg, 1)}"
                print(line)
            # per-paw contact summary at the last frame of the episode
            last = State(qpos=phys.qpos[n - 1], qvel=phys.qvel[n - 1],
                         time=phys.time[n - 1])
            with torch.no_grad():
                _, info = dynamics.step(model, last, model.key_ctrl[0],
                                        n_substeps=1)
                fw, _, ic = dynamics.foot_contact_summary(model,
                                                          info.contact)
            print("  paw contact Fz [N]:",
                  np.round(fw.cpu().numpy()[:, 2], 2),
                  "in contact:", ic.cpu().numpy())
        if args.gif and ep == 0:
            from .utils.render import record_rollout

            sel = State(qpos=phys.qpos[:n][::4].cpu(),
                        qvel=phys.qvel[:n][::4].cpu(),
                        time=phys.time[:n][::4].cpu())
            record_rollout(model.to("cpu"), sel, args.gif, fps=12)
            print(f"  wrote {args.gif}")
    return out


if __name__ == "__main__":
    main()
