#!/usr/bin/env python
"""Held-out-distribution monocular-depth evaluation on the port: the
counterpart of scripts/depth_offdist_eval.py.

The DepthCNN (opendog_tpu_torch/apps/mono_depth.py) trains on frames
rendered from four terrain realizations (``generate_terrain`` from
``torch.Generator`` seeds 0-3) and a bounded pose box.  This eval measures
RMSE on data it never saw, against the mean-depth predictor:

  * held-out GEOMETRY: terrains from generator seeds 100-103;
  * held-out POSES: camera positions outside the training box;
  * both.

Renderer and terrain family are shared with training (the cross-family
eval, scripts/torch_depth_crossfam_eval.py, changes them).  Run from the
repository root:

    python3 scripts/torch_depth_offdist_eval.py                 # the card
    python3 scripts/torch_depth_offdist_eval.py --device cpu

Writes ``metrics.json`` under ``--out`` (default
``runs/torch_depth_offdist``, kept out of git): the JAX script's keys, plus
``device`` (the card's name and power limit, or ``cpu``) and ``seconds``
(host, the whole run).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def out_box(rng):
    """A pose outside the training box: 1.8-2.3 m from the origin, any
    yaw."""
    r = rng.uniform(1.8, 2.3)
    th = rng.uniform(-np.pi, np.pi)
    return np.array([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-np.pi, np.pi)], np.float32)


def setup(args):
    """(model, cam, training terrains, trained net, train metrics, the
    device's line) on ``args.device``."""
    import torch

    from opendog_tpu_torch.apps.mono_depth import CamConfig, train_depth_net
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.device import (card_line, resolve_device,
                                          use_full_fp32)
    from opendog_tpu_torch.physics import terrain as terrain_lib

    dev = resolve_device(args.device)
    use_full_fp32()
    m = load_opendog("terrain", device=dev)
    cam = CamConfig()
    train_terrains = [terrain_lib.generate_terrain(
        m, torch.Generator().manual_seed(s)) for s in range(4)]
    net, train_metrics = train_depth_net(
        m, train_terrains, n_train=args.train_frames, n_val=12,
        steps=args.steps, cam=cam, seed=0, device=dev)
    line = card_line() if dev.type == "cuda" else "cpu"
    return m, cam, train_terrains, net, train_metrics, line


def parse_args(argv, out):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=out)
    ap.add_argument("--train_frames", type=int, default=48)
    ap.add_argument("--eval_frames", type=int, default=16)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def write(args, res):
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res), flush=True)


def main(argv=None):
    import torch

    from opendog_tpu_torch.apps.mono_depth import (eval_depth_arm,
                                                   train_box_pose)
    from opendog_tpu_torch.physics import terrain as terrain_lib

    args = parse_args(argv, "runs/torch_depth_offdist")
    start = time.perf_counter()
    m, cam, train_terrains, net, train_metrics, line = setup(args)
    heldout = [terrain_lib.generate_terrain(
        m, torch.Generator().manual_seed(s)) for s in range(100, 104)]

    def arm(terrains, pose_fn, seed):
        return eval_depth_arm(m, net, terrains, args.eval_frames, seed,
                              pose_fn=pose_fn, cam=cam)

    res = dict(
        train=train_metrics,
        heldout_geometry=arm(heldout, train_box_pose, 5000),
        heldout_poses=arm(train_terrains, out_box, 6000),
        heldout_geometry_and_poses=arm(heldout, out_box, 7000),
        device=line,
        seconds=time.perf_counter() - start,
    )
    write(args, res)


if __name__ == "__main__":
    main()
