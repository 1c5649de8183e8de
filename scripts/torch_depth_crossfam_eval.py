#!/usr/bin/env python
"""Cross-family monocular-depth evaluation on the port: the counterpart of
scripts/depth_crossfam_eval.py.

The DepthCNN trains exactly as in scripts/torch_depth_offdist_eval.py
(family-1 terrain ``terrain.generate_terrain`` + the family-1 sun-shaded
renderer ``mono_depth.render_shaded``).  This eval then measures the
untouched net on frames whose generators it never saw, against the
mean-depth predictor:

  * family-2 terrain: spectral fBm + terraces + craters
    (``terrain.generate_terrain_fractal``, generator seeds 200-203);
  * family-2 appearance: overcast dome + aerial fog + albedo texture +
    vignette + shot noise (``mono_depth.render_shaded_overcast``) over the
    training terrains;
  * both at once.

Run from the repository root:

    python3 scripts/torch_depth_crossfam_eval.py                # the card
    python3 scripts/torch_depth_crossfam_eval.py --device cpu

Writes ``metrics.json`` under ``--out`` (default
``runs/torch_depth_crossfam``, kept out of git): the JAX script's keys,
plus ``device`` (the card's name and power limit, or ``cpu``) and
``seconds`` (host, the whole run).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the training, arguments and output of the held-out eval (this directory
# is the script's first path entry)
from torch_depth_offdist_eval import parse_args, setup, write  # noqa: E402


def main(argv=None):
    import torch

    from opendog_tpu_torch.apps.mono_depth import (
        eval_depth_arm, render_shaded, render_shaded_overcast)
    from opendog_tpu_torch.physics import terrain as terrain_lib

    args = parse_args(argv, "runs/torch_depth_crossfam")
    start = time.perf_counter()
    m, cam, train_terrains, net, train_metrics, line = setup(args)
    fam2 = [terrain_lib.generate_terrain_fractal(
        m, generator=torch.Generator().manual_seed(s))
        for s in range(200, 204)]

    def arm(terrains, renderer, seed):
        return eval_depth_arm(m, net, terrains, args.eval_frames, seed,
                              renderer=renderer, cam=cam)

    res = dict(
        train=train_metrics,
        train_family=("generate_terrain + render_shaded "
                      "(sun-lambert, inverse-square)"),
        fam2_terrain=arm(fam2, render_shaded, 8000),
        fam2_renderer=arm(train_terrains, render_shaded_overcast, 9000),
        fam2_both=arm(fam2, render_shaded_overcast, 10000),
        device=line,
        seconds=time.perf_counter() - start,
    )
    write(args, res)


if __name__ == "__main__":
    main()
