#!/usr/bin/env python3
"""Hold the substep kernels (K1 ``substep_flat``, K2 ``substep_payload``, K3
``substep_plane``, K4 ``substep_pergeom``, K2 + K4
``substep_pergeom_payload``, K2 + K3 ``substep_plane_payload``) of two
checkouts of the PyTorch port against each other on one CUDA card: their
outputs and their times.

Usage, from the root of a checkout, with another checkout (e.g. the parent
commit unpacked with ``git archive``) at OTHER:

    python3 scripts/torch_kernel_ab.py OTHER

Each checkout runs in its own process, builds its own kernels and computes,
with the functions of its own ``chip_smoke.py`` (the same numpy and torch
seeds in both), each kernel's output and its plain version's output at its
paths' shapes, and times each kernel with CUDA events
(``chip_smoke.event_ms``):
  K1, K2  random Go1 states (``random_batch``; K2 with the payloads U(0, 3)
          kg of ``random_modes``) at the flat MPC path's two shapes (MPPI
          rollout K=256 x 2 substeps of 10 ms, plant K=1 x 10 of 2 ms);
  K3      random OpenDOG states on the ground with random planes
          (``random_modes``) at the trunk-plane MPPI rollout, K=256 x 2;
  K4      random OpenDOG states on the generated terrain (seed 0) with
          their own per-geom planes (``terrain_batch``) at the per-geom
          MPPI rollout (K=256 x 2) and the terrain plant (K=1 x 10);
  K2+K4   the same with payloads U(0, 3) kg at the per-geom payload MPPI
          rollout (K=256 x 2);
  K2+K3   the domain-randomised batch (``batch_inputs``, OpenDOG on flat
          ground) at K=4096 x 10 substeps of 2 ms.
The checkouts run in the order other, this, this, other, so that a drift of
the card shows as a difference between the two runs of one checkout.  The
script prints one JSON line: per kernel and shape, whether the inputs and
the two kernels' outputs are bit-identical, each checkout's kernel-vs-plain
max abs error and kernel times, and the card's name and power limit.  It
exits with 1 if the inputs differ or the kernels are not bit-identical.  It
imports no JAX.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROLLOUT, PLANT = (256, 0.01, 2), (1, 0.002, 10)
BATCH = (4096, 0.002, 10)
KERNELS = (  # name, robot, with_plane, with_payload, shapes
    ("substep_flat", "go1", False, False, (ROLLOUT, PLANT)),
    ("substep_payload", "go1", False, True, (ROLLOUT, PLANT)),
    ("substep_plane", "opendog", True, False, (ROLLOUT,)),
    ("substep_pergeom", "opendog", "per_geom", False, (ROLLOUT, PLANT)),
    ("substep_pergeom_payload", "opendog", "per_geom", True, (ROLLOUT,)),
    ("substep_plane_payload", "opendog_flat", True, True, (BATCH,)),
)
REPS = 200

CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from chip_smoke import (batch_inputs, event_ms, random_batch, random_modes,
                        terrain_batch)
from opendog_tpu_torch.assets import load_go1, load_opendog
from opendog_tpu_torch.ops import cuda_step
from opendog_tpu_torch.physics import terrain as terrain_lib
dev = torch.device("cuda", 0)
models = {"go1": load_go1("flat", device=dev),
          "opendog": load_opendog("terrain", device=dev),
          "opendog_flat": load_opendog("flat", device=dev)}
terr = terrain_lib.generate_terrain(models["opendog"],
                                    torch.Generator().manual_seed(0))
out = {}
for name, robot, with_plane, with_payload, shapes in %r:
    m = models[robot]
    for K, dt, n in shapes:
        if with_plane == "per_geom":
            arrays = terrain_batch(m, terr, K) + (
                random_modes(m, K, False, True)[1] if with_payload else None,)
        elif with_plane and with_payload:
            arrays = batch_inputs(m, K)
        elif with_plane:
            arrays = (random_batch(m, K, on_ground=True)
                      + random_modes(m, K, True))
        else:
            arrays = random_batch(m, K) + random_modes(m, K, False, True)
            if not with_payload:
                arrays = arrays[:3] + (None, None)
        args = [None if a is None else torch.from_numpy(a).to(dev)
                for a in arrays]
        kern = cuda_step.build_cuda_substep(m, dt, n, device=dev,
                                            with_plane=with_plane,
                                            with_payload=with_payload)
        kp, kv = kern(*args)
        pp, pv = cuda_step.build_plain_substep(m, dt, n, with_plane,
                                               with_payload)(*args)
        torch.cuda.synchronize()
        tag = f"{name}_K{K}x{n}"
        out[f"{tag}_ms"] = np.float64(event_ms(torch, lambda: kern(*args), %d))
        for key, t in zip(("in_qpos", "in_qvel", "in_ctrl", "in_plane",
                           "in_payload"), args):
            if t is not None:
                out[f"{tag}_{key}"] = t.cpu().numpy()
        for key, t in (("kern_qpos", kp), ("kern_qvel", kv),
                       ("plain_qpos", pp), ("plain_qvel", pv)):
            out[f"{tag}_{key}"] = t.cpu().numpy()
np.savez(sys.argv[2], **out)
""" % (KERNELS, REPS)


def run_checkout(root: str, path: str) -> dict:
    subprocess.run([sys.executable, "-c", CHILD, root, path], check=True,
                   cwd=root, timeout=900)
    with np.load(path) as f:
        return dict(f)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate((("other", other), ("this", here),
                                           ("this", here),
                                           ("other", other))):
            runs.append((label, run_checkout(
                root, os.path.join(tmp, f"{i}_{label}.npz"))))
    res = {label: r for label, r in runs}  # outputs: the second run of each
    ok, report = True, []
    for name, _, _, _, shapes in KERNELS:
        for K, _, n in shapes:
            tag = f"{name}_K{K}x{n}"
            a, b = res["this"], res["other"]
            inputs = [key for key in a if key.startswith(f"{tag}_in_")]
            same_in = (sorted(inputs) == sorted(
                key for key in b if key.startswith(f"{tag}_in_"))) and all(
                np.array_equal(a[key], b[key]) for key in inputs)
            same_kern = all(np.array_equal(a[f"{tag}_kern_{x}"],
                                           b[f"{tag}_kern_{x}"])
                            for x in ("qpos", "qvel"))
            errs = {label: {x: float(np.abs(r[f"{tag}_kern_{x}"]
                                            - r[f"{tag}_plain_{x}"]).max())
                            for x in ("qpos", "qvel")}
                    for label, r in res.items()}
            ms = {label: [float(r[f"{tag}_ms"]) for lab, r in runs
                          if lab == label] for label in ("this", "other")}
            ok = ok and same_in and same_kern
            report.append({
                "kernel": name, "shape": f"K={K} x{n}",
                "same_inputs": same_in, "kernels_bit_identical": same_kern,
                "kernel_vs_plain": errs, "ms": ms,
                "speedup": (sum(ms["other"]) / sum(ms["this"]))})
    print(json.dumps({"other": other, "card": smi, "reps": REPS,
                      "order": [lab for lab, _ in runs],
                      "results": report}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
