#!/usr/bin/env python3
"""Hold the flat substep kernel (K1) of two checkouts of the PyTorch port
against each other on one CUDA card.

Usage, from the root of a checkout, with another checkout (e.g. the parent
commit unpacked with ``git archive``) at OTHER:

    python3 scripts/torch_kernel_ab.py OTHER

Each checkout runs in its own process, builds its own kernels and computes,
on the random Go1 states of its own ``chip_smoke.random_batch`` (the same
numpy seed in both), the flat kernel's output and its plain version's
output at the flat MPC path's two shapes (MPPI rollout K=256 x 2 substeps
of 10 ms, plant K=1 x 10 of 2 ms).  The script prints, per shape, whether
the two kernels' outputs are bit-identical and each checkout's kernel-vs-
plain max abs error, and exits with 1 if the inputs differ or the kernels
are not bit-identical.  It imports no JAX.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SHAPES = ((256, 0.01, 2), (1, 0.002, 10))

CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from chip_smoke import random_batch
from opendog_tpu_torch.assets import load_go1
from opendog_tpu_torch.ops import cuda_step
dev = torch.device("cuda", 0)
m = load_go1("flat", device=dev)
out = {}
for K, dt, n in %r:
    args = [torch.from_numpy(a).to(dev) for a in random_batch(m, K)]
    kp, kv = cuda_step.build_cuda_substep(m, dt, n, device=dev)(*args)
    pp, pv = cuda_step.build_plain_substep(m, dt, n)(*args)
    torch.cuda.synchronize()
    tag = f"K{K}x{n}"
    for name, t in (("in_qpos", args[0]), ("in_qvel", args[1]),
                    ("kern_qpos", kp), ("kern_qvel", kv),
                    ("plain_qpos", pp), ("plain_qvel", pv)):
        out[f"{tag}_{name}"] = t.cpu().numpy()
np.savez(sys.argv[2], **out)
""" % (SHAPES,)


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
    with tempfile.TemporaryDirectory() as tmp:
        res = {label: run_checkout(root, os.path.join(tmp, f"{label}.npz"))
               for label, root in (("this", here), ("other", other))}
    ok, report = True, []
    for K, _, n in SHAPES:
        tag = f"K{K}x{n}"
        a, b = res["this"], res["other"]
        same_in = all(np.array_equal(a[f"{tag}_in_{x}"], b[f"{tag}_in_{x}"])
                      for x in ("qpos", "qvel"))
        same_kern = all(np.array_equal(a[f"{tag}_kern_{x}"],
                                       b[f"{tag}_kern_{x}"])
                        for x in ("qpos", "qvel"))
        errs = {label: {x: float(np.abs(r[f"{tag}_kern_{x}"]
                                        - r[f"{tag}_plain_{x}"]).max())
                        for x in ("qpos", "qvel")}
                for label, r in res.items()}
        ok = ok and same_in and same_kern
        report.append({"shape": tag, "same_inputs": same_in,
                       "kernels_bit_identical": same_kern,
                       "kernel_vs_plain": errs})
    print(json.dumps({"other": other, "results": report}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
