#!/usr/bin/env python3
"""Hold the flat-ground substep kernels (K1 ``substep_flat``, K2
``substep_payload``) of two checkouts of the PyTorch port against each other
on one CUDA card: their outputs and their times.

Usage, from the root of a checkout, with another checkout (e.g. the parent
commit unpacked with ``git archive``) at OTHER:

    python3 scripts/torch_kernel_ab.py OTHER

Each checkout runs in its own process, builds its own kernels and computes,
on the random Go1 states of its own ``chip_smoke.random_batch`` (and, for
K2, the payloads U(0, 3) kg of its own ``chip_smoke.random_modes``; the same
numpy seeds in both), each kernel's output and its plain version's output
at the flat MPC path's two shapes (MPPI rollout K=256 x 2 substeps of 10 ms,
plant K=1 x 10 of 2 ms), and times each kernel with CUDA events
(``chip_smoke.event_ms``).  The checkouts run in the order other, this,
this, other, so that a drift of the card shows as a difference between the
two runs of one checkout.  The script prints one JSON line: per kernel and
shape, whether the inputs and the two kernels' outputs are bit-identical,
each checkout's kernel-vs-plain max abs error and kernel times, and the
card's name and power limit.  It exits with 1 if the inputs differ or the
kernels are not bit-identical.  It imports no JAX.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SHAPES = ((256, 0.01, 2), (1, 0.002, 10))
KERNELS = (("substep_flat", False), ("substep_payload", True))
REPS = 200

CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from chip_smoke import event_ms, random_batch, random_modes
from opendog_tpu_torch.assets import load_go1
from opendog_tpu_torch.ops import cuda_step
dev = torch.device("cuda", 0)
m = load_go1("flat", device=dev)
out = {}
for name, with_payload in %r:
    for K, dt, n in %r:
        arrays = random_batch(m, K)
        if with_payload:
            arrays += random_modes(m, K, False, True)[1:]
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        extra = {"payload": args.pop()} if with_payload else {}
        kern = cuda_step.build_cuda_substep(m, dt, n, device=dev,
                                            with_payload=with_payload)
        kp, kv = kern(*args, **extra)
        pp, pv = cuda_step.build_plain_substep(m, dt, n, False, with_payload)(
            *args, **extra)
        torch.cuda.synchronize()
        tag = f"{name}_K{K}x{n}"
        out[f"{tag}_ms"] = np.float64(event_ms(torch, lambda: kern(*args, **extra), %d))
        for key, t in (("in_qpos", args[0]), ("in_qvel", args[1]),
                       ("kern_qpos", kp), ("kern_qvel", kv),
                       ("plain_qpos", pp), ("plain_qvel", pv)):
            out[f"{tag}_{key}"] = t.cpu().numpy()
        if with_payload:
            out[f"{tag}_in_payload"] = extra["payload"].cpu().numpy()
np.savez(sys.argv[2], **out)
""" % (KERNELS, SHAPES, REPS)


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
    for name, with_payload in KERNELS:
        for K, _, n in SHAPES:
            tag = f"{name}_K{K}x{n}"
            a, b = res["this"], res["other"]
            inputs = ("qpos", "qvel") + (("payload",) if with_payload else ())
            same_in = all(np.array_equal(a[f"{tag}_in_{x}"],
                                         b[f"{tag}_in_{x}"]) for x in inputs)
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
