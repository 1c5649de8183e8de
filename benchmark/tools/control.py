"""The readings that a cell's correctness limits are set from, on the chip
at the cell's own size: for each seed, a short run of the program (its
sampled ticks, as a benchmark run samples them) and then, on the host, the
plain reference twice: in float32 (the program's readings: how far the
program lies from it) and with its products in TF32 (the control's
readings: how far the reference put in the program's place in the next
precision down lies from it).  One process runs every seed, the program
and then the reference on the card, as a benchmark run does.

    python3 -m benchmark.tools.control --workload go1_trot_k4096 \
        --seconds 3 --seeds 11 12 13 --out control.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from benchmark.harness import cli, ranks, spec, window
    cli.use_checkout_caches()
    cell = spec.Cell(args.workload)
    runs = []
    for seed in args.seeds:
        t0 = time.time()
        if cell.chips == 1:
            out = [window.run_rank(cell, seed, args.seconds, False,
                                   "cuda:0", t0)]
        else:
            from opendog_tpu_torch.ops import cuda_step
            cuda_step.cuda_library()
            out = ranks.spawn(cell, seed, args.seconds, False, t0)
        runs.append([r["records"] for r in out])
        print(f"seed {seed}: {len(out[0]['latencies'])} ticks, "
              f"{time.time() - t0:.1f} s", flush=True)
    drv = cell.driver()
    results = [(drv.check(cell.config, cell.traffic, r, device="cuda:0"),
                drv.check(cell.config, cell.traffic, r, tf32=True,
                          device="cuda:0")) for r in runs]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for seed, (prog, ctl) in zip(args.seeds, results):
            rec = dict(cell=cell.name, seed=seed, program=prog, control=ctl)
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
