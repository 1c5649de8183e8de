"""The cost of the program's spans (``opendog_tpu_torch.utils.profiling``) in
a cell's closed-loop tick, on the chip: two of the cell's drivers in one
process, one set up (its graph captured) with the spans on and one with
them off, ticked in turns, ``--ticks`` ticks a block, off first in odd
rounds and on first in even ones, after ``--warmup`` ticks of each.  Each
tick is the benchmark's tick (the noise draw, the replay, the copy out, the
synchronise), timed on the host's clock.  Prints each side's median, 95th
percentile and mean and their differences, the medians by a tick's place
in the spans' cycle of ``READ_EVERY`` (the device times are read on one
tick in that many, which a median of all ticks hides), and the count of
ticks behind each; one cell on one chip.

    python3 -m benchmark.tools.span_cost --workload go1_trot_k256 \
        --rounds 10 --ticks 200 --out span_cost.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2 ** 31 + 11)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--ticks", type=int, default=200)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from benchmark.harness import cli, spec, stats
    from benchmark.tools.runs import card_line
    cli.use_checkout_caches()
    from opendog_tpu_torch.solvers.graph import READ_EVERY
    from opendog_tpu_torch.utils import profiling
    cell = spec.Cell(args.workload)
    if cell.chips != 1:
        raise SystemExit("one chip only: the two drivers share the card")
    drivers = {}
    for on in (False, True):
        profiling.set_spans(on)
        drv = cell.driver().Driver(cell.config, cell.traffic, args.seed,
                                   "cuda:0")
        setup = drv.setup()
        drivers[on] = drv
        print(f"spans {'on' if on else 'off'}: capture "
              f"{setup['capture_s']:.3f} s", flush=True)
    ticks = {False: [], True: []}
    for on in (False, True):
        profiling.set_spans(on)
        for _ in range(args.warmup):
            drivers[on].tick()
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            profiling.set_spans(on)
            ticks[on] += [drivers[on].tick()[0]
                          for _ in range(args.ticks)]
    profiling.set_spans(True)
    med = {on: statistics.median(v) * 1e3 for on, v in ticks.items()}
    p95 = {on: stats.percentile(v, 95) * 1e3 for on, v in ticks.items()}
    mean = {on: statistics.fmean(v) * 1e3 for on, v in ticks.items()}
    # each side's ticks in order: warm-up and blocks are whole cycles when
    # they are multiples of READ_EVERY, so a place keeps its phase
    by_place = {on: [statistics.median(v[i::READ_EVERY]) * 1e3
                     for i in range(READ_EVERY)] for on, v in ticks.items()}
    rec = dict(cell=cell.name, card=card_line(), rounds=args.rounds,
               ticks_per_side=len(ticks[True]),
               median_off_ms=med[False], median_on_ms=med[True],
               diff_us=(med[True] - med[False]) * 1e3,
               diff_pct=100 * (med[True] / med[False] - 1),
               p95_off_ms=p95[False], p95_on_ms=p95[True],
               p95_diff_us=(p95[True] - p95[False]) * 1e3,
               p95_diff_pct=100 * (p95[True] / p95[False] - 1),
               mean_off_ms=mean[False], mean_on_ms=mean[True],
               mean_diff_us=(mean[True] - mean[False]) * 1e3,
               mean_diff_pct=100 * (mean[True] / mean[False] - 1),
               place_medians_off_ms=by_place[False],
               place_medians_on_ms=by_place[True],
               round_medians_off_ms=[
                   statistics.median(ticks[False][i:i + args.ticks]) * 1e3
                   for i in range(0, len(ticks[False]), args.ticks)],
               round_medians_on_ms=[
                   statistics.median(ticks[True][i:i + args.ticks]) * 1e3
                   for i in range(0, len(ticks[True]), args.ticks)])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    for drv in drivers.values():
        drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
