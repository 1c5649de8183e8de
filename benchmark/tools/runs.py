"""Several runs of the benchmark in one call, one process each, in order:
the way to take a cell's two sets of runs, or to try a length.  Each run's
result line, exit code, seconds and the end of its standard error go to
one JSON line of ``--out``; a summary goes to standard output.

    python3 -m benchmark.tools.runs --out k4096_runs.jsonl \
        --seconds 20 --runs go1_trot_k4096:11:0 go1_trot_k4096:12:1

Each ``--runs`` item is ``cell:seed:trace``."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--runs", nargs="+", required=True)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    print("card:", card_line(), flush=True)
    worst = 0
    with open(args.out, "a") as f:
        for item in args.runs:
            cell, seed, trace = item.split(":")
            cmd = [sys.executable, "benchmark/run.py", "--workload", cell,
                   "--seed", seed, "--seconds", str(args.seconds),
                   "--trace", trace]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True)
            secs = time.time() - t0
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = dict(cell=cell, seed=int(seed), trace=int(trace),
                       seconds=args.seconds, rc=proc.returncode,
                       wall_s=secs, result=result,
                       stderr=proc.stderr[-4000:], card=card_line())
            f.write(json.dumps(rec) + "\n")
            f.flush()
            worst = max(worst, proc.returncode)
            brief = ({k: round(v["value"], 4) for k, v in
                      result["metrics"].items()} if result else None)
            checks = ({k: v["value"] for k, v in result["checks"].items()}
                      if result else None)
            print(f"{item} rc={proc.returncode} wall={secs:.1f}s "
                  f"correct={result and result['correct']} "
                  f"failed={result and result['failed']} {brief} {checks}",
                  flush=True)
            if proc.returncode:
                print(proc.stderr[-3000:], flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
