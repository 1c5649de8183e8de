"""The benchmark's command: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The result is one JSON line, the last of standard output; the numbers
compared for ``correct`` are the last lines of standard error too.  With
no card, or fewer cards than the cell asks for, it exits 3 and prints no
result.  It never falls back to the CPU."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types
from typing import Dict, Optional

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "opendog_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def use_checkout_caches() -> None:
    """Every compile cache at a fixed directory inside the checkout (the
    substep library's build lives in ``opendog_tpu_torch/_build``)."""
    for var, sub in CACHES.items():
        path = os.path.join(spec.ROOT, ".bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``opendog_tpu_torch`` is not
    ``opendog_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             start_wall: float, device: str = "cuda",
             overrides: Optional[Dict] = None,
             rank_module: str = "benchmark.harness.ranks") -> Dict:
    """The cell's run(s), merged, judged and read: the result line's
    fields and ``checks``.  ``device="cpu"``, ``overrides`` of the traffic
    and ``rank_module`` (what each rank process runs) serve the tests."""
    from . import ranks, window
    traffic = dict(cell.traffic, **(overrides or {}))
    if cell.chips == 1:
        runs = [window.run_rank(cell, seed, seconds, trace,
                                "cpu" if device == "cpu" else "cuda:0",
                                start_wall, overrides=overrides)]
    else:
        if device != "cpu":
            from opendog_tpu_torch.ops import cuda_step
            cuda_step.cuda_library()   # built once, before any rank starts
        runs = ranks.spawn(cell, seed, seconds, trace, start_wall, device,
                           overrides, rank_module)
    merged = window.merge(runs, cell)
    for r in runs:
        for f in r["failures"]:
            log(f"rank {r['rank']} failed tick: {f}")
    log(f"{merged['ticks']} ticks in {merged['window_s']:.3f} s, "
        f"{merged['failed']} failed; set-up {merged['setup_s']:.3f} s; "
        f"judging {len(runs[0]['records']['index'])} sampled ticks")
    t0 = time.perf_counter()
    readings = cell.driver().check(cell.config, traffic,
                                   [r["records"] for r in runs],
                                   device="cpu" if device == "cpu"
                                   else "cuda:0")
    log(f"reference: {time.perf_counter() - t0:.1f} s")
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in readings.items()}
    # every tick the run drew for judging was judged: the eager start tick
    # and ``check_ticks`` of the window, on every rank
    want = traffic["check_ticks"] + 1
    checks["unjudged_ticks"] = {
        "value": max(want - len(r["records"]["index"]) for r in runs),
        "limit": 0}
    correct = (set(readings) == set(cell.limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    if trace:
        values = merged["per_layer"]
    else:
        ctx = types.SimpleNamespace(window=merged)
        values = {m["name"]: spec.reader(m["name"]).read(ctx)
                  for m in entries}
    for m in entries:
        if values.get(m["name"]) is not None:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": merged["kind"], "count": cell.chips,
           "memory_peak_bytes": merged["memory"]}
    out = {"correct": bool(correct), "attempted": merged["ticks"],
           "failed": merged["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=merged["busy_s"], window_s=merged["traced_s"])
        if merged["breakdown"] is not None:
            out["breakdown"] = merged["breakdown"]
    out["checks"] = checks
    return out


def main(argv, start_wall: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()
    import torch
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, this machine has "
            f"{torch.cuda.device_count()}")
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   start_wall)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
