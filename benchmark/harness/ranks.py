"""A cell on several chips: one process per rank, each with a card of its
own (NCCL), started on a free localhost port and waited for with a time
limit; one rank's failure or the limit ends them all.  Each rank writes its
run (``window.run_rank``) to the run's directory, which the parent reads.
``--device cpu`` (tests and rehearsal only) runs gloo ranks on the CPU.

Run as ``python3 -m benchmark.harness.ranks '<json>'`` by :func:`spawn`."""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from . import spec

RANK_TIMEOUT_S = 330.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cell: spec.Cell, seed: int, seconds: float, trace: bool,
          start_wall: float, device: str = "cuda",
          overrides: Optional[Dict] = None,
          module: str = "benchmark.harness.ranks") -> List[Dict]:
    """Runs the cell's ranks (``python3 -m module``) and returns each one's
    run, in rank order.  Raises with the failing rank's log."""
    import torch
    n = cell.chips
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [spec.ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    with tempfile.TemporaryDirectory() as tmp:
        addr = f"127.0.0.1:{free_port()}"
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w+")
                for r in range(n)]
        procs = []
        for r in range(n):
            arg = dict(cell=cell.name, seed=seed, seconds=seconds,
                       trace=trace, start_wall=start_wall, device=device,
                       rank=r, world=n, addr=addr, dir=tmp,
                       overrides=overrides)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, json.dumps(arg)],
                cwd=spec.ROOT, env=env, stdout=logs[r],
                stderr=subprocess.STDOUT))
        t0, failed = time.monotonic(), None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} of {n} exited {codes[bad[0]]}"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() - t0 > RANK_TIMEOUT_S:
                    failed = f"the {n} ranks did not end in {RANK_TIMEOUT_S} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        if failed is not None:
            worst = next((r for r, p in enumerate(procs)
                          if p.returncode not in (0, -9)), 0)
            raise RuntimeError(f"{failed}; rank {worst}'s log:\n"
                               f"{texts[worst][-6000:]}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


def main(arg: Dict) -> int:
    """One rank: its run, written to the run's directory.  A rank that has
    loaded a module of JAX or the JAX package by the end of its run exits
    4 and writes nothing, so that the run prints no result."""
    import torch
    from .cli import forbidden_modules
    from .window import run_rank
    cell = spec.Cell(arg["cell"])
    device = "cpu" if arg["device"] == "cpu" else f"cuda:{arg['rank']}"
    out = run_rank(cell, arg["seed"], arg["seconds"], arg["trace"], device,
                   arg["start_wall"], rank=arg["rank"], world=arg["world"],
                   addr=arg["addr"], overrides=arg["overrides"])
    found = forbidden_modules()
    if found:
        print(f"rank {arg['rank']}: modules of JAX or the JAX package were "
              f"loaded: {found}", file=sys.stderr, flush=True)
        return 4
    path = os.path.join(arg["dir"], f"rank{arg['rank']}.pt")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
