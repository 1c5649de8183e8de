#!/usr/bin/env python3
"""Eager cost of the sample-sharded MPPI solve at world size 1, on one GPU.

Brings up an NCCL group of one rank (``parallel.initialize_distributed``),
then times scripts/bench_suite.py config 6 (Go1 flat trot, K=256, H=25,
2 x 10 ms on K1) eagerly with ``mppi.make_solver`` and with
``make_solver(mesh=sample_mesh(1))`` in turns (plain, sharded, sharded,
plain, ...) on the same normals, and the two collectives of the sharded
update alone.  Then it profiles one solve of each with ``torch.profiler``
and prints, per side, the host's CUDA runtime and NCCL calls by name
(count and host time), to show where the sharded solve spends what the
plain one does not.

Run from the root of a checkout on a machine with a card:
    python3 scripts/torch_sharded_ab.py [--pairs 10] [--port N]
(``--port`` 0, the default, takes a free localhost port.)
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def host_calls(torch, fn):
    """{name: (count, host ms)} of the runtime / NCCL / c10d calls that
    ``fn()`` makes, from torch.profiler's CPU events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = ev.key
        if any(w in name for w in ("cuda", "nccl", "c10d", "Synchronize",
                                   "record_param_comms")):
            out[name] = (ev.count, ev.cpu_time_total / 1e3)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1])[:15])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("torch_sharded_ab: no CUDA device", file=sys.stderr)
        return 2
    from opendog_tpu_torch.parallel import (collectives,
                                            initialize_distributed,
                                            sample_mesh)
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import mppi
    from chip_smoke import config6, free_port

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    initialize_distributed(f"127.0.0.1:{args.port or free_port()}", 1, 0)
    try:
        dev = torch.device("cuda", 0)
        mesh = sample_mesh(1)
        m, cost, cfg = config6(dev, 256)
        solves = dict(plain=mppi.make_solver(m, cost, cfg, device=dev),
                      sharded=mppi.make_solver(m, cost, cfg, mesh=mesh))
        st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        normals = torch.randn((cfg.num_samples, cfg.horizon, m.nu),
                              generator=gen, device=dev)
        for solve in solves.values():
            for _ in range(3):
                solve(st, ms0, None, normals)
        torch.cuda.synchronize()
        times = {k: [] for k in solves}
        for i in range(args.pairs):
            order = ("plain", "sharded") if i % 2 == 0 else ("sharded",
                                                             "plain")
            for side in order:
                t0 = time.perf_counter()
                solves[side](st, ms0, None, normals)
                torch.cuda.synchronize()
                times[side].append(1e3 * (time.perf_counter() - t0))
        x = torch.zeros(1, cfg.horizon * m.nu + 3, device=dev)
        coll = {}
        for name, fn in (("psum", collectives.psum),
                         ("pmin", collectives.pmin)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn(x, mesh)
            torch.cuda.synchronize()
            coll[name] = 10.0 * (time.perf_counter() - t0)
        calls = {side: host_calls(torch, lambda s=solve: s(st, ms0, None,
                                                           normals))
                 for side, solve in solves.items()}
    finally:
        dist.destroy_process_group()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"[sharded-ab] {smi}: config 6 eager ms/solve in turns over "
          f"{args.pairs} pairs: median plain {med['plain']:.3f}, sharded "
          f"{med['sharded']:.3f}; all {json.dumps(times)}")
    print(f"[sharded-ab] one eager collective of the update's buffer, ms "
          f"(host clock, 100 calls): {json.dumps(coll)}")
    for side, c in calls.items():
        print(f"[sharded-ab] {side}: host calls (count, ms): "
              + json.dumps(c))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
