"""What the port's multi-device scripts (``scripts/torch_multiprocess_scaling.py``,
``torch_scaling_bench.py`` and ``torch_comm_volume.py``, the counterparts of
the JAX package's multi-process scaling, scaling bench and comm volume
scripts) share: starting N ranks of one script, joining a rank to its
process group, a timed window that the slowest rank sets, and leaving.

A script's parent process resolves the device and, on the card, builds the
substep kernels (``ops/build.py``) before any rank starts, so that no
rank's nvcc build lands inside another rank's rendezvous.  It then starts
the ranks as subprocesses of the same script (``--rank``, ``--world``,
``--addr``, ``--dir``: hidden arguments), on a coordinator port taken by
binding port 0, and waits with a time limit.  One rank's failure or the
time limit kills every rank and fails the run: a hung rendezvous never
hangs the caller.  Each rank writes its result to ``--dir`` as JSON, which
the parent reads.

The backend follows one rule.  On the card it is NCCL with one card per
rank: more ranks than cards raise in ``parallel.initialize_distributed``,
and nothing switches to gloo.  ``--device cpu`` runs gloo ranks on the CPU,
for the tests and for rehearsal.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import ROOT, open_device, write_metrics  # noqa: E402,F401


def add_rank_args(ap: argparse.ArgumentParser) -> None:
    """The arguments the parent passes to each rank it starts (hidden), and
    ``--device`` (the card unless ``cpu``)."""
    ap.add_argument("--device", default=None,
                    help="cpu: gloo ranks on the CPU (default: the cards, "
                         "NCCL, one card per rank)")
    for name, kind in (("rank", int), ("world", int), ("addr", str),
                       ("dir", str)):
        ap.add_argument(f"--{name}", type=kind, default=None,
                        help=argparse.SUPPRESS)


def free_port() -> int:
    """A free TCP port on localhost (bound once to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prepare(device):
    """(device, line) of the parent: the device resolved (no card raises)
    and, on the card, the substep kernels built, before any rank starts."""
    dev, line = open_device(device)
    if dev.type == "cuda":
        from opendog_tpu_torch.ops import cuda_step
        cuda_step.cuda_library()
    return dev, line


def card_count(dev) -> int:
    """The cards of this host (0 on the CPU)."""
    import torch
    return torch.cuda.device_count() if dev.type == "cuda" else 0


def spawn(script: str, n: int, argv, timeout_s: float) -> list:
    """Runs ``python3 script ARGV`` as ``n`` ranks of one process group on a
    free localhost port and returns each rank's result (rank order: what
    it passed to :func:`leave`).  Every rank must exit 0 within
    ``timeout_s``; on one rank's failure or the time limit every rank is
    killed and this raises with that rank's log."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as tmp:
        addr = f"127.0.0.1:{free_port()}"
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, script, *argv, "--rank", str(r), "--world",
             str(n), "--addr", addr, "--dir", tmp],
            cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        t0 = time.monotonic()
        failed = None
        try:
            while failed is None:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} of {n} exited {codes[bad[0]]}"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() - t0 > timeout_s:
                    failed = f"the {n} ranks did not end in {timeout_s} s"
                time.sleep(0.1)
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
            raise RuntimeError(f"{os.path.basename(script)}: {failed}; "
                               f"rank {worst}'s log:\n{texts[worst][-6000:]}")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def join(args):
    """The rank's side of :func:`spawn`: the process group up
    (``parallel.initialize_distributed``: NCCL on the cards, one card per
    rank, else raises; gloo with ``--device cpu``), full float32 products,
    and the rank's device."""
    import torch
    from opendog_tpu_torch.device import use_full_fp32
    from opendog_tpu_torch.parallel import initialize_distributed
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    initialize_distributed(args.addr, args.world, args.rank,
                           device="cpu" if cpu else None)
    use_full_fp32()
    return (torch.device("cpu") if cpu
            else torch.device("cuda", torch.cuda.current_device()))


def host_record() -> dict:
    """The host's cores and this rank's CPU affinity: ranks that share a
    host contend for its cores."""
    return dict(host_cores=os.cpu_count(),
                affinity=len(os.sched_getaffinity(0)))


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def slowest(seconds: float, mesh) -> float:
    """The largest of the ranks' ``seconds`` over ``mesh`` (``pmin`` of the
    negation: the collectives have no ``pmax``)."""
    import torch
    from opendog_tpu_torch.parallel import collectives
    x = torch.tensor([-seconds], dtype=torch.float64, device=mesh.device)
    return -float(collectives.pmin(x, mesh)[0])


def window(fn, mesh):
    """``(seconds, fn())`` timed the same way on every rank of ``mesh``: a
    barrier, the rank's card synchronised, ``fn``, the card synchronised
    again, and the elapsed time reduced over the ranks to its maximum (the
    slowest rank sets the rate)."""
    import torch.distributed as dist
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    sync(mesh.device)
    t0 = time.perf_counter()
    out = fn()
    sync(mesh.device)
    return slowest(time.perf_counter() - t0, mesh), out


def leave(args, result) -> None:
    """Writes the rank's ``result`` (JSON) for the parent and leaves without
    tearing the group down: a rank that destroys its group or exits
    normally while a peer still tears down (rank 0 hosts the TCP store) can
    abort in c10d's threads.  After the barrier every rank is past its last
    collective; rank 0, the store's host, leaves last."""
    import torch.distributed as dist
    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    open(os.path.join(args.dir, f"done{args.rank}"), "w").close()
    t0 = time.monotonic()
    while args.rank == 0 and time.monotonic() - t0 < 60 and not all(
            os.path.exists(os.path.join(args.dir, f"done{r}"))
            for r in range(args.world)):
        time.sleep(0.01)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
