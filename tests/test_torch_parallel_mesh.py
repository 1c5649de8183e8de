"""The port's multi-device layer (``opendog_tpu_torch.parallel``) on the CPU:
ranks are subprocesses on one gloo group over TCP on localhost, and the
helpers here start them for the other ``test_torch_sharded_*`` files too.

* ``initialize_distributed`` at 2 ranks with a psum over sharded rows, the
  counterpart of tests/test_distributed_multiprocess.py::
  test_two_process_distributed_psum;
* ``shard_batch`` / ``replicate``;
* every collective bit-identical across ranks (and equal to the sum, mean,
  min and concatenation taken in rank order with numpy float32), and at
  world size 1, with and without a process group, its input back;
* ``scaling_efficiency`` against the JAX function on the same ``run_fn``;
* the backend rules of ``initialize_distributed`` and the mesh checks.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from opendog_tpu.parallel import scaling_efficiency as jax_scaling_efficiency
from opendog_tpu_torch.parallel import (collectives, env_mesh,
                                        initialize_distributed, make_mesh,
                                        replicate, sample_mesh,
                                        scaling_efficiency, shard_batch)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the lines every rank starts with: argv = address, world size, rank, out dir
PREAMBLE = """\
import os
import sys
import time
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from opendog_tpu_torch.parallel import initialize_distributed

ADDR, N, RANK, OUT = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
assert initialize_distributed(ADDR, N, RANK, device="cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == N


def load_inputs():
    return torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)


def save(result):
    # Shut down without tearing the group down: a rank that destroys its
    # group or exits normally while a peer still tears down (rank 0 hosts
    # the TCP store) can abort in c10d's threads ("terminate called without
    # an active exception").  After the barrier every rank is past its last
    # collective; rank 0, the store's host, leaves last.
    torch.save(result, os.path.join(OUT, f"rank{RANK}.pt"))
    dist.barrier()
    open(os.path.join(OUT, f"done{RANK}"), "w").close()
    if RANK == 0:
        t0 = time.monotonic()
        while not all(os.path.exists(os.path.join(OUT, f"done{r}"))
                      for r in range(N)) and time.monotonic() - t0 < 60:
            time.sleep(0.01)
    sys.stdout.flush()
    os._exit(0)
"""


def free_port() -> int:
    """A free TCP port on localhost (bound once to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, body: str, n: int, timeout_s: float = 150,
              inputs=None):
    """Runs ``PREAMBLE + body`` as ``n`` gloo ranks in subprocesses on the
    CPU and returns what each rank passed to ``save`` (rank order); the
    ranks read ``inputs`` with ``load_inputs()``.  Every rank must exit 0
    within ``timeout_s``: a hung rendezvous fails the test instead of
    hanging the suite."""
    out = tmp_path / f"ranks{n}"
    out.mkdir()
    torch.save(inputs, out / "inputs.pt")
    script = out / "rank.py"
    script.write_text(PREAMBLE + textwrap.dedent(body))
    addr = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), addr, str(n), str(r), str(out)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def same_on_every_rank(results, key):
    """Every rank's ``results[r][key]`` (a tensor or a dict of them) equals
    rank 0's bit for bit; returns rank 0's."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        got = res[key]
        items = got.items() if isinstance(got, dict) else [(key, got)]
        for k, v in items:
            want = first[k] if isinstance(first, dict) else first
            assert torch.equal(v, want), f"rank {r} differs on {key}/{k}"
    return first


def test_two_rank_distributed_psum(tmp_path):
    """Two ranks bring the group up through ``initialize_distributed``,
    shard the rows of arange(12).reshape(4, 3) over an env mesh and psum
    their local sums: 66 on both."""
    results = run_ranks(tmp_path, """
        from opendog_tpu_torch.parallel import collectives, env_mesh, shard_batch
        mesh = env_mesh(device="cpu")
        assert (mesh.size, mesh.index) == (N, RANK)
        full = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        local = shard_batch(mesh, full)
        save(dict(local=local,
                  total=collectives.psum(local.sum(), mesh)))
    """, 2)
    for r, res in enumerate(results):
        assert res["total"].item() == 66.0
        torch.testing.assert_close(
            res["local"], torch.arange(12.).reshape(4, 3)[2 * r:2 * r + 2],
            rtol=0, atol=0)


COLLECTIVES_BODY = """
    import numpy as np
    from opendog_tpu_torch.parallel import (collectives, make_mesh,
                                            replicate, shard_batch)
    mesh = make_mesh(axis="sp", device="cpu")
    x = torch.from_numpy(np.random.default_rng(100 + RANK).normal(
        size=(3, 4)).astype(np.float32))
    tree = dict(a=torch.full((2, 3), float(RANK)), b=[torch.tensor(RANK)])
    save(dict(x=x, psum=collectives.psum(x, mesh),
              pmean=collectives.pmean(x, mesh),
              pmin=collectives.pmin(x, mesh),
              all_gather=collectives.all_gather(x, mesh),
              axis_index=torch.tensor(collectives.axis_index(mesh)),
              replicated=replicate(mesh, tree)["a"],
              block=shard_batch(mesh, torch.arange(4 * N))))
"""


@pytest.mark.parametrize("n", [1, 2, 4])
def test_collectives_bit_identical_across_ranks(tmp_path, n):
    """psum, pmean, pmin, the tiled all_gather and axis_index on random
    float32 blocks (one per rank): the same bits on every rank, equal to
    numpy's float32 sum / min / concatenation in rank order; pmean, one
    plain all_reduce that adds in the backend's order, within n - 1
    roundings of the rank-order sum, over n; at one rank (a gloo group of
    one) each returns its input.  replicate
    broadcasts rank 0's tree; shard_batch gives rank r rows [4r, 4r+4)."""
    results = run_ranks(tmp_path, COLLECTIVES_BODY, n)
    xs = [res["x"].numpy() for res in results]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    want = dict(psum=acc, pmin=np.minimum.reduce(xs),
                all_gather=np.concatenate(xs))
    for key, value in want.items():
        got = same_on_every_rank(results, key)
        np.testing.assert_array_equal(got.numpy(), value, err_msg=key)
    eps = np.finfo(np.float32).eps
    bound = (n - 1) * eps * np.sum(np.abs(xs), axis=0) / n
    assert np.all(np.abs(same_on_every_rank(results, "pmean").numpy()
                         - acc / np.float32(n)) <= bound)
    same_on_every_rank(results, "replicated")
    assert torch.equal(results[0]["replicated"], torch.zeros(2, 3))
    for r, res in enumerate(results):
        assert int(res["axis_index"]) == r
        assert torch.equal(res["block"], torch.arange(4 * r, 4 * r + 4))
    if n == 1:
        for key in ("psum", "pmean", "pmin", "all_gather"):
            assert torch.equal(results[0][key], results[0]["x"]), key


def test_collectives_without_a_process_group_return_their_input():
    """One process, no torch.distributed: a mesh of one rank, no group, no
    collective run; every collective returns its input bit for bit."""
    mesh = sample_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.index, mesh.axis) == (None, 1, 0,
                                                               "mp")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 2)).astype(np.float32))
    for fn in (collectives.psum, collectives.pmean, collectives.pmin,
               collectives.all_gather):
        assert torch.equal(fn(x, mesh), x), fn.__name__
    assert collectives.capturable(mesh) and collectives.capturable(None)
    tree = dict(q=torch.arange(6.).reshape(3, 2))
    assert torch.equal(replicate(mesh, tree)["q"], tree["q"])
    assert torch.equal(shard_batch(mesh, tree["q"]), tree["q"])


def test_mesh_checks():
    """The errors of the mesh helpers: a mesh larger than the world and a
    batch that does not split."""
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(2, device="cpu")
    mesh = env_mesh(device="cpu")
    with pytest.raises(ValueError, match="split"):
        shard_batch(mesh, torch.zeros(()))
    assert initialize_distributed(None) is False


def test_two_ranks_on_one_card_need_gloo(monkeypatch):
    """NCCL refuses two ranks on one card: without backend='gloo' that
    raises before any process group is made, as does asking for NCCL; one
    rank per card picks NCCL (not started here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="share a card|of its own"):
            initialize_distributed("127.0.0.1:1", 2, 0, backend=backend,
                                   device="cuda:0")
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed("127.0.0.1:1", 1, 0, backend="mpi",
                               device="cuda:0")


def test_scaling_efficiency_matches_jax():
    """The copy against the JAX function on the same run_fn."""
    thr = {1: 100.0, 2: 190.0, 4: 330.0, 8: 600.0}
    assert scaling_efficiency(thr.get, [1, 2, 4, 8]) == \
        jax_scaling_efficiency(thr.get, [1, 2, 4, 8])
    assert scaling_efficiency(lambda n: 0.0, [1, 2]) == \
        jax_scaling_efficiency(lambda n: 0.0, [1, 2])
