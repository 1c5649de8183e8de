"""Meshes and sharding helpers on ``torch.distributed``.

Port of ``opendog_tpu/parallel/mesh.py``.  One process per rank, and a rank
owns one device: ``cuda:rank % device_count``, or the CPU when the caller
passes ``device="cpu"``.  A :class:`Mesh` is one axis over the first n
ranks of the default group; the port's meshes are 1-D, so the solvers and
the collectives take the mesh and no axis name (the axis name is a label):

* ``env_mesh``: the env / scenario batch (data parallel, axis ``"dp"``);
* ``sample_mesh``: the MPPI rollout-sample axis (``mppi.make_solver(...,
  mesh=sample_mesh())``, axis ``"mp"``), the solver's reductions riding
  ``parallel.collectives``;
* ``make_mesh(n, axis)``: any other axis, e.g. ``"sp"`` for the
  horizon-sharded Riccati sweep of ``ilqr.make_ilqr(..., mesh=)``.

Without ``torch.distributed`` initialised a mesh has one rank and no
process group, and its collectives return their input.
``initialize_distributed`` brings the process group up over TCP; NCCL
runs only where every rank has a card of its own (NCCL refuses two ranks
on one device), and two ranks that share a card must ask for gloo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..envs.base import tree_map


@dataclass(frozen=True)
class Mesh:
    """One mesh axis: the process ``group`` (None without
    ``torch.distributed``), the axis name (a label), the number of ranks
    on it, this rank's index along it and the device this rank computes
    on."""

    group: Any
    axis: str
    size: int
    index: int
    device: torch.device

    def on_device(self, device=None) -> torch.device:
        """The device of an entry point sharded over this mesh: the
        mesh's, which ``device``, where one is given, must be."""
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{self.device}")
        return self.device


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device=None) -> Optional[Mesh]:
    """A mesh over the first ``n_devices`` ranks of the default group (all
    of them if None) with axis name ``axis``; this rank computes on
    ``device`` (``cuda:rank % device_count`` if None).  Every rank of the
    default group must call it; one outside the first ``n_devices`` gets
    None.  On a process group the mesh's communicator is warmed up here,
    with one collective, so that a CUDA graph can capture its later ones."""
    initialized = dist.is_available() and dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if initialized
                   else (1, 0))
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks needs 1 to {world} ranks")
    if device is None:
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards) if cards else "cuda"
    device = resolve_device(device)
    group = None
    if initialized:
        group = (dist.group.WORLD if n == world
                 else dist.new_group(ranks=list(range(n))))
    if rank >= n:
        return None
    mesh = Mesh(group=group, axis=axis, size=n, index=rank, device=device)
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    return mesh


def env_mesh(n_devices: Optional[int] = None, device=None) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks for the env / scenario
    batch (axis ``"dp"``)."""
    return make_mesh(n_devices, "dp", device)


def sample_mesh(n_devices: Optional[int] = None,
                device=None) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks for the MPPI K-sample
    axis (axis ``"mp"``)."""
    return make_mesh(n_devices, "mp", device)


def shard_batch(mesh: Mesh, tree):
    """This rank's block of the leading axis of every tensor of a global
    ``tree``, on the mesh's device: rank i takes rows ``[i b, (i + 1) b)``
    of ``n b``.  Raises where n does not divide a leading axis."""

    def block(x):
        if x.dim() == 0 or x.shape[0] % mesh.size:
            raise ValueError(f"a leading axis of {tuple(x.shape)} does not "
                             f"split over {mesh.size} ranks")
        b = x.shape[0] // mesh.size
        return x[mesh.index * b:(mesh.index + 1) * b].to(
            mesh.device).clone()

    return tree_map(block, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` as rank 0 holds it, on every rank's device
    (a broadcast from rank 0 of the mesh)."""

    def rep(x):
        y = x.detach().to(mesh.device).clone()
        if mesh.group is not None:
            dist.broadcast(y, src=0, group=mesh.group)
        return y

    return tree_map(rep, tree)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Brings up the default process group over TCP
    (``init_method="tcp://" + coordinator_address``, e.g.
    ``"localhost:19945"``) as rank ``process_id`` of ``num_processes``.
    Returns False, and does nothing, when ``coordinator_address`` is None
    (one process); True once the group is up.

    ``backend`` None picks gloo for ``device="cpu"`` and NCCL where every
    rank has a card of its own (``num_processes`` at most the cards of this
    host); then this rank's card is ``process_id % device_count``.  Where
    two ranks would share a card, NCCL refuses them: pass
    ``backend="gloo"``, else this raises.  Nothing switches backend
    quietly."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a distributed run needs num_processes and "
                         "process_id")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve_device(device)  # raises where there is no card
    own_card = not cpu and torch.cuda.device_count() >= num_processes
    if backend is None:
        if cpu:
            backend = "gloo"
        elif own_card:
            backend = "nccl"
        else:
            raise ValueError(
                f"{num_processes} ranks on {torch.cuda.device_count()} "
                "card(s): two ranks would share a card, which NCCL "
                "refuses; pass backend='gloo' to run them over gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not own_card:
            raise ValueError("NCCL needs a card of its own for every rank: "
                             f"{num_processes} ranks on "
                             f"{torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True
