"""Collectives over a mesh's process group: the port's counterparts of the
``jax.lax`` collectives that the JAX package calls inside ``shard_map``
(``psum``, ``pmean``, ``pmin``, a tiled ``all_gather`` and
``axis_index``).

``psum``, ``pmin`` and ``all_gather`` ride one ``all_reduce(SUM)`` of a
slot buffer.  Rank r writes its value into slot r of a zero ``(n, ...)``
buffer; the sum fills every slot exactly, since adding zeros is exact; then
each rank reduces the slot axis itself, in rank order.  So:

* every rank ends up with the same bits, and NCCL and gloo give the same
  bits;
* a mesh of one rank gives its input back unchanged, so a sharded path at
  world size 1 equals the unsharded one bit for bit;
* gloo's missing CUDA ``all_gather`` and ``MIN`` are never needed.

Their buffers are small (at most a plan, ``(n, H, nu)``).  ``pmean``, which
PPO applies to a network's whole gradient vector every minibatch, is one
plain ``all_reduce(SUM)`` divided by n instead: it moves the vector once,
not n times.  Every rank still gets the same bits (each element is reduced
once and then shared), and one rank still gets its input back, but NCCL
and gloo may sum in different orders.  A mesh without a process group (one
process, no ``torch.distributed``) runs no collective at all.

On an NCCL group the ``all_reduce`` can be captured in a CUDA graph (the
mesh warms its communicator up when it is made); on a gloo group it
cannot, and :func:`require_capturable` says so.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _slots(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, ...) with every rank's ``x`` in its slot, on every rank."""
    buf = x.new_zeros((mesh.size,) + tuple(x.shape))
    buf[mesh.index] = x
    if mesh.group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, added in rank order."""
    buf = _slots(x, mesh)
    out = buf[0]
    for i in range(1, mesh.size):
        out = out + buf[i]
    return out


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks divided by n, as
    ``jax.lax.pmean``: one ``all_reduce(SUM)`` of ``x`` itself, in the
    backend's order of addition."""
    out = x.clone()
    if mesh.group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out / mesh.size


def pmin(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the mesh's ranks."""
    return torch.amin(_slots(x, mesh), dim=0)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order (``tiled``
    ``jax.lax.all_gather``): (n * x.shape[0], ...)."""
    return _slots(x, mesh).reshape((mesh.size * x.shape[0],)
                                   + tuple(x.shape[1:]))


def axis_index(mesh) -> int:
    """This rank's index along the mesh axis (``jax.lax.axis_index``)."""
    return mesh.index


def capturable(mesh) -> bool:
    """Whether a CUDA graph can hold this mesh's collectives: no mesh, a
    mesh without a process group, or an NCCL group."""
    return (mesh is None or mesh.group is None
            or dist.get_backend(mesh.group) == "nccl")


def require_capturable(mesh, what: str) -> None:
    """Raises ``ValueError`` when ``what`` would capture this mesh's
    collectives in a CUDA graph and the group cannot be captured (gloo).
    Nothing runs eagerly instead."""
    if not capturable(mesh):
        raise ValueError(
            f"{what} captures a CUDA graph, and a graph cannot hold a "
            f"collective of a {dist.get_backend(mesh.group)} group: use an "
            "NCCL group (one card per rank), or the eager path")
