"""The plain closed-loop MPC tick with per-geom contact planes: the tick of
``mppi.build_tick`` on a terrain, with its two grounds replaced.

* The rollouts: each collision sphere of every lane contacts the terrain's
  tangent plane under that sphere at the solve-from state
  (``physics.dynamics.geom_local_planes``, 4 rows a sphere), through the
  plain substep's per-geom mode (``scalar_core``, ``with_plane="per_geom"``).
* The plant: the same plain per-geom substep at the model's timestep, one
  lane, its planes rebuilt from the plant state every tick.

Everything else (the candidates, the cost, the softmax-weighted update,
the shift, the TF32 control) is ``mppi.build_tick``'s.  The planes and the
update run one tick at a time at the program's shapes (``(1, nq)`` for the
rollouts' planes, ``(nq,)`` for the plant's), so that on the card a sound
program reads no gap; the plain substep is elementwise over lanes, so the
ticks share its calls.  It imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from .mppi import _TF32, plain_substep
from .physics import State, Terrain, dynamics


def build_tick(model, step_cost: Callable, mppi: Dict, plant_substeps: int,
               terrain: Terrain) -> Callable:
    """``tick(qpos (B, nq), qvel (B, nv), time (B,), nominal (B, H, nu),
    normals (B, K, H, nu), tf32=False) -> dict`` as ``mppi.build_tick``'s,
    on per-geom planes in the rollouts and in the plant."""
    H, K = mppi["horizon"], mppi["num_samples"]
    dt_tick = mppi["rollout_dt"] * mppi["n_substeps"]
    lo = model.actuator_ctrlrange[:, 0]
    hi = model.actuator_ctrlrange[:, 1]
    roll = plain_substep(model, mppi["rollout_dt"], mppi["n_substeps"],
                         with_plane="per_geom")
    plant = plain_substep(model, model.timestep, plant_substeps,
                          with_plane="per_geom")
    alpha, sigma = mppi["smooth_alpha"], mppi["noise_sigma"]

    def planes_of(qpos):
        """(4 ngeom, B): each tick's plane rows, from its own call."""
        return torch.stack([dynamics.geom_local_planes(
            model, terrain, q).reshape(-1) for q in qpos], dim=1)

    def candidates_of(nominal, normals):
        e = normals * sigma
        c = torch.zeros_like(e[:, :, 0])
        eps = []
        for h in range(H):
            c = alpha * c + (1 - alpha) * e[:, :, h]
            eps.append(c)
        return torch.clamp(nominal[:, None] + torch.stack(eps, dim=2),
                           lo, hi)

    def lanes(x):
        return x[:, None].expand(x.shape[0], K, *x.shape[1:]).reshape(
            x.shape[0] * K, *x.shape[1:])

    def rollout_costs(qpos, qvel, time, cand):
        qp = lanes(qpos).T.contiguous()
        qv = lanes(qvel).T.contiguous()
        rows = cand.permute(1, 2, 0).contiguous()
        plane = lanes(planes_of(qpos[:, None]).T).T.contiguous()
        prev, t, disc, total = cand[:, 0], lanes(time), 1.0, None
        for h in range(H):
            ctrl = cand[:, h]
            qp, qv = roll(qp, qv, rows[h], plane)
            t = t + dt_tick
            c = step_cost(State(qpos=qp.T, qvel=qv.T, time=t), ctrl,
                          prev) * disc
            total = c if total is None else total + c
            prev = ctrl
            disc = disc * mppi["gamma"]
        return total

    def update(c, cand):
        """The softmax-weighted nominal of one tick's K plans."""
        c = torch.where(torch.isfinite(c), c, torch.full_like(c, 1e9))
        beta = torch.min(c, dim=1).values
        w = torch.exp(-(c - beta[:, None]) / mppi["temperature"])
        new = torch.einsum("sk,skhu->shu", w, cand)
        return new / torch.sum(w, dim=1)[:, None, None], beta, c

    def tick(qpos, qvel, time, nominal, normals, tf32=False):
        B = qpos.shape[0]
        with (_TF32() if tf32 else contextlib.nullcontext()):
            cand = candidates_of(nominal, normals)
            c = rollout_costs(qpos, qvel, time,
                              cand.reshape(B * K, H, -1)).reshape(B, K)
            outs = [update(c[b:b + 1], cand[b:b + 1]) for b in range(B)]
            new = torch.cat([o[0] for o in outs])
            ctrl = new[:, 0]
            qp, qv = plant(qpos.T.contiguous(), qvel.T.contiguous(),
                           ctrl.T.contiguous(), planes_of(qpos))
        return dict(ctrl=ctrl,
                    nominal=torch.cat([new[:, 1:], new[:, -1:]], dim=1),
                    qpos=qp.T, qvel=qv.T,
                    best_cost=torch.cat([o[1] for o in outs]),
                    mean_cost=torch.cat([torch.sum(o[2], dim=1)
                                         for o in outs]) / K)

    return tick
