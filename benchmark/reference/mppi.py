"""The plain closed-loop MPC tick: one MPPI solve and one plant step.

Written from the program's description of a tick (sample smoothed, clipped
plans around the nominal; roll all of them out on the substep; cost every
step; move the nominal to the softmax-weighted mean; shift it; step the
plant 50 Hz) on the frozen copies beside this file: the plain substep
(``scalar_core``) and the op-graph step (``physics.dynamics``).  It imports
nothing of the program.

``tick`` judges B ticks at once: tick b's K rollouts are lanes ``[b K, (b +
1) K)`` of one plain substep call per control step.  The substep and the
cost are elementwise over lanes, so lane b k computes what it would alone;
the update and the op-graph plant, whose reductions and products follow
their shapes, run one tick at a time at the program's shapes.  On the
card the plain substep rounds as the substep kernels do (``-fmad=false``),
so a sound program reads no gap there.

``tf32=True`` gives the control: every matrix product of the tick (the
weighted update, and the products inside the op-graph step) takes operands
rounded to TF32's 10-bit mantissa, as the card's TF32 path does, and sums
in float32.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

from . import costs, scalar_core
from .physics import State, Terrain, dynamics


def plain_substep(model, dt: float, n_substeps: int,
                  with_plane=False) -> Callable:
    """``step(qpos (nq, L), qvel (nv, L), ctrl (nu, L), plane=None) ->
    (qpos', qvel')``: ``n_substeps`` plain substeps (a copy of the
    program's ``build_plain_substep``)."""
    sub = scalar_core.build_substep(model, dt, with_plane, False)

    def step(qpos, qvel, ctrl, plane=None):
        qp, qv, ct = qpos.unbind(0), qvel.unbind(0), ctrl.unbind(0)
        pl = plane.unbind(0) if plane is not None else None
        for _ in range(n_substeps):
            qp, qv = sub(qp, qv, ct, pl, None)
        return torch.stack(qp), torch.stack(qv)

    return step


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest value with a 10-bit mantissa
    (ties away from zero), as TF32 takes a product's operands."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum}


class _TF32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_tf32(a) if torch.is_tensor(a)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **kwargs)


def cost_of(model, spec: Dict) -> Callable:
    """The step cost a configuration names (``spec["cost"]``)."""
    home = model.key_qpos[0, 7:]
    if spec["name"] == "trot":
        params = costs.TrotCostParams(
            desired_vel_xy=tuple(spec["desired_vel_xy"]),
            target_height=spec["target_height"])
        return costs.trot_cost(model, params, home, legs=spec["legs"])
    if spec["name"] == "standing":
        return costs.standing_cost(model, spec["target_height"], home)
    raise ValueError(f"unknown cost {spec['name']!r}")


def build_tick(model, step_cost: Callable, mppi: Dict, plant_substeps: int,
               terrain: Optional[Terrain] = None) -> Callable:
    """``tick(qpos (B, nq), qvel (B, nv), time (B,), nominal (B, H, nu),
    normals (B, K, H, nu), tf32=False) -> dict`` of ``ctrl`` (B, nu),
    ``nominal`` (B, H, nu) shifted, ``qpos`` / ``qvel`` after the plant,
    ``best_cost`` and ``mean_cost`` (B,).  ``mppi`` holds the solver's
    numbers (``horizon``, ``num_samples``, ``n_substeps``, ``rollout_dt``,
    ``noise_sigma``, ``temperature``, ``smooth_alpha``, ``gamma``).  With a
    terrain the rollouts contact the tangent plane under the trunk (one
    plane per tick) and the plant is the op-graph step on the terrain
    itself; without one, both run the flat plain substep."""
    H, K = mppi["horizon"], mppi["num_samples"]
    dt = mppi["rollout_dt"]
    dt_tick = dt * mppi["n_substeps"]
    lo = model.actuator_ctrlrange[:, 0]
    hi = model.actuator_ctrlrange[:, 1]
    roll = plain_substep(model, dt, mppi["n_substeps"],
                         with_plane=terrain is not None)
    plant = (None if terrain is not None
             else plain_substep(model, model.timestep, plant_substeps))
    alpha, sigma = mppi["smooth_alpha"], mppi["noise_sigma"]

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

    def trunk_planes(qpos):
        h, n = dynamics._terrain_height_normal(model, terrain, qpos[:, :2])
        p0 = torch.stack([qpos[:, 0], qpos[:, 1], h], dim=-1)
        rows = torch.cat([n, torch.sum(n * p0, dim=-1)[:, None]], dim=-1)
        return lanes(rows).T.contiguous()

    def rollout_costs(qpos, qvel, time, cand):
        qp = lanes(qpos).T.contiguous()
        qv = lanes(qvel).T.contiguous()
        rows = cand.permute(1, 2, 0).contiguous()
        plane = trunk_planes(qpos) if terrain is not None else None
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

    def plant_step(qpos, qvel, time, ctrl):
        if terrain is not None:
            st = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=time),
                               ctrl, terrain, n_substeps=plant_substeps)[0]
            return st.qpos, st.qvel
        qp, qv = plant(qpos.T.contiguous(), qvel.T.contiguous(),
                       ctrl.T.contiguous())
        return qp.T, qv.T

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
            # one tick at a time from here, at the program's shapes: a
            # reduction's order follows its shape
            outs = [update(c[b:b + 1], cand[b:b + 1]) for b in range(B)]
            new = torch.cat([o[0] for o in outs])
            ctrl = new[:, 0]
            if terrain is None:
                qp, qv = plant_step(qpos, qvel, time, ctrl)
            else:
                steps = [plant_step(qpos[b], qvel[b], time[b], ctrl[b])
                         for b in range(B)]
                qp = torch.stack([s[0] for s in steps])
                qv = torch.stack([s[1] for s in steps])
        return dict(ctrl=ctrl,
                    nominal=torch.cat([new[:, 1:], new[:, -1:]], dim=1),
                    qpos=qp, qvel=qv,
                    best_cost=torch.cat([o[1] for o in outs]),
                    mean_cost=torch.cat([torch.sum(o[2], dim=1)
                                         for o in outs]) / K)

    return tick
