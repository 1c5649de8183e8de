"""Receding-horizon MPC loop at a 50 Hz control rate.

Port of ``opendog_tpu/solvers/mpc.py`` (``MPCCarry``, ``make_mpc`` and the
flat kernel plant of ``_make_plant_step``, lines 73-87 and 98-180): one
``tick`` re-plans with the MPPI solver and advances the plant one 50 Hz
step through the same substep kernel (K = 1, ``plant_substeps`` substeps at
the model's timestep in one launch).  ``run`` is a Python loop over ticks.
The host-pipelined ``RealtimeController`` and terrain are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import build_cuda_substep
from ..physics import State
from . import mppi


@dataclass
class MPCCarry:
    plant: State
    solver: mppi.MPPIState
    generator: Optional[torch.Generator]
    # FIFO of not-yet-applied controls when ctrl_lag > 0, shape (lag, nu);
    # None when the loop runs lag-free
    ctrl_queue: Optional[torch.Tensor] = None


def _make_plant_step(model, plant_substeps: int, device) -> Callable:
    """One 50 Hz plant tick: ``plant_substeps`` kernel substeps at the
    model's timestep, K = 1, one launch."""
    plant_sub = build_cuda_substep(model, model.timestep,
                                   n_substeps=plant_substeps, device=device)

    def plant_step(st: State, ctrl: torch.Tensor) -> State:
        qp, qv = plant_sub(st.qpos[:, None], st.qvel[:, None], ctrl[:, None])
        t2 = st.time + plant_substeps * float(model.timestep)
        return State(qpos=qp[:, 0], qvel=qv[:, 0], time=t2)

    return plant_step


def make_mpc(
    model,
    step_cost: Callable,
    config: mppi.MPPIConfig = mppi.MPPIConfig(),
    plant_substeps: int = 10,
    ctrl_lag: int = 0,
    lag_compensation: bool = False,
    device=None,
):
    """Returns ``(init(generator, physics_state) -> carry,
    tick(carry, normals=None) -> (carry, info),
    run(carry, n, normals=None) -> (carry, traj))`` on ``device`` (CUDA
    unless the caller names another).

    ``ctrl_lag`` makes the plant apply the solve from ``ctrl_lag`` ticks
    ago (the deployment pipeline's delay); ``lag_compensation`` rolls the
    current plant state forward through the queued controls before solving,
    so each solve plans from the state its action will land on.  ``normals``
    passes each solve's (K, H, nu) noise draw (``run``: one per tick,
    stacked); without it the carry's generator draws on the device."""
    device = resolve_device(device)
    use_full_fp32()
    model = model.to(device)
    solve = mppi.make_solver(model, step_cost, config, device=device)
    plant_step = _make_plant_step(model, plant_substeps, device)
    rng = model.actuator_ctrlrange
    hold_ctrl = torch.clamp(model.key_ctrl[0], rng[:, 0], rng[:, 1])

    def init(generator: Optional[torch.Generator],
             physics_state: State) -> MPCCarry:
        queue = (hold_ctrl[None].repeat(ctrl_lag, 1) if ctrl_lag > 0
                 else None)
        plant = State(qpos=physics_state.qpos.to(device),
                      qvel=physics_state.qvel.to(device),
                      time=physics_state.time.to(device))
        return MPCCarry(plant=plant, solver=mppi.init_state(model, config),
                        generator=generator, ctrl_queue=queue)

    def tick(carry: MPCCarry, normals: Optional[torch.Tensor] = None):
        solve_from = carry.plant
        if ctrl_lag > 0 and lag_compensation:
            # predict the state this solve's action will land on
            for i in range(ctrl_lag):
                solve_from = plant_step(solve_from, carry.ctrl_queue[i])
        ctrl, solver_state, stats = solve(solve_from, carry.solver,
                                          carry.generator, normals)
        if ctrl_lag > 0:
            applied = carry.ctrl_queue[0]
            queue = torch.cat([carry.ctrl_queue[1:], ctrl[None]], dim=0)
        else:
            applied, queue = ctrl, carry.ctrl_queue
        plant = plant_step(carry.plant, applied)
        out = dict(ctrl=applied, qpos=plant.qpos, qvel=plant.qvel, **stats)
        if ctrl_lag > 0 and lag_compensation:
            # the predicted application state; with a deterministic plant it
            # equals the actual plant state ctrl_lag ticks later
            out["solve_from_qpos"] = solve_from.qpos
        return replace(carry, plant=plant, solver=solver_state,
                       ctrl_queue=queue), out

    def run(carry: MPCCarry, n_ticks: int,
            normals: Optional[torch.Tensor] = None):
        outs = []
        for i in range(n_ticks):
            carry, out = tick(carry, None if normals is None else normals[i])
            outs.append(out)
        traj = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return carry, traj

    return init, tick, run
