"""MPPI (Model Predictive Path Integral) solver on the substep kernel.

Port of ``opendog_tpu/solvers/mppi.py`` on one device, on flat ground or on
a terrain (through the local contact planes of the substep kernel), with or
without a carried payload: no sample mesh, command, anchor or terminal cost
(ROADMAP M10, M14).  One solve samples K smoothed, clipped control plans
around the nominal, rolls all of them out through the substep kernel (one
launch per control step, the ``rollout_costs_pallas`` path of the JAX
package), and moves the nominal to their softmax-weighted mean.

Noise: the JAX package draws one key per sample; PyTorch cannot reproduce
those bits.  ``solve`` therefore takes the ``(K, H, nu)`` standard-normal
draw as an argument (``normals``) or draws it on the device from a
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import build_cuda_substep
from ..physics import State, Terrain, dynamics

PLANE_MODES = ("trunk", "per_geom")


@dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 25          # control steps (0.5 s at 50 Hz)
    num_samples: int = 256     # K rollouts per solve
    temperature: float = 0.3   # softmax lambda
    noise_sigma: float = 0.15  # exploration std in ctrl units [rad]
    n_substeps: int = 4        # physics substeps per control step
    rollout_dt: float = 0.0    # rollout physics dt; 0 -> model.timestep
    smooth_alpha: float = 0.6  # noise low-pass (colored exploration)
    gamma: float = 1.0         # cost discount
    engine: str = "kernel"     # the substep kernel (K1); the only engine
    # until the op-graph physics is ported (ROADMAP M8)


@dataclass
class MPPIState:
    """Carried between solves: the shifted nominal control plan."""

    nominal: torch.Tensor  # (H, nu)


def init_state(model, config: MPPIConfig, key_name: str = "home") -> MPPIState:
    ctrl0 = model.key_ctrl[model.key_id(key_name)]
    return MPPIState(nominal=ctrl0[None].repeat(config.horizon, 1))


def make_solver(
    model,
    step_cost: Callable,
    config: MPPIConfig = MPPIConfig(),
    device=None,
    terrain: Optional[Terrain] = None,
    with_payload: bool = False,
    plane_mode: str = "trunk",
):
    """Build ``solve(physics_state, mppi_state, generator=None, normals=None
    [, payload]) -> (ctrl, mppi_state', stats)`` on ``device`` (CUDA unless
    the caller names another).

    ``normals`` is the (K, H, nu) standard-normal draw before sigma,
    smoothing and clipping; when it is None the solve draws it with
    ``generator`` (a ``torch.Generator`` on the device) or the device's
    default generator.

    With ``terrain`` the rollouts contact the terrain's tangent plane(s)
    under the solve-from state, computed once per solve: with
    ``plane_mode="trunk"`` one plane at the trunk's xy shared by every
    geom (kernel K3), with ``"per_geom"`` each geom's own plane (K4).
    With ``with_payload=True`` the solve takes a trailing ``payload``, a
    point mass [kg] rigidly attached at the trunk origin that every rollout
    carries (K2)."""
    if config.engine != "kernel":
        raise ValueError(
            f"engine {config.engine!r} is not ported: the rollouts run on "
            "the substep kernel ('kernel'); the op-graph engine is ROADMAP M8")
    if plane_mode not in PLANE_MODES:
        raise ValueError(f"plane_mode must be one of {PLANE_MODES}, got "
                         f"{plane_mode!r}")
    device = resolve_device(device)
    use_full_fp32()
    model = model.to(device)
    ctrlrange = model.actuator_ctrlrange
    lo, hi = ctrlrange[:, 0], ctrlrange[:, 1]
    H, K, nu = config.horizon, config.num_samples, model.nu
    dt = float(config.rollout_dt) if config.rollout_dt else model.timestep
    dt_tick = dt * config.n_substeps
    if terrain is not None:
        terrain = terrain.to(device)
    with_plane = (False if terrain is None
                  else "per_geom" if plane_mode == "per_geom" else True)
    psub = build_cuda_substep(model, dt, n_substeps=config.n_substeps,
                              device=device, with_plane=with_plane,
                              with_payload=with_payload)

    def _local_plane(state: State, k: int) -> torch.Tensor:
        """Contact plane rows of the rollouts: the terrain's tangent
        plane(s) under the solve-from state.  ``"trunk"``: (4, k), one
        plane at the trunk's xy shared by every geom; ``"per_geom"``:
        (4 * ngeom, k), each geom's own plane."""
        if plane_mode == "per_geom":
            planes = dynamics.geom_local_planes(model, terrain, state.qpos)
            row = planes.reshape(-1)  # (ngeom, 4) row-major: 4g..4g+3
        else:
            h, n = dynamics._terrain_height_normal(model, terrain,
                                                   state.qpos[None, :2])
            n = n[0]
            p0 = torch.stack([state.qpos[0], state.qpos[1], h[0]])
            row = torch.cat([n, torch.dot(n, p0)[None]])  # (4,)
        return row[:, None].expand(row.shape[0], k).contiguous()

    def rollout_costs(state: State, candidates: torch.Tensor,
                      payload=None) -> torch.Tensor:
        """(K,) total cost of every candidate plan: carry in the (rows, K)
        layout, one kernel launch per control step."""
        k = candidates.shape[0]
        qp = state.qpos[:, None].expand(model.nq, k).contiguous()
        qv = state.qvel[:, None].expand(model.nv, k).contiguous()
        ctrl_rows = candidates.permute(1, 2, 0).contiguous()  # (H, nu, k)
        extra = {}
        if terrain is not None:
            extra["plane"] = _local_plane(state, k)
        if with_payload:
            extra["payload"] = torch.as_tensor(
                payload, dtype=torch.float32, device=device).reshape(
                1, 1).expand(1, k).contiguous()
        prev_ctrl = candidates[:, 0]
        t = state.time
        disc = 1.0
        total = None
        for h in range(H):
            ctrl = candidates[:, h]
            qp, qv = psub(qp, qv, ctrl_rows[h], **extra)
            t = t + dt_tick
            st = State(qpos=qp.T, qvel=qv.T, time=t.expand(k))
            c = step_cost(st, ctrl, prev_ctrl) * disc
            total = c if total is None else total + c
            prev_ctrl = ctrl
            disc = disc * config.gamma
        return total

    def sample_candidates(nominal: torch.Tensor,
                          normals: torch.Tensor) -> torch.Tensor:
        """(K, H, nu) clipped candidate plans.  Colored (low-pass)
        exploration noise keeps the position servos from chattering."""
        e = normals * config.noise_sigma
        c = torch.zeros_like(e[:, 0])
        eps = []
        for h in range(H):
            c = config.smooth_alpha * c + (1 - config.smooth_alpha) * e[:, h]
            eps.append(c)
        eps = torch.stack(eps, dim=1)
        return torch.clamp(nominal[None] + eps, lo, hi)

    def weighted_update(candidates, costs):
        beta = torch.min(costs)
        w_un = torch.exp(-(costs - beta) / config.temperature)
        denom = torch.sum(w_un)
        new_nominal = torch.einsum("k,khu->hu", w_un, candidates) / denom
        stats = dict(
            best_cost=beta,
            mean_cost=torch.sum(costs) / K,
            # effective sample size of the normalised weights
            ess=torch.square(denom) / torch.sum(torch.square(w_un)),
        )
        return new_nominal, stats

    def solve(state: State, mppi: MPPIState,
              generator: Optional[torch.Generator] = None,
              normals: Optional[torch.Tensor] = None, *aux):
        if len(aux) != int(with_payload):
            raise ValueError(
                f"solver built with_payload={with_payload}: expected "
                f"{int(with_payload)} trailing args (payload), got {len(aux)}")
        payload = aux[0] if with_payload else None
        if normals is None:
            normals = torch.randn((K, H, nu), generator=generator,
                                  device=device, dtype=torch.float32)
        elif normals.shape != (K, H, nu):
            raise ValueError(f"normals must have shape {(K, H, nu)}, got "
                             f"{tuple(normals.shape)}")
        candidates = sample_candidates(mppi.nominal, normals)
        costs = rollout_costs(state, candidates, payload)
        # diverged rollouts must not poison the softmax: treat non-finite
        # costs as very bad, not NaN
        costs = torch.where(torch.isfinite(costs), costs,
                            torch.full_like(costs, 1e9))
        new_nominal, stats = weighted_update(candidates, costs)
        ctrl = new_nominal[0]
        # receding horizon: shift, repeat last
        shifted = torch.cat([new_nominal[1:], new_nominal[-1:]], dim=0)
        return ctrl, MPPIState(nominal=shifted), stats

    return solve
