"""MPPI (Model Predictive Path Integral) solver on the substep kernel or
the op-graph physics step.

Port of ``opendog_tpu/solvers/mppi.py`` on one device, on flat ground or on
a terrain, with or without a carried payload: no sample mesh, command,
anchor or terminal cost (ROADMAP M10, M14).  One solve samples K smoothed,
clipped control plans around the nominal, rolls all of them out, and moves
the nominal to their softmax-weighted mean.  Two rollout engines, named
after what runs them (the JAX package names them after its backends):

* ``engine="kernel"`` (JAX ``"pallas"``): the substep kernel, one launch
  per control step for all K rollouts (``rollout_costs_pallas``); on a
  terrain the rollouts contact local tangent planes.
* ``engine="ops"`` (JAX ``"xla"``, the JAX default): the op-graph step
  ``physics.dynamics.step`` over all K rollouts at once, with exact
  bilinear terrain contact and static boxes (the Go1 ``jump`` and
  ``landing`` platforms need it: the kernel has no box contact).

Noise: the JAX package draws one key per sample; PyTorch cannot reproduce
those bits.  ``solve`` therefore takes the ``(K, H, nu)`` standard-normal
draw as an argument (``normals``) or draws it on the device from a
``torch.Generator``.

On the card :func:`graph_solve` replays a solve from a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import build_cuda_substep
from ..physics import State, Terrain, dynamics
from .graph import GraphedTick

PLANE_MODES = ("trunk", "per_geom")
ENGINES = ("kernel", "ops")


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
    engine: str = "kernel"     # rollout physics: "kernel" (the substep
    # kernel, JAX "pallas") or "ops" (the op-graph step, JAX "xla")


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
    With ``engine="ops"`` the rollouts run the op-graph step on the
    terrain itself (exact bilinear contact; ``plane_mode`` is unused).
    With ``with_payload=True`` (kernel engine only) the solve takes a
    trailing ``payload``, a point mass [kg] rigidly attached at the trunk
    origin that every rollout carries (K2): a float, or a one-element
    float32 tensor on the device.

    A solve copies no host data to the device and reads nothing back, so
    :func:`graph_solve` can capture it in a CUDA graph."""
    if config.engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES} (the JAX "
                         "package's 'pallas' and 'xla'), got "
                         f"{config.engine!r}")
    if with_payload and config.engine != "kernel":
        raise ValueError("payload-aware solves ride the substep kernel's "
                         "payload rows: with_payload=True needs "
                         "engine='kernel'")
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
    if config.engine == "kernel":
        with_plane = (False if terrain is None
                      else "per_geom" if plane_mode == "per_geom" else True)
        psub = build_cuda_substep(model, dt, n_substeps=config.n_substeps,
                                  device=device, with_plane=with_plane,
                                  with_payload=with_payload)
    else:
        rollout_model = model.replace(timestep=dt)

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

    def rollout_costs_kernel(state: State, candidates: torch.Tensor,
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
            extra["payload"] = payload.reshape(1, 1).expand(1, k).contiguous()
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

    def rollout_costs_ops(state: State, candidates: torch.Tensor,
                          payload=None) -> torch.Tensor:
        """(K,) total cost of every candidate plan: the op-graph step over
        all K rollouts at once, one call per control step (the JAX
        package's vmapped ``rollout_cost``)."""
        k = candidates.shape[0]
        st = State(qpos=state.qpos.expand(k, model.nq),
                   qvel=state.qvel.expand(k, model.nv),
                   time=state.time.expand(k))
        prev_ctrl = candidates[:, 0]
        disc = 1.0
        total = None
        for h in range(H):
            ctrl = candidates[:, h]
            st, _ = dynamics.step(rollout_model, st, ctrl, terrain,
                                  n_substeps=config.n_substeps)
            c = step_cost(st, ctrl, prev_ctrl) * disc
            total = c if total is None else total + c
            prev_ctrl = ctrl
            disc = disc * config.gamma
        return total

    rollout_costs = (rollout_costs_kernel if config.engine == "kernel"
                     else rollout_costs_ops)

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
        if with_payload and not torch.is_tensor(payload):
            # a fill, not a copy of host data: a graph can capture it
            payload = torch.full((), float(payload), dtype=torch.float32,
                                 device=device)
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


def graph_solve(solve: Callable, state: State, mppi_state: MPPIState,
                normals: torch.Tensor, *aux):
    """``solve`` (of :func:`make_solver`) captured in a CUDA graph
    (:class:`~.graph.GraphedTick`) from these example inputs, on the device
    of ``normals``: returns ``gsolve(state, mppi_state, generator=None,
    normals=None, *aux) -> (ctrl, mppi_state', stats)``, which computes what
    ``solve`` computes.  Without ``normals`` it draws them with
    ``generator`` into the graph's static buffer before the replay, as
    ``solve`` draws them; a float ``aux`` (the payload) is filled into its
    buffer.  Its outputs are static tensors that the next call overwrites:
    clone what you keep.  Raises on a device other than CUDA."""

    def fn(qpos, qvel, time, nominal, normals, *aux):
        ctrl, ms, stats = solve(State(qpos=qpos, qvel=qvel, time=time),
                                MPPIState(nominal=nominal), None, normals,
                                *aux)
        return ctrl, ms.nominal, stats

    device = normals.device
    aux_t = [a if torch.is_tensor(a) else
             torch.full((), float(a), dtype=torch.float32, device=device)
             for a in aux]
    graph = GraphedTick(fn, (state.qpos, state.qvel, state.time,
                             mppi_state.nominal, normals, *aux_t), device)
    bufs = graph.inputs

    def gsolve(state: State, mppi_state: MPPIState,
               generator: Optional[torch.Generator] = None,
               normals: Optional[torch.Tensor] = None, *aux):
        if normals is None:
            normals = bufs[4]
            torch.randn(normals.shape, generator=generator, out=normals)
        aux = [a if torch.is_tensor(a) else bufs[5 + i].fill_(float(a))
               for i, a in enumerate(aux)]
        ctrl, nominal, stats = graph(state.qpos, state.qvel, state.time,
                                     mppi_state.nominal, normals, *aux)
        return ctrl, MPPIState(nominal=nominal), stats

    gsolve.graph = graph
    return gsolve
