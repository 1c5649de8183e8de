"""MPPI (Model Predictive Path Integral) solver on the substep kernel or
the op-graph physics step.

Port of ``opendog_tpu/solvers/mppi.py``, on flat ground or on a terrain,
with or without a carried payload, a runtime command, an anchor to an
action reference and a terminal cost, on one device or with the K samples
sharded over a mesh of ranks (``make_solver(..., mesh=)``).  One solve
samples K smoothed, clipped control plans around the nominal, rolls all of
them out, and moves the nominal to their softmax-weighted mean.  Two
rollout engines, named after what runs them
(the JAX package names them after its backends):

* ``engine="kernel"`` (JAX ``"pallas"``): the substep kernel, one launch
  per control step for all K rollouts (``rollout_costs_pallas``); on a
  terrain the rollouts contact local tangent planes.
* ``engine="ops"`` (JAX ``"xla"``, the JAX default): the op-graph step
  ``physics.dynamics.step`` over all K rollouts at once, with exact
  bilinear terrain contact and static boxes (the Go1 ``jump`` and
  ``landing`` platforms need it: the kernel has no box contact).

:func:`make_batched_solver` is the counterpart of ``jax.vmap(solve)`` over
S scenarios: each rollout step is one launch over S x K lanes, scenario s
owning lanes ``[s K, (s + 1) K)``, and the update reduces over K within
each scenario.  :func:`make_solver` is the same solve at S = 1.

Noise: the JAX package draws one key per sample; PyTorch cannot reproduce
those bits.  ``solve`` therefore takes the ``(K, H, nu)`` (batched: ``(S,
K, H, nu)``) standard-normal draw as an argument (``normals``) or draws it
on the device from a ``torch.Generator``.

With ``mesh`` (``parallel.sample_mesh``) every rank takes the same global
(K, H, nu) normals and rolls out its block of ``K / n`` samples, and the
softmax-weighted update reduces over the ranks with ``pmin`` and ``psum``
(``parallel.collectives``), as the JAX solve does under ``shard_map``.

On the card :func:`graph_solve` replays a solve, single or batched, from a
CUDA graph; with a mesh, only on an NCCL group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import build_cuda_substep
from ..parallel import collectives
from ..physics import State, Terrain, dynamics
from .costs import ref_takes_cmd
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


def init_state(model, config: MPPIConfig, key_name: str = "home",
               scenarios: Optional[int] = None) -> MPPIState:
    """The keyframe's control held over the horizon: nominal (H, nu), or
    (S, H, nu) for ``scenarios`` = S (a batched solver's state)."""
    ctrl0 = model.key_ctrl[model.key_id(key_name)]
    nominal = ctrl0[None].repeat(config.horizon, 1)
    if scenarios is not None:
        nominal = nominal[None].repeat(scenarios, 1, 1)
    return MPPIState(nominal=nominal)


def _make_core(model, step_cost: Callable, config: MPPIConfig, device,
               terrain: Optional[Terrain], with_payload: bool,
               plane_mode: str, terminal_cost: Optional[Callable],
               with_command: bool, u_ref_fn: Optional[Callable],
               anchor_w: float, mesh=None):
    """Checks the options and builds ``core(qpos (S, nq), qvel (S, nv), time
    (S,), nominal (S, H, nu), normals (S, K_local, H, nu), payload (S,) or
    None, command (S, c) or None) -> (ctrl (S, nu), shifted nominal (S, H,
    nu), stats of (S,))``, the solve of S scenarios at once.  With ``mesh``
    the K samples are spread over its ranks, K_local = K / n on each, and
    the update reduces over the ranks.  Returns ``(core, device)``."""
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
    anchored = u_ref_fn is not None and anchor_w > 0.0
    ref_cmd = anchored and ref_takes_cmd(u_ref_fn)
    if ref_cmd and not with_command:
        raise ValueError("a command-indexed u_ref_fn (t, cmd) needs "
                         "with_command=True")
    device = resolve_device(device)
    use_full_fp32()
    model = model.to(device)
    ctrlrange = model.actuator_ctrlrange
    lo, hi = ctrlrange[:, 0], ctrlrange[:, 1]
    H, K, nu = config.horizon, config.num_samples, model.nu
    K_local = K // (1 if mesh is None else mesh.size)
    dt = float(config.rollout_dt) if config.rollout_dt else model.timestep
    dt_tick = dt * config.n_substeps
    # plan slot k applies from state.time + k * dt_tick (the distiller's
    # label is expert - u_ref(state.time) at k = 0)
    slot_times = dt_tick * torch.arange(H, dtype=torch.float32,
                                        device=device)
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

    def bind_cost(command):
        """The step cost with the lanes' commands bound (the cost itself
        when the solver takes no command)."""
        if command is None:
            return step_cost
        return lambda st, c, p: step_cost(st, c, p, command)

    def lanes(x: torch.Tensor) -> torch.Tensor:
        """(S, ...) per-scenario rows -> (S K_local, ...) per-lane rows."""
        return x[:, None].expand(x.shape[0], K_local, *x.shape[1:]).reshape(
            x.shape[0] * K_local, *x.shape[1:])

    def local_planes(qpos: torch.Tensor) -> torch.Tensor:
        """Contact plane rows of the rollouts, (rows, S K): the terrain's
        tangent plane(s) under each scenario's solve-from state.
        ``"trunk"``: one plane at the trunk's xy shared by every geom (4
        rows); ``"per_geom"``: each geom's own plane (4 * ngeom rows)."""
        if plane_mode == "per_geom":
            planes = dynamics.geom_local_planes(model, terrain, qpos)
            rows = planes.reshape(qpos.shape[0], -1)  # 4g..4g+3 per geom
        else:
            h, n = dynamics._terrain_height_normal(model, terrain,
                                                   qpos[:, :2])
            p0 = torch.stack([qpos[:, 0], qpos[:, 1], h], dim=-1)
            rows = torch.cat([n, torch.sum(n * p0, dim=-1)[:, None]], dim=-1)
        return lanes(rows).T.contiguous()

    def rollout_costs_kernel(qpos, qvel, time, candidates, payload,
                             command):
        """(S K,) total cost of every lane's plan: carry in the (rows, S K)
        layout, one kernel launch per control step."""
        L = candidates.shape[0]
        cost_fn = bind_cost(command)
        qp = lanes(qpos).T.contiguous()
        qv = lanes(qvel).T.contiguous()
        ctrl_rows = candidates.permute(1, 2, 0).contiguous()  # (H, nu, L)
        extra = {}
        if terrain is not None:
            extra["plane"] = local_planes(qpos)
        if with_payload:
            extra["payload"] = lanes(payload).reshape(1, L).contiguous()
        prev_ctrl = candidates[:, 0]
        t = lanes(time)
        disc = 1.0
        total = None
        for h in range(H):
            ctrl = candidates[:, h]
            qp, qv = psub(qp, qv, ctrl_rows[h], **extra)
            t = t + dt_tick
            st = State(qpos=qp.T, qvel=qv.T, time=t)
            c = cost_fn(st, ctrl, prev_ctrl) * disc
            total = c if total is None else total + c
            prev_ctrl = ctrl
            disc = disc * config.gamma
        if terminal_cost is not None:
            total = total + terminal_cost(st)
        return total

    def rollout_costs_ops(qpos, qvel, time, candidates, payload, command):
        """(S K,) total cost of every lane's plan: the op-graph step over
        all lanes at once, one call per control step (the JAX package's
        vmapped ``rollout_cost``)."""
        cost_fn = bind_cost(command)
        st = State(qpos=lanes(qpos), qvel=lanes(qvel), time=lanes(time))
        prev_ctrl = candidates[:, 0]
        disc = 1.0
        total = None
        for h in range(H):
            ctrl = candidates[:, h]
            st, _ = dynamics.step(rollout_model, st, ctrl, terrain,
                                  n_substeps=config.n_substeps)
            c = cost_fn(st, ctrl, prev_ctrl) * disc
            total = c if total is None else total + c
            prev_ctrl = ctrl
            disc = disc * config.gamma
        if terminal_cost is not None:
            total = total + terminal_cost(st)
        return total

    rollout_costs = (rollout_costs_kernel if config.engine == "kernel"
                     else rollout_costs_ops)

    def sample_candidates(nominal: torch.Tensor,
                          normals: torch.Tensor) -> torch.Tensor:
        """(S, K, H, nu) clipped candidate plans.  Colored (low-pass)
        exploration noise keeps the position servos from chattering."""
        e = normals * config.noise_sigma
        c = torch.zeros_like(e[:, :, 0])
        eps = []
        for h in range(H):
            c = (config.smooth_alpha * c
                 + (1 - config.smooth_alpha) * e[:, :, h])
            eps.append(c)
        eps = torch.stack(eps, dim=2)
        return torch.clamp(nominal[:, None] + eps, lo, hi)

    def ref_seq(time, command):
        """(S, H, nu) anchor targets, u_ref at each plan slot's time."""
        ts = time[:, None] + slot_times
        if ref_cmd:
            return u_ref_fn(ts, command[:, None].expand(
                command.shape[0], H, command.shape[-1]))
        return u_ref_fn(ts)

    def weighted_update(candidates, costs):
        """Softmax-weighted nominal of each scenario, reduced over its K
        lanes; with a mesh, ``pmin`` of the best cost and one ``psum`` of
        the weighted sums over the ranks (``mppi.py:304-330``)."""
        beta = torch.min(costs, dim=1).values
        if mesh is not None:
            beta = collectives.pmin(beta, mesh)
        w_un = torch.exp(-(costs - beta[:, None]) / config.temperature)
        denom = torch.sum(w_un, dim=1)
        new_nominal = torch.einsum("sk,skhu->shu", w_un, candidates)
        sum_cost = torch.sum(costs, dim=1)
        sum_w2_un = torch.sum(torch.square(w_un), dim=1)
        if mesh is not None:
            S = costs.shape[0]
            sums = collectives.psum(torch.cat(
                [new_nominal.reshape(S, H * nu), denom[:, None],
                 sum_cost[:, None], sum_w2_un[:, None]], dim=1), mesh)
            new_nominal = sums[:, :H * nu].reshape(S, H, nu)
            denom, sum_cost, sum_w2_un = sums[:, H * nu:].unbind(1)
        stats = dict(
            best_cost=beta,
            mean_cost=sum_cost / K,
            # effective sample size of the normalised weights
            ess=torch.square(denom) / sum_w2_un,
        )
        return new_nominal / denom[:, None, None], stats

    def core(qpos, qvel, time, nominal, normals, payload=None,
             command=None):
        S = qpos.shape[0]
        candidates = sample_candidates(nominal, normals)
        flat = candidates.reshape(S * K_local, H, nu)
        costs = rollout_costs(
            qpos, qvel, time, flat, payload,
            None if command is None else lanes(command)).reshape(S, K_local)
        if anchored:
            costs = costs + anchor_w * torch.sum(torch.square(
                candidates - ref_seq(time, command)[:, None]), dim=(2, 3))
        # diverged rollouts must not poison the softmax: treat non-finite
        # costs as very bad, not NaN
        costs = torch.where(torch.isfinite(costs), costs,
                            torch.full_like(costs, 1e9))
        new_nominal, stats = weighted_update(candidates, costs)
        ctrl = new_nominal[:, 0]
        # receding horizon: shift, repeat last
        shifted = torch.cat([new_nominal[:, 1:], new_nominal[:, -1:]], dim=1)
        return ctrl, shifted, stats

    return core, device


def _trailing(aux, with_payload: bool, with_command: bool, S: int, device):
    """(payload (S,) or None, command (S, c) or None) from a solve's
    trailing arguments ``[payload][, command]``.  A float payload becomes a
    fill, not a copy of host data, so a graph can capture it."""
    expect = int(with_payload) + int(with_command)
    if len(aux) != expect:
        raise ValueError(
            f"solver built with_payload={with_payload}, with_command="
            f"{with_command}: expected {expect} trailing args (payload "
            f"first), got {len(aux)}")
    payload = command = None
    if with_payload:
        payload = aux[0]
        if torch.is_tensor(payload):
            payload = payload.reshape(-1).expand(S)
        else:
            payload = torch.full((S,), float(payload), dtype=torch.float32,
                                 device=device)
    if with_command:
        command = aux[-1].reshape(S, -1)
    return payload, command


def make_solver(
    model,
    step_cost: Callable,
    config: MPPIConfig = MPPIConfig(),
    device=None,
    terrain: Optional[Terrain] = None,
    with_payload: bool = False,
    plane_mode: str = "trunk",
    terminal_cost: Optional[Callable] = None,
    with_command: bool = False,
    u_ref_fn: Optional[Callable] = None,
    anchor_w: float = 0.0,
    mesh=None,
):
    """Build ``solve(physics_state, mppi_state, generator=None, normals=None
    [, payload][, command]) -> (ctrl, mppi_state', stats)`` on ``device``
    (CUDA unless the caller names another; with ``mesh``, the mesh's
    device).

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

    With ``with_command=True`` the solve takes a trailing ``command`` (a
    (c,) tensor, after the payload) passed to ``step_cost(state, ctrl,
    prev_ctrl, command)`` (``costs.trot_cost_cmd``).  ``terminal_cost(state)``
    adds a cost of each rollout's final state.  With ``u_ref_fn`` and
    ``anchor_w > 0`` every plan pays ``anchor_w * sum_k ||u_k - u_ref(t +
    k dt)||^2``, which keeps the expert from re-timing the gait against
    the reference; ``u_ref_fn`` is ``(t)`` or, with ``with_command``,
    ``(t, cmd)`` (``costs.ref_takes_cmd``), batch-first.

    With ``mesh`` (a one-axis ``parallel.Mesh``) the K samples are
    sharded over its n ranks (``mppi.py:137-139``, ``:345-373``):
    every rank takes the same global normals, drawn from one seeded
    generator on every rank or passed in, and rolls out its block of K / n
    (rank i: samples ``[i K / n, (i + 1) K / n)``, the JAX split of the
    per-sample keys); the update takes ``pmin`` of the best cost and
    ``psum`` of the weighted sums, and ``mean_cost`` divides by the global
    K.  Every rank returns the same bits; with one rank the solve equals the
    unsharded one bit for bit.  Raises where n does not divide K.

    A solve copies no host data to the device and reads nothing back, so
    :func:`graph_solve` can capture it in a CUDA graph (with a mesh, on an
    NCCL group only)."""
    H, K, nu = config.horizon, config.num_samples, model.nu
    if mesh is not None:
        if K % mesh.size:
            raise ValueError(f"num_samples ({K}) must divide over the "
                             f"sample mesh's {mesh.size} ranks")
        device = mesh.on_device(device)
    core, device = _make_core(model, step_cost, config, device, terrain,
                              with_payload, plane_mode, terminal_cost,
                              with_command, u_ref_fn, anchor_w, mesh)
    K_local = K // (1 if mesh is None else mesh.size)
    first = 0 if mesh is None else mesh.index * K_local

    def solve(state: State, mppi: MPPIState,
              generator: Optional[torch.Generator] = None,
              normals: Optional[torch.Tensor] = None, *aux):
        payload, command = _trailing(aux, with_payload, with_command, 1,
                                     device)
        if normals is None:
            normals = torch.randn((K, H, nu), generator=generator,
                                  device=device, dtype=torch.float32)
        elif normals.shape != (K, H, nu):
            raise ValueError(f"normals must have shape {(K, H, nu)}, got "
                             f"{tuple(normals.shape)}")
        ctrl, nominal, stats = core(
            state.qpos[None], state.qvel[None], state.time.reshape(1),
            mppi.nominal[None], normals[None, first:first + K_local],
            payload, command)
        return (ctrl[0], MPPIState(nominal=nominal[0]),
                {k: v[0] for k, v in stats.items()})

    solve.mesh = mesh
    return solve


def make_batched_solver(
    model,
    step_cost: Callable,
    config: MPPIConfig = MPPIConfig(),
    scenarios: int = 1,
    device=None,
    terrain: Optional[Terrain] = None,
    with_payload: bool = False,
    plane_mode: str = "trunk",
    terminal_cost: Optional[Callable] = None,
    with_command: bool = False,
    u_ref_fn: Optional[Callable] = None,
    anchor_w: float = 0.0,
):
    """The counterpart of ``jax.vmap(solve)`` over ``scenarios`` = S:
    ``solve(physics_states, mppi_states, generator=None, normals=None
    [, payloads][, commands]) -> (ctrls (S, nu), mppi_states', stats)``.

    States carry a leading S axis (``qpos`` (S, nq), ``time`` (S,)), as do
    the nominals (S, H, nu), ``payloads`` (S,) (or one float for all) and
    ``commands`` (S, c); ``normals`` is (S, K, H, nu).  Each rollout step
    is one kernel launch over S K lanes, scenario s on lanes ``[s K, (s +
    1) K)``; ``best_cost``, ``mean_cost`` and ``ess`` are (S,), each
    reduced over its scenario's K lanes.  Per scenario it computes what
    :func:`make_solver`'s solve computes on the same normals.  The options
    are :func:`make_solver`'s."""
    if scenarios < 1:
        raise ValueError(f"scenarios must be >= 1, got {scenarios}")
    core, device = _make_core(model, step_cost, config, device, terrain,
                              with_payload, plane_mode, terminal_cost,
                              with_command, u_ref_fn, anchor_w)
    S, H, K, nu = scenarios, config.horizon, config.num_samples, model.nu

    def solve(states: State, mppi: MPPIState,
              generator: Optional[torch.Generator] = None,
              normals: Optional[torch.Tensor] = None, *aux):
        if states.qpos.shape[0] != S or mppi.nominal.shape != (S, H, nu):
            raise ValueError(
                f"expected {S} scenarios: qpos (S, nq) and nominal "
                f"{(S, H, nu)}, got {tuple(states.qpos.shape)} and "
                f"{tuple(mppi.nominal.shape)}")
        payload, command = _trailing(aux, with_payload, with_command, S,
                                     device)
        if normals is None:
            normals = torch.randn((S, K, H, nu), generator=generator,
                                  device=device, dtype=torch.float32)
        elif normals.shape != (S, K, H, nu):
            raise ValueError(f"normals must have shape {(S, K, H, nu)}, "
                             f"got {tuple(normals.shape)}")
        ctrl, nominal, stats = core(states.qpos, states.qvel,
                                    states.time.reshape(S), mppi.nominal,
                                    normals, payload, command)
        return ctrl, MPPIState(nominal=nominal), stats

    return solve


def graph_solve(solve: Callable, state: State, mppi_state: MPPIState,
                normals: torch.Tensor, *aux):
    """``solve`` (of :func:`make_solver`, or of :func:`make_batched_solver`
    with batched example inputs) captured in a CUDA graph
    (:class:`~.graph.GraphedTick`) from these example inputs, on the device
    of ``normals``: returns ``gsolve(state, mppi_state, generator=None,
    normals=None, *aux) -> (ctrl, mppi_state', stats)``, which computes what
    ``solve`` computes.  Without ``normals`` it draws them with
    ``generator`` into the graph's static buffer before the replay, as
    ``solve`` draws them; a float ``aux`` (the payload) is filled into its
    buffer.  Its outputs are static tensors that the next call overwrites:
    clone what you keep.  Raises on a device other than CUDA, and for a
    solve sharded over a gloo group (a graph cannot hold its
    collectives)."""
    collectives.require_capturable(getattr(solve, "mesh", None),
                                   "graph_solve")

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
