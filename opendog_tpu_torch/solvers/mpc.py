"""Receding-horizon MPC loop at a 50 Hz control rate.

Port of ``opendog_tpu/solvers/mpc.py`` (``MPCCarry``, ``make_mpc`` and the
kernel plants of ``_make_plant_step``, lines 33-87 and 98-180): one
``tick`` re-plans with the MPPI solver and advances the plant one 50 Hz
step through the substep kernel (K = 1, ``plant_substeps`` substeps at the
model's timestep in one launch): the flat kernel on flat ground, the
per-geom plane kernel on a terrain.  ``run`` is a Python loop over ticks.
:func:`graph_tick` replays a tick from a CUDA graph (the counterpart of the
JAX package's jitted tick), and :class:`RealtimeController` (lines
183-327) is the host-side pipelined 50 Hz tick of the robot bridge.  The
exact-bilinear terrain plant (it needs the op-graph step, ROADMAP M8) is
not ported yet.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import build_cuda_substep
from ..physics import State, Terrain, dynamics, make_state
from . import mppi
from .graph import GraphedTick

TERRAIN_PLANTS = ("exact", "kernel")


@dataclass
class MPCCarry:
    plant: State
    solver: mppi.MPPIState
    generator: Optional[torch.Generator]
    # FIFO of not-yet-applied controls when ctrl_lag > 0, shape (lag, nu);
    # None when the loop runs lag-free
    ctrl_queue: Optional[torch.Tensor] = None


def _check_terrain_plant(terrain: Optional[Terrain],
                         terrain_plant: str) -> None:
    """Raises for a terrain plant that is unknown or not ported."""
    if terrain_plant not in TERRAIN_PLANTS:
        raise ValueError(f"terrain_plant must be one of {TERRAIN_PLANTS}, "
                         f"got {terrain_plant!r}")
    if terrain is not None and terrain_plant == "exact":
        raise NotImplementedError(
            "terrain_plant='exact' needs the op-graph physics step with "
            "exact bilinear hfield contact, which is not ported yet "
            "(ROADMAP M8); pass terrain_plant='kernel'")


def _make_plant_step(model, plant_substeps: int, device,
                     terrain: Optional[Terrain] = None) -> Callable:
    """One 50 Hz plant tick: ``plant_substeps`` kernel substeps at the
    model's timestep, K = 1, one launch.  On a terrain the kernel takes
    per-geom planes (each paw contacts the terrain's tangent plane at its
    own xy), recomputed from the plant state every tick."""
    plant_sub = build_cuda_substep(
        model, model.timestep, n_substeps=plant_substeps, device=device,
        with_plane="per_geom" if terrain is not None else False)

    def plant_step(st: State, ctrl: torch.Tensor) -> State:
        extra = {}
        if terrain is not None:
            planes = dynamics.geom_local_planes(model, terrain, st.qpos)
            extra["plane"] = planes.reshape(-1)[:, None].contiguous()
        qp, qv = plant_sub(st.qpos[:, None], st.qvel[:, None], ctrl[:, None],
                           **extra)
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
    terrain: Optional[Terrain] = None,
    terrain_plant: str = "exact",
    plane_mode: str = "trunk",
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
    stacked); without it the carry's generator draws on the device.

    With ``terrain`` the rollouts contact its local planes (``plane_mode``,
    see ``mppi.make_solver``) and the plant integrates on the per-geom
    plane kernel (``terrain_plant="kernel"``).  The JAX package's default
    ``terrain_plant="exact"``, the op-graph step with exact bilinear
    contact, is not ported (ROADMAP M8) and raises."""
    _check_terrain_plant(terrain, terrain_plant)
    device = resolve_device(device)
    use_full_fp32()
    model = model.to(device)
    if terrain is not None:
        terrain = terrain.to(device)
    solve = mppi.make_solver(model, step_cost, config, device=device,
                             terrain=terrain, plane_mode=plane_mode)
    plant_step = _make_plant_step(model, plant_substeps, device, terrain)
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


def graph_tick(tick: Callable, carry: MPCCarry, normals: torch.Tensor):
    """``tick`` (of :func:`make_mpc`) captured in a CUDA graph
    (:class:`~.graph.GraphedTick`) from this example carry and (K, H, nu)
    ``normals``, on their device: returns ``gtick(carry, normals=None) ->
    (carry, info)``, which computes what ``tick`` computes.  Without
    ``normals`` it draws them with the carry's generator into the graph's
    static buffer before the replay, as ``tick`` draws them.  The returned
    carry and info are static tensors that the next call overwrites:
    clone what you keep.  Raises on a device other than CUDA."""
    lagged = carry.ctrl_queue is not None

    def fn(qpos, qvel, time, nominal, normals, *queue):
        c = MPCCarry(plant=State(qpos=qpos, qvel=qvel, time=time),
                     solver=mppi.MPPIState(nominal=nominal), generator=None,
                     ctrl_queue=queue[0] if lagged else None)
        c2, out = tick(c, normals)
        nxt = (c2.plant.qpos, c2.plant.qvel, c2.plant.time,
               c2.solver.nominal) + ((c2.ctrl_queue,) if lagged else ())
        return nxt, out

    queue = (carry.ctrl_queue,) if lagged else ()
    graph = GraphedTick(fn, (carry.plant.qpos, carry.plant.qvel,
                             carry.plant.time, carry.solver.nominal, normals,
                             *queue), normals.device)

    def gtick(carry: MPCCarry, normals: Optional[torch.Tensor] = None):
        if normals is None:
            normals = graph.inputs[4]
            torch.randn(normals.shape, generator=carry.generator, out=normals)
        queue = (carry.ctrl_queue,) if lagged else ()
        nxt, out = graph(carry.plant.qpos, carry.plant.qvel, carry.plant.time,
                         carry.solver.nominal, normals, *queue)
        return MPCCarry(plant=State(qpos=nxt[0], qvel=nxt[1], time=nxt[2]),
                        solver=mppi.MPPIState(nominal=nxt[3]),
                        generator=carry.generator,
                        ctrl_queue=nxt[4] if lagged else None), out

    gtick.graph = graph
    return gtick


def _compensated_solver(solve: Callable, plant_step: Callable, lag: int):
    """``solve_c(state, mppi_state, generator=None, normals=None, queue) ->
    (ctrl, mppi_state', stats)``: ``solve`` from ``state`` rolled through
    the ``lag`` in-flight controls of ``queue`` (lag, nu), which the robot
    applies over the next ``lag`` ticks; ``stats["queue"]`` is the FIFO
    with ``ctrl`` appended."""

    def solve_c(state, mppi_state, generator=None, normals=None, queue=None):
        for i in range(lag):
            state = plant_step(state, queue[i])
        ctrl, ms, stats = solve(state, mppi_state, generator, normals)
        stats = dict(stats, queue=torch.cat([queue[1:], ctrl[None]], dim=0))
        return ctrl, ms, stats

    return solve_c


class _HostPipeline:
    """The controller's device-to-host pipeline, the counterpart of the JAX
    class's ``copy_to_host_async`` and deque: a ring of ``depth`` host
    slots, each a control buffer, a measured-state buffer and, on CUDA, an
    event.  ``push`` starts a non-blocking copy of a control into the next
    slot (pinned memory on CUDA) and records the slot's event after it;
    ``pop`` waits on the oldest slot's event and reads its control.  A slot
    is reused only after its pop: ``depth`` is lag + 1, and the controller
    pops as soon as more than ``lag`` slots are pending.  The measured state
    of a tick is staged in the slot that its control will take, so its
    host-to-device copy is also complete before the slot is written
    again."""

    def __init__(self, depth: int, nu: int, nq: int, nv: int, device):
        cuda = device.type == "cuda"
        self._nq, self._nv = nq, nv
        self._ctrl = [torch.empty(nu, pin_memory=cuda) for _ in range(depth)]
        self._state = [torch.empty(nq + nv + 1, pin_memory=cuda)
                       for _ in range(depth)]
        self._events = [torch.cuda.Event() if cuda else None
                        for _ in range(depth)]
        self._device = device
        self._pending = deque()
        self._slot = 0

    def __len__(self) -> int:
        return len(self._pending)

    def stage(self, qpos, qvel, t: float) -> State:
        """The measured state, float32, in the next slot's host buffer."""
        nq, nv = self._nq, self._nv
        buf = self._state[self._slot]
        x = buf.numpy()
        x[:nq] = np.asarray(qpos, np.float32).reshape(nq)
        x[nq:nq + nv] = np.asarray(qvel, np.float32).reshape(nv)
        x[nq + nv] = t
        return State(qpos=buf[:nq], qvel=buf[nq:nq + nv], time=buf[nq + nv])

    def push(self, ctrl: torch.Tensor) -> None:
        i = self._slot
        self._ctrl[i].copy_(ctrl, non_blocking=True)
        if self._events[i] is not None:
            self._events[i].record(torch.cuda.current_stream(self._device))
        self._pending.append(i)
        self._slot = (i + 1) % len(self._ctrl)

    def pop(self) -> np.ndarray:
        i = self._pending.popleft()
        if self._events[i] is not None:
            self._events[i].synchronize()
        return self._ctrl[i].numpy().copy()


class RealtimeController:
    """Host-side pipelined MPC tick for a robot bridge at a 50 Hz budget.

    Port of ``opendog_tpu/solvers/mpc.py:183-327``.  Each tick enqueues
    solve(t) on the device, starts a non-blocking copy of its first action
    into pinned host memory with a CUDA event after it, and returns
    ctrl(t - lag): the control whose copy has had ``lag`` ticks to land.
    In a loop paced at the tick period the wait on its event is then short;
    pick ``lag >= ceil(solve time / tick period) + 1``.  Until the pipeline
    is primed a tick returns the keyframe control clipped into ctrlrange.

    Benchmark mode (``start``, ``tick``, ``drain``) advances an internal
    plant on the device (bench.py's host-loop metric).  Bridge mode
    (``bridge_tick``) solves from a measured robot state, which enters
    through a pinned staging buffer and a non-blocking copy.

    ``compensate=True`` (with ``lag > 0``) applies delay compensation: the
    measured or internal state is rolled forward on the device through the
    ``lag`` dispatched-but-not-yet-applied controls before solving
    (``make_mpc(lag_compensation=True)``).  In benchmark mode the internal
    plant then also applies the solve from ``lag`` ticks ago; without it
    the internal plant applies the fresh solve.

    On CUDA the tick, the solve and the compensated solve replay CUDA
    graphs (:func:`graph_tick`, :func:`~.mppi.graph_solve`), the port's
    counterpart of the JAX class's jitted, donated programs; on the CPU
    they run eagerly on the plain substep.  The device alone decides.

    ``generator`` (a ``torch.Generator`` on the device; seed 0 if None)
    stands for the JAX class's ``key``: it draws each solve's (K, H, nu)
    normals unless the call passes ``normals``.  PyTorch cannot reproduce
    ``jax.random``, so the tests pass the JAX controller's draws.

    On a terrain the solves use one trunk plane (``plane_mode="trunk"``,
    as the JAX class's solver does).  The JAX class's plants on a terrain
    are the exact-bilinear step, which is not ported (ROADMAP M8): there
    benchmark mode raises in ``start`` and ``compensate=True`` raises here,
    as ``make_mpc`` does; an uncompensated bridge solve works.
    """

    def __init__(self, model, step_cost: Callable, config: mppi.MPPIConfig,
                 terrain: Optional[Terrain] = None, lag: int = 1,
                 plant_substeps: int = 10,
                 generator: Optional[torch.Generator] = None,
                 compensate: bool = False, device=None):
        self.lag = max(0, int(lag))
        self.compensate = bool(compensate) and self.lag > 0
        if self.compensate:
            _check_terrain_plant(terrain, "exact")
        self.device = resolve_device(device)
        use_full_fp32()
        self.model = model.to(self.device)
        self.terrain = None if terrain is None else terrain.to(self.device)
        self._step_cost, self._config = step_cost, config
        self._plant_substeps = plant_substeps
        self._graphs = self.device.type == "cuda"
        self._generator = (generator if generator is not None else
                           torch.Generator(device=self.device).manual_seed(0))
        solve = mppi.make_solver(self.model, step_cost, config,
                                 device=self.device, terrain=self.terrain)
        if self.compensate:
            solve = _compensated_solver(
                solve, _make_plant_step(self.model, plant_substeps,
                                        self.device), self.lag)
        self._solve = solve  # bridge mode; graphed at the first bridge_tick
        self._bridge = None
        self._nominal = None  # bridge mode's solver state, made lazily
        self._queue_dev = None  # bridge mode's in-flight ctrl FIFO
        self._init = self._tick = self._carry = None  # set by start()
        self._pipe = _HostPipeline(self.lag + 1, model.nu, model.nq, model.nv,
                                   self.device)
        # placeholder returned until the pipeline is primed: the keyframe
        # ctrl clipped into ctrlrange (keyframes may sit just outside it)
        rng = self.model.numpy("actuator_ctrlrange")
        self._last_ctrl = np.clip(self.model.numpy("key_ctrl")[0],
                                  rng[:, 0], rng[:, 1])

    def _example_normals(self) -> torch.Tensor:
        cfg = self._config
        return torch.zeros((cfg.num_samples, cfg.horizon, self.model.nu),
                           dtype=torch.float32, device=self.device)

    def _advance(self, ctrl: torch.Tensor) -> np.ndarray:
        self._pipe.push(ctrl)
        if len(self._pipe) > self.lag:
            self._last_ctrl = self._pipe.pop()
        return self._last_ctrl

    # -------- benchmark mode (internal on-device plant) ----------------
    def start(self, physics_state: State) -> None:
        """(Re)start the internal plant from ``physics_state``."""
        first = self._init is None
        if first:
            self._init, self._tick, _ = make_mpc(
                self.model, self._step_cost, self._config,
                plant_substeps=self._plant_substeps,
                ctrl_lag=self.lag if self.compensate else 0,
                lag_compensation=self.compensate, device=self.device,
                terrain=self.terrain)
        self._carry = self._init(self._generator, physics_state)
        if first and self._graphs:
            self._tick = graph_tick(self._tick, self._carry,
                                    self._example_normals())

    @property
    def plant(self) -> State:
        """Benchmark mode's internal plant state (on CUDA static tensors
        that the next tick overwrites: clone what you keep)."""
        if self._carry is None:
            raise RuntimeError("benchmark mode: call start() first")
        return self._carry.plant

    def tick(self, normals: Optional[torch.Tensor] = None) -> np.ndarray:
        """One pipelined control tick; returns ctrl(t-lag) as numpy."""
        if self._carry is None:
            raise RuntimeError("benchmark mode: call start() first")
        self._carry, out = self._tick(self._carry, normals)
        return self._advance(out["ctrl"])

    def drain(self) -> np.ndarray:
        """Flush the pipeline (e.g. at shutdown)."""
        while len(self._pipe):
            self._last_ctrl = self._pipe.pop()
        if self.compensate:
            # the in-flight FIFO no longer matches what the robot applies
            # after a drain; the next bridge_tick re-primes it with the
            # hold control
            self._queue_dev = None
        return self._last_ctrl

    # -------- bridge mode (external plant: the real robot) -------------
    def bridge_tick(self, qpos: np.ndarray, qvel: np.ndarray, t: float = 0.0,
                    normals: Optional[torch.Tensor] = None) -> np.ndarray:
        """One tick against a measured robot state; returns ctrl(t-lag)."""
        if self._nominal is None:
            self._nominal = mppi.init_state(self.model, self._config).nominal
        aux = ()
        if self.compensate:
            if self._queue_dev is None:
                # prime with what the robot is actually doing pre-pipeline:
                # holding the keyframe stance (= _last_ctrl placeholder)
                self._queue_dev = torch.from_numpy(np.tile(
                    self._last_ctrl[None], (self.lag, 1))).to(self.device)
            aux = (self._queue_dev,)
        if self._bridge is None:
            self._bridge = self._solve
            if self._graphs:
                self._bridge = mppi.graph_solve(
                    self._solve, make_state(self.model, "home"),
                    mppi.MPPIState(nominal=self._nominal),
                    self._example_normals(), *aux)
        st = self._pipe.stage(qpos, qvel, t)
        ctrl, ms, stats = self._bridge(
            st, mppi.MPPIState(nominal=self._nominal), self._generator,
            normals, *aux)
        self._nominal = ms.nominal
        if self.compensate:
            self._queue_dev = stats["queue"]
        return self._advance(ctrl)
