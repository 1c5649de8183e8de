"""Receding-horizon MPC loop at a 50 Hz control rate.

Port of ``opendog_tpu/solvers/mpc.py`` (``MPCCarry``, ``make_mpc`` and the
plants of ``_make_plant_step``, lines 33-180): one ``tick`` re-plans with
the MPPI solver and advances the plant one 50 Hz step of
``plant_substeps`` substeps at the model's timestep.  With the kernel
engine the plant is one kernel launch (K = 1): the flat kernel on flat
ground, the per-geom plane kernel on a terrain with
``terrain_plant="kernel"``, and on a terrain with the default
``terrain_plant="exact"`` the exact plant kernel on the card (the contact
of ``physics.dynamics.step``: bilinear heightfield and static boxes at
every substep).  With the op-graph engine, on the CPU and on a terrain of
one grid per env, the exact plant is the op-graph step
``physics.dynamics.step`` itself.  ``run`` is a
Python loop over ticks.  :func:`graph_tick` replays a tick from a CUDA
graph (the counterpart of the JAX package's jitted tick), and
:class:`RealtimeController` (lines 183-327) is the host-side pipelined
50 Hz tick of the robot bridge.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import ExactPlant, build_cuda_substep
from ..parallel.collectives import require_capturable
from ..physics import State, Terrain, dynamics, make_state
from ..utils.profiling import span
from . import ilqr as ilqr_mod, mppi
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


def _make_plant_step(model, plant_substeps: int, device,
                     terrain: Optional[Terrain] = None,
                     engine: str = "kernel",
                     terrain_plant: str = "exact") -> Callable:
    """One 50 Hz plant tick of ``plant_substeps`` substeps at the model's
    timestep, as the JAX package picks it:

    * ``engine="kernel"`` on flat ground: the flat kernel, K = 1, one
      launch;
    * ``engine="kernel"`` on a terrain with ``terrain_plant="kernel"``: the
      per-geom plane kernel, each paw on the terrain's tangent plane at its
      own xy, recomputed from the plant state every tick;
    * ``engine="kernel"`` on a CUDA device and a terrain of one grid with
      ``terrain_plant="exact"``: the exact plant kernel
      (``cuda_step.ExactPlant``), K = 1, one launch: the contact of
      ``dynamics.step``, bilinear heightfield and static boxes looked up at
      every substep, for a model without the progressive contact impedance
      (``geom_imp_dmin``, which only the op-graph step computes);
    * otherwise (``"exact"`` on the CPU, on a grid per env or with the
      impedance, or ``engine="ops"``): the op-graph step with exact
      bilinear contact (``dynamics.step``)."""
    device = resolve_device(device)
    exact = terrain is not None and terrain_plant == "exact"
    if (engine == "kernel" and exact and device.type == "cuda"
            and terrain.height.dim() == 2 and model.geom_imp_dmin is None):
        plant = ExactPlant(model, model.timestep, plant_substeps,
                           terrain.height, device)

        def plant_step_exact(st: State, ctrl: torch.Tensor) -> State:
            qp, qv = plant(st.qpos[:, None], st.qvel[:, None], ctrl[:, None])
            t2 = st.time + plant_substeps * float(model.timestep)
            return State(qpos=qp[:, 0], qvel=qv[:, 0], time=t2)

        return plant_step_exact
    if engine != "kernel" or exact:
        def plant_step_ops(st: State, ctrl: torch.Tensor) -> State:
            return dynamics.step(model, st, ctrl, terrain,
                                 n_substeps=plant_substeps)[0]

        return plant_step_ops

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
    mesh=None,
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
    see ``mppi.make_solver``) and the plant has the op-graph step's exact
    bilinear contact (``terrain_plant="exact"``, the default, as in the JAX
    package: on CUDA the exact plant kernel) or is the per-geom plane
    kernel (``"kernel"``).  With
    ``config.engine="ops"`` both the rollouts and the plant run the
    op-graph step (see :func:`_make_plant_step`).

    ``mesh`` shards the solve's K samples over its ranks
    (``mppi.make_solver(..., mesh=)``; the device is then the mesh's): each
    tick's generator draws the global normals on every rank, and the plant
    runs redundantly on every rank on the same bits, as the replicated
    plant under ``shard_map`` does."""
    if terrain_plant not in TERRAIN_PLANTS:
        raise ValueError(f"terrain_plant must be one of {TERRAIN_PLANTS}, "
                         f"got {terrain_plant!r}")
    if mesh is not None:
        device = mesh.on_device(device)
    device = resolve_device(device)
    use_full_fp32()
    model = model.to(device)
    if terrain is not None:
        terrain = terrain.to(device)
    solve = mppi.make_solver(model, step_cost, config, device=device,
                             terrain=terrain, plane_mode=plane_mode,
                             mesh=mesh)
    plant_step = _make_plant_step(model, plant_substeps, device, terrain,
                                  config.engine, terrain_plant)
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
        with span("mpc.plant"):
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

    tick.mesh = mesh
    return init, tick, run


def graph_tick(tick: Callable, carry: MPCCarry, normals: torch.Tensor):
    """``tick`` (of :func:`make_mpc`) captured in a CUDA graph
    (:class:`~.graph.GraphedTick`) from this example carry and (K, H, nu)
    ``normals``, on their device: returns ``gtick(carry, normals=None) ->
    (carry, info)``, which computes what ``tick`` computes.  Without
    ``normals`` it draws them with the carry's generator into the graph's
    static buffer before the replay, as ``tick`` draws them.  The returned
    carry and info are static tensors that the next call overwrites:
    clone what you keep.  Raises on a device other than CUDA, and for a
    tick sharded over a gloo group (a graph cannot hold its collectives; on
    an NCCL group the capture holds them)."""
    require_capturable(getattr(tick, "mesh", None), "graph_tick")
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

    solve_c.mesh = solve.mesh
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

    On a terrain the kernel engine's solves use one trunk plane
    (``plane_mode="trunk"``, as the JAX class's solver does), and the
    plants (benchmark mode's internal plant, the compensated solve's
    roll-forward) have the op-graph step's exact bilinear contact, the JAX
    class's default ``terrain_plant="exact"`` (:func:`_make_plant_step`:
    on CUDA the exact plant kernel).

    ``mesh`` shards each solve's K samples over its ranks
    (``mppi.make_solver(..., mesh=)``), each rank running the same
    controller on its own card; the graphs then capture its collectives,
    which only an NCCL group allows: on CUDA a gloo mesh raises.
    """

    def __init__(self, model, step_cost: Callable, config: mppi.MPPIConfig,
                 terrain: Optional[Terrain] = None, lag: int = 1,
                 plant_substeps: int = 10,
                 generator: Optional[torch.Generator] = None,
                 compensate: bool = False, device=None, mesh=None):
        self.lag = max(0, int(lag))
        self.compensate = bool(compensate) and self.lag > 0
        self.device = resolve_device(
            device if mesh is None else mesh.on_device(device))
        use_full_fp32()
        self.model = model.to(self.device)
        self.terrain = None if terrain is None else terrain.to(self.device)
        self._step_cost, self._config = step_cost, config
        self._mesh = mesh
        self._plant_substeps = plant_substeps
        self._graphs = self.device.type == "cuda"
        if self._graphs:
            require_capturable(mesh, "RealtimeController")
        self._generator = (generator if generator is not None else
                           torch.Generator(device=self.device).manual_seed(0))
        solve = mppi.make_solver(self.model, step_cost, config,
                                 device=self.device, terrain=self.terrain,
                                 mesh=mesh)
        if self.compensate:
            solve = _compensated_solver(
                solve, _make_plant_step(self.model, plant_substeps,
                                        self.device, self.terrain,
                                        config.engine), self.lag)
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
                terrain=self.terrain, mesh=self._mesh)
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


def make_ilqr_tracker(
    model,
    step_cost: Callable,
    ilqr_config=None,
    track_ticks: int = 50,
    plant_substeps: int = 10,
    terrain: Optional[Terrain] = None,
    u_ref_fn: Optional[Callable] = None,
    device=None,
    graphs: Optional[bool] = None,
):
    """BASELINE config 3: whole-body iLQR with a slow replan and a fast
    tracking loop (``opendog_tpu/solvers/mpc.py:330-420``).  Returns
    ``cycle(plant, U_init) -> (plant', U_next, traj)``: one replan of the
    full horizon, then ``track_ticks`` plant ticks of the time-varying LQR
    policy u_t = clip(U*_t + K_t (x - X*_t)) from the solve's final gains,
    each ``plant_substeps`` substeps of the op-graph step at the model's
    timestep (1 Hz replan / 50 Hz tracking at the defaults).  ``traj``
    holds the tracked ``qpos`` and ``ctrl`` per tick and the solve's
    ``cost``.

    The next plan starts from ``u_ref_fn`` (e.g. ``costs.trot_gait_ref``,
    batch-first in time) at the next cycle's stage times, or else from the
    receding plan padded with its last control.  Plan at the plant's
    integration rate and warm-start from the gait reference: the JAX
    package's docstring gives the measurements behind both.

    ``graphs`` (default: on CUDA) replays the solve's pieces and the
    tracked plant tick from CUDA graphs captured at their first call; the
    cycle equals the eager cycle bit for bit.  Only on CUDA.  After a call,
    ``cycle.stats`` holds its solve's ``stats`` (``make_ilqr``)."""
    if ilqr_config is None:
        ilqr_config = ilqr_mod.ILQRConfig(
            horizon=50, n_substeps=10, rollout_dt=0.002, iterations=5)
    if not ilqr_config.horizon >= track_ticks:
        raise ValueError(f"the horizon ({ilqr_config.horizon}) must cover "
                         f"the tracked ticks ({track_ticks})")
    device = resolve_device(device)
    if graphs is None:
        graphs = device.type == "cuda"
    model = model.to(device)
    if terrain is not None:
        terrain = terrain.to(device)
    solve = ilqr_mod.make_ilqr(model, step_cost, ilqr_config,
                               terrain=terrain, device=device, graphs=graphs)
    run = ilqr_mod._Pieces(device, graphs)
    lo = model.actuator_ctrlrange[:, 0]
    hi = model.actuator_ctrlrange[:, 1]
    stage_dt = ilqr_config.n_substeps * ilqr_config.rollout_dt
    steps = stage_dt * torch.arange(ilqr_config.horizon, dtype=torch.float32,
                                    device=device)

    def track(qpos, qvel, time, U_t, K_t, X_t):
        """One tracked plant tick."""
        x = torch.cat([qpos, qvel])
        u = torch.clamp(U_t + K_t @ (x - X_t), lo, hi)
        st2, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=time),
                               u, terrain, n_substeps=plant_substeps)
        return st2.qpos, st2.qvel, st2.time, u

    def cycle(plant: State, U_init: torch.Tensor):
        """One replan + ``track_ticks`` tracked plant ticks."""
        U, X, stats = solve(plant, U_init)
        cycle.stats = stats
        K_fb = stats["K_fb"]
        qpos, qvel, t = (plant.qpos.to(device), plant.qvel.to(device),
                         plant.time.to(device))
        Q = qpos.new_empty((track_ticks,) + qpos.shape)
        C = U.new_empty((track_ticks, model.nu))
        for i in range(track_ticks):
            qpos, qvel, t, C[i] = run(track, qpos, qvel, t, U[i], K_fb[i],
                                      X[i])
            Q[i] = qpos
        plant2 = State(qpos=qpos.clone(), qvel=qvel.clone(), time=t.clone())
        if u_ref_fn is not None:
            # canonical warm start: the gait reference at the next cycle's
            # absolute stage times
            U_next = torch.clamp(u_ref_fn(plant2.time + steps), lo, hi)
        else:
            U_next = torch.cat([U[track_ticks:],
                                U[-1:].repeat(track_ticks, 1)], dim=0)
        return plant2, U_next, dict(qpos=Q, ctrl=C, cost=stats["cost"])

    cycle.solve, cycle.pieces, cycle.stats = solve, run, None
    return cycle
