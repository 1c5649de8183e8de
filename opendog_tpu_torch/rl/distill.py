"""MPC -> policy distillation (BASELINE config 5).

Port of ``opendog_tpu/rl/distill.py``: the MPPI controller is the expert
over S batched scenarios (optionally with per-scenario payloads and
commands), and a compact policy network regresses the visited (observation,
expert action) pairs, DAgger-style, the student driving a growing share of
the ticks.  ``collect`` and ``train_on`` are the pieces of DAgger with an
aggregate buffer (``scripts/torch_distill_cmd.py``); ``round_fn`` trains on
the latest round only; ``eval_fn`` is the student-only proof rollout.

Each collect tick is one batched expert solve over S x K lanes
(``mppi.make_batched_solver``: one rollout-step launch over all of them),
the student's forward, the mix by the DAgger drive mask, the label and one
plant step of the S scenarios (the substep kernel at K = S on the kernel
engine, the op-graph step on ``engine="ops"``).  On the card the tick is
captured in one CUDA graph at its first call and replayed; it reads nothing
from the host, and its random draws (the expert's normals, the drive mask)
are made outside the graph into static buffers, from the state's
``torch.Generator`` (the JAX package's key) or injected.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call

from ..device import resolve_device, use_full_fp32
from ..ops.cuda_step import build_cuda_substep
from ..physics import State, dynamics
from ..solvers import mppi
from ..solvers.costs import ref_takes_cmd
from ..solvers.graph import GraphedTick


class Distiller(NamedTuple):
    """What :func:`make_distiller` returns: ``init`` / ``round_fn`` /
    ``eval_fn``, the per-round interface that trains on the latest round
    only, and ``collect`` / ``train_on``, the pieces of DAgger with an
    aggregate buffer (collect with the current student, append, train on
    resamples of the whole buffer)."""

    init: Callable
    round_fn: Callable
    eval_fn: Callable
    collect: Callable
    train_on: Callable


@dataclass(frozen=True)
class DistillConfig:
    num_scenarios: int = 8       # parallel MPC experts
    rollout_ticks: int = 50      # expert ticks per round
    rounds: int = 10
    lr: float = 3e-4
    batch_size: int = 256
    epochs_per_round: int = 4
    beta_decay: float = 0.7      # DAgger mixing: P(expert drives)


@dataclass
class DistillState:
    """The student's parameters (``{name: leaf tensor}`` of the network),
    the Adam optimizer over them (optax's ``adam`` state), and the
    generator of every random draw (the JAX package's key)."""

    params: dict
    opt_state: torch.optim.Adam
    generator: Optional[torch.Generator]


def make_distiller(
    model,
    step_cost: Callable,
    obs_fn: Callable,
    network,
    mppi_config: mppi.MPPIConfig = mppi.MPPIConfig(),
    config: DistillConfig = DistillConfig(),
    plant_substeps: int = 10,
    action_ref_fn: Optional[Callable] = None,
    with_prev_ctrl: bool = False,
    payload_range: Optional[tuple] = None,
    command_dim: int = 0,
    plant_k_tile: Optional[int] = None,
    anchor_w: float = 0.0,
    device=None,
    graphs: Optional[bool] = None,
) -> Distiller:
    """Returns a :class:`Distiller` on ``device`` (CUDA unless the caller
    names another).

    ``obs_fn(qpos, qvel, t)`` maps (S, nq), (S, nv), (S,) to (S, obs)
    observations; ``network`` is an ``rl.networks.MLPActorCritic`` whose
    ``obs_dim`` is that width plus ``nu`` with ``with_prev_ctrl`` (the
    previously applied control less the home control) plus
    ``command_dim``.

    * ``init(generator, example_state, params=None) -> DistillState``:
      parameters drawn as flax draws them from ``generator`` (a
      ``torch.Generator`` on the device), or ``params`` (``{name: tensor}``,
      e.g. carried from the JAX package by ``networks.load_flax_params``).
    * ``collect(dstate, plants, mppi_states, beta, payloads=None,
      commands=None, normals=None, drive=None, trace=None) -> (plants,
      mppi_states, generator, obs (T S, obs), labels (T S, nu))`` runs
      ``config.rollout_ticks`` = T ticks.  ``normals`` (T, S, K, H, nu)
      and ``drive`` (T, S, 1) bool inject the expert's normals and the
      drive mask (``bernoulli(beta)``: the expert drives); otherwise both
      are drawn per tick from ``dstate.generator``.  A ``trace`` dict
      receives each tick's applied ``ctrl``, ``student`` control and plant
      ``qpos`` (T, S, ...).
    * ``train_on(dstate, obs, labels, generator=None, perms=None) ->
      (dstate, loss)``: ``epochs_per_round`` epochs of Adam on minibatches
      of ``batch_size`` (the remainder of each permutation dropped);
      ``perms`` (epochs, n) injects the permutations.  ``loss`` is the last
      epoch's mean.
    * ``round_fn(dstate, plants, round_idx, payloads=None, commands=None,
      normals=None, drive=None, perms=None) -> (dstate, plants, metrics)``:
      one DAgger round at ``beta = beta_decay ** round_idx``.
    * ``eval_fn(dstate, plants, ticks, payloads=None, commands=None,
      normals=None) -> dict``: the student drives every scenario while the
      expert labels each visited state; ``qpos_traj`` (ticks, S, nq),
      ``ctrl_traj``, ``action_rmse``, ``final_x``, ``final_z``.  It draws
      from a copy of ``dstate.generator``, which it leaves as it was.

    With ``action_ref_fn`` (``(t)`` or, with commands, ``(t, cmd)``,
    batch-first) the student learns the residual: labels are ``expert -
    u_ref`` and the deployed action ``net(obs) + u_ref``; ``anchor_w > 0``
    anchors the expert to it (``mppi.make_solver``).  ``payload_range``
    (kernel engine only) carries a per-scenario trunk payload (S,) that the
    expert plans with and the plant integrates but the student does not
    observe; ``command_dim > 0`` gives each scenario a command (S,
    command_dim) that the expert plans for and the student observes; both
    are trailing arguments of ``collect`` / ``round_fn`` / ``eval_fn``.
    ``plant_k_tile``, the JAX package's lane tile of its plant kernel, has
    no effect here: the card's kernel takes any K.

    ``graphs`` (default: on CUDA) captures the collect and eval ticks in
    CUDA graphs; ``graphs=False`` runs them eagerly, bit for bit the
    same."""
    use_payload = payload_range is not None
    use_command = command_dim > 0
    if use_payload and mppi_config.engine != "kernel":
        raise ValueError("payload randomization rides the substep kernel's "
                         "payload rows: payload_range needs engine='kernel'")
    if anchor_w > 0.0 and action_ref_fn is None:
        raise ValueError("anchor_w anchors the expert to action_ref_fn")
    ref_cmd = action_ref_fn is not None and ref_takes_cmd(action_ref_fn)
    if ref_cmd and not use_command:
        raise ValueError("a command-scaled u_ref (t, cmd) needs "
                         "command_dim > 0")
    device = resolve_device(device)
    if graphs is None:
        graphs = device.type == "cuda"
    use_full_fp32()
    model = model.to(device)
    network = network.to(device)
    S = config.num_scenarios
    H, K, nu = mppi_config.horizon, mppi_config.num_samples, model.nu
    solve = mppi.make_batched_solver(
        model, step_cost, mppi_config, scenarios=S, device=device,
        with_payload=use_payload, with_command=use_command,
        u_ref_fn=action_ref_fn if anchor_w > 0.0 else None,
        anchor_w=anchor_w)
    rng = model.actuator_ctrlrange
    lo, hi = rng[:, 0], rng[:, 1]
    home_ctrl = torch.clamp(model.key_ctrl[0], lo, hi)
    dt_plant = plant_substeps * float(model.timestep)
    names = [n for n, _ in network.named_parameters()]

    if mppi_config.engine == "kernel":
        # the plant integrates on the expert's engine: the kernel at K = S
        plant_sub = build_cuda_substep(model, model.timestep, plant_substeps,
                                       device=device,
                                       with_payload=use_payload)

        def plant_step(qpos, qvel, time, ctrl, payloads):
            extra = {"payload": payloads[None, :].contiguous()} \
                if use_payload else {}
            qp, qv = plant_sub(qpos.T.contiguous(), qvel.T.contiguous(),
                               ctrl.T.contiguous(), **extra)
            return qp.T, qv.T, time + dt_plant
    else:
        def plant_step(qpos, qvel, time, ctrl, payloads):
            st, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel,
                                               time=time), ctrl, None,
                                  n_substeps=plant_substeps)
            return st.qpos, st.qvel, st.time

    def ref(t, cmds):
        if action_ref_fn is None:
            return torch.zeros(t.shape + (nu,), device=device)
        return action_ref_fn(t, cmds) if ref_cmd else action_ref_fn(t)

    def full_obs(qpos, qvel, t, prev, cmds):
        parts = [obs_fn(qpos, qvel, t)]
        if with_prev_ctrl:
            parts.append(prev - home_ctrl)
        if use_command:
            parts.append(cmds)
        return torch.cat(parts, dim=-1)

    def student_act(params, obs, t, cmds):
        pred = functional_call(network, params, (obs,), {"value": False})[0]
        return torch.clamp(pred + ref(t, cmds), lo, hi)

    def expert_and_student(qpos, qvel, time, nominal, prev, normals, rest):
        """The expert's batched solve and the student's action at a tick's
        inputs; ``rest`` is ``[payloads][, commands]`` and then the
        student's parameters.  Returns (expert ctrl, nominal', obs, student
        ctrl, payloads, commands)."""
        n_extra = int(use_payload) + int(use_command)
        extras = rest[:n_extra]
        payloads = extras[0] if use_payload else None
        cmds = extras[-1] if use_command else None
        params = dict(zip(names, rest[n_extra:]))
        expert, ms, _ = solve(State(qpos=qpos, qvel=qvel, time=time),
                              mppi.MPPIState(nominal=nominal), None, normals,
                              *extras)
        obs = full_obs(qpos, qvel, time, prev, cmds)
        student = student_act(params, obs, time, cmds)
        return expert, ms.nominal, obs, student, payloads, cmds

    def collect_tick(qpos, qvel, time, nominal, prev, normals, drive,
                     *rest):
        with torch.no_grad():
            expert, nominal, obs, student, payloads, cmds = \
                expert_and_student(qpos, qvel, time, nominal, prev, normals,
                                   rest)
            ctrl = torch.where(drive, expert, student)
            label = expert - ref(time, cmds)
            qp, qv, t = plant_step(qpos, qvel, time, ctrl, payloads)
        return qp, qv, t, nominal, ctrl, obs, label, student

    def eval_tick(qpos, qvel, time, nominal, prev, normals, *rest):
        with torch.no_grad():
            expert, nominal, _, ctrl, payloads, _ = expert_and_student(
                qpos, qvel, time, nominal, prev, normals, rest)
            qp, qv, t = plant_step(qpos, qvel, time, ctrl, payloads)
            err2 = torch.mean(torch.square(ctrl - expert))
        return qp, qv, t, nominal, ctrl, err2

    class _Runner:
        """A tick eager, or captured at its first call and replayed."""

        def __init__(self, fn):
            self.fn, self.graph = fn, None

        def __call__(self, *inputs):
            if not graphs:
                return self.fn(*inputs)
            if self.graph is None:
                self.graph = GraphedTick(self.fn, inputs, device)
            return self.graph(*inputs)

    collect_run, eval_run = _Runner(collect_tick), _Runner(eval_tick)
    normals_buf = torch.empty((S, K, H, nu), device=device)
    uniform_buf = torch.empty((S, 1), device=device)

    def extras_of(payloads, commands):
        out = []
        if use_payload:
            if payloads is None:
                raise ValueError("distiller built with payload_range: pass "
                                 "payloads (S,)")
            out.append(torch.as_tensor(payloads, dtype=torch.float32,
                                       device=device).reshape(S))
        if use_command:
            if commands is None:
                raise ValueError("distiller built with command_dim: pass "
                                 "commands (S, command_dim)")
            out.append(torch.as_tensor(commands, dtype=torch.float32,
                                       device=device).reshape(
                                           S, command_dim))
        return out

    def param_inputs(dstate):
        return [dstate.params[n].detach() for n in names]

    def draw_normals(gen, normals, i):
        if normals is not None:
            return normals[i]
        return torch.randn(normals_buf.shape, generator=gen,
                           out=normals_buf)

    def init(generator: Optional[torch.Generator], example_state: State,
             params: Optional[dict] = None) -> DistillState:
        width = full_obs(example_state.qpos[None], example_state.qvel[None],
                         example_state.time.reshape(1), home_ctrl[None],
                         torch.zeros(1, command_dim, device=device)).shape[-1]
        if width != network.obs_dim:
            raise ValueError(f"observations are {width} wide, the network "
                             f"takes {network.obs_dim}")
        if params is None:
            params = network.flax_init(generator)
        params = {n: params[n].detach().to(device).clone().requires_grad_()
                  for n in names}
        opt = torch.optim.Adam(params.values(), lr=config.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return DistillState(params=params, opt_state=opt,
                            generator=generator)

    def collect(dstate: DistillState, plants: State, mppi_states, beta,
                payloads=None, commands=None, normals=None, drive=None,
                trace: Optional[dict] = None):
        T = config.rollout_ticks
        gen = dstate.generator
        extras = extras_of(payloads, commands)
        params = param_inputs(dstate)
        qpos, qvel, time = plants.qpos, plants.qvel, plants.time
        nominal, prev = mppi_states.nominal, home_ctrl.expand(S, nu)
        obs_buf = labels_buf = None
        kept = {k: [] for k in ("ctrl", "student", "qpos")}
        for i in range(T):
            nrm = draw_normals(gen, normals, i)
            if drive is not None:
                mask = drive[i]
            else:
                torch.rand(uniform_buf.shape, generator=gen,
                           out=uniform_buf)
                mask = uniform_buf < beta
            qpos, qvel, time, nominal, prev, obs, label, student = \
                collect_run(qpos, qvel, time, nominal, prev, nrm, mask,
                            *extras, *params)
            if obs_buf is None:
                obs_buf = obs.new_empty((T,) + obs.shape)
                labels_buf = label.new_empty((T,) + label.shape)
            obs_buf[i].copy_(obs)
            labels_buf[i].copy_(label)
            if trace is not None:
                for k, v in (("ctrl", prev), ("student", student),
                             ("qpos", qpos)):
                    kept[k].append(v.clone())
        if trace is not None:
            trace.update({k: torch.stack(v) for k, v in kept.items()})
        plants = State(qpos=qpos.clone(), qvel=qvel.clone(),
                       time=time.clone())
        return (plants, mppi.MPPIState(nominal=nominal.clone()), gen,
                obs_buf.reshape(T * S, -1), labels_buf.reshape(T * S, -1))

    def eval_fn(dstate: DistillState, plants: State, ticks: int,
                payloads=None, commands=None, normals=None):
        gen = dstate.generator
        if gen is not None and normals is None:
            state = gen.get_state()
            gen = torch.Generator(device=device)
            gen.set_state(state)
        extras = extras_of(payloads, commands)
        params = param_inputs(dstate)
        qpos, qvel, time = plants.qpos, plants.qvel, plants.time
        nominal = mppi.init_state(model, mppi_config, scenarios=S).nominal
        prev = home_ctrl.expand(S, nu)
        qs, cs, errs = [], [], []
        for i in range(ticks):
            nrm = draw_normals(gen, normals, i)
            qpos, qvel, time, nominal, prev, err2 = eval_run(
                qpos, qvel, time, nominal, prev, nrm, *extras, *params)
            qs.append(qpos.clone())
            cs.append(prev.clone())
            errs.append(err2.clone())
        qpos_traj = torch.stack(qs)
        return dict(qpos_traj=qpos_traj, ctrl_traj=torch.stack(cs),
                    action_rmse=torch.sqrt(torch.mean(torch.stack(errs))),
                    final_x=qpos_traj[-1, :, 0], final_z=qpos_traj[-1, :, 2])

    def train_on(dstate: DistillState, obs, labels,
                 generator: Optional[torch.Generator] = None, perms=None):
        gen = dstate.generator if generator is None else generator
        n = obs.shape[0]
        mb = min(config.batch_size, n)
        opt = dstate.opt_state
        params = dstate.params
        epoch_loss = None
        for e in range(config.epochs_per_round):
            perm = (perms[e] if perms is not None else
                    torch.randperm(n, generator=gen, device=obs.device))
            idxs = perm[: (n // mb) * mb].reshape(-1, mb)
            losses = []
            for idx in idxs:
                opt.zero_grad(set_to_none=True)
                pred = functional_call(network, params, (obs[idx],),
                                       {"value": False})[0]
                loss = torch.mean(torch.square(pred - labels[idx]))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            epoch_loss = torch.mean(torch.stack(losses))
        return dstate, epoch_loss

    def round_fn(dstate: DistillState, plants: State, round_idx: int,
                 payloads=None, commands=None, normals=None, drive=None,
                 perms=None):
        beta = config.beta_decay ** round_idx
        plants, _, _, obs, labels = collect(
            dstate, plants, mppi.init_state(model, mppi_config, scenarios=S),
            beta, payloads, commands, normals, drive)
        dstate, loss = train_on(dstate, obs, labels, perms=perms)
        return dstate, plants, dict(distill_loss=loss, beta=beta)

    return Distiller(init, round_fn, eval_fn, collect, train_on)
