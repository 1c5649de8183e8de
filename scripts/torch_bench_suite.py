#!/usr/bin/env python
"""Extended benchmark suite on the port: the counterpart of
scripts/bench_suite.py, one record per BASELINE.json config.

Configs (``--skip`` / ``--only`` keys, in the order they run):

  1    standing-balance hold, one OpenDOG env: the op-graph step at 50
       substeps per call (plant substeps/s)
  2    flat-ground Go1 trot MPPI, K=256 x 0.5 s (solves/s)
  2b   the same at K=4096 rollouts per tick
  2c   OpenDOG terrain MPPI, trunk plane (K3), exact plant
  2cp  the same with per-geom planes (K4) on both sides, plus the
       deviation from the exact-plant loop
  2d   payload-aware trot MPPI, 1.5 kg on K2 (100 solves, one start)
  6    sample-sharded MPPI at world size 1 in this process
  3    iLQR 1 Hz replan + 50 Hz tracking (cycle latency)
  3b   contact-scheduled iLQR trot, 10 cycles
  4    domain-randomised batch, op-graph step over B=4096 (env ticks/s);
       on the card also 4b (K1 at 4096 x 10) and 4c (K2+K3, a plane and a
       payload per scenario)
  4d   K2+K3 at B=32,768 scenarios
  2e   terrain planning fidelity (scripts/torch_terrain_fidelity.py)
  2f   the price of pipelining lag (scripts/torch_lag_sweep.py)
  5    one MPC -> policy distillation round, mini config

Every config builds its path on the port: the kernel engine on both
devices (on the CPU the kernels' plain versions), each tick, solve or step
replayed from a CUDA graph on the card, ``torch.cuda.synchronize()`` before
each clock read.  2b, 2c, 2cp, 2d, 4b, 4c, 4d and 2e run on the card only,
as the JAX script runs them only off the CPU.  Beside each kernel config
(2, 2b, 4b, 4c, 4d) the record carries the kernel's row at the config's
shape (``kernel_record``: against its plain version, its time and bound).

Run from the repository root:

    python3 scripts/torch_bench_suite.py                 # the card, all
    python3 scripts/torch_bench_suite.py --only 1 4d     # some configs
    python3 scripts/torch_bench_suite.py --device cpu --only 2 3

Writes one JSON line per record to stdout and the records to ``--out``
(default ``runs/torch_bench_suite/BENCH_SUITE.json``, kept out of git;
never the repository's BENCH_SUITE.json, the JAX package's record).  A
partial run updates only the configs it ran; each record carries its
``_provenance`` (time and the card's name and power limit).
"""
import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import (ROOT, Replayed, kernel_record,  # noqa: E402
                              mpc_tick, open_device)
from torch_multidev_common import free_port  # noqa: E402

from bench_torch import solve_throughput, sync, trot_setup  # noqa: E402

KEYS = ("1", "2", "2b", "2c", "2cp", "2d", "6", "3", "3b", "4", "4d", "2e",
        "2f", "5")
CARD_ONLY = {"2b", "2c", "2cp", "2d", "4d", "2e"}
DEFAULT_OUT = os.path.join("runs", "torch_bench_suite", "BENCH_SUITE.json")
BATCH = 4096            # config 4's scenarios
BATCH_32K = 32768       # config 4d's
TICKS = 100             # warm-up and timed ticks or solves of 2-2d and 6
REPS = 20               # timed steps or launches of 4-4d
TERRAIN_SEED = 5        # the JAX script's PRNGKey(5), drawn by torch here


def timed(dev, fn):
    """(seconds, fn()) with the card synchronised before and after (the JAX
    script's ``fetch``)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out


def counted(dev, fn):
    """(seconds, fn(), launches): ``fn`` timed, and the kernel launches it
    made (the counter's growth, which leaves a caller's count whole)."""
    import collections
    from opendog_tpu_torch.ops import cuda_step
    sync(dev)
    before = collections.Counter(cuda_step.LAUNCHES)
    dt, out = timed(dev, fn)
    return dt, out, dict(cuda_step.LAUNCHES - before)


# ---- config 1: standing-balance hold, single env -------------------------

def hold_step(model, n_substeps=50):
    """Config 1's step: ``(qpos, qvel, time) -> (qpos, qvel, time)`` after
    ``n_substeps`` op-graph substeps under the keyframe's control,
    unclipped, as the JAX script holds it (``m.key_ctrl[0]``)."""
    from opendog_tpu_torch.physics import State, dynamics
    hold = model.key_ctrl[0]

    def step(qpos, qvel, t):
        s, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=t),
                             hold, n_substeps=n_substeps)
        return s.qpos, s.qvel, s.time

    return step


def config_1(dev, reps=40):
    """OpenDOG flat from ``home``: one warm-up call (on the card: the
    capture of the 50-substep step in one CUDA graph), then ``reps``
    timed calls."""
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.physics import make_state
    m = load_opendog("flat", device=dev)
    s = make_state(m, "home")
    step = Replayed(hold_step(m), dev)
    capture_s, state = timed(dev, lambda: step(s.qpos, s.qvel, s.time))

    def run():
        x = state
        for _ in range(reps):
            x = step(*x)
        return x

    dt, (qpos, _, _) = timed(dev, run)
    z = float(qpos[2])
    return dict(plant_substeps_per_sec=round(reps * 50 / dt, 1),
                trunk_z=round(z, 4), healthy=bool(0.04 < z < 0.12),
                capture_s=capture_s)


# ---- configs 2 and 2b: flat-ground trot MPPI -----------------------------

def trot_mpc(model, num_samples, horizon=25):
    """(init, tick, cfg) of the trot MPC of configs 2 and 2b (bench.py's,
    ``bench_torch.trot_setup``; plant 10 x 2 ms), on the model's
    device."""
    from opendog_tpu_torch.solvers import make_mpc
    cost, cfg = trot_setup(model, num_samples, horizon)
    init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                             device=model.device)
    return init, tick, cfg


def mpc_rows(label, model, cfg, plant, launches):
    """The kernel rows of a flat MPC path on the card: K1 at the rollouts'
    (K, n_substeps) and at the plant's (1, 10), from the
    plant state on every lane under the home control plus sigma noise
    clipped into ctrlrange.  ``launches``: the path's counts."""
    import torch
    from opendog_tpu_torch.ops import cuda_step
    dev, K, key = plant.qpos.device, cfg.num_samples, cuda_step.launch_key
    gen = torch.Generator(device=dev).manual_seed(2)
    lim = model.actuator_ctrlrange
    ctrl = model.key_ctrl[0] + cfg.noise_sigma * torch.randn(
        (K, model.nu), generator=gen, device=dev)
    ctrl = torch.clamp(ctrl, lim[:, 0], lim[:, 1]).T.contiguous()
    qp = plant.qpos[:, None].repeat(1, K).contiguous()
    qv = plant.qvel[:, None].repeat(1, K).contiguous()
    return [kernel_record(f"{label} rollout", model, cfg.rollout_dt,
                          cfg.n_substeps, qp, qv, ctrl,
                          launches.get(key(K, cfg.n_substeps), 0)),
            kernel_record(f"{label} plant", model, model.timestep, 10,
                          qp[:, :1].contiguous(), qv[:, :1].contiguous(),
                          ctrl[:, :1].contiguous(),
                          launches.get(key(1, 10), 0))]


def trot_ticks(dev, K, label, ticks, kernels=True):
    """Configs 2 / 2b: Go1 flat from ``home``, generator seed 0; the tick
    captured, then ``bench_torch.solve_throughput``: ``ticks`` graph ticks
    of warm-up and ``ticks`` timed (the kernel rows count the launches of
    both).  Returns the fields the two records share."""
    import torch
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.physics import make_state
    m = load_go1("flat", device=dev)
    init, tick, cfg = trot_mpc(m, K)
    carry = init(torch.Generator(device=dev).manual_seed(0),
                 make_state(m, "home"))
    capture_s, tick = timed(dev, lambda: mpc_tick(
        tick, carry, (K, cfg.horizon, m.nu)))
    _, (sps, carry), launches = counted(
        dev, lambda: solve_throughput(tick, carry, ticks, 1))
    q = carry.plant.qpos.cpu().numpy()
    out = dict(solves_per_sec=round(sps, 1),
               final_x=round(float(q[0]), 2),
               healthy=bool(0.12 < q[2] < 0.5), capture_s=capture_s)
    if kernels and dev.type == "cuda":
        out["kernels"] = mpc_rows(label, m, cfg, carry.plant, launches)
    return out


def config_2(dev):
    """K=256: the configuration of bench.py."""
    return trot_ticks(dev, 256, "bench 2", TICKS)


def config_2b(dev, ticks=TICKS, kernels=True):
    """K=4096, the BASELINE rollout target; ``meets_50hz``."""
    rec = trot_ticks(dev, 4096, "bench 2b", ticks, kernels)
    sps = rec["solves_per_sec"]
    return dict(solves_per_sec=sps, rollouts_per_tick=4096,
                meets_50hz=bool(sps >= 50.0),
                **{k: v for k, v in rec.items() if k != "solves_per_sec"})


# ---- configs 2c and 2cp: OpenDOG terrain MPPI ----------------------------

def terrain_setup(dev):
    """(model, terrain, cost, cfg, start, note) of configs 2c / 2cp:
    OpenDOG on a rough generated terrain, the port's draw (``rough_terrain``
    of scripts/torch_terrain_fidelity.py from torch seed 5: the JAX
    script's jax.random.PRNGKey(5) terrain, which torch cannot reproduce,
    is rough too), the standing cost 0.0694 m above the ground under the
    start, sigma 0.08, the keyframe lifted by that ground height (the JAX
    script's fixed +0.151 m is the height of a flat episode)."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.solvers import MPPIConfig, costs
    from torch_terrain_fidelity import rough_terrain
    m = load_opendog("terrain", device=dev)
    terr, seed = rough_terrain(m, TERRAIN_SEED)
    h0 = float(dynamics._terrain_height_normal(
        m, terr, torch.zeros(1, 2, device=dev))[0][0])
    cost = costs.standing_cost(m, 0.0694 + h0, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.08, engine="kernel")
    s0 = make_state(m, "home")
    s0.qpos[2] += h0
    note = (f"port draw: generate_terrain(torch.Generator().manual_seed("
            f"{seed})), relief "
            f"{float(terr.height.max() - terr.height.min()):.3f} m, ground "
            f"under the start {h0:.4f} m")
    return m, terr, cost, cfg, s0, note


def terrain_ticks(m, terr, cost, cfg, s0, **kw):
    """TICKS warm-up graph ticks and TICKS timed ones of the
    terrain MPC (``make_mpc(..., terrain=terr, **kw)``) from generator
    seed 0: (solves per second of the timed ticks, last carry)."""
    import torch
    from opendog_tpu_torch.solvers import make_mpc
    dev = m.device
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10, device=dev,
                             terrain=terr, **kw)
    carry = init(torch.Generator(device=dev).manual_seed(0), s0)
    tick = mpc_tick(tick, carry, (cfg.num_samples, cfg.horizon, m.nu))
    return solve_throughput(tick, carry, TICKS, 1)


def config_2c(dev):
    """Trunk-plane rollouts (K3), the exact bilinear plant."""
    m, terr, cost, cfg, s0, note = terrain_setup(dev)
    sps, carry = terrain_ticks(m, terr, cost, cfg, s0)
    q = carry.plant.qpos.cpu().numpy()
    return dict(solves_per_sec=round(sps, 1),
                trunk_z=round(float(q[2]), 3),
                all_finite=bool(np.isfinite(q).all()),
                terrain=note)


def config_2cp(dev):
    """Per-geom planes on both sides (K4 rollouts and plant), and the
    distance to where the exact-plant loop (config 2c) is after as many
    ticks (2 x TICKS) from the same start and generator seed."""
    m, terr, cost, cfg, s0, note = terrain_setup(dev)
    sps, carry = terrain_ticks(m, terr, cost, cfg, s0,
                               terrain_plant="kernel", plane_mode="per_geom")
    q = carry.plant.qpos.cpu().numpy()
    _, exact = terrain_ticks(m, terr, cost, cfg, s0)
    qe = exact.plant.qpos.cpu().numpy()
    return dict(solves_per_sec=round(sps, 1),
                trunk_z=round(float(q[2]), 3),
                all_finite=bool(np.isfinite(q).all()),
                final_dev_vs_exact_plant_m=round(
                    float(np.linalg.norm(q[:3] - qe[:3])), 4),
                terrain=note)


# ---- config 2d: payload-aware trot MPPI ----------------------------------

def solve_loop(solve, st, ms, gen, *aux):
    """TICKS receding solves from the one state ``st`` (the plant does not
    advance, as in the JAX script's scan): the last solver state and
    stats, and every control, stacked."""
    import torch
    ctrls = []
    for _ in range(TICKS):
        ctrl, ms, stats = solve(st, ms, gen, None, *aux)
        ctrls.append(ctrl.clone())
    return ms, stats, torch.stack(ctrls)


def config_2d(dev):
    """Go1 plans with a 1.5 kg load on K2: 100 solves from ``home``
    (generator seed 0) as warm-up, 100 timed (seed 1)."""
    import torch
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_solve, mppi
    kg = 1.5
    m = load_go1("flat", device=dev)
    cost, cfg = trot_setup(m, 256)
    solve = mppi.make_solver(m, cost, cfg, device=dev, with_payload=True)
    st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
    if dev.type == "cuda":
        solve = graph_solve(solve, st, ms0, torch.zeros(
            (cfg.num_samples, cfg.horizon, m.nu), device=dev), kg)
    solve_loop(solve, st, ms0, torch.Generator(device=dev).manual_seed(0),
               kg)
    dt, (_, _, ctrls) = timed(dev, lambda: solve_loop(
        solve, st, ms0, torch.Generator(device=dev).manual_seed(1), kg))
    return dict(solves_per_sec=round(TICKS / dt, 1), payload_kg=kg,
                all_finite=bool(torch.isfinite(ctrls).all()))


# ---- config 6: sample-sharded MPPI ---------------------------------------

def config_6(dev):
    """Config 2's solve with its K = 256 x world size samples sharded over
    ``sample_mesh()`` (``psum`` / ``pmin`` reductions), at world size 1 in
    this process (NCCL on the card, gloo on the CPU): 100 receding solves
    from ``home`` as warm-up, then the same 100 timed (generator seed 0
    both times)."""
    import torch
    import torch.distributed as dist
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.parallel import initialize_distributed, sample_mesh
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_solve, mppi
    cuda = dev.type == "cuda"
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                           device=None if cuda else "cpu")
    try:
        mesh = sample_mesh(1, device=dev)
        m = load_go1("flat", device=dev)
        cost, cfg = trot_setup(m, 256 * mesh.size)
        solve = mppi.make_solver(m, cost, cfg, mesh=mesh)
        st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
        if cuda:
            solve = graph_solve(solve, st, ms0, torch.zeros(
                (cfg.num_samples, cfg.horizon, m.nu), device=dev))

        def run():
            return solve_loop(solve, st, ms0,
                              torch.Generator(device=dev).manual_seed(0))

        run()
        dt, (_, stats, _) = timed(dev, run)
        return dict(solves_per_sec=round(TICKS / dt, 1), devices=mesh.size,
                    rollouts_per_tick=cfg.num_samples,
                    best_cost=round(float(stats["best_cost"]), 3),
                    backend=dist.get_backend())
    finally:
        dist.destroy_process_group()


# ---- configs 3 and 3b: whole-body iLQR -----------------------------------

def settled_go1(dev):
    """Go1's ``home`` after 200 op-graph substeps under the keyframe's
    control (unclipped, as the JAX script)."""
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.physics import dynamics, make_state
    m = load_go1("flat", device=dev)
    s, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0], None,
                         n_substeps=200)
    return m, s


def config_3(dev):
    """Go1 standing under iLQR (H=50, 3 iterations) with 50 tracked ticks:
    one cycle that captures, then one timed."""
    from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr_tracker
    m, s = settled_go1(dev)
    cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
    icfg = ILQRConfig(horizon=50, n_substeps=2, rollout_dt=0.01,
                      iterations=3)
    cycle = make_ilqr_tracker(m, cost, icfg, track_ticks=50,
                              plant_substeps=10, device=dev)
    U0 = m.key_ctrl[0][None].repeat(icfg.horizon, 1)
    capture_s, (plant, U, _) = timed(dev, lambda: cycle(s, U0))
    dt, (plant, U, _) = timed(dev, lambda: cycle(plant, U))
    z = float(plant.qpos[2])
    return dict(cycle_seconds=round(dt, 3),
                realtime_factor=round(1.0 / dt, 2),  # a cycle covers 1 s
                trunk_z=round(z, 3), healthy=bool(0.15 < z < 0.4),
                capture_cycle_seconds=capture_s)


def trot_ilqr_record(dt, n_cycles, x0, q_final, trajs):
    """Config 3b's record (scripts/bench_suite.py:374-394): ``dt`` seconds
    for ``n_cycles`` cycles, ``x0`` the trunk x before them, ``q_final``
    the plant qpos after them, ``trajs`` each cycle's tracked qpos (ticks,
    nq), numpy.  Health is judged over the whole trot: the minimum trunk
    z over every tick and the mean over the last cycle."""
    dist = float(q_final[0]) - x0
    zs = np.concatenate([np.asarray(t)[:, 2] for t in trajs])
    z_last = np.asarray(trajs[-1])[:, 2]
    return dict(cycle_seconds=round(dt / n_cycles, 3),
                realtime_factor=round(0.5 / (dt / n_cycles), 2),
                distance_m=round(dist, 3),
                mean_speed_mps=round(dist / (0.5 * n_cycles), 3),
                locomotes=bool(dist > 0.1),
                trunk_z_min=round(float(zs.min()), 3),
                trunk_z_last_cycle_mean=round(float(z_last.mean()), 3),
                trunk_z_final=round(float(q_final[2]), 3),
                healthy=bool(zs.min() > 0.12
                             and 0.18 < z_last.mean() < 0.4))


def config_3b(dev):
    """Go1 trotting under trot_schedule + contact_schedule_cost at 0.5 m/s
    (H=25 at 10 x 2 ms, 6 iterations, warm started from trot_gait_ref),
    0.5 s replan / 50 Hz tracking, time reset to 0: one cycle that
    captures, then 10 timed (5 s of locomotion)."""
    import torch
    from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr_tracker
    n_cycles = 10
    m, s = settled_go1(dev)
    s.time = torch.zeros((), device=dev)
    home_j = m.key_qpos[0, 7:]
    pc = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0), target_height=0.265)
    sched = costs.trot_schedule(pc, legs="go1")
    cost = costs.contact_schedule_cost(m, sched, pc, home_j, legs="go1")
    icfg = ILQRConfig(horizon=25, n_substeps=10, rollout_dt=0.002,
                      iterations=6)
    u_ref = costs.trot_gait_ref(m, pc, home_j, legs="go1")
    cycle = make_ilqr_tracker(m, cost, icfg, track_ticks=25,
                              plant_substeps=10, u_ref_fn=u_ref, device=dev)
    U0 = m.key_ctrl[0][None].repeat(icfg.horizon, 1)
    capture_s, (plant, U, _) = timed(dev, lambda: cycle(s, U0))
    x0 = float(plant.qpos[0])

    def run():
        nonlocal plant, U
        trajs = []
        for _ in range(n_cycles):
            plant, U, traj = cycle(plant, U)
            trajs.append(traj["qpos"].clone())
        return trajs

    dt, trajs = timed(dev, run)
    rec = trot_ilqr_record(dt, n_cycles, x0, plant.qpos.cpu().numpy(),
                           [t.cpu().numpy() for t in trajs])
    rec["capture_cycle_seconds"] = capture_s
    return rec


# ---- configs 4, 4b, 4c, 4d: the domain-randomised batch ------------------

def batch_draws(model):
    """Config 4's draws: (BATCH, nq) standard normals from torch seed 0 on
    the CPU (the JAX script draws jax.random.PRNGKey(0); the tests give
    ``batch_start`` that draw)."""
    import torch
    return torch.randn((BATCH, model.nq),
                       generator=torch.Generator().manual_seed(0))


def batch_start(model, draws):
    """Config 4's start, batch-first: ``home`` plus 0.02 x ``draws`` (B,
    nq) standard normals on all of qpos, the quaternion included
    (unnormalised, as in the JAX script), at rest, and the keyframe's
    control on every env: (qpos, qvel, ctrl) tensors on the model's
    device."""
    import torch
    dev = model.device
    if not torch.is_tensor(draws):
        draws = torch.from_numpy(np.array(draws, np.float32))
    draws = draws.to(dev, torch.float32)
    B = draws.shape[0]
    qpos = model.key_qpos[0][None].repeat(B, 1) + 0.02 * draws
    return (qpos, torch.zeros((B, model.nv), device=dev),
            model.key_ctrl[0][None].repeat(B, 1))


def batch_step(model, ctrl, n_substeps=10):
    """Config 4's tick: ``(qpos, qvel, time) -> (qpos, qvel, time)`` of the
    op-graph step over the leading batch axis, each env under its row of
    ``ctrl``."""
    from opendog_tpu_torch.physics import State, dynamics

    def step(qpos, qvel, t):
        s, _ = dynamics.step(model, State(qpos=qpos, qvel=qvel, time=t),
                             ctrl, n_substeps=n_substeps)
        return s.qpos, s.qvel, s.time

    return step


def config_4(dev, reps=REPS):
    """OpenDOG flat, BATCH envs from ``batch_start`` on ``batch_draws``,
    the 10-substep op-graph step over the batch: one warm-up call (on the
    card: the capture of one CUDA graph), then ``reps`` timed.  Returns
    the record and the final (qpos, qvel, ctrl), batch-first."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    m = load_opendog("flat", device=dev)
    B = BATCH
    qpos, qvel, ctrl = batch_start(m, batch_draws(m))
    step = Replayed(batch_step(m, ctrl), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    capture_s, state = timed(dev, lambda: step(
        qpos, qvel, torch.zeros(B, device=dev)))

    def run():
        x = state
        for _ in range(reps):
            x = step(*x)
        return x

    dt, (qpos, qvel, _) = timed(dev, run)
    rec = dict(env_ticks_per_sec=round(B * reps / dt, 1),
               ticks_per_sec_per_env=round(reps / dt, 2),
               meets_4096_per_tick=bool(B * reps / dt >= 4096 * 50),
               capture_s=capture_s,
               all_finite=bool(torch.isfinite(qpos).all()
                               & torch.isfinite(qvel).all()))
    if dev.type == "cuda":
        rec["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return rec, (qpos.clone(), qvel.clone(), ctrl)


def fused_steps(step, args, reps):
    """One warm-up launch of a substep kernel from ``args`` (qpos, qvel,
    ctrl[, plane, payload]), then ``reps`` timed from where it ends:
    (seconds, launches of the timed ones, final (qpos, qvel))."""
    qp, qv = step(*args)
    rest = args[2:]

    def run():
        nonlocal qp, qv
        for _ in range(reps):
            qp, qv = step(qp, qv, *rest)
        return qp, qv

    dt, out, launches = counted(qp.device, run)
    return dt, launches, out


def config_4b(dev, batch, reps=REPS, kernels=True):
    """K1 on config 4's final states laid out as (rows, B), B x 10
    substeps of 2 ms per launch.  Returns the record and the final (qpos,
    qvel) rows."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step
    m = load_opendog("flat", device=dev)
    qp, qv, ct = (cuda_step.rows_from_batch(x) for x in batch)
    B = qp.shape[1]
    step = cuda_step.build_cuda_substep(m, m.timestep, 10, device=dev)
    dt, launches, (qp2, qv2) = fused_steps(step, (qp, qv, ct), reps)
    rec = dict(env_ticks_per_sec=round(B * reps / dt, 1),
               meets_4096_per_tick=bool(B * reps / dt >= 4096 * 50),
               all_finite=bool(torch.isfinite(qv2).all()))
    if kernels:
        rec["kernels"] = [kernel_record(
            "bench 4b", m, m.timestep, 10, qp, qv, ct,
            launches.get(cuda_step.launch_key(B, 10), 0))]
    return rec, (qp2, qv2)


def domrand_modes(B, rng):
    """Config 4c's draws, in the JAX script's order from ``rng`` (numpy):
    each scenario's ground plane (tilt ~N(0, 0.04) in x and y, offset
    ~N(0, 0.03)) as (4, B) and its trunk payload U(0, 0.5) kg as (1, B),
    float32."""
    tilt = rng.normal(0, 0.04, (2, B))
    nz = np.sqrt(1.0 - np.clip(tilt[0] ** 2 + tilt[1] ** 2, 0, 0.5))
    dvec = rng.normal(0, 0.03, B)
    plane = np.stack([tilt[0], tilt[1], nz, dvec]).astype(np.float32)
    payload = rng.uniform(0.0, 0.5, (1, B)).astype(np.float32)
    return plane, payload


def batch_inputs(model, K):
    """Config 4d's domain-randomised batch (scripts/bench_suite.py:480-
    498): OpenDOG home states with 0.02 float32 noise at rest, home
    controls, one plane per scenario and a payload, all from numpy seed 0
    in the JAX script's order: numpy (rows, K)."""
    rng = np.random.default_rng(0)
    qp = np.tile(model.numpy("key_qpos")[0].astype(np.float32)[:, None],
                 (1, K))
    qp += 0.02 * rng.standard_normal(qp.shape).astype(np.float32)
    qv = np.zeros((model.nv, K), np.float32)
    ct = np.tile(model.numpy("key_ctrl")[0].astype(np.float32)[:, None],
                 (1, K))
    plane, payload = domrand_modes(K, rng)
    return qp, qv, ct, plane, payload


def plane_payload_steps(dev, name, args, reps, kernels):
    """K2+K3 (``substep_plane_payload``; for OpenDOG's 24 spheres the
    32-sphere build, 8 rollouts a block) on ``args`` (rows, B): one
    warm-up launch and ``reps`` timed.  Returns the fields and the final
    qvel."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step
    m = load_opendog("flat", device=dev)
    B = args[0].shape[1]
    step = cuda_step.build_cuda_substep(m, m.timestep, 10, device=dev,
                                        with_plane=True, with_payload=True)
    dt, launches, (_, qv) = fused_steps(step, args, reps)
    rec = dict(env_ticks_per_sec=round(B * reps / dt, 1),
               all_finite=bool(torch.isfinite(qv).all()))
    if dev.type == "cuda":
        warps = cuda_step.cuda_library()[0].substep_warps_per_block(
            1, 1, m.ngeom)
        rec["launch"] = (f"{math.ceil(B / warps)} blocks of {warps} "
                         f"rollouts ({m.ngeom} spheres)")
    if kernels:
        rec["kernels"] = [kernel_record(
            name, m, m.timestep, 10, *args[:3],
            launches.get(cuda_step.launch_key(B, 10, True, True), 0),
            plane=(True, args[3]), payload=args[4])]
    return rec


def config_4c(dev, batch, rows):
    """K2+K3 at B x 10, REPS timed launches, from the states 4b ends on
    (``rows``) under config 4's controls, each scenario on its own plane
    with its own payload (``domrand_modes`` from a fresh numpy seed 0)."""
    import torch
    from opendog_tpu_torch.ops import cuda_step
    ct = cuda_step.rows_from_batch(batch[2])
    B = ct.shape[1]
    plane, payload = (torch.from_numpy(a).to(dev) for a in domrand_modes(
        B, np.random.default_rng(0)))
    rec = plane_payload_steps(dev, "bench 4c", (*rows, ct, plane, payload),
                              REPS, True)
    return dict(meets_4096_per_tick=bool(
        rec["env_ticks_per_sec"] >= 4096 * 50), **rec)


def config_4d(dev, reps=REPS, kernels=True):
    """K2+K3 at B=32,768 x 10 on ``batch_inputs``: the single-card slice
    of BASELINE config 5's 32k scenarios."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    m = load_opendog("flat", device=dev)
    B = BATCH_32K
    args = tuple(torch.from_numpy(a).to(dev) for a in batch_inputs(m, B))
    rec = plane_payload_steps(dev, "bench 4d", args, reps, kernels)
    return dict(scenarios=B, meets_32k_per_tick=bool(
        rec["env_ticks_per_sec"] >= B * 50), **rec)


def suite_4(dev):
    """Config 4 and, on the card, 4b and 4c from where it ends."""
    rec, batch = config_4(dev)
    out = [("4_batch4096_rollouts", rec)]
    if dev.type == "cuda":
        rec_b, rows = config_4b(dev, batch)
        out += [("4b_batch4096_fused", rec_b),
                ("4c_batch4096_domrand_planes_payloads",
                 config_4c(dev, batch, rows))]
    return out


# ---- configs 2e and 2f: the application scripts --------------------------

def script_last_line(name, argv):
    """``scripts/<name>.py``'s ``main(argv)`` run here with its stdout
    captured: its last line, parsed."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def fidelity_record(fid):
    """Config 2e's record from the fidelity script's summary
    (scripts/bench_suite.py:520-539)."""
    return dict(plane_arm=fid["plane_arm"], exact=fid["exact"],
                plane=fid[fid["plane_arm"]],
                distance_ratio=fid["distance_ratio_plane_vs_exact"],
                cost_ratio=fid["cost_ratio_plane_vs_exact"],
                per_geom=fid.get("per_geom"),
                distance_ratio_pergeom=fid.get(
                    "distance_ratio_pergeom_vs_exact"),
                cost_ratio_pergeom=fid.get("cost_ratio_pergeom_vs_exact"))


def lag_price_record(lag, lagc):
    """Config 2f's record from the lag sweep's summaries at lags 0 and 3
    and compensated at lag 3 (scripts/bench_suite.py:555-576)."""
    by = {r["lag"]: r for r in lag["results"]}
    lag3c = lagc["results"][0]
    return dict(lag0=by.get(0), lag3=by.get(3), lag3_compensated=lag3c,
                final_x_lag3_vs_lag0=lag["final_x_lag3_vs_lag0"],
                final_x_lag3_comp_vs_lag0=round(
                    lag3c["final_x_mean"]
                    / max(1e-9, by[0]["final_x_mean"]), 3)
                if 0 in by else None)


def config_2e(dev, out_dir):
    """Local-plane and per-geom planning against exact op-graph planning
    on the same rough terrains, 200 ticks, seeds 0 and 2."""
    fid = script_last_line("torch_terrain_fidelity", [
        "--ticks", "200", "--seeds", "0", "2", "--device", str(dev),
        "--out", os.path.join(out_dir, "2e_terrain_fidelity.json")])
    return fidelity_record(fid)


def config_2f(dev, out_dir):
    """The trot MPC with the plant applying the solve from 0 and 3 ticks
    ago, then compensated at 3: 300 ticks, one seed."""
    common = ["--ticks", "300", "--seeds", "1", "--device", str(dev)]
    lag = script_last_line("torch_lag_sweep", common + [
        "--lags", "0", "3", "--out", os.path.join(out_dir, "2f_lags.json")])
    lagc = script_last_line("torch_lag_sweep", common + [
        "--lags", "3", "--compensate",
        "--out", os.path.join(out_dir, "2f_compensated.json")])
    return lag_price_record(lag, lagc)


# ---- config 5: one distillation round ------------------------------------

def config_5(dev):
    """OpenDOG flat, standing_cost 0.065, the 64-64 student, S=8 scenarios
    x 50 ticks, batch 64, 4 epochs, MPPI H=10 at K=64 on K1: one round that
    captures, one timed, then a 100-tick student-only eval."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.physics import State, make_state
    from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
    from opendog_tpu_torch.rl.networks import MLPActorCritic
    from opendog_tpu_torch.solvers import MPPIConfig, costs
    S, ticks = 8, 50
    m = load_opendog("flat", device=dev)
    cost = costs.standing_cost(m, 0.065, m.key_qpos[0, 7:])
    net = MLPActorCritic(m.nq - 2 + m.nv, m.nu, hidden=(64, 64), device=dev)
    dcfg = DistillConfig(num_scenarios=S, rollout_ticks=ticks, batch_size=64,
                         epochs_per_round=4)
    mcfg = MPPIConfig(horizon=10, num_samples=64, n_substeps=2,
                      rollout_dt=0.01, engine="kernel")
    d = make_distiller(m, cost, lambda qp, qv, t: torch.cat(
        [qp[..., 2:], qv], dim=-1), net, mcfg, dcfg, plant_substeps=10,
        device=dev)
    s0 = make_state(m, "home")
    plants = State(qpos=s0.qpos[None].repeat(S, 1),
                   qvel=torch.zeros(S, m.nv, device=dev),
                   time=torch.zeros(S, device=dev))
    dstate = d.init(torch.Generator(device=dev).manual_seed(0), s0)
    dstate, plants, _ = d.round_fn(dstate, plants, 0)
    dt, (dstate, plants, metrics) = timed(dev, lambda: d.round_fn(
        dstate, plants, 0))
    loss = float(metrics["distill_loss"])
    ev = d.eval_fn(dstate, plants, 100)
    zs = ev["qpos_traj"][:, :, 2]
    return dict(round_seconds=round(dt, 2),
                expert_labels_per_sec=round(S * ticks / dt, 1),
                distill_loss=round(loss, 4),
                student_action_rmse=round(float(ev["action_rmse"]), 4),
                student_upright_frac=round(float(
                    ((zs > 0.03) & (zs < 0.25)).float().mean()), 3),
                healthy=bool(np.isfinite(loss)))


# ---- the suite -------------------------------------------------------------

NAMES = {"1": "1_standing_hold", "2": "2_trot_mppi_256",
         "2b": "2b_trot_mppi_4096", "2c": "2c_terrain_mppi_256",
         "2cp": "2c_pergeom_kernel_plant", "2d": "2d_payload_trot_mppi_256",
         "6": "6_sample_sharded_mppi", "3": "3_ilqr_replan_track",
         "3b": "3b_scheduled_ilqr_trot", "4d": "4d_batch32k_domrand",
         "2e": "2e_terrain_fidelity", "2f": "2f_lag_price",
         "5": "5_distill_round"}
RUNNERS = {"1": config_1, "2": config_2, "2b": config_2b, "2c": config_2c,
           "2cp": config_2cp, "2d": config_2d, "6": config_6, "3": config_3,
           "3b": config_3b, "4d": config_4d, "5": config_5}


def run_config(key, dev, out_dir):
    """The (name, record) pairs of config ``key`` on ``dev``."""
    if key == "4":
        return suite_4(dev)
    if key in ("2e", "2f"):
        return [(NAMES[key], (config_2e if key == "2e" else config_2f)(
            dev, out_dir))]
    return [(NAMES[key], RUNNERS[key](dev))]


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="--only and --device are the port's own options; the rest "
               "are scripts/bench_suite.py's.")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--skip", nargs="*", default=[], choices=KEYS,
                   metavar="KEY", help="configs not to run: "
                                       + " ".join(KEYS))
    p.add_argument("--only", nargs="*", default=None, choices=KEYS,
                   metavar="KEY", help="run these configs alone (less "
                                       "--skip)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, "BENCH_SUITE.json"):
        p.error("BENCH_SUITE.json is the JAX package's record; write the "
                "port's elsewhere")
    import gc
    import torch

    # merge semantics: a partial run updates only the configs it ran
    results = {}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                results = json.load(f)
        except (json.JSONDecodeError, OSError):
            results = {}
    dev, line = open_device(args.device)
    stamp = dict(recorded_at=time.strftime("%Y-%m-%dT%H:%M:%S"), device=line)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    for key in KEYS:
        if (key in args.skip or (args.only is not None
                                 and key not in args.only)
                or (dev.type != "cuda" and key in CARD_ONLY)):
            continue
        t0 = time.perf_counter()
        for name, rec in run_config(key, dev, out_dir):
            rec["seconds"] = time.perf_counter() - t0  # the key's whole run
            results[name] = {**rec, "_provenance": stamp}
            print(json.dumps({"config": name, **rec}), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
