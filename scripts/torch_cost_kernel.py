#!/usr/bin/env python3
"""The rollouts' tracking-cost kernel (``rollout_tracking_cost``) on one CUDA
card: its rows of the kernel table.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_cost_kernel.py [--out cost_kernel.json]

Builds the kernel library (``opendog_tpu_torch/csrc/``), prints the ptxas
report of ``rollout_tracking_cost`` (registers, stack, spills), then, on
OpenDOG's terrain scene (the generated terrain of seed 0) at the MPPI
rollouts' K=256 and K=4096 lanes, from the home keyframe lifted onto the
ground with its joints perturbed by N(0, 0.03) rad and run through two
trunk-plane control steps (K3):

* one control step's cost against the op path it replaces
  (``costs.standing_cost``'s closure on the carry's (rows, L) layout, times
  the discount, added to the total): the widest gap, which must read 0;
* the milliseconds of one launch by CUDA events, eagerly and replayed from
  a CUDA graph of 25 launches (as the tick replays them), beside the op
  path's step, eagerly and replayed;
* its bound: the bytes it must move (the rows it reads, the total read and
  written) over the card's memory rate, against its operations over the
  float32 peak.

Then the three MPC ticks of the benchmark's one-chip configurations, built
by ``make_mpc`` and replayed from their CUDA graphs (``graph_tick``):
OpenDOG on rough terrain with trunk planes and the exact plant at K=256,
with per-geom planes at K=4096, and the Go1 trot at K=256; each row gives
the launches a replay adds to ``COST_LAUNCHES`` (25 on OpenDOG's standing
cost, 0 on the trot cost) and the ms of a replay.  Prints one JSON line (and
writes it to ``--out``) with the card's name and power limit.  It imports
no JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LANES = (256, 4096)
H = 25
REPS = 200          # eager launches or graph replays timed
TICKS = 50          # replayed MPC ticks timed
SIGMA = 0.03


def cost_rows(torch, dev):
    from torch_exact_plant import graphed
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.physics import State, dynamics
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from opendog_tpu_torch.solvers import costs
    from opendog_tpu_torch.utils.profiling import (event_ms,
                                                   tracking_cost_bound)

    m = load_opendog("terrain", device=dev)
    terr = terrain_lib.generate_terrain(
        m, torch.Generator().manual_seed(0)).to(dev)
    h0 = float(dynamics._terrain_height_normal(
        m, terr, torch.zeros(1, 2, device=dev))[0][0])
    cost = costs.standing_cost(m, 0.0694 + h0, m.key_qpos[0, 7:])
    kernel = cuda_step.TrackingCostKernel(m, *cost.tracking, dev)
    psub = cuda_step.build_cuda_substep(m, 0.01, 2, device=dev,
                                        with_plane=True)
    rng = m.actuator_ctrlrange
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for L in LANES:
        qpos = m.key_qpos[0][None].repeat(L, 1)
        qpos[:, 2] += h0
        qpos[:, 7:] += SIGMA * torch.randn(L, m.nq - 7, device=dev,
                                           generator=gen)
        h, n = dynamics._terrain_height_normal(m, terr, qpos[:, :2])
        p0 = torch.stack([qpos[:, 0], qpos[:, 1], h], dim=-1)
        plane = torch.cat([n, torch.sum(n * p0, dim=-1)[:, None]],
                          dim=-1).T.contiguous()
        cand = torch.clamp(m.key_ctrl[0] + 0.08 * torch.randn(
            L, 2, m.nu, device=dev, generator=gen), rng[:, 0], rng[:, 1])
        ctrl_rows = cand.permute(1, 2, 0).contiguous()
        qp, qv = qpos.T.contiguous(), torch.zeros(m.nv, L, device=dev)
        for k in range(2):
            qp, qv = psub(qp, qv, ctrl_rows[k], plane=plane)
        ctrl, prev = ctrl_rows[1], ctrl_rows[0]
        base = torch.rand(L, device=dev, generator=gen)
        st = State(qpos=qp.T, qvel=qv.T, time=torch.zeros(L, device=dev))

        def op_step():
            return base + cost(st, cand[:, 1], cand[:, 0]) * 0.9

        def kernel_step():
            return kernel(qp, qv, ctrl, prev, 0.9, base.clone())

        want, got = op_step(), kernel_step()
        torch.cuda.synchronize()
        gap = float((got - want).abs().max())
        total = base.clone()
        ms = event_ms(lambda: kernel(qp, qv, ctrl, prev, 0.9, total), REPS)
        replay_ms = graphed(torch, lambda: [
            kernel(qp, qv, ctrl, prev, 0.9, total) for _ in range(H)],
            REPS) / H
        op_ms = event_ms(op_step, REPS)
        op_replay_ms = graphed(torch, op_step, REPS)
        bound_ms, bound_by, ops, nbytes = tracking_cost_bound(m, L)
        rows.append(dict(
            name=f"{cuda_step.ROLLOUT_COST} L={L}", lanes=L,
            launches=f"{H}/tick", max_abs_err=gap, bit_equal=bool(
                torch.equal(got, want)), ms=ms, replayed_ms=replay_ms,
            op_path_ms=op_ms, op_path_replayed_ms=op_replay_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
            roofline_pct=100.0 * bound_ms / replay_ms))
        print(f"[cost] L={L}: {ms * 1e3:.2f} us eager, {replay_ms * 1e3:.2f} "
              f"us replayed; op path {op_ms * 1e3:.1f} / "
              f"{op_replay_ms * 1e3:.1f} us; bound "
              f"{rows[-1]['bound_ms'] * 1e3:.3f} us; gap {gap}",
              file=sys.stderr)
    return rows


def tick_rows(torch, dev):
    """COST_LAUNCHES a replay and ms a replay of the three one-chip MPC
    ticks of the benchmark's configurations."""
    from opendog_tpu_torch.assets import load_go1, load_opendog
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from opendog_tpu_torch.solvers import (MPPIConfig, costs, graph_tick,
                                           make_mpc)
    from opendog_tpu_torch.utils.profiling import event_ms

    dog = load_opendog("terrain", device=dev)
    terr = terrain_lib.generate_terrain(
        dog, torch.Generator().manual_seed(0)).to(dev)
    h0 = float(dynamics._terrain_height_normal(
        dog, terr, torch.zeros(1, 2, device=dev))[0][0])
    standing = costs.standing_cost(dog, 0.0694 + h0, dog.key_qpos[0, 7:])
    go1 = load_go1("flat", device=dev)
    trot = costs.trot_cost(go1, costs.TrotCostParams(
        desired_vel_xy=(0.5, 0.0), target_height=0.265),
        go1.key_qpos[0, 7:], legs="go1")
    cases = (
        ("opendog_terrain_exact", dog, standing, 256, 0.08,
         dict(terrain=terr, terrain_plant="exact", plane_mode="trunk")),
        ("opendog_terrain_pergeom_k4096", dog, standing, 4096, 0.08,
         dict(terrain=terr, terrain_plant="kernel", plane_mode="per_geom")),
        ("go1_trot_k256", go1, trot, 256, 0.12, {}))
    rows = []
    for name, m, cost, K, sigma, extra in cases:
        cfg = MPPIConfig(horizon=H, num_samples=K, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=sigma, temperature=0.3)
        init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10,
                                 device=dev, **extra)
        s0 = make_state(m, "home")
        if extra:
            s0.qpos[2] += h0
        carry = init(None, s0)
        gen = torch.Generator(device=dev).manual_seed(3)
        normals = torch.randn((K, H, m.nu), device=dev, generator=gen)
        gtick = graph_tick(tick, carry, normals)
        per_replay = dict(gtick.graph.count_of(cuda_step.COST_LAUNCHES))
        state = {"carry": carry}

        def replay():
            state["carry"], _ = gtick(state["carry"], normals)

        ms = event_ms(replay, TICKS)
        rows.append(dict(cell=name, lanes=K,
                         cost_launches_per_tick=sum(per_replay.values()),
                         cost_launch_keys=per_replay, replay_ms=ms))
        print(f"[cost] {name}: {per_replay} a replay, {ms:.3f} ms",
              file=sys.stderr)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_cost_kernel: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch_exact_plant import card_line
    from opendog_tpu_torch.ops import cuda_step

    dev = torch.device("cuda", 0)
    _, built = cuda_step.cuda_library()
    lines = built.log.splitlines()
    report = next(([ln.strip() for ln in lines[i:i + 4]]
                   for i, line in enumerate(lines)
                   if f"'{cuda_step.ROLLOUT_COST}'" in line), [])
    for line in report:
        print(f"[cost] {line}", file=sys.stderr)
    rows = cost_rows(torch, dev)
    ticks = tick_rows(torch, dev)
    res = dict(kernel=cuda_step.ROLLOUT_COST, card=card_line(),
               ptxas=report, rows=rows, ticks=ticks)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    gap = max(r["max_abs_err"] for r in rows)
    if gap != 0.0:
        print(f"torch_cost_kernel: the kernel differs from the op path by "
              f"{gap}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
