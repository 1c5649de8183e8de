#!/usr/bin/env python
"""Collective traffic of the sharded programs on the port, counted and
timed on the cards: the counterpart of scripts/comm_volume.py.

The JAX script counts the collectives of each 8-way-sharded program in its
optimized HLO and models their time on TPU v5e ICI.  The port has no HLO:
it counts what ``parallel/collectives.py`` hands to ``dist.all_reduce``
(``collectives.TRAFFIC``) over one eager pass, and it measures instead of
modelling.  The same three programs at the same shapes, over a mesh of
``--ranks`` ranks (default: the cards present; one card per rank over NCCL,
or ``--device cpu``: gloo ranks on the CPU):

  mppi  sample-sharded MPPI: Go1 flat, ``trot_cost(legs="go1")``, K=4096,
        H=25, 2 x 10 ms substeps on the substep kernel (K1);
  ilqr  horizon-sharded iLQR: ``ILQRConfig(horizon=64, n_substeps=2,
        rollout_dt=0.005, iterations=1, riccati="associative")`` over a
        mesh of the ranks (the associative sweep's two all_gathers per
        backward pass);
  ppo   data-parallel PPO: ``WalkEnv(opendog flat, frame_skip=2)``, a
        64-64 network, ``PPOConfig(num_envs=16, n_steps=16, num_epochs=1,
        minibatch_size=32)`` through ``parallel.make_sharded_ppo`` (one
        gradient ``pmean`` per minibatch).

For each program the record holds ``collectives`` and ``bytes_per_solve``
(``bytes_per_chunk`` for PPO) from the counter, by collective; the
measured ``collective_us``: the counted all_reduce sizes replayed on the
mesh in one pass, timed with CUDA events (the host clock on the CPU),
slowest rank; ``solve_ms`` (``chunk_ms``) at n ranks and at one rank with
the same work per rank, each replayed from CUDA graphs on the card, and
``efficiency_{n}dev``, their ratio.  ``psum``, ``pmin`` and ``all_gather``
reduce an (n, ...) slot buffer, so their bytes grow with n.

It also checks agreement at 2 and 4 ranks (those the world holds): each program at n ranks against the same program at
one rank on the same global inputs.  Every rank must return the same bits
(rank 0 reads the others' outputs), and rank 0 must match the one-rank
result within the tolerances of the CPU tests (tests/test_torch_sharded_*:
MPPI ``SOLVE_TOLS``, iLQR U 5e-4 and cost 1e-4, PPO parameters 2e-5,
metrics 1e-4, env states 1e-5).  The PPO check runs one minibatch of the
whole batch: with smaller minibatches each rank permutes only its own
samples (``make_sharded_ppo``).  A failed check exits non-zero.

Run from the repository root:

    python3 scripts/torch_comm_volume.py                  # all cards
    python3 scripts/torch_comm_volume.py --device cpu --ranks 2 --smoke

Writes ``metrics.json`` under ``--out`` (default ``runs/torch_comm_volume``,
kept out of git; never ``SCALING.json``) with ``device``, ``backend``,
``host_cores`` and ``seconds``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_multidev_common as common  # noqa: E402

MPPI = dict(num_samples=4096, horizon=25, n_substeps=2, rollout_dt=0.01)
ILQR = dict(horizon=64, n_substeps=2, rollout_dt=0.005, iterations=1,
            riccati="associative")
PPO = dict(num_envs=16, n_steps=16, num_epochs=1, minibatch_size=32)
HIDDEN = (64, 64)
HYPER = dict(lr=1e-4, ent_coef=0.0)
SMOKE = dict(mppi=dict(MPPI, num_samples=16, horizon=2, n_substeps=1),
             ilqr=dict(ILQR, horizon=4, n_substeps=1),
             ppo=dict(PPO, num_envs=4, n_steps=2, minibatch_size=4))
REPS = dict(mppi=20, ilqr=3, ppo=2)   # timed solves or chunks
SECTION = dict(mppi="mppi_sample_sharded_k4096",
               ilqr="ilqr_horizon_sharded_h64",
               ppo="ppo_dp_gradient_allreduce")
SOLVE_TOLS = dict(ctrl=1e-5, nominal=1e-5, best_cost=1e-4, mean_cost=1e-4,
                  ess=1e-4)
ILQR_TOLS = dict(U=5e-4, cost=1e-4)
PPO_TOLS = dict(params=2e-5, metrics=1e-4, env_states=1e-5, last_obs=1e-5)
NORMALS_SEED = 4
CHECK_RANKS = (2, 4)
TIMEOUT_S = 1800   # the ranks, rendezvous included
NOTE = ("collectives and bytes: what parallel/collectives.py hands to "
        "dist.all_reduce over one eager pass (psum / pmin / all_gather: an "
        "(n, ...) slot buffer, n x.nbytes; pmean: x.nbytes); collective_us: "
        "those all_reduces replayed on the mesh, CUDA events, slowest rank; "
        "solve_ms: the program replayed from CUDA graphs, slowest rank.  "
        "Not comparable with SCALING.json's per-shard HLO counts and "
        "modelled TPU v5e times.")


def go1_trot(dev):
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.solvers import costs
    m = load_go1("flat", device=dev)
    return m, costs.trot_cost(m, costs.TrotCostParams(), m.key_qpos[0, 7:],
                              legs="go1")


def mppi_program(cfg, dev, mesh, graphs, per_rank=False):
    """``run() -> outputs`` of one solve from Go1's home state on the global
    normals of NORMALS_SEED (``per_rank``: a one-rank solve of this rank's
    K / n samples, the first K / n of the normals)."""
    import torch
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    m, cost = go1_trot(dev)
    K = cfg["num_samples"]
    normals = torch.randn((K, cfg["horizon"], m.nu), generator=torch.
                          Generator().manual_seed(NORMALS_SEED)).to(dev)
    if per_rank:
        K //= per_rank
        normals = normals[:K].contiguous()
    mcfg = MPPIConfig(**dict(cfg, num_samples=K))
    solve = mppi.make_solver(m, cost, mcfg, device=dev, mesh=mesh)
    state, ms0 = make_state(m, "home"), mppi.init_state(m, mcfg)
    if graphs:
        solve = mppi.graph_solve(solve, state, ms0, normals)

    def run():
        ctrl, ms, stats = solve(state, ms0, None, normals)
        return dict(ctrl=ctrl, nominal=ms.nominal, **stats)
    return run


def ilqr_program(cfg, dev, mesh, graphs, per_rank=False):
    """``run() -> outputs`` of one horizon-sharded solve from Go1's home
    state and the held home control (``per_rank``: the same solve on one
    rank; the rollouts and expansions are every rank's whole work)."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import ILQRConfig, make_ilqr
    m, cost = go1_trot(dev)
    solve = make_ilqr(m, cost, ILQRConfig(**cfg), device=dev,
                      graphs=graphs, mesh=mesh)
    s0 = make_state(m, "home")
    U0 = m.key_ctrl[0][None].repeat(cfg["horizon"], 1)

    def run():
        U, X, stats = solve(s0, U0)
        return dict(U=U, cost=stats["cost"])
    return run


def ppo_program(cfg, dev, mesh, graphs, per_rank=False):
    """``run() -> outputs`` of the next chunk of one data-parallel learner
    from generator seed 0 (``per_rank``: a one-rank learner of this rank's
    num_envs / n envs and minibatch / n).  The rollout step replays its
    graph on the card whatever ``graphs`` says: it holds no collective."""
    import torch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.envs import WalkEnv
    from opendog_tpu_torch.envs.base import tree_leaves
    from opendog_tpu_torch.parallel import make_sharded_ppo
    from opendog_tpu_torch.rl.networks import MLPActorCritic
    from opendog_tpu_torch.rl.ppo import Hyper, PPOConfig
    if per_rank:
        cfg = dict(cfg, num_envs=cfg["num_envs"] // per_rank,
                   minibatch_size=cfg["minibatch_size"] // per_rank)
    env = WalkEnv(load_opendog("flat", device=dev), frame_skip=2)
    net = MLPActorCritic(env.obs_size, env.action_dim, hidden=HIDDEN)
    init, chunk = make_sharded_ppo(env, net, PPOConfig(**cfg), mesh)
    state = init(torch.Generator(device=dev).manual_seed(0))
    hyper = Hyper(**HYPER)

    def run():
        nonlocal state
        state, metrics = chunk(state, hyper)
        return dict(**{f"params/{k}": v.detach()
                       for k, v in state.params.items()},
                    **{f"metrics/{k}": v for k, v in metrics.items()},
                    **{f"env_states/{i}": x for i, x in enumerate(
                        tree_leaves(state.env_states))},
                    last_obs=state.last_obs)
    return run


PROGRAMS = dict(mppi=mppi_program, ilqr=ilqr_program, ppo=ppo_program)


def replay_ms(counts, mesh, reps):
    """Milliseconds of one pass of the ``collectives.TRAFFIC`` ``counts``'
    all_reduces on ``mesh`` (zero buffers of the counted sizes), over
    ``reps`` passes after one, slowest rank: CUDA events on the card, the
    host clock on the CPU."""
    import torch
    import torch.distributed as dist
    bufs = [(torch.zeros(numel, dtype=dtype, device=mesh.device), calls)
            for (_, dtype, numel), calls in counts.items()]

    def one():
        for buf, calls in bufs:
            for _ in range(calls):
                dist.all_reduce(buf, group=mesh.group)

    one()
    dist.barrier(group=mesh.group)
    common.sync(mesh.device)
    if mesh.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            one()
        end.record()
        torch.cuda.synchronize(mesh.device)
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            one()
        ms = 1e3 * (time.perf_counter() - t0) / reps
    return 1e3 * common.slowest(ms / 1e3, mesh)


def timed_ms(run, mesh, reps):
    """Milliseconds of one ``run()`` (captured and warm) over ``reps``,
    slowest rank."""
    dt, _ = common.window(lambda: [run() for _ in range(reps)], mesh)
    return 1e3 * dt / reps


def host(outputs):
    return {k: v.detach().cpu().clone() for k, v in outputs.items()}


class Programs:
    """The programs of one rank, built once per (program, ranks, graphs,
    one-rank share, shapes): a graphed solve is captured once and replayed
    by the timing and the checks alike.  A PPO learner trains on at every
    chunk, so each call builds a new one."""

    def __init__(self, dev, meshes):
        self.dev, self.meshes, self.memo = dev, meshes, {}

    def get(self, name, cfg, n, graphs, per_rank=False):
        if name == "ilqr":   # every rank's work is the whole solve's
            per_rank = False
        key = (name, n, graphs, per_rank, repr(sorted(cfg.items())))
        if name == "ppo" or key not in self.memo:
            self.memo[key] = PROGRAMS[name](cfg, self.dev, self.meshes[n],
                                            graphs, per_rank)
        return self.memo[key]


def measure(programs, name, cfg, n, reps):
    """The program's record at ``n`` ranks (rank 0's; every rank of the
    world takes part, ranks outside a one-rank mesh wait)."""
    import torch.distributed as dist
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.parallel import collectives
    dev, mesh = programs.dev, programs.meshes[n]
    graphs = dev.type == "cuda"
    # the counting pass, eager (PPO: the first chunk, whose rollout graph
    # holds no collective; the timed chunks train on from it)
    run = programs.get(name, cfg, n, graphs=False)
    collectives.TRAFFIC.clear()
    run()
    common.sync(dev)
    counts = collectives.TRAFFIC.copy()
    by = collectives.traffic(counts)
    rec = dict(ranks=n, collectives=sum(v["calls"] for v in by.values()),
               **{"bytes_per_chunk" if name == "ppo" else "bytes_per_solve":
                  sum(v["bytes"] for v in by.values())},
               by_collective=by,
               collective_us=1e3 * replay_ms(counts, mesh, 20))
    if graphs and name != "ppo":
        run = programs.get(name, cfg, n, graphs)
    run()                         # captures; then the timed window
    cuda_step.LAUNCHES.clear()
    ms = timed_ms(run, mesh, reps)
    rec["launches"] = dict(cuda_step.LAUNCHES)
    one = ms if n == 1 else None
    if n > 1:
        if mesh.index == 0:
            run1 = programs.get(name, cfg, 1, graphs, per_rank=n)
            run1()                # captures
            one = timed_ms(run1, programs.meshes[1], reps)
        dist.barrier()
    unit = "chunk_ms" if name == "ppo" else "solve_ms"
    rec.update({unit: ms, f"{unit}_one_rank": one,
                f"efficiency_{n}dev": None if one is None else one / ms})
    return rec


def check(programs, name, cfg, ns, out_dir, rank):
    """The agreement of the program at each of ``ns`` ranks with the
    program at one rank on the same global inputs: each rank saves its
    outputs, rank 0 reads them and compares ({n: record} on rank 0, None
    on the others)."""
    import torch
    import torch.distributed as dist
    if name == "ppo":   # one minibatch: the one-rank learner's samples
        cfg = dict(cfg, minibatch_size=cfg["num_envs"] * cfg["n_steps"])
    graphs = programs.dev.type == "cuda"
    ref = (host(programs.get(name, cfg, 1, graphs)()) if rank == 0
           else None)
    out = {}
    for n in ns:
        path = os.path.join(out_dir, f"{name}_{n}_rank{{}}.pt")
        if programs.meshes[n] is not None:
            torch.save(host(programs.get(name, cfg, n, graphs)()),
                       path.format(rank))
        dist.barrier()
        if rank == 0:
            out[str(n)] = compare(name, [torch.load(path.format(r))
                                         for r in range(n)], ref)
    return out if rank == 0 else None


def compare(name, outs, ref):
    """The agreement record of the ranks' outputs ``outs`` against the
    one-rank ``ref``: the replicated outputs the same bits on every rank,
    and each output within its tolerance (|a - b| <= tol (1 + |b|))."""
    import torch
    tols = dict(mppi=SOLVE_TOLS, ilqr=ILQR_TOLS, ppo=PPO_TOLS)[name]

    def group(k):
        return k.split("/")[0]

    def tol(k):
        return tols[group(k)]

    sharded = {k for k in ref if group(k) in ("env_states", "last_obs")}
    same = all(torch.equal(o[k], outs[0][k]) for o in outs[1:]
               for k in ref if k not in sharded)
    got = {k: (torch.cat([o[k] for o in outs]) if k in sharded
               else outs[0][k]) for k in ref}
    err = {}
    ok = same
    for k, want in ref.items():
        d = (got[k].double() - want.double()).abs()
        excess = (d - tol(k) * (1 + want.double().abs())).max()
        err[k] = float(d.max())
        ok = ok and bool(excess <= 0) and bool(torch.isfinite(d).all())
    worst = {}
    for k, v in err.items():
        worst[group(k)] = max(worst.get(group(k), 0.0), v)
    return dict(ranks=len(outs), ranks_bit_equal=same, max_abs=worst,
                tolerances=tols, ok=ok)


def rank_main(args):
    import torch.distributed as dist
    from opendog_tpu_torch.parallel import make_mesh
    dev = common.join(args)
    world = args.world
    checks = [n for n in CHECK_RANKS if n <= world]
    programs = Programs(dev, {n: make_mesh(n, device=dev)
                              for n in sorted({1, world, *checks})})
    cfgs = SMOKE if args.smoke else dict(mppi=MPPI, ilqr=ILQR, ppo=PPO)
    reps = dict(REPS, **({} if args.reps is None else
                         {k: args.reps for k in REPS}))
    out = dict(records={}, agreement={})
    for name in PROGRAMS:
        out["records"][name] = measure(programs, name, cfgs[name], world,
                                       reps[name])
        if checks:
            res = check(programs, name, cfgs[name], checks, args.dir,
                        args.rank)
            if res is not None:
                out["agreement"][name] = res
    if dev.type == "cuda" and args.rank == 0:
        out["kernels"] = [mppi_kernel_row(cfgs["mppi"], dev, world,
                                          out["records"]["mppi"]["launches"])]
    common.leave(args, dict(out, backend=dist.get_backend(),
                            **common.host_record()))


def mppi_kernel_row(cfg, dev, n, launches):
    """K1's ``kernels``-line row at the per-rank rollout shape (K / n x2)."""
    import torch
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import MPPIConfig, mppi
    from torch_multiprocess_scaling import rollout_row
    m, _ = go1_trot(dev)
    mcfg = MPPIConfig(**cfg)
    normals = torch.randn((mcfg.num_samples, mcfg.horizon, m.nu), generator=
                          torch.Generator().manual_seed(NORMALS_SEED)).to(dev)
    return rollout_row(m, mcfg, n, make_state(m, "home"),
                       mppi.init_state(m, mcfg), normals, launches,
                       "comm-volume mppi")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="the mesh (default: the cards present; on the CPU 2)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (for the CPU)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed solves or chunks per program (default: "
                         f"{REPS})")
    ap.add_argument("--out", default="runs/torch_comm_volume")
    common.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    start = time.perf_counter()
    dev, line = common.prepare(args.device)
    n = args.ranks or common.card_count(dev) or 2
    child = []
    for flag, value in (("--smoke", args.smoke), ("--reps", args.reps),
                        ("--device", args.device)):
        if value is True:
            child.append(flag)
        elif value not in (None, False):
            child += [flag, str(value)]
    ranks = common.spawn(os.path.abspath(__file__), n, child, TIMEOUT_S)
    r0 = ranks[0]
    res = dict(methodology=dict(note=NOTE, ranks=n, smoke=args.smoke),
               device=line, backend=r0["backend"], host_cores=os.cpu_count(),
               rank_affinity=[x["affinity"] for x in ranks])
    for name in PROGRAMS:
        res[SECTION[name]] = r0["records"][name]
    res["agreement"] = r0["agreement"]
    res["kernels"] = r0.get("kernels", [])
    res["ok"] = all(c["ok"] for per in r0["agreement"].values()
                    for c in per.values())
    res["seconds"] = time.perf_counter() - start
    common.write_metrics(os.path.join(args.out, "metrics.json"), res)
    if not res["ok"]:
        raise SystemExit("torch_comm_volume: an agreement check failed: "
                         + str(r0["agreement"]))


if __name__ == "__main__":
    main()
