#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opendog_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no "ok" line):
  device   - a CUDA card must be present; prints its name and power limit;
  build    - builds the substep kernels (csrc/, one nvcc call: the six
             entry points flat, payload, plane, pergeom, plane_payload and
             pergeom_payload, all one warp per rollout, and the batch's
             plane_payload kernel for models of at most 32 spheres) for
             sm_90a and prints the ptxas report of each and, for each entry
             point at its paths' model, the rollouts and dynamic shared
             memory per block and the blocks and warps resident per SM;
  check    - every kernel against its plain PyTorch version on the card at
             every shape its paths launch: flat on random Go1 states (MPPI
             rollout K=256 x 2 substeps of 10 ms; plant K=1 x 10 of 2 ms);
             payload on random Go1 states with payloads U(0, 3) kg (K=256
             x 2); plane on random OpenDOG states with random planes (K=256
             x 2); pergeom on random OpenDOG states on the generated terrain
             with their own per-geom planes (K=256 x 2, K=1 x 10);
             plane_payload on the domain-randomised batch (K=4096 x 10);
             pergeom_payload on the terrain states with payloads U(0, 3) kg
             (K=256 x 2); and, check only, all six at a ragged K=257 x 2
             (the last block of the kernels part full);
  main     - the Go1 flat-ground MPPI trot loop of bench.py (K=256, H=25,
             2 x 10 ms substeps, plant 10 x 2 ms per 50 Hz tick) through
             make_mpc: the tick captured in a CUDA graph (graph_tick) must
             equal the eager tick bit for bit on the same injected normals
             for 4 ticks (ctrl, qpos, qvel, nominal); then 250 ticks eager
             and 250 replayed, each from generator seed 0: trunk in (0.12,
             0.5) m, finite, forward more than 0.5 m, 25 + 1 flat launches
             per tick (counted per replay on the graph), ms/tick of both
             side by side;
  terrain  - OpenDOG terrain MPC with per-geom planes on both sides (bench
             2c_pergeom: K=256, H=25, 2 x 10 ms, sigma 0.08; per-geom
             kernel plant) on a generated terrain, eager and graph as in
             main, 100 ticks each: finite, trunk above the ground under it
             in (0.03, 0.21) m at every tick and in (0.03, 0.15) m once the
             drop from the keyframe is over, 25 + 1 pergeom launches per
             tick;
  terrain-trunk - the same with one trunk plane for the rollouts, 50 ticks,
             25 plane + 1 pergeom launches per tick;
  payload  - payload-aware trot MPPI (bench 2d): 0 kg equals the flat
             solver to 1e-6, 1.5 kg changes best_cost; the solve captured
             in a CUDA graph (graph_solve) equals the eager solve bit for
             bit on injected normals (ctrl, nominal, stats); 100 solves
             with 1.5 kg eager and 100 replayed: finite, 25 payload
             launches per solve;
  batch    - 20 steps of the K=4096 domain-randomised plane + payload batch
             (bench 4c): finite;
  pergeom-payload - per-geom terrain solves of OpenDOG standing on the
             generated terrain with 0.5 kg: 0 kg equals the per-geom solver
             to 1e-6, 0.5 kg changes best_cost; graph vs eager as in
             payload; 10 solves each: finite, 25 pergeom_payload launches
             per solve;
  realtime - bench.py:104-156 on the port: 50 graph ticks with a blocking
             copy of the control (the blocking reference), lag = min(5,
             max(1, ceil(median / 20 ms) + 1)), then RealtimeController in
             benchmark mode primed lag + 3 ticks and paced at 20 ms for 250
             ticks; prints bench.py's host-loop fields (p99 / median / max
             / mean host-blocking ms, meets_50hz_budget, overruns, control
             delay, blocking p99 and median); every control finite and in
             ctrlrange, the internal plant's trunk z in (0.12, 0.5) m and
             forward more than 0.5 m, 25 + 1 flat launches per replay;
  bridge   - RealtimeController in bridge mode with delay compensation at
             that lag, 250 ticks paced at 20 ms against a stand-in robot
             (the flat plant step on the card, read to the host before
             each tick, applying each returned control): the same fields
             and gates, 25 rollout + lag + 1 plant launches per tick;
  profile  - torch.profiler over 10 ticks of the flat and terrain loops,
             eager and graph;
  timing   - CUDA-event times of every kernel at each of its path shapes,
             beside its plain version and its bound.
The last lines are the card's name and power limit, one JSON object of
kernel records, and {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

TICKS = 250            # flat trot loop
TERRAIN_TICKS = 100    # per-geom terrain MPC
TRUNK_TICKS = 50       # trunk-plane terrain MPC
PAYLOAD_SOLVES = 100
PERGEOM_PAYLOAD_SOLVES = 10
PERGEOM_PAYLOAD_KG = 0.5
BATCH_STEPS = 20
EQ_STEPS = 4           # graph vs eager calls on the same normals, per path
SYNC_TICKS = 50        # [realtime] blocking reference ticks (bench.py's n2)
RT_TICKS = 250         # [realtime] paced ticks (bench.py's n)
TICK_S = 0.02          # the 50 Hz tick period
# a control is the softmax-weighted mean of plans clipped into ctrlrange;
# float32 rounding of that mean may put it an ulp or so outside
RANGE_TOL = 1e-6
TERRAIN_SEED = 0       # torch.Generator seed on the CPU: not a flat episode
DROP_TICKS = 25        # the keyframe's 0.13 m drop to standing is over by then
# trunk height above the ground under it on the terrain paths: OpenDOG
# stands at 0.069 m; the keyframe starts it at 0.2 m, so the band admits
# 0.21 m until the drop is over
DROP_BAND = (0.03, 0.21)
STAND_BAND = (0.03, 0.15)
MIN_FINAL_X = 0.5      # m trotted forward by the flat loop
CHECK_TOL = {"qpos": 1e-4, "qvel": 1e-3}  # kernel vs plain, max abs error
# the substep of the kernels' design; the entry points are in
# substep_kernel.cu
SOURCE = "opendog_tpu_torch/csrc/substep_warp.cuh"
PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROLLOUT = dict(K=256, dt=0.01, n=2)
RAGGED = dict(K=257, dt=0.01, n=2)  # one rollout past the MPPI paths' K
PLANT = dict(K=1, dt=0.002, n=10)
BATCH = dict(K=4096, dt=0.002, n=10)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_batch(model, K, seed=1, on_ground=False):
    """Random states around the home keyframe, as the JAX package's
    tests/test_pallas_core.py::_random_batch builds them: (rows, K).  With
    ``on_ground`` the keyframe is first lowered until its lowest collision
    sphere touches z = 0 (OpenDOG's keyframe holds the trunk at 0.2 m,
    13 cm above where it stands)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.numpy("key_qpos")[0], (K, 1)).astype(np.float32)
    if on_ground:
        qpos[:, 2] -= home_clearance(model)
    qpos[:, :3] += rng.normal(0, 0.01, (K, 3))
    qpos[:, 7:] += rng.normal(0, 0.05, (K, model.nq - 7))
    qvel = rng.normal(0, 0.2, (K, model.nv)).astype(np.float32)
    lo, hi = model.numpy("actuator_ctrlrange").T
    ctrl = rng.uniform(lo, hi, (K, model.nu)).astype(np.float32)
    return tuple(np.ascontiguousarray(a.T) for a in (qpos, qvel, ctrl))


def home_clearance(model):
    """Height of the home keyframe's lowest collision sphere above z = 0."""
    import torch
    from opendog_tpu_torch.physics import dynamics, spatial
    m = model.to("cpu")
    xpos, xquat = dynamics.fk(m, m.key_qpos[0])
    R = spatial.quat_to_mat(xquat)
    gb = m.geom_body.long()
    z = xpos[gb, 2] + torch.einsum("gj,gj->g", R[gb, 2, :], m.geom_pos)
    return float((z - m.geom_radius).min())


def random_modes(model, K, with_plane=False, with_payload=False, seed=1):
    """Random inputs of the plane and payload modes, numpy (rows, K) or
    None: planes {n.x = d} near z = 0, tilted as in the JAX package's
    domain-randomised batch (scripts/bench_suite.py:449-454: tilt
    ~N(0, 0.04)) with offsets ~N(0, 0.01), one per rollout (4, K) or one
    per geom and rollout (4 * ngeom, K); payloads U(0, 3) kg (1, K)."""
    rng = np.random.default_rng(seed + 100)
    plane = payload = None
    if with_plane:
        n_planes = model.ngeom if with_plane == "per_geom" else 1
        tilt = rng.normal(0, 0.04, (2, n_planes, K))
        nz = np.sqrt(1.0 - np.clip(tilt[0] ** 2 + tilt[1] ** 2, 0, 0.5))
        d = rng.normal(0, 0.01, (n_planes, K))
        plane = np.stack([tilt[0], tilt[1], nz, d], axis=1)  # (n, 4, K)
        plane = plane.reshape(4 * n_planes, K).astype(np.float32)
    if with_payload:
        payload = rng.uniform(0.0, 3.0, (1, K)).astype(np.float32)
    return plane, payload


def event_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps calls, timed with CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def terrain_batch(model, terrain, K, seed=2):
    """Random OpenDOG states on the ground of ``terrain`` (random_batch on
    the ground, spread over +-1.5 m in x and y, lifted by the terrain
    height under the trunk) and their own per-geom planes: numpy
    (qpos, qvel, ctrl, plane (4 * ngeom, K))."""
    import torch
    from opendog_tpu_torch.physics import dynamics
    qpos, qvel, ctrl = random_batch(model, K, seed, on_ground=True)
    rng = np.random.default_rng(seed + 200)
    qpos[:2] += rng.uniform(-1.5, 1.5, (2, K)).astype(np.float32)
    m = model.to("cpu")
    t = terrain.to("cpu")
    h, _ = dynamics._terrain_height_normal(m, t, torch.from_numpy(qpos[:2].T))
    qpos[2] += h.numpy()
    planes = dynamics.geom_local_planes(m, t, torch.from_numpy(qpos.T.copy()))
    plane = planes.reshape(K, -1).T.contiguous().numpy()
    return qpos, qvel, ctrl, plane


def batch_inputs(model, K):
    """The domain-randomised batch of scripts/bench_suite.py (configs
    4c/4d): OpenDOG home states with 0.02 noise at rest, home controls, one
    plane per scenario (tilt ~N(0, 0.04), offset ~N(0, 0.03)) and a payload
    U(0, 0.5) kg, from numpy seed 0: numpy (rows, K)."""
    rng = np.random.default_rng(0)
    qp = np.tile(model.numpy("key_qpos")[0][:, None], (1, K))
    qp = (qp + 0.02 * rng.standard_normal(qp.shape)).astype(np.float32)
    qv = np.zeros((model.nv, K), np.float32)
    ct = np.tile(model.numpy("key_ctrl")[0][:, None], (1, K)).astype(
        np.float32)
    tilt = rng.normal(0, 0.04, (2, K))
    nz = np.sqrt(1.0 - np.clip(tilt[0] ** 2 + tilt[1] ** 2, 0, 0.5))
    plane = np.stack([tilt[0], tilt[1], nz,
                      rng.normal(0, 0.03, K)]).astype(np.float32)
    payload = rng.uniform(0.0, 0.5, (1, K)).astype(np.float32)
    return qp, qv, ct, plane, payload


class Smoke:
    """The phases of the run; ``records`` collects one entry per kernel and
    path shape for the JSON line."""

    def __init__(self, torch, dev):
        from opendog_tpu_torch.assets import load_go1, load_opendog
        from opendog_tpu_torch.ops import cuda_step
        from opendog_tpu_torch.physics import terrain as terrain_lib
        self.torch, self.dev, self.cs = torch, dev, cuda_step
        self.go1 = load_go1("flat", device=dev)
        self.dog = load_opendog("flat", device=dev)
        self.dog_t = load_opendog("terrain", device=dev)
        # generated on the CPU from a seed, so that every card gets it
        self.terrain = terrain_lib.generate_terrain(
            self.dog_t, torch.Generator().manual_seed(TERRAIN_SEED))
        self.records = {}
        self.pairs = {}  # eager and graph ms per path, for the summary

    # -- check ------------------------------------------------------------
    def check(self, label, model, shape, with_plane, with_payload, arrays,
              keep=True):
        """Kernel vs plain on ``arrays`` (numpy (rows, K): qpos, qvel, ctrl,
        plane or None, payload or None); keeps the record for timing unless
        ``keep`` is False (a shape that no path launches)."""
        torch, cs = self.torch, self.cs
        args = [None if a is None else
                torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                for a in arrays]
        kern = cs.build_cuda_substep(model, shape["dt"], shape["n"],
                                     device=self.dev, with_plane=with_plane,
                                     with_payload=with_payload)
        plain = cs.build_plain_substep(model, shape["dt"], shape["n"],
                                       with_plane, with_payload)
        kp, kv = kern(*args)
        pp, pv = plain(*args)
        torch.cuda.synchronize()
        err = {"qpos": (kp - pp).abs().max().item(),
               "qvel": (kv - pv).abs().max().item()}
        if not (torch.isfinite(kp).all() and torch.isfinite(kv).all()):
            raise RuntimeError(f"[check] {label}: kernel output not finite")
        # conditioning of these inputs: the plain version's own change when
        # qvel moves by 1e-7 relative (a few float32 ulps)
        _, pv2 = plain(args[0], args[1] * (1 + 1e-7), *args[2:])
        spread = (pv2 - pv).abs().max(dim=0).values
        K = shape["K"]
        log(f"[check] {label} K={K} x{shape['n']} dt={shape['dt']}: "
            f"max abs err qpos {err['qpos']:.3e} qvel {err['qvel']:.3e} "
            f"(tolerance {CHECK_TOL['qpos']:.0e} / {CHECK_TOL['qvel']:.0e}; "
            f"max |qvel| {pv.abs().max().item():.3f}; plain qvel moves by "
            f"up to {spread.max().item():.3e} under a 1e-7 relative change "
            f"of qvel, by > 1e-4 in {int((spread > 1e-4).sum())} of {K} "
            f"rollouts)")
        for k in err:
            if not err[k] <= CHECK_TOL[k]:
                raise RuntimeError(f"[check] {label}: kernel disagrees with "
                                   f"its plain version on {k}: {err[k]}")
        if not keep:
            return
        self.records[label] = dict(
            model=model, shape=shape, err=max(err.values()), args=args,
            kern=kern, plain=plain, launches=0, name=kern.name,
            key=cs.launch_key(K, shape["n"], with_plane, with_payload),
            modes=(with_plane, with_payload))

    def check_all(self):
        go1, dog, dog_t = self.go1, self.dog, self.dog_t
        none = (None, None)
        self.check("flat rollout", go1, ROLLOUT, False, False,
                   random_batch(go1, ROLLOUT["K"]) + none)
        self.check("flat plant", go1, PLANT, False, False,
                   random_batch(go1, PLANT["K"]) + none)
        K = ROLLOUT["K"]
        self.check("payload rollout", go1, ROLLOUT, False, True,
                   random_batch(go1, K) + random_modes(go1, K, False, True))
        self.check("plane rollout", dog_t, ROLLOUT, True, False,
                   random_batch(dog_t, K, on_ground=True)
                   + random_modes(dog_t, K, True))
        self.check("pergeom rollout", dog_t, ROLLOUT, "per_geom", False,
                   terrain_batch(dog_t, self.terrain, K) + (None,))
        self.check("pergeom plant", dog_t, PLANT, "per_geom", False,
                   terrain_batch(dog_t, self.terrain, PLANT["K"]) + (None,))
        self.check("plane_payload batch", dog, BATCH, True, True,
                   batch_inputs(dog, BATCH["K"]))
        self.check("pergeom_payload rollout", dog_t, ROLLOUT, "per_geom",
                   True, terrain_batch(dog_t, self.terrain, K)
                   + random_modes(dog_t, K, False, True)[1:])
        Kr = RAGGED["K"]
        self.check("flat ragged", go1, RAGGED, False, False,
                   random_batch(go1, Kr) + none, keep=False)
        self.check("payload ragged", go1, RAGGED, False, True,
                   random_batch(go1, Kr) + random_modes(go1, Kr, False, True),
                   keep=False)
        self.check("plane ragged", dog_t, RAGGED, True, False,
                   random_batch(dog_t, Kr, on_ground=True)
                   + random_modes(dog_t, Kr, True), keep=False)
        self.check("pergeom ragged", dog_t, RAGGED, "per_geom", False,
                   terrain_batch(dog_t, self.terrain, Kr) + (None,),
                   keep=False)
        self.check("plane_payload ragged", dog, RAGGED, True, True,
                   batch_inputs(dog, Kr), keep=False)
        self.check("pergeom_payload ragged", dog_t, RAGGED, "per_geom", True,
                   terrain_batch(dog_t, self.terrain, Kr)
                   + random_modes(dog_t, Kr, False, True)[1:], keep=False)

    # -- paths ------------------------------------------------------------
    def counted(self, label, run, want):
        """Runs ``run()`` with every launch count set to 0 just before and
        read just after; the counts must equal ``want`` exactly."""
        cs = self.cs
        cs.LAUNCHES.clear()
        out = run()
        self.torch.cuda.synchronize()
        launches = dict(cs.LAUNCHES)
        log(f"[{label}] kernel launches: {launches}")
        if launches != want:
            raise RuntimeError(f"[{label}] kernel launches {launches} != "
                               f"{want}")
        for rec in self.records.values():
            rec["launches"] += launches.get(rec["key"], 0)
        return out

    def graph_matches(self, label, step, gstep, first, n=None):
        """The graphed step against the eager one on the same injected
        normals for EQ_STEPS calls, each side from ``first``: ``step(prev,
        normals)`` returns (next, outputs), where outputs is a dict of
        tensors; every output must be equal bit for bit."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(11)
        e = g = first
        differ, keys = {}, set()
        for _ in range(EQ_STEPS):
            normals = torch.randn(n, device=self.dev, generator=gen)
            e, oe = step(e, normals)
            g, og = gstep(g, normals)
            for k, a in oe.items():
                keys.add(k)
                if not torch.equal(a, og[k]):
                    d = (a - og[k]).abs().nan_to_num(nan=float("inf"))
                    differ[k] = max(differ.get(k, 0.0), d.max().item())
        torch.cuda.synchronize()
        verdict = (f"DIFFER, max abs {differ}" if differ
                   else "equal bit for bit")
        log(f"[{label}] graph vs eager over {EQ_STEPS} calls on the same "
            f"normals: {', '.join(sorted(keys))} {verdict}")
        if differ:
            raise RuntimeError(f"[{label}] the graph differs from the eager "
                               f"path: max abs {differ}")

    def tick_pair(self, label, tick, init, s0, cfg, nu, run_loop, want):
        """The eager tick and its CUDA graph (captured from the loop's first
        carry): bit for bit on injected normals, then ``run_loop`` on each
        from the same generator seed, with the launches counted per replay.
        Returns {side: (wall, loop result, last carry)} and the graphed
        tick."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.solvers import graph_tick
        n = (cfg.num_samples, cfg.horizon, nu)
        first = init(torch.Generator(device=dev).manual_seed(0), s0)
        t0 = time.perf_counter()
        gtick = graph_tick(tick, first, torch.zeros(n, device=dev))
        torch.cuda.synchronize()
        log(f"[{label}] captured the tick in {time.perf_counter() - t0:.3f} "
            f"s: {sum(gtick.graph.launches.values())} substep launches per "
            f"replay {dict(gtick.graph.launches)}")
        def step(fn):
            def call(carry, normals):
                carry, out = fn(carry, normals)
                return carry, dict(ctrl=out["ctrl"], qpos=out["qpos"],
                                   qvel=out["qvel"],
                                   nominal=carry.solver.nominal)
            return call

        self.graph_matches(label, step(tick), step(gtick), first, n)
        out = {}
        for side, fn in (("eager", tick), ("graph", gtick)):
            carry = init(torch.Generator(device=dev).manual_seed(0), s0)
            out[side] = self.counted(f"{label} {side}",
                                     lambda: run_loop(fn, carry), want)
        return out, gtick

    def flat_loop(self):
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
        model = self.go1
        params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                      target_height=0.265)
        cost = costs.trot_cost(model, params, model.key_qpos[0, 7:],
                               legs="go1")
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.12, temperature=0.3)
        init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                                 device=dev)
        warm = init(torch.Generator(device=dev).manual_seed(1),
                    make_state(model, "home"))
        for _ in range(3):
            warm, _ = tick(warm)
        torch.cuda.synchronize()

        def run(fn, carry):
            zs, finite = [], []
            t0 = time.perf_counter()
            for _ in range(TICKS):
                carry, out = fn(carry)
                zs.append(out["qpos"][2].clone())
                finite.append(torch.isfinite(out["qpos"]).all()
                              & torch.isfinite(out["qvel"]).all())
            torch.cuda.synchronize()
            return time.perf_counter() - t0, zs, finite, out, carry

        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]): cfg.horizon * TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): TICKS}
        res, gtick = self.tick_pair("main", tick, init,
                                    make_state(model, "home"), cfg, model.nu,
                                    run, want)
        for side, (wall, zs, finite, out, carry) in res.items():
            z = torch.stack(zs).cpu().numpy()
            all_finite = bool(torch.stack(finite).all().item())
            final_x = float(carry.plant.qpos[0].item())
            log(f"[main] {side}: {TICKS} ticks in {wall:.3f} s: "
                f"{1e3 * wall / TICKS:.3f} ms/tick, {TICKS / wall:.2f} "
                f"solves/s | final_x {final_x:.3f} m | trunk z min "
                f"{z.min():.4f} max {z.max():.4f} | finite {all_finite} | "
                f"best_cost {float(out['best_cost']):.3f} ess "
                f"{float(out['ess']):.2f}")
            if not ((z > 0.12) & (z < 0.5)).all():
                raise RuntimeError(f"[main] {side}: trunk height left "
                                   "(0.12, 0.5) m")
            if not all_finite:
                raise RuntimeError(f"[main] {side}: non-finite plant state")
            if not final_x > MIN_FINAL_X:
                raise RuntimeError(f"[main] {side}: final_x {final_x:.3f} m "
                                   f"<= {MIN_FINAL_X} m")
        self.log_pair("main", res, TICKS, "tick")
        same = torch.equal(res["eager"][4].plant.qpos,
                           res["graph"][4].plant.qpos)
        log(f"[main] the graph loop, drawing its normals from the same "
            f"generator seed, ends on the eager loop's plant state: {same}")
        if not same:
            raise RuntimeError("[main] the graph loop drew other normals "
                               "than the eager loop")
        carry = init(torch.Generator(device=dev).manual_seed(0),
                     make_state(model, "home"))
        return dict(tick=tick, gtick=gtick, carry=carry, model=model,
                    cost=cost, cfg=cfg)

    def log_pair(self, label, res, n, unit):
        """Eager and graph ms per tick or solve, side by side."""
        e, g = (1e3 * res[side][0] / n for side in ("eager", "graph"))
        log(f"[{label}] ms/{unit}: eager {e:.3f}, graph {g:.3f} ({e / g:.2f}x"
            f", same call, {n} {unit}s each)")
        self.pairs[label] = dict(eager_ms=e, graph_ms=g, n=n, unit=unit)

    def terrain_loop(self, label, plane_mode, ticks):
        """OpenDOG standing MPC on the generated terrain, kernel plant."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import dynamics, make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
        model, terr = self.dog_t, self.terrain
        span = float(terr.height.max() - terr.height.min())
        h0 = float(dynamics._terrain_height_normal(
            model, terr, torch.zeros(1, 2, device=dev))[0][0])
        log(f"[{label}] terrain seed {TERRAIN_SEED}: heights span "
            f"{span:.4f} m, ground under the start {h0:.4f} m")
        if not span > 0.05:
            raise RuntimeError(f"[{label}] the terrain is flat")
        cost = costs.standing_cost(model, 0.0694 + h0, model.key_qpos[0, 7:])
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.08, temperature=0.3)
        init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                                 device=dev, terrain=terr,
                                 terrain_plant="kernel",
                                 plane_mode=plane_mode)
        s0 = make_state(model, "home")
        s0.qpos[2] += h0  # the bench's +0.151 on a flat episode
        warm = init(torch.Generator(device=dev).manual_seed(1), s0)
        for _ in range(3):
            warm, _ = tick(warm)
        torch.cuda.synchronize()

        def run(fn, carry):
            qs = []
            t0 = time.perf_counter()
            for _ in range(ticks):
                carry, out = fn(carry)
                qs.append(torch.cat([out["qpos"], out["qvel"]]))
            torch.cuda.synchronize()
            return time.perf_counter() - t0, torch.stack(qs), carry

        rollout_mode = "per_geom" if plane_mode == "per_geom" else True
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"], rollout_mode):
                cfg.horizon * ticks,
                cs.launch_key(PLANT["K"], PLANT["n"], "per_geom"): ticks}
        res, gtick = self.tick_pair(label, tick, init, s0, cfg, model.nu,
                                    run, want)
        for side, (wall, qs, _) in res.items():
            qpos = qs[:, :model.nq]
            ground, _ = dynamics._terrain_height_normal(model, terr,
                                                        qpos[:, :2])
            clear = (qpos[:, 2] - ground).cpu().numpy()
            finite = bool(torch.isfinite(qs).all().item())
            settled = clear[DROP_TICKS:]
            log(f"[{label}] {side}: {ticks} ticks in {wall:.3f} s: "
                f"{1e3 * wall / ticks:.3f} ms/tick | trunk above ground: min "
                f"{clear.min():.4f} max {clear.max():.4f}, from tick "
                f"{DROP_TICKS} min {settled.min():.4f} max "
                f"{settled.max():.4f}, last {clear[-1]:.4f} | xy drift "
                f"{float(qpos[-1, :2].norm()):.4f} m | finite {finite}")
            if not finite:
                raise RuntimeError(f"[{label}] {side}: non-finite plant "
                                   "state")
            lo, hi = DROP_BAND
            if not ((clear > lo) & (clear < hi)).all():
                raise RuntimeError(f"[{label}] {side}: trunk left "
                                   f"{DROP_BAND} m above the ground")
            lo, hi = STAND_BAND
            if not ((settled > lo) & (settled < hi)).all():
                raise RuntimeError(f"[{label}] {side}: trunk left "
                                   f"{STAND_BAND} m above the ground after "
                                   f"tick {DROP_TICKS}")
        self.log_pair(label, res, ticks, "tick")
        carry = init(torch.Generator(device=dev).manual_seed(0), s0)
        return dict(tick=tick, gtick=gtick, carry=carry)

    def solve_pair(self, label, pay, st, ms0, payload, cfg, n_solves, want):
        """A payload solver and its CUDA graph: bit for bit on injected
        normals, then ``n_solves`` solves on each from the same generator
        seed with the launches counted per replay; the solve outputs must
        be finite."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.solvers import graph_solve
        n = (cfg.num_samples,) + tuple(ms0.nominal.shape)
        t0 = time.perf_counter()
        gsolve = graph_solve(pay, st, ms0, torch.zeros(n, device=dev),
                             payload)
        torch.cuda.synchronize()
        log(f"[{label}] captured the solve in "
            f"{time.perf_counter() - t0:.3f} s: launches per replay "
            f"{dict(gsolve.graph.launches)}")

        def step(fn):
            def call(ms, normals):
                ctrl, ms, stats = fn(st, ms, None, normals, payload)
                return ms, dict(ctrl=ctrl, nominal=ms.nominal, **stats)
            return call

        self.graph_matches(label, step(pay), step(gsolve), ms0, n)
        res = {}
        for side, fn in (("eager", pay), ("graph", gsolve)):
            gen = torch.Generator(device=dev).manual_seed(0)

            def run():
                ms, ctrls = ms0, []
                t0 = time.perf_counter()
                for _ in range(n_solves):
                    ctrl, ms, stats = fn(st, ms, gen, None, payload)
                    ctrls.append(ctrl.clone())
                torch.cuda.synchronize()
                return time.perf_counter() - t0, torch.stack(ctrls), stats

            res[side] = self.counted(f"{label} {side}", run, want)
            wall, ctrls, stats = res[side]
            finite = bool(torch.isfinite(ctrls).all().item()) and all(
                bool(torch.isfinite(v).all().item()) for v in stats.values())
            log(f"[{label}] {side}: {n_solves} solves with {payload} kg in "
                f"{wall:.3f} s: {1e3 * wall / n_solves:.3f} ms/solve | "
                f"best_cost {float(stats['best_cost']):.4f} | finite {finite}")
            if not finite:
                raise RuntimeError(f"[{label}] {side}: non-finite solve "
                                   "output")
        self.log_pair(label, res, n_solves, "solve")

    def payload_solves(self):
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
        model = self.go1
        params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                      target_height=0.265)
        cost = costs.trot_cost(model, params, model.key_qpos[0, 7:],
                               legs="go1")
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.12, temperature=0.3)
        flat = mppi.make_solver(model, cost, cfg, device=dev)
        pay = mppi.make_solver(model, cost, cfg, device=dev,
                               with_payload=True)
        st, ms0 = make_state(model, "home"), mppi.init_state(model, cfg)
        normals = torch.randn(
            (cfg.num_samples, cfg.horizon, model.nu), device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
        c_f, m_f, s_f = flat(st, ms0, None, normals)
        c_0, m_0, s_0 = pay(st, ms0, None, normals, 0.0)
        c_h, _, s_h = pay(st, ms0, None, normals, 1.5)
        d0 = max((c_0 - c_f).abs().max().item(),
                 (m_0.nominal - m_f.nominal).abs().max().item(),
                 abs(float(s_0["best_cost"]) - float(s_f["best_cost"])))
        dh = abs(float(s_h["best_cost"]) - float(s_0["best_cost"]))
        log(f"[payload] 0 kg vs the flat solver: max abs difference {d0:.3e} "
            f"(tolerance 1e-6); 1.5 kg moves best_cost by {dh:.4f} "
            f"({float(s_0['best_cost']):.4f} -> {float(s_h['best_cost']):.4f})")
        if not d0 <= 1e-6:
            raise RuntimeError(f"[payload] 0 kg differs from the flat "
                               f"solver by {d0}")
        if not dh > 1e-3:
            raise RuntimeError("[payload] 1.5 kg does not change best_cost")
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"], False, True):
                cfg.horizon * PAYLOAD_SOLVES}
        self.solve_pair("payload", pay, st, ms0, 1.5, cfg, PAYLOAD_SOLVES,
                        want)

    def pergeom_payload_solves(self):
        """Per-geom terrain MPPI of OpenDOG standing on the generated
        terrain, carrying a payload."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import dynamics, make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
        model, terr = self.dog_t, self.terrain
        h0 = float(dynamics._terrain_height_normal(
            model, terr, torch.zeros(1, 2, device=dev))[0][0])
        cost = costs.standing_cost(model, 0.0694 + h0, model.key_qpos[0, 7:])
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.08, temperature=0.3)
        pg = mppi.make_solver(model, cost, cfg, device=dev, terrain=terr,
                              plane_mode="per_geom")
        pay = mppi.make_solver(model, cost, cfg, device=dev, terrain=terr,
                               plane_mode="per_geom", with_payload=True)
        st = make_state(model, "home")
        st.qpos[2] += h0 + 0.0694 - float(model.key_qpos[0, 2])  # standing
        ms0 = mppi.init_state(model, cfg)
        normals = torch.randn(
            (cfg.num_samples, cfg.horizon, model.nu), device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
        c_f, m_f, s_f = pg(st, ms0, None, normals)
        c_0, m_0, s_0 = pay(st, ms0, None, normals, 0.0)
        c_h, _, s_h = pay(st, ms0, None, normals, PERGEOM_PAYLOAD_KG)
        d0 = max((c_0 - c_f).abs().max().item(),
                 (m_0.nominal - m_f.nominal).abs().max().item(),
                 abs(float(s_0["best_cost"]) - float(s_f["best_cost"])))
        dh = abs(float(s_h["best_cost"]) - float(s_0["best_cost"]))
        log(f"[pergeom-payload] 0 kg vs the per-geom solver: max abs "
            f"difference {d0:.3e} (tolerance 1e-6); {PERGEOM_PAYLOAD_KG} kg "
            f"moves best_cost by {dh:.4f} ({float(s_0['best_cost']):.4f} -> "
            f"{float(s_h['best_cost']):.4f})")
        if not d0 <= 1e-6:
            raise RuntimeError(f"[pergeom-payload] 0 kg differs from the "
                               f"per-geom solver by {d0}")
        if not dh > 1e-6:
            raise RuntimeError("[pergeom-payload] the payload does not "
                               "change best_cost")
        want = {cs.launch_key(cfg.num_samples, cfg.n_substeps, "per_geom",
                              True): cfg.horizon * PERGEOM_PAYLOAD_SOLVES}
        self.solve_pair("pergeom-payload", pay, st, ms0, PERGEOM_PAYLOAD_KG,
                        cfg, PERGEOM_PAYLOAD_SOLVES, want)

    def realtime(self, flat):
        """bench.py:104-156 on the port: the blocking reference (the graphed
        tick plus a blocking copy of its control), the pipeline depth from
        its median, then RealtimeController in benchmark mode paced at
        50 Hz; the host-blocking time of each tick."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import RealtimeController
        model, cfg, gtick, carry = (flat[k] for k in ("model", "cfg", "gtick",
                                                      "carry"))
        lat_sync = np.zeros(SYNC_TICKS)
        for i in range(SYNC_TICKS):
            t0 = time.perf_counter()
            carry, out = gtick(carry)
            out["ctrl"].cpu()
            lat_sync[i] = time.perf_counter() - t0
        sync_p99 = float(np.percentile(lat_sync, 99) * 1e3)
        sync_median = float(np.median(lat_sync) * 1e3)
        lag = int(min(5, max(1, np.ceil(sync_median / (TICK_S * 1e3)) + 1)))
        log(f"[realtime] blocking reference over {SYNC_TICKS} graph ticks: "
            f"median {sync_median:.3f} ms, p99 {sync_p99:.3f} ms -> lag {lag}")
        rtc = RealtimeController(model, flat["cost"], cfg, lag=lag,
                                 plant_substeps=10, device=dev,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(0))
        t0 = time.perf_counter()
        rtc.start(make_state(model, "home"))
        torch.cuda.synchronize()
        log(f"[realtime] start() captured the tick in "
            f"{time.perf_counter() - t0:.3f} s")
        rtc.tick()
        for _ in range(lag + 3):  # prime the pipeline at pace
            time.sleep(TICK_S)
            rtc.tick()

        def run():
            lat = np.zeros(RT_TICKS)
            ctrls, overruns = [], 0
            next_t = time.perf_counter()
            for i in range(RT_TICKS):
                next_t += TICK_S
                t0 = time.perf_counter()
                ctrl = rtc.tick()
                lat[i] = time.perf_counter() - t0
                ctrls.append(ctrl)
                rest = next_t - time.perf_counter()
                if rest > 0:
                    time.sleep(rest)
                else:
                    overruns += 1
                    next_t = time.perf_counter()
            return lat, np.array(ctrls), overruns

        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]):
                cfg.horizon * RT_TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): RT_TICKS}
        lat, ctrls, overruns = self.counted("realtime", run, want)
        rtc.drain()
        qpos = rtc.plant.qpos.cpu().numpy()
        fields = dict(loop_fields(lat, overruns, lag),
                      host_loop_sync_p99_ms=sync_p99,
                      host_loop_sync_median_ms=sync_median)
        self.check_loop("realtime", model, ctrls, qpos, fields)
        return fields

    def check_loop(self, label, model, ctrls, qpos, fields):
        """Prints a paced loop's fields and gates its controls and plant:
        finite, in ctrlrange to RANGE_TOL, trunk z in (0.12, 0.5) m,
        forward more than MIN_FINAL_X."""
        fields.update(plant_z=float(qpos[2]), final_x=float(qpos[0]))
        log(f"[{label}] {len(ctrls)} ticks paced at {TICK_S * 1e3:.0f} ms: "
            + json.dumps(fields))
        rng = model.numpy("actuator_ctrlrange")
        if not (ctrls.shape == (len(ctrls), model.nu)
                and np.isfinite(ctrls).all()):
            raise RuntimeError(f"[{label}] a control is not finite")
        out_of_range = float(np.maximum(np.maximum(rng[:, 0] - ctrls,
                                                   ctrls - rng[:, 1]),
                                        0).max())
        log(f"[{label}] controls leave ctrlrange by at most "
            f"{out_of_range:.3e} (tolerance {RANGE_TOL:.0e})")
        if not out_of_range <= RANGE_TOL:
            raise RuntimeError(f"[{label}] a control left ctrlrange")
        if not 0.12 < qpos[2] < 0.5:
            raise RuntimeError(f"[{label}] trunk z {qpos[2]:.4f} m left "
                               "(0.12, 0.5)")
        if not qpos[0] > MIN_FINAL_X:
            raise RuntimeError(f"[{label}] final_x {qpos[0]:.3f} m <= "
                               f"{MIN_FINAL_X} m")

    def bridge(self, flat, lag):
        """RealtimeController in bridge mode with delay compensation at
        ``lag``, paced at 50 Hz against a stand-in robot: the flat cell's
        plant step (K1, K=1 x10) on the card, whose state is read to the
        host before each tick and which applies each returned control.
        Times what bridge_tick blocks its caller, as [realtime] does."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import RealtimeController
        model, cfg = flat["model"], flat["cfg"]
        robot = cs.build_cuda_substep(model, model.timestep, PLANT["n"],
                                      device=dev)
        rtc = RealtimeController(model, flat["cost"], cfg, lag=lag,
                                 plant_substeps=PLANT["n"], compensate=True,
                                 device=dev, generator=torch.Generator(
                                     device=dev).manual_seed(1))
        st = make_state(model, "home")
        qpos, qvel, t = st.qpos[:, None], st.qvel[:, None], 0.0

        def tick():
            nonlocal qpos, qvel, t
            q, v = qpos[:, 0].cpu().numpy(), qvel[:, 0].cpu().numpy()
            t0 = time.perf_counter()
            ctrl = rtc.bridge_tick(q, v, t)
            blocked = time.perf_counter() - t0
            qpos, qvel = robot(qpos, qvel, torch.from_numpy(ctrl).to(
                dev)[:, None].contiguous())
            t += TICK_S
            return blocked, ctrl

        t0 = time.perf_counter()
        tick()  # captures the compensated solve
        log(f"[bridge] first bridge_tick (captures the solve) "
            f"{time.perf_counter() - t0:.3f} s")
        for _ in range(lag + 3):
            time.sleep(TICK_S)
            tick()

        def run():
            lat = np.zeros(RT_TICKS)
            ctrls, overruns = [], 0
            next_t = time.perf_counter()
            for i in range(RT_TICKS):
                next_t += TICK_S
                lat[i], ctrl = tick()
                ctrls.append(ctrl)
                rest = next_t - time.perf_counter()
                if rest > 0:
                    time.sleep(rest)
                else:
                    overruns += 1
                    next_t = time.perf_counter()
            return lat, np.array(ctrls), overruns

        # the compensated solve rolls lag plant steps; the robot steps once
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]):
                cfg.horizon * RT_TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): (lag + 1) * RT_TICKS}
        lat, ctrls, overruns = self.counted("bridge", run, want)
        rtc.drain()
        fields = loop_fields(lat, overruns, lag)
        self.check_loop("bridge", model, ctrls, qpos[:, 0].cpu().numpy(),
                        fields)
        return fields

    def batch_steps(self):
        torch, dev, cs = self.torch, self.dev, self.cs
        model, K = self.dog, BATCH["K"]
        step = cs.build_cuda_substep(model, BATCH["dt"], BATCH["n"],
                                     device=dev, with_plane=True,
                                     with_payload=True)
        qp, qv, ct, plane, payload = (torch.from_numpy(a).to(dev)
                                      for a in batch_inputs(model, K))

        def run():
            nonlocal qp, qv
            t0 = time.perf_counter()
            for _ in range(BATCH_STEPS):
                qp, qv = step(qp, qv, ct, plane, payload)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        want = {cs.launch_key(K, BATCH["n"], True, True): BATCH_STEPS}
        wall = self.counted("batch", run, want)
        finite = bool((torch.isfinite(qp).all()
                       & torch.isfinite(qv).all()).item())
        z = qp[2]
        log(f"[batch] {BATCH_STEPS} steps of K={K} x{BATCH['n']} in "
            f"{wall:.4f} s: {1e3 * wall / BATCH_STEPS:.4f} ms/step, "
            f"{K * BATCH_STEPS / wall:.0f} scenario-ticks/s | trunk z "
            f"{float(z.min()):.4f}..{float(z.max()):.4f} | finite {finite}")
        if not finite:
            raise RuntimeError("[batch] non-finite state")

    # -- profile ----------------------------------------------------------
    def profile(self, label, tick, carry, n=10):
        """Device busy share and kernel time by name over ``n`` ticks.  Only
        the profiler's own failures are caught; errors of the ticks
        propagate."""
        torch = self.torch
        from opendog_tpu_torch.physics import dynamics
        try:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile, record_function
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        except (ImportError, RuntimeError, AttributeError) as e:
            log(f"[profile] {label}: not measured ({type(e).__name__}: {e})")
            return
        planes_fn = dynamics.geom_local_planes

        def traced_planes(*a, **k):  # a range per call, read below
            with record_function("geom_local_planes"):
                return planes_fn(*a, **k)

        dynamics.geom_local_planes = traced_planes
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                carry, _ = tick(carry)
            torch.cuda.synchronize()
            window_us = 1e6 * (time.perf_counter() - t0)
        finally:
            dynamics.geom_local_planes = planes_fn
        try:
            prof.stop()
            averages = prof.key_averages()
        except (RuntimeError, AttributeError) as e:
            log(f"[profile] {label}: not measured ({type(e).__name__}: {e})")
            return
        dev_us, kern_us, rows, planes = 0.0, 0.0, [], None
        for ev in averages:
            if ev.key == "geom_local_planes":
                # the host-side range; its device-side twin spans the
                # queue from its first to its last kernel, not kernel time
                if ev.device_type == DeviceType.CPU:
                    planes = ev
                continue
            if ev.device_type != DeviceType.CUDA:
                continue  # host-side events; their kernels are listed too
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            dev_us += t
            if ev.key.startswith("substep_"):
                kern_us += t
            rows.append((t, ev.count, ev.key))
        for t, count, key in sorted(rows, reverse=True)[:8]:
            log(f"[profile] {label} {t / n:10.1f} us/tick  {count / n:7.1f} "
                f"calls/tick  {key[:70]}")
        if dev_us <= 0:
            log(f"[profile] {label}: device time not measured (the trace "
                "holds no device events)")
            return
        n_launch = sum(r[1] for r in rows)
        n_sub = sum(r[1] for r in rows if r[2].startswith("substep_"))
        log(f"[profile] {label} over {n} ticks: {window_us / n:.0f} us/tick, "
            f"device busy {100 * dev_us / window_us:.1f}%, substep kernels "
            f"{100 * kern_us / window_us:.1f}% ({n_sub / n:.0f} launches/"
            f"tick), other kernels {100 * (dev_us - kern_us) / window_us:.1f}"
            f"% ({(n_launch - n_sub) / n:.0f} launches/tick)")
        if planes is not None:
            log(f"[profile] {label} geom_local_planes: {planes.count / n:.0f} "
                f"calls/tick, host {planes.cpu_time_total / n:.0f} us/tick "
                f"({100 * planes.cpu_time_total / window_us:.1f}% of the "
                f"profiled tick)")

    def planes_cost(self, qpos, reps=50):
        """geom_local_planes alone, on the card: milliseconds per call by
        the host clock (ending in a synchronise) and by CUDA events, eager
        and replayed from a CUDA graph (its share of a replayed per-geom
        tick, which calls it twice), and its kernel launches per call from
        the profiler."""
        torch = self.torch
        from opendog_tpu_torch.physics import dynamics
        from opendog_tpu_torch.solvers import GraphedTick
        planes = lambda q: dynamics.geom_local_planes(self.dog_t, self.terrain,
                                                      q)
        fn = lambda: planes(qpos)
        graphed = GraphedTick(planes, (qpos,), self.dev)
        graph_ms = event_ms(torch, lambda: graphed(graphed.inputs[0]), reps)
        tick_ms = self.pairs["terrain"]["graph_ms"]
        log(f"[profile] geom_local_planes replayed from a CUDA graph: "
            f"{graph_ms:.4f} ms per call (CUDA events); 2 calls are "
            f"{100 * 2 * graph_ms / tick_ms:.1f}% of the replayed per-geom "
            f"tick's {tick_ms:.3f} ms")
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / reps
        ev_ms = event_ms(torch, fn, reps)
        launches = "not measured"
        try:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            launches = sum(ev.count for ev in prof.key_averages()
                           if ev.device_type == DeviceType.CUDA)
        except (ImportError, RuntimeError, AttributeError) as e:
            launches = f"not measured ({type(e).__name__}: {e})"
        log(f"[profile] geom_local_planes alone: {host_ms:.4f} ms per call "
            f"(host clock), {ev_ms:.4f} ms (CUDA events), {launches} kernel "
            f"launches per call; 2 calls per terrain tick")

    # -- timing -----------------------------------------------------------
    def timing(self):
        from opendog_tpu_torch.ops import scalar_core
        torch = self.torch
        kernels = []
        for label, rec in self.records.items():
            shape, model = rec["shape"], rec["model"]
            K, n = shape["K"], shape["n"]
            args = rec["args"]
            ms = event_ms(torch, lambda: rec["kern"](*args),
                          200 if n * K < 20000 else 50)
            plain_ms = event_ms(torch, lambda: rec["plain"](*args), 2)
            ops = scalar_core.count_substep_ops(
                model, shape["dt"], *rec["modes"]) * K * n
            nbytes = 4 * sum(a.numel() for a in args if a is not None) + 4 * K * (
                model.nq + model.nv)
            t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
            bound_ms = 1e3 * max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            design = self.cs.KERNEL_DESIGNS[rec["name"]]
            log(f"[timing] {label} ({rec['name']}, {design} design) K={K} "
                f"x{n}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.6f} "
                f"ms by {bound_by} ({ops} ops at 67 TFLOP/s fp32 vs {nbytes} "
                f"B at 3.35 TB/s; {100 * bound_ms / ms:.3f}% of bound); "
                f"launches on the paths {rec['launches']}; library call: "
                f"none computes this function")
            kernels.append({
                "name": f"{rec['name']} ({label}: K={K}, {n} substeps)",
                "route": "cuda",
                "design": design,
                "source": SOURCE,
                "replaces": "opendog_tpu/ops/pallas_step.py:115",
                "launches": rec["launches"],
                "max_abs_err": rec["err"],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            })
        for label, rec in self.records.items():
            if rec["launches"] < 1:
                raise RuntimeError(f"[timing] {label}: no path launched "
                                   f"{rec['key']}")
        return kernels


def loop_fields(lat, overruns, lag):
    """bench.py's host-loop fields of a paced loop's blocking times [s]."""
    p99 = float(np.percentile(lat, 99) * 1e3)
    return {
        "host_loop_p99_latency_ms": p99,
        "host_loop_median_latency_ms": float(np.median(lat) * 1e3),
        "host_loop_max_latency_ms": float(lat.max() * 1e3),
        "host_loop_mean_latency_ms": float(lat.mean() * 1e3),
        "host_loop_meets_50hz_budget": bool(p99 < TICK_S * 1e3),
        "host_loop_control_delay_ticks": lag,
        "host_loop_overruns": overruns,
    }


def occupancy(lib, cs, smoke):
    """Prints the launch shape of each entry point's kernel for the model
    of its paths (Go1 for the flat modes, OpenDOG for the plane modes), and
    of the plane + payload kernel for a model above the small size class;
    raises where the card could not hold one block of a kernel."""
    n_max = cs.table_layout()[0]["SC_NG_MAX"]
    rows = [(name, with_plane, with_payload,
             (smoke.go1 if with_plane is False else smoke.dog).ngeom)
            for (with_plane, with_payload), name in cs.KERNEL_NAMES.items()]
    rows.append((cs.KERNEL_NAMES[(True, True)], True, True, n_max))
    for name, with_plane, with_payload, ngeom in rows:
        args = (cs._PLANE_CODE[with_plane], int(with_payload), ngeom)
        warps = lib.substep_warps_per_block(*args)
        smem = lib.substep_warp_smem_bytes(*args)
        blocks = lib.substep_warp_occupancy(*args)
        log(f"[build] {name} at {ngeom} spheres: {warps} rollouts (warps) "
            f"per block, {smem} B of dynamic shared memory per block, "
            f"{blocks} blocks = {blocks * warps} warps per SM")
        if not blocks >= 1:
            raise RuntimeError(f"[build] {name} at {ngeom} spheres: "
                               f"occupancy {blocks}")


def main():
    import torch

    # ---- device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from opendog_tpu_torch.ops import cuda_step

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build ----
    lib, built = cuda_step.cuda_library()
    log(f"[build] {built.path} built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "spill", "stack", "Compiling")):
            log(f"[build] {line.strip()}")
    for name in cuda_step.KERNEL_NAMES.values():
        if f"'{name}'" not in built.log:
            raise RuntimeError(f"[build] no ptxas report of {name}")
    smoke = Smoke(torch, dev)
    occupancy(lib, cuda_step, smoke)

    smoke.check_all()
    flat = smoke.flat_loop()
    terr = smoke.terrain_loop("terrain", "per_geom", TERRAIN_TICKS)
    smoke.terrain_loop("terrain-trunk", "trunk", TRUNK_TICKS)
    smoke.payload_solves()
    smoke.batch_steps()
    smoke.pergeom_payload_solves()
    realtime = smoke.realtime(flat)
    bridge = smoke.bridge(flat, realtime["host_loop_control_delay_ticks"])
    for label, path in (("flat", flat), ("terrain", terr)):
        smoke.profile(f"{label} eager", path["tick"], path["carry"])
        smoke.profile(f"{label} graph", path["gtick"], path["carry"])
    smoke.planes_cost(terr["carry"].plant.qpos)
    kernels = smoke.timing()

    # ---- summary ----
    log("[summary] eager and graph ms per path (same call): "
        + json.dumps(smoke.pairs))
    log("[summary] realtime: " + json.dumps(realtime))
    log("[summary] bridge: " + json.dumps(bridge))
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
