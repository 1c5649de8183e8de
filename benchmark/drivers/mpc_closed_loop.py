"""Driver of closed-loop MPC ticks: the program's ``solvers.make_mpc`` tick,
replayed from its CUDA graph (``solvers.graph_tick``), one controller that
waits for each command before it sends the next state.

A tick, as the harness times it: the benchmark draws the tick's (K, H, nu)
standard normals on the device from the run's seed, the program replays
its tick (noise shaping, K rollouts on the substep kernel, the cost, the
softmax-weighted update, the plant step; on a mesh the cross-rank
reduction), and the control and the plant state are copied to the host,
which waits for them.  A tick fails where the control or the plant state
is not finite, or the trunk leaves the configuration's health band.

The inputs are the benchmark's: the start state (the keyframe with its
joints perturbed from the seed), the terrain (the frozen generator from the
seed, always rough) and the normals.  The program gets its own model,
cost and solver from its own modules; the reference (``check``) builds
them again from the frozen copies in ``benchmark/reference``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness.window import seed_for

PURPOSE_START, PURPOSE_NORMALS, PURPOSE_TERRAIN = 1, 2, 4


def make_inputs(config: Dict, traffic: Dict, seed: int) -> Dict:
    """The run's inputs on the CPU, from the seed: the start ``qpos`` /
    ``qvel``, the terrain ``heights`` (or None) and the standing cost's
    target height (or None)."""
    from benchmark.reference.assets import load_robot
    from benchmark.reference.physics import dynamics, terrain as rterrain
    from benchmark.reference.physics import Terrain
    model = load_robot(config["robot"], config["scene"])
    qpos = model.key_qpos[model.key_id(config["start"]["key"])].clone()
    g = torch.Generator().manual_seed(seed_for(seed, PURPOSE_START))
    sigma = traffic["start_joint_sigma"]
    qpos[7:] += sigma * torch.randn(model.nq - 7, generator=g)
    heights = target = None
    if config.get("terrain"):
        g = torch.Generator().manual_seed(seed_for(seed, PURPOSE_TERRAIN))
        draws = rterrain.draw_terrain(model, g)._replace(
            flat_u=torch.ones(()))          # always the rough branch
        heights = rterrain.generate_terrain(model, draws=draws).height
        h0 = float(dynamics._terrain_height_normal(
            model, Terrain(height=heights), torch.zeros(1, 2))[0][0])
        qpos[2] += h0
        cost = config["cost"]
        if "height_above_ground" in cost:
            target = cost["height_above_ground"] + h0
    return dict(qpos=qpos, qvel=torch.zeros(model.nv), heights=heights,
                target_height=target)


def _cost_spec(config: Dict, target: Optional[float]) -> Dict:
    spec = dict(config["cost"])
    if target is not None:
        spec["target_height"] = target
    return spec


class Driver:
    """One rank's closed-loop MPC: ``setup``, ``tick`` and what the harness
    reads.  ``label``, where the harness sets it, names the host's phases
    of a traced tick."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 rank: int = 0, world: int = 1, addr: Optional[str] = None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.rank, self.world, self.addr = rank, world, addr
        self.label = None
        self._records: List[Dict] = []
        self.failures: List[Dict] = []    # the first failed ticks, why
        self._collective_bytes = 0

    # -- set-up -----------------------------------------------------------
    def setup(self) -> Dict:
        from opendog_tpu_torch import assets
        from opendog_tpu_torch.parallel import collectives
        from opendog_tpu_torch.physics import State, Terrain
        from opendog_tpu_torch.solvers import (MPPIConfig, costs,
                                               graph_tick, make_mpc)
        c, t = self.config, self.traffic
        mesh = None
        if self.world > 1:
            from opendog_tpu_torch.parallel import (initialize_distributed,
                                                    sample_mesh)
            cpu = self.device.type == "cpu"
            initialize_distributed(self.addr, self.world, self.rank,
                                   device="cpu" if cpu else None)
            mesh = sample_mesh(self.world, device="cpu" if cpu else None)
            self.device = mesh.device
        self.mesh = mesh
        dev = self.device
        inputs = make_inputs(c, t, self.seed)
        load = {"go1": assets.load_go1, "opendog": assets.load_opendog}
        model = load[c["robot"]](c["scene"], device=dev)
        terrain = (None if inputs["heights"] is None
                   else Terrain(height=inputs["heights"].to(dev)))
        spec = _cost_spec(c, inputs["target_height"])
        home = model.key_qpos[0, 7:]
        if spec["name"] == "trot":
            cost = costs.trot_cost(model, costs.TrotCostParams(
                desired_vel_xy=tuple(spec["desired_vel_xy"]),
                target_height=spec["target_height"]), home,
                legs=spec["legs"])
        else:
            cost = costs.standing_cost(model, spec["target_height"], home)
        m = c["mppi"]
        cfg = MPPIConfig(horizon=t.get("horizon", m["horizon"]),
                         num_samples=t["num_samples"],
                         temperature=m["temperature"],
                         noise_sigma=m["noise_sigma"],
                         n_substeps=m["n_substeps"],
                         rollout_dt=m["rollout_dt"],
                         smooth_alpha=m["smooth_alpha"], gamma=m["gamma"],
                         engine=m["engine"])
        self.shape = (cfg.num_samples, cfg.horizon, model.nu)
        init, tick, _ = make_mpc(
            model, cost, cfg, plant_substeps=c["plant"]["substeps"],
            device=None if mesh is not None else dev, terrain=terrain,
            terrain_plant=c["plant"]["terrain_plant"],
            plane_mode=m["plane_mode"], mesh=mesh)
        self.carry = init(None, State(qpos=inputs["qpos"].to(dev),
                                      qvel=inputs["qvel"].to(dev),
                                      time=torch.zeros((), device=dev)))
        self.inputs = inputs
        self.gen = torch.Generator(device=dev).manual_seed(
            seed_for(self.seed, PURPOSE_NORMALS))
        self.normals = torch.empty(self.shape, device=dev)
        n = model.nu + model.nq + model.nv
        self.host = torch.empty(n, pin_memory=dev.type == "cuda")
        self.nu, self.nq = model.nu, model.nq
        band = c.get("health", {})
        self.z_band = (band.get("z_min", -np.inf), band.get("z_max", np.inf))
        # the start: one eager tick from the benchmark's start state, judged
        # as a sample; it also counts the collectives of one tick
        before = sum(v["bytes"] for v in collectives.traffic().values())
        self.gtick = tick
        self.tick(record=True, index=-1)
        after = sum(v["bytes"] for v in collectives.traffic().values())
        self._collective_bytes = after - before
        t0 = time.perf_counter()
        if dev.type == "cuda":
            self.gtick = graph_tick(tick, self.carry, self.normals)
        self.tick(record=False)
        return dict(capture_s=time.perf_counter() - t0)

    # -- the timed tick ---------------------------------------------------
    def _range(self, name):
        return (self.label(name) if self.label is not None
                else contextlib.nullcontext())

    def tick(self, record: bool = False, index: int = 0):
        """One closed-loop tick: (host seconds from the draw to the control
        readable on the host, whether it failed)."""
        if record:
            p = self.carry.plant
            rec = dict(index=index, qpos=p.qpos.clone(), qvel=p.qvel.clone(),
                       time=p.time.clone(),
                       nominal=self.carry.solver.nominal.clone())
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        with self._range("bench.noise"):
            torch.randn(self.shape, generator=self.gen, out=self.normals)
        with self._range("bench.tick"):
            self.carry, out = self.gtick(self.carry, self.normals)
        with self._range("bench.copy_out"):
            nu, nq, p = self.nu, self.nq, self.carry.plant
            self.host[:nu].copy_(out["ctrl"], non_blocking=cuda)
            self.host[nu:nu + nq].copy_(p.qpos, non_blocking=cuda)
            self.host[nu + nq:].copy_(p.qvel, non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - t0
        h = self.host.numpy()
        z = h[nu + 2]
        failed = not (np.isfinite(h).all()
                      and self.z_band[0] < z < self.z_band[1])
        if failed and len(self.failures) < 10:
            self.failures.append(dict(
                tick=index, trunk_z=float(z),
                ctrl_finite=bool(np.isfinite(h[:nu]).all()),
                state_finite=bool(np.isfinite(h[nu:]).all())))
        if record:
            rec.update(normals=(self.normals.clone() if self.rank == 0
                                else None),
                       out_ctrl=out["ctrl"].clone(),
                       out_nominal=self.carry.solver.nominal.clone(),
                       out_qpos=p.qpos.clone(), out_qvel=p.qvel.clone(),
                       out_best=out["best_cost"].clone(),
                       out_mean=out["mean_cost"].clone())
            self._records.append(rec)
        return dt, failed

    # -- what the harness reads -------------------------------------------
    def agree_max(self, n: int) -> int:
        import torch.distributed as dist
        x = torch.tensor([n], device=self.device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return int(x.item())

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> Dict[str, float]:
        """Cumulative program counters: the substep kernels' launches by
        kernel and shape (``ops.cuda_step.LAUNCHES``)."""
        from opendog_tpu_torch.ops import cuda_step
        return {"launches " + k: v for k, v in cuda_step.LAUNCHES.items()}

    def facts(self) -> Dict:
        return dict(robot=self.config["robot"], world=self.world,
                    collective_bytes_per_tick=self._collective_bytes)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def device_name(self) -> str:
        if self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    def records(self) -> Dict:
        """The sampled ticks stacked, on the CPU (the run's inputs beside
        them)."""
        keys = [k for k in self._records[0] if k != "index"]
        out = {k: (torch.stack([r[k] for r in self._records]).cpu()
                   if self._records[0][k] is not None else None)
               for k in keys}
        out["index"] = [r["index"] for r in self._records]
        out["heights"] = self.inputs["heights"]
        out["target_height"] = self.inputs["target_height"]
        return out

    def close(self) -> None:
        self.gtick = self.carry = self.normals = None
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.group)
            dist.destroy_process_group()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


# -- the comparison that decides ``correct`` -------------------------------

def reference_outputs(config: Dict, traffic: Dict, rec: Dict,
                      tf32: bool = False, device="cpu") -> Dict:
    """The plain reference's outputs of the sampled ticks ``rec`` (rank 0's
    records), from their inputs, on ``device`` (the card in a run: there
    the plain substep rounds as the kernels do), on the CPU."""
    from benchmark.reference import mppi as rmppi
    from benchmark.reference.assets import load_robot
    from benchmark.reference.physics import Terrain
    model = load_robot(config["robot"], config["scene"], device)
    terrain = (None if rec["heights"] is None
               else Terrain(height=rec["heights"].to(device)))
    cost = rmppi.cost_of(model, _cost_spec(config, rec["target_height"]))
    m = dict(config["mppi"], num_samples=traffic["num_samples"],
             horizon=traffic.get("horizon", config["mppi"]["horizon"]))
    if terrain is not None and (config["plant"]["terrain_plant"] != "exact"
                                or m["plane_mode"] != "trunk"):
        raise ValueError("the reference has the trunk-plane rollouts and "
                         "the exact plant on a terrain, nothing else")
    tick = rmppi.build_tick(model, cost, m, config["plant"]["substeps"],
                            terrain)
    on = {k: rec[k].to(device) for k in ("qpos", "qvel", "time", "nominal",
                                         "normals")}
    with torch.inference_mode():
        out = tick(on["qpos"], on["qvel"], on["time"], on["nominal"],
                   on["normals"], tf32=tf32)
    return {k: v.cpu() for k, v in out.items()}


COMPARED = (("ctrl_gap", "ctrl", "out_ctrl"),
            ("nominal_gap", "nominal", "out_nominal"),
            ("qpos_gap", "qpos", "out_qpos"),
            ("qvel_gap", "qvel", "out_qvel"))


def gaps(ref: Dict, rec: Dict) -> Dict[str, float]:
    """The widest gap of each output between ``rec`` (what was served) and
    ``ref`` (the reference's); NaN reads as infinitely wide."""
    out = {}
    for name, rk, pk in COMPARED:
        d = (ref[rk] - rec[pk]).abs()
        out[name] = (float("inf") if not torch.isfinite(d).all()
                     else float(d.max()))
    return out


def check(config: Dict, traffic: Dict, records: List[Dict],
          tf32: bool = False, device="cpu") -> Dict[str, float]:
    """The numbers compared: each output's widest gap from the reference
    over the sampled ticks (rank 0's), and with more than one rank the
    widest gap between any rank's outputs and rank 0's (the ranks must
    agree bit for bit).  With ``tf32`` the reference in TF32 takes the
    program's place: the control's readings.  ``device``: where the
    reference runs."""
    rec = records[0]
    ref = reference_outputs(config, traffic, rec, device=device)
    if tf32:
        served = reference_outputs(config, traffic, rec, tf32=True,
                                   device=device)
        rec = dict(rec, **{pk: served[rk] for _, rk, pk in COMPARED})
    out = gaps(ref, rec)
    if len(records) > 1:
        worst = 0.0
        for other in records[1:]:
            for _, _, pk in COMPARED:
                d = (other[pk] - records[0][pk]).abs()
                worst = max(worst, float("inf") if not torch.isfinite(
                    d).all() else float(d.max()))
        out["rank_gap"] = worst
    return out
