#!/usr/bin/env python3
"""Time the MPC ticks and the payload MPPI solves of the PyTorch port on one
CUDA card in turns: two checkouts against each other, or the eager tick
against the tick replayed from a CUDA graph in this checkout.

Usage, from the root of a checkout:

    python3 scripts/torch_tick_ab.py OTHER    # this checkout against OTHER
                                              # (e.g. the parent commit
                                              # unpacked with git archive)
    python3 scripts/torch_tick_ab.py --graph  # eager against graph, here

Each run is a process of its own in one checkout and one mode (eager, or
graph: every tick and solve captured with ``solvers.graph_tick`` /
``solvers.graph_solve`` after its warm-up and replayed): the Go1 flat trot
loop of ``chip_smoke.py`` [main] (make_mpc, K=256, H=25, 2 x 10 ms
substeps, plant 10 x 2 ms) warmed up for 5 ticks and timed over TICKS
ticks; the payload solver of [payload] with 1.5 kg warmed up for 3 solves
and timed over SOLVES solves; then the OpenDOG terrain loops of [terrain]
(per-geom planes for rollouts and plant) and [terrain-trunk] (one trunk
plane for the rollouts, per-geom planes for the plant) on the generated
terrain of seed 0, and [exact-terrain] (bench 2c: one trunk plane for the
rollouts, the default exact plant: bilinear contact, on the card the
exact plant kernel), each warmed up for 5 ticks and timed over TERRAIN_TICKS ticks;
and the per-geom payload solver of [pergeom-payload] (OpenDOG
standing on that terrain with 0.5 kg) warmed up for 3 solves and timed
over SOLVES.  Each is timed by the host clock around work that ends in
``torch.cuda.synchronize()``.  The runs go other, this, this, other, other,
this (eager, graph, graph, eager, eager, graph with --graph), so that a
drift of the card or its host shows as a spread between the runs of one
side.  The script prints one JSON line with every run's ms/tick and
ms/solve and the card's name and power limit.  It imports no JAX.
"""
import json
import os
import subprocess
import sys

TICKS = 200
SOLVES = 50
TERRAIN_TICKS = 100

CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
GRAPH = sys.argv[2] == "graph"
if GRAPH:
    from opendog_tpu_torch.solvers import graph_solve, graph_tick
from opendog_tpu_torch.assets import load_go1
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc, mppi
dev = torch.device("cuda", 0)
model = load_go1("flat", device=dev)
params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0), target_height=0.265)
cost = costs.trot_cost(model, params, model.key_qpos[0, 7:], legs="go1")
cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2, rollout_dt=0.01,
                 noise_sigma=0.12, temperature=0.3)
def normals(cfg, nu):
    return torch.zeros((cfg.num_samples, cfg.horizon, nu), device=dev)
init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10, device=dev)
carry = init(torch.Generator(device=dev).manual_seed(0),
             make_state(model, "home"))
if GRAPH:
    tick = graph_tick(tick, carry, normals(cfg, model.nu))
for _ in range(5):
    carry, _ = tick(carry)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(%d):
    carry, out = tick(carry)
torch.cuda.synchronize()
tick_ms = 1e3 * (time.perf_counter() - t0) / %d
pay = mppi.make_solver(model, cost, cfg, device=dev, with_payload=True)
st, ms = make_state(model, "home"), mppi.init_state(model, cfg)
gen = torch.Generator(device=dev).manual_seed(0)
if GRAPH:
    pay = graph_solve(pay, st, ms, normals(cfg, model.nu), 1.5)
for _ in range(3):
    pay(st, ms, gen, None, 1.5)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(%d):
    ctrl, ms, stats = pay(st, ms, gen, None, 1.5)
torch.cuda.synchronize()
solve_ms = 1e3 * (time.perf_counter() - t0) / %d
from opendog_tpu_torch.assets import load_opendog
from opendog_tpu_torch.physics import dynamics
from opendog_tpu_torch.physics import terrain as terrain_lib
dog = load_opendog("terrain", device=dev)
terr = terrain_lib.generate_terrain(dog, torch.Generator().manual_seed(0))
h0 = float(dynamics._terrain_height_normal(
    dog, terr, torch.zeros(1, 2, device=dev))[0][0])
cost = costs.standing_cost(dog, 0.0694 + h0, dog.key_qpos[0, 7:])
cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2, rollout_dt=0.01,
                 noise_sigma=0.08, temperature=0.3)
terrain_ms = {}
for mode in ("per_geom", "trunk", "exact"):
    plant = dict(terrain_plant="exact", plane_mode="trunk") if mode == \
        "exact" else dict(terrain_plant="kernel", plane_mode=mode)
    init, tick, _ = make_mpc(dog, cost, cfg, plant_substeps=10, device=dev,
                             terrain=terr, **plant)
    s0 = make_state(dog, "home")
    s0.qpos[2] += h0
    carry_t = init(torch.Generator(device=dev).manual_seed(0), s0)
    if GRAPH:
        tick = graph_tick(tick, carry_t, normals(cfg, dog.nu))
    for _ in range(5):
        carry_t, _ = tick(carry_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(%d):
        carry_t, _ = tick(carry_t)
    torch.cuda.synchronize()
    terrain_ms[mode] = 1e3 * (time.perf_counter() - t0) / %d
pay_t = mppi.make_solver(dog, cost, cfg, device=dev, terrain=terr,
                         plane_mode="per_geom", with_payload=True)
st = make_state(dog, "home")
st.qpos[2] += h0 + 0.0694 - float(dog.key_qpos[0, 2])
ms = mppi.init_state(dog, cfg)
if GRAPH:
    pay_t = graph_solve(pay_t, st, ms, normals(cfg, dog.nu), 0.5)
for _ in range(3):
    pay_t(st, ms, gen, None, 0.5)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(%d):
    ctrl, ms, stats = pay_t(st, ms, gen, None, 0.5)
torch.cuda.synchronize()
pergeom_solve_ms = 1e3 * (time.perf_counter() - t0) / %d
print(json.dumps({"tick_ms": tick_ms, "solve_ms": solve_ms,
                  "pergeom_tick_ms": terrain_ms["per_geom"],
                  "trunk_tick_ms": terrain_ms["trunk"],
                  "exact_tick_ms": terrain_ms["exact"],
                  "pergeom_payload_solve_ms": pergeom_solve_ms,
                  "final_x": float(carry.plant.qpos[0].item())}))
""" % (TICKS, TICKS, SOLVES, SOLVES, TERRAIN_TICKS, TERRAIN_TICKS, SOLVES,
       SOLVES)


def run_checkout(root: str, mode: str = "eager") -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, root, mode],
                          cwd=root, timeout=900, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the {mode} run in {root} failed:\n"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1] == "--graph":
        sides = {"eager": (here, "eager"), "graph": (here, "graph")}
        order = ("eager", "graph", "graph", "eager", "eager", "graph")
    else:
        sides = {"other": (os.path.abspath(sys.argv[1]), "eager"),
                 "this": (here, "eager")}
        order = ("other", "this", "this", "other", "other", "this")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    runs = [(label, run_checkout(*sides[label])) for label in order]
    res = {label: {key: [r[key] for lab, r in runs if lab == label]
                   for key in ("tick_ms", "solve_ms", "pergeom_tick_ms",
                               "trunk_tick_ms", "exact_tick_ms",
                               "pergeom_payload_solve_ms", "final_x")}
           for label in sides}
    print(json.dumps({"sides": {k: list(v) for k, v in sides.items()},
                      "card": smi, "ticks": TICKS, "solves": SOLVES,
                      "terrain_ticks": TERRAIN_TICKS, "order": list(order),
                      "results": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
