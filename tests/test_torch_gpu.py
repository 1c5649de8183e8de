"""Tests of the port that need a CUDA card: every substep kernel against its
plain PyTorch version on the card, at the shapes of the paths that launch
it (and, for the warp-design kernels, at the edges of their grid), the
launch counter, and the ticks, solves and controller replayed from CUDA
graphs against their eager versions.  Where there is no card they skip
(decided inside a fixture, so that every worker collects the same
tests).

This file imports neither JAX nor the JAX package, so that it runs on the
GPU machine, where the repository's conftest.py (which imports JAX) is left
out:  python -m pytest --noconftest -o addopts="" -q -m gpu tests/test_torch_gpu.py
"""
import collections

import numpy as np
import pytest
import torch

from opendog_tpu_torch.assets import load_go1, load_opendog
from opendog_tpu_torch.ops import cuda_step
from chip_smoke import random_batch, random_modes

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_rows(model, K, device):
    """chip_smoke.py's random states, (rows, K), on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in random_batch(model, K))


# the kernels, all on the warp design: (robot, with_plane, with_payload)
WARP_KERNELS = {"flat": ("go1", False, False),         # K1
                "payload": ("go1", False, True),       # K2
                "plane": ("opendog", True, False),     # K3
                "pergeom": ("opendog", "per_geom", False),  # K4
                "plane_payload": ("opendog", True, True),   # K2 + K3
                "pergeom_payload": ("opendog", "per_geom", True)}  # K2 + K4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(WARP_KERNELS))
@pytest.mark.parametrize("K,dt,n", [
    (K, 0.01, n) for K in (1, 31, 256, 257) for n in (1, 2)
] + [(1, 0.002, 10)])
def test_kernel_matches_plain_on_card(cuda_device, K, dt, n, mode):
    """The six kernels equal their plain version exactly (the same
    operations in the same order, built with -fmad=false): at one rollout,
    a partial warp group (K=31), the MPPI paths' K=256, a ragged last block
    (K=257) and the plant step.  K1 and K2 on random Go1 states, payloads
    U(0, 3) kg; K3, K4 and the plane modes with a payload on random OpenDOG
    states on the ground, with random planes per rollout or per geom and
    rollout (OpenDOG's plane + payload kernel is the small-class one)."""
    robot, with_plane, with_payload = WARP_KERNELS[mode]
    if robot == "go1":
        m = load_go1("flat", device=cuda_device)
        qp, qv, ct = _random_rows(m, K, cuda_device)
    else:
        m = load_opendog("flat", device=cuda_device)
        qp, qv, ct = (torch.from_numpy(a).to(cuda_device)
                      for a in random_batch(m, K, on_ground=True))
    extra = {name: torch.from_numpy(a).to(cuda_device)
             for name, a in zip(("plane", "payload"),
                                random_modes(m, K, with_plane, with_payload))
             if a is not None}
    key = cuda_step.launch_key(K, n, with_plane, with_payload)
    before = cuda_step.LAUNCHES[key]
    kp, kv = cuda_step.build_cuda_substep(
        m, dt, n, device=cuda_device, with_plane=with_plane,
        with_payload=with_payload)(qp, qv, ct, **extra)
    pp, pv = cuda_step.build_plain_substep(m, dt, n, with_plane,
                                           with_payload)(qp, qv, ct, **extra)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES[key] == before + 1
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


@pytest.mark.gpu
def test_kernel_rejects_cpu_tensors(cuda_device):
    m = load_go1("flat", device=cuda_device)
    step = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device)
    qp, qv, ct = _random_rows(m, 4, "cpu")
    with pytest.raises(ValueError, match="is on"):
        step(qp, qv, ct)


@pytest.mark.gpu
@pytest.mark.parametrize("robot,K,dt,n,with_plane,with_payload", [
    ("go1", 256, 0.01, 2, False, True),            # K2: payload MPPI
    ("opendog", 256, 0.01, 2, True, False),        # K3: trunk-plane MPPI
    ("opendog", 256, 0.01, 2, "per_geom", False),  # K4: per-geom MPPI
    ("opendog", 4096, 0.01, 2, "per_geom", False),  # K4: 4096 rollouts
    ("opendog", 1, 0.002, 10, "per_geom", False),  # K4: terrain plant
    ("opendog", 4096, 0.002, 10, True, True),      # K2 + K3: batch
    ("opendog", 256, 0.01, 2, "per_geom", True),   # K2 + K4: per-geom
])
def test_mode_kernel_matches_plain_on_card(cuda_device, robot, K, dt, n,
                                           with_plane, with_payload):
    """Each plane / payload instantiation against its plain version on
    random states on the ground, random planes and payloads, at the shapes
    of its paths (the K=4096 batch and the per-geom payload rollout
    included): equal exactly, as every warp-design kernel is."""
    m = (load_go1 if robot == "go1" else load_opendog)("flat",
                                                       device=cuda_device)
    qp, qv, ct = (torch.from_numpy(a).to(cuda_device)
                  for a in random_batch(m, K, on_ground=True))
    extra = {name: torch.from_numpy(a).to(cuda_device)
             for name, a in zip(("plane", "payload"),
                                random_modes(m, K, with_plane, with_payload))
             if a is not None}
    key = cuda_step.launch_key(K, n, with_plane, with_payload)
    before = cuda_step.LAUNCHES[key]
    kp, kv = cuda_step.build_cuda_substep(
        m, dt, n, device=cuda_device, with_plane=with_plane,
        with_payload=with_payload)(qp, qv, ct, **extra)
    pp, pv = cuda_step.build_plain_substep(m, dt, n, with_plane,
                                           with_payload)(qp, qv, ct, **extra)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES[key] == before + 1
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


@pytest.mark.gpu
@pytest.mark.parametrize("robot,K,with_plane", [
    ("opendog", 256, True), ("opendog", 4096, True),
    ("opendog", 256, "per_geom"), ("opendog", 4096, "per_geom"),
    ("go1", 256, False)])
def test_cost_kernel_rollout_total_matches_op_path(cuda_device, robot, K,
                                                   with_plane):
    """The rollouts' tracking-cost kernel against the op path it replaces
    (``costs.standing_cost``'s closure on the carry, times the discount,
    added up) over 25 control steps of K3 or K4 from the perturbed home
    keyframe on rough terrain (OpenDOG, 8 controls), or of K1 on flat
    ground (Go1, 12 controls: the other widths of the sums), gamma 0.9:
    every lane's total bit for bit, and one launch a step in
    COST_LAUNCHES."""
    from opendog_tpu_torch.physics import State, dynamics
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from opendog_tpu_torch.solvers import costs
    if robot == "go1":
        m = load_go1("flat", device=cuda_device)
        h0, height = 0.0, 0.265
    else:
        m = load_opendog("terrain", device=cuda_device)
        terr = terrain_lib.generate_terrain(
            m, torch.Generator().manual_seed(0)).to(cuda_device)
        h0 = float(dynamics._terrain_height_normal(
            m, terr, torch.zeros(1, 2, device=cuda_device))[0][0])
        height = 0.0694 + h0
    cost = costs.standing_cost(m, height, m.key_qpos[0, 7:])
    kernel = cuda_step.TrackingCostKernel(m, *cost.tracking, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qpos = m.key_qpos[0][None].repeat(K, 1)
    qpos[:, 2] += h0
    qpos[:, 7:] += 0.03 * torch.randn(K, m.nq - 7, device=cuda_device,
                                      generator=g)
    extra = {}
    if with_plane == "per_geom":
        planes = dynamics.geom_local_planes(m, terr, qpos).reshape(K, -1)
        extra["plane"] = planes.T.contiguous()
    elif with_plane:
        h, n = dynamics._terrain_height_normal(m, terr, qpos[:, :2])
        p0 = torch.stack([qpos[:, 0], qpos[:, 1], h], dim=-1)
        planes = torch.cat([n, torch.sum(n * p0, dim=-1)[:, None]], dim=-1)
        extra["plane"] = planes.T.contiguous()
    rng = m.actuator_ctrlrange
    cand = torch.clamp(m.key_ctrl[0] + 0.08 * torch.randn(
        K, 25, m.nu, device=cuda_device, generator=g), rng[:, 0], rng[:, 1])
    rows = cand.permute(1, 2, 0).contiguous()
    psub = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                        with_plane=with_plane)
    qp, qv = qpos.T.contiguous(), torch.zeros(m.nv, K, device=cuda_device)
    key = cuda_step.cost_launch_key(K)
    before = cuda_step.COST_LAUNCHES[key]
    want = got = None
    disc = 1.0
    for h in range(25):
        qp, qv = psub(qp, qv, rows[h], **extra)
        st = State(qpos=qp.T, qvel=qv.T, time=torch.zeros(K,
                                                          device=cuda_device))
        c = cost(st, cand[:, h], cand[:, max(h - 1, 0)]) * disc
        want = c if want is None else want + c
        got = kernel(qp, qv, rows[h], rows[max(h - 1, 0)], disc, got)
        disc = disc * 0.9
    torch.cuda.synchronize()
    assert cuda_step.COST_LAUNCHES[key] == before + 25
    assert torch.isfinite(want).all()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["terrain", "box", "edge"])
@pytest.mark.parametrize("K", [1, 5])
def test_exact_plant_matches_plain_on_card(cuda_device, case, K):
    """The exact plant kernel (``exact_plant``: the terrain ground of
    ``dynamics.step``, 10 x 2 ms) equals its plain version exactly on the
    card, as every warp-design kernel does: at the plant's K=1 and across
    two blocks (K=5), on random OpenDOG states on the generated terrain,
    over the static box (spheres inside it and beside it) and past the
    heightfield's clipped edge.  One launch, counted in PLANT_LAUNCHES and
    not in LAUNCHES."""
    from opendog_tpu_torch.ops import scalar_core
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from chip_smoke import exact_plant_batch
    m = load_opendog("terrain", device=cuda_device)
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    qp, qv, ct, heights = (torch.from_numpy(a).to(cuda_device)
                           for a in exact_plant_batch(m, terr, K, case))
    key = cuda_step.plant_launch_key(K, 10)
    before = cuda_step.PLANT_LAUNCHES[key]
    substep_launches = dict(cuda_step.LAUNCHES)
    kp, kv = cuda_step.ExactPlant(m, 0.002, 10, heights,
                                  cuda_device)(qp, qv, ct)
    pp, pv = cuda_step.build_plain_substep(
        m, 0.002, 10, scalar_core.TERRAIN)(qp, qv, ct, heights)
    torch.cuda.synchronize()
    assert cuda_step.PLANT_LAUNCHES[key] == before + 1
    assert dict(cuda_step.LAUNCHES) == substep_launches
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


def _bench_suite():
    """scripts/torch_bench_suite.py as a module (it imports no JAX)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "torch_bench_suite", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "torch_bench_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["4b", "4d"])
def test_bench_suite_batch_kernels_match_plain_on_card(cuda_device, config):
    """The benchmark suite's new kernel shapes on their own inputs, 10
    substeps of 2 ms: K1 on OpenDOG at 4096 (config 4b, from config 4's
    start) and K2+K3 at 32,768 scenarios (config 4d, the 32-sphere build
    over 4096 blocks of 8, which the wrapper names) equal their plain
    versions exactly."""
    suite = _bench_suite()
    m = load_opendog("flat", device=cuda_device)
    if config == "4b":
        args = tuple(cuda_step.rows_from_batch(x) for x in suite.batch_start(
            m, suite.batch_draws(m)))
        modes, entry = (False, False), "substep_flat"
    else:
        args = tuple(torch.from_numpy(a).to(cuda_device)
                     for a in suite.batch_inputs(m, suite.BATCH_32K))
        modes, entry = (True, True), "substep_plane_payload_small"
    key = cuda_step.launch_key(args[0].shape[1], 10, *modes)
    before = cuda_step.LAUNCHES[key]
    kern = cuda_step.build_cuda_substep(
        m, m.timestep, 10, device=cuda_device, with_plane=modes[0],
        with_payload=modes[1])
    assert kern.entry == entry
    kp, kv = kern(*args)
    pp, pv = cuda_step.build_plain_substep(m, m.timestep, 10, *modes)(*args)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES[key] == before + 1
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


@pytest.mark.gpu
def test_payload_kernel_at_zero_is_the_flat_kernel(cuda_device):
    """A zero payload leaves the trunk's mass and com as they are, so the
    payload kernel's result is the flat kernel's, bit for bit."""
    m = load_go1("flat", device=cuda_device)
    qp, qv, ct = _random_rows(m, 256, cuda_device)
    flat = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device)
    loaded = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                          with_payload=True)
    a = flat(qp, qv, ct)
    b = loaded(qp, qv, ct, payload=torch.zeros(1, 256, device=cuda_device))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("with_plane", [True, "per_geom"])
def test_plane_payload_kernel_at_zero_is_the_plane_kernel(cuda_device,
                                                          with_plane):
    """A zero payload leaves the trunk as it is, so the plane and per-geom
    kernels with a payload (the former on the small workspace class for
    OpenDOG) give the payload-free kernels' result bit for bit."""
    m = load_opendog("flat", device=cuda_device)
    qp, qv, ct = (torch.from_numpy(a).to(cuda_device)
                  for a in random_batch(m, 256, on_ground=True))
    plane = torch.from_numpy(random_modes(m, 256, with_plane)[0]).to(
        cuda_device)
    bare = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                        with_plane=with_plane)
    loaded = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                          with_plane=with_plane,
                                          with_payload=True)
    a = bare(qp, qv, ct, plane)
    b = loaded(qp, qv, ct, plane,
               payload=torch.zeros(1, 256, device=cuda_device))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_batch_kernel_size_classes_agree(cuda_device):
    """The plane + payload kernel in its two workspace size classes (the
    launcher picks the small one for OpenDOG's 24 spheres; a sphere count
    above SC_NG_SMALL picks the full one) on the batch's shape, K=4096 x 10
    substeps of 2 ms: bit for bit, each resident on an SM, the small one
    with less shared memory per rollout."""
    m = load_opendog("flat", device=cuda_device)
    K, n = 4096, 10
    arrays = (random_batch(m, K, on_ground=True)
              + random_modes(m, K, True, True))
    qp, qv, ct, plane, payload = (torch.from_numpy(a).to(cuda_device)
                                  for a in arrays)
    lib, _ = cuda_step.cuda_library()
    n_max = cuda_step.table_layout()[0]["SC_NG_MAX"]
    raw = bytearray(memoryview(cuda_step.substep_table(m, 0.002)).cast("B"))
    table = torch.frombuffer(raw, dtype=torch.uint8).to(cuda_device)
    outs = {}
    for ngeom in (m.ngeom, n_max):
        op, ov = torch.empty_like(qp), torch.empty_like(qv)
        rc = lib.substep_launch(
            table.data_ptr(), qp.data_ptr(), qv.data_ptr(), ct.data_ptr(),
            plane.data_ptr(), payload.data_ptr(), op.data_ptr(),
            ov.data_ptr(), K, n, 1, 1, ngeom,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        assert lib.substep_warp_occupancy(1, 1, ngeom) >= 1
        outs[ngeom] = (op, ov)
    torch.cuda.synchronize()
    small, full = outs[m.ngeom], outs[n_max]
    assert torch.isfinite(small[0]).all() and torch.isfinite(small[1]).all()
    assert torch.equal(small[0], full[0]) and torch.equal(small[1], full[1])
    per_rollout = {ngeom: lib.substep_warp_smem_bytes(1, 1, ngeom)
                   / lib.substep_warps_per_block(1, 1, ngeom)
                   for ngeom in (m.ngeom, n_max)}
    assert per_rollout[m.ngeom] < per_rollout[n_max]


# -- the graphed tick, solves and controller ------------------------------

def _bench_config(sigma=0.12):
    from opendog_tpu_torch.solvers import MPPIConfig
    return MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                      rollout_dt=0.01, noise_sigma=sigma, temperature=0.3)


def _go1_trot(device):
    from opendog_tpu_torch.solvers import costs
    m = load_go1("flat", device=device)
    params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265)
    return m, costs.trot_cost(m, params, m.key_qpos[0, 7:], legs="go1")


def _dog_terrain(device):
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from opendog_tpu_torch.solvers import costs
    m = load_opendog("terrain", device=device)
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    return m, terr, costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])


def _normals(n, cfg, nu, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((cfg.num_samples, cfg.horizon, nu), device=device,
                        generator=g) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["flat", "per_geom", "trunk", "exact"])
def test_graph_tick_equals_eager_tick(cuda_device, path):
    """The make_mpc tick replayed from a CUDA graph equals the eager tick
    bit for bit on the same normals from the same carry (it replays the
    same kernels), and each replay counts one tick's launches: 25 rollout
    launches and one plant launch; on the exact plant (bench 2c:
    trunk-plane rollouts) the plant's launch is the exact plant kernel's,
    one a tick in PLANT_LAUNCHES; on the terrain paths (the standing cost)
    25 launches of the cost kernel in COST_LAUNCHES, none on Go1's trot."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_tick, make_mpc
    if path == "flat":
        m, cost = _go1_trot(cuda_device)
        cfg, extra = _bench_config(), {}
        s0 = make_state(m, "home")
    else:
        m, terr, cost = _dog_terrain(cuda_device)
        cfg = _bench_config(0.08)
        extra = (dict(terrain=terr) if path == "exact" else
                 dict(terrain=terr, terrain_plant="kernel", plane_mode=path))
        s0 = make_state(m, "home")
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10,
                             device=cuda_device, **extra)
    carry0 = init(torch.Generator(device=cuda_device).manual_seed(0), s0)
    normals = _normals(4, cfg, m.nu, cuda_device)
    keys = ("ctrl", "qpos", "qvel")
    eager, carry = [], carry0
    for n in normals:
        carry, out = tick(carry, n)
        eager.append([out[k] for k in keys] + [carry.solver.nominal])
    gtick = graph_tick(tick, carry0, normals[0])
    rollout = (False if path == "flat" else
               "per_geom" if path == "per_geom" else True)
    want_launches = {cuda_step.launch_key(256, 2, rollout): 25}
    want_plant = {}
    if path == "exact":
        want_plant[cuda_step.plant_launch_key(1, 10)] = 1
    else:
        want_launches[cuda_step.launch_key(
            1, 10, False if path == "flat" else "per_geom")] = 1
    # the standing cost of the terrain paths runs its own kernel, one launch
    # a control step; the trot cost keeps its torch ops
    want_cost = ({} if path == "flat" else
                 {cuda_step.cost_launch_key(256): 25})
    assert dict(gtick.graph.launches) == want_launches
    assert dict(gtick.graph.count_of(cuda_step.PLANT_LAUNCHES)) == want_plant
    assert dict(gtick.graph.count_of(cuda_step.COST_LAUNCHES)) == want_cost
    cuda_step.LAUNCHES.clear()
    cuda_step.PLANT_LAUNCHES.clear()
    cuda_step.COST_LAUNCHES.clear()
    carry = carry0
    for n, want in zip(normals, eager):
        carry, out = gtick(carry, n)
        got = [out[k] for k in keys] + [carry.solver.nominal]
        for k, a, b in zip(keys + ("nominal",), got, want):
            assert torch.equal(a, b), k
    torch.cuda.synchronize()
    assert dict(cuda_step.LAUNCHES) == {
        k: v * len(normals) for k, v in gtick.graph.launches.items()}
    assert dict(cuda_step.PLANT_LAUNCHES) == {
        k: v * len(normals) for k, v in want_plant.items()}
    assert dict(cuda_step.COST_LAUNCHES) == {
        k: v * len(normals) for k, v in want_cost.items()}


@pytest.mark.gpu
def test_graph_tick_outlives_the_eager_tick(cuda_device):
    """A graph_tick whose eager tick, solver and kernel steps are no longer
    referenced anywhere else (the MPC built inside a function that returns
    the graphed tick alone) replays the same bits as the eager tick after
    the freed memory has been handed to other tensors: the graph keeps
    what it reads (the kernels' model tables, the cost's constants)
    alive.  Before GraphedTick kept its function, such a replay read
    reused memory (scripts/torch_lag_sweep.py: an illegal instruction on
    an H100)."""
    import gc
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_tick, make_mpc
    m, cost = _go1_trot(cuda_device)
    cfg = _bench_config()
    normals = _normals(3, cfg, m.nu, cuda_device)
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10,
                             device=cuda_device)
    carry0 = init(None, make_state(m, "home"))
    eager, carry = [], carry0
    for n in normals:
        carry, out = tick(carry, n)
        eager.append(out["qpos"].clone())

    def graphed_only():
        m2, cost2 = _go1_trot(cuda_device)
        init2, tick2, _ = make_mpc(m2, cost2, cfg, plant_substeps=10,
                                   device=cuda_device)
        c = init2(None, make_state(m2, "home"))
        return graph_tick(tick2, c, normals[0]), c

    gtick, carry = graphed_only()
    gc.collect()
    # NaN into the freed blocks: the caching allocator hands them to new
    # tensors of every size class (the model's and the cost's tensors, the
    # kernels' tables are small)
    filler = [torch.full((n,), float("nan"), device=cuda_device)
              for n in (2 ** k for k in range(17)) for _ in range(256)]
    for n, want in zip(normals, eager):
        carry, out = gtick(carry, n)
        assert torch.equal(out["qpos"], want)
    del filler


# libcuda's CUgraphNodeType
NODE_KERNEL, NODE_EVENT_RECORD = 0, 7


def _node_types(graph):
    """{node type: count} of a captured ``torch.cuda.CUDAGraph`` (kept with
    ``keep_graph=True``), from libcuda's ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType``."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    out = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(0)
        assert lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0
        out[kind.value] += 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["flat", "exact"])
def test_spans_in_a_replayed_tick(cuda_device, path):
    """The make_mpc tick captured with the spans on and off (Go1 flat; the
    exact terrain plant, whose rollouts also open ``mppi.planes`` inside
    ``mppi.rollout``): the same kernel nodes, two event-record nodes more
    per span, the same bits on every replay; every span reads a positive
    device time on every read replay (the first and every READ_EVERY-th),
    and the stage medians add up to the graph's device span within 5%."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_tick, make_mpc
    from opendog_tpu_torch.solvers.graph import READ_EVERY
    from opendog_tpu_torch.utils import profiling
    if path == "flat":
        m, cost = _go1_trot(cuda_device)
        cfg, extra = _bench_config(), {}
    else:
        m, terr, cost = _dog_terrain(cuda_device)
        cfg, extra = _bench_config(0.08), dict(terrain=terr)
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10,
                             device=cuda_device, **extra)
    carry0 = init(None, make_state(m, "home"))
    normals = _normals(2 * READ_EVERY + 1, cfg, m.nu, cuda_device)
    stages = {"mppi.sample", "mppi.rollout", "mppi.update", "mpc.plant"}
    named = stages | ({"mppi.planes"} if path == "exact" else set())
    was = profiling.set_spans(False)
    try:
        g_off = graph_tick(tick, carry0, normals[0])
        profiling.set_spans(True)
        profiling.SPANS.clear()
        g_on = graph_tick(tick, carry0, normals[0])
        assert g_off.graph.pairs == ()
        assert {name for name, _, _ in g_on.graph.pairs} == named
        assert len(g_on.graph.pairs) == len(named)
        on, off = (_node_types(g.graph.graph) for g in (g_on, g_off))
        assert on[NODE_KERNEL] == off[NODE_KERNEL] > 0
        assert on[NODE_EVENT_RECORD] - off[NODE_EVENT_RECORD] == 2 * len(
            named)
        c_on = c_off = carry0
        for n in normals:
            profiling.set_spans(True)
            c_on, o_on = g_on(c_on, n)
            profiling.set_spans(False)
            c_off, o_off = g_off(c_off, n)
            for k in ("ctrl", "qpos", "qvel"):
                assert torch.equal(o_on[k], o_off[k]), k
            assert torch.equal(c_on.solver.nominal, c_off.solver.nominal)
        g_on.graph.flush()
    finally:
        profiling.set_spans(was)
    store = profiling.SPANS
    med = {}
    for name in named | {"graph.replay"}:
        ms = [v for _, v in store.device(name)]
        assert len(ms) == 3 and min(ms) > 0, (name, ms)
        med[name] = float(np.median(ms))
    periods = [v for _, v in store.device("graph.period")]
    assert len(periods) == 2 and min(periods) >= med["graph.replay"]
    assert len(store.host("graph.replay")) == len(normals)
    total = sum(med[name] for name in stages)
    assert abs(total - med["graph.replay"]) <= 0.05 * med["graph.replay"], \
        med


@pytest.mark.gpu
def test_a_replay_adds_every_counter_back(cuda_device):
    """GraphedTick takes each program counter's counts out of its capture
    and adds them back on every replay: a test counter made by
    ``profiling.counter``, and ``collectives.TRAFFIC`` through a psum on a
    one-rank NCCL group, whose all-reduce span reads a positive device
    time on every read replay."""
    import socket

    import torch.distributed as dist

    from opendog_tpu_torch.parallel import (collectives,
                                            initialize_distributed,
                                            sample_mesh)
    from opendog_tpu_torch.solvers import graph as graph_mod
    from opendog_tpu_torch.utils import profiling

    test = profiling.counter()
    try:
        def fn(x):
            test["calls"] += 1
            test["elements"] += x.numel()
            return x * 2

        x = torch.ones(4, device=cuda_device)
        g = graph_mod.GraphedTick(fn, (x,), cuda_device)
        assert test == {"calls": 1, "elements": 4}     # the eager warm-up
        assert g.count_of(test) == {"calls": 1, "elements": 4}
        for _ in range(3):
            g(x)
        assert test == {"calls": 4, "elements": 16}
    finally:
        profiling.COUNTERS[:] = [c for c in profiling.COUNTERS
                                 if c is not test]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    was = profiling.set_spans(True)
    try:
        assert dist.get_backend() == "nccl"
        mesh = sample_mesh(1)
        x = torch.arange(6.0, device=cuda_device)
        collectives.TRAFFIC.clear()
        g = graph_mod.GraphedTick(lambda v: collectives.psum(v, mesh), (x,),
                                  cuda_device)
        key = ("psum", torch.float32, 6)
        assert dict(collectives.TRAFFIC) == {key: 1}
        assert g.count_of(collectives.TRAFFIC) == {key: 1}
        assert [name for name, _, _ in g.pairs] == ["collectives.all_reduce"]
        profiling.SPANS.clear()
        for _ in range(graph_mod.READ_EVERY + 1):
            out = g(x)
        g.flush()
        assert torch.equal(out, x)
        assert dict(collectives.TRAFFIC) == {key: graph_mod.READ_EVERY + 2}
        ms = [v for _, v in profiling.SPANS.device("collectives.all_reduce")]
        assert len(ms) == 2 and min(ms) > 0, ms
    finally:
        profiling.set_spans(was)
        dist.destroy_process_group()


@pytest.mark.gpu
def test_span_clock_is_the_profilers(cuda_device):
    """A span's start (``time.time_ns()``) lies within 50 us of the
    profiler's own record of the same range, once both are warm."""
    from torch.profiler import ProfilerActivity, profile

    from opendog_tpu_torch.utils import profiling
    x = torch.ones(1 << 16, device=cuda_device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    was = profiling.set_spans(True)
    try:
        with profile(activities=acts):
            with profiling.span("clock.check"):
                x.mul_(1.0001)
            torch.cuda.synchronize()
        profiling.SPANS.clear()
        with profile(activities=acts) as prof:
            for _ in range(20):
                with profiling.span("clock.check"):
                    x.mul_(1.0001)
                torch.cuda.synchronize()
    finally:
        profiling.set_spans(was)
    ranges = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name() == "clock.check"
              and "CUDA" not in str(ev.device_type())]
    ours = profiling.SPANS.host("clock.check")
    assert len(ranges) == len(ours) == 20
    gaps_us = [abs(s - ev.start_ns()) / 1e3
               for (s, _), ev in zip(ours, ranges)][5:]
    assert max(gaps_us) < 50, gaps_us


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["flat", "per_geom"])
def test_graph_payload_solve_equals_eager(cuda_device, path):
    """Both payload solves replayed from a CUDA graph equal the eager solve
    bit for bit on the same normals, with the payload as a float and as a
    tensor."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_solve, mppi
    if path == "flat":
        m, cost = _go1_trot(cuda_device)
        cfg, extra = _bench_config(), {}
    else:
        m, terr, cost = _dog_terrain(cuda_device)
        cfg, extra = _bench_config(0.08), dict(terrain=terr,
                                               plane_mode="per_geom")
    solve = mppi.make_solver(m, cost, cfg, device=cuda_device,
                             with_payload=True, **extra)
    st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
    normals = _normals(3, cfg, m.nu, cuda_device)
    gsolve = graph_solve(solve, st, ms0, normals[0], 0.5)
    ms_e = ms_g = ms0
    for i, n in enumerate(normals):
        payload = 1.5 if i % 2 == 0 else torch.full((), 1.5,
                                                    device=cuda_device)
        ce, ms_e, se = solve(st, ms_e, None, n, payload)
        cg, ms_g, sg = gsolve(st, ms_g, None, n, payload)
        assert torch.equal(ce, cg)
        assert torch.equal(ms_e.nominal, ms_g.nominal)
        assert torch.equal(se["best_cost"], sg["best_cost"])


@pytest.mark.gpu
@pytest.mark.parametrize("lag,compensate", [(1, False), (2, True)])
def test_realtime_controller_on_card(cuda_device, lag, compensate):
    """Twenty benchmark-mode ticks of bench.py's configuration give finite
    controls in ctrlrange, and the stream is the eager make_mpc loop's
    controls (with ``ctrl_lag=lag`` and compensation when compensating)
    ``lag`` ticks late, bit for bit, on the same normals."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import RealtimeController, make_mpc
    m, cost = _go1_trot(cuda_device)
    cfg = _bench_config()
    normals = _normals(20, cfg, m.nu, cuda_device)
    rtc = RealtimeController(m, cost, cfg, lag=lag, plant_substeps=10,
                             compensate=compensate, device=cuda_device)
    rtc.start(make_state(m, "home"))
    got = [rtc.tick(n) for n in normals]
    last = rtc.drain()
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10,
                             ctrl_lag=lag if compensate else 0,
                             lag_compensation=compensate, device=cuda_device)
    carry = init(None, make_state(m, "home"))
    want = []
    for n in normals:
        carry, out = tick(carry, n)
        want.append(out["ctrl"].cpu().numpy())
    rng = m.numpy("actuator_ctrlrange")
    hold = np.clip(m.numpy("key_ctrl")[0], rng[:, 0], rng[:, 1])
    got = np.array(got)
    assert np.isfinite(got).all()
    # a softmax-weighted mean of clipped plans may round an ulp outside
    assert ((got >= rng[:, 0] - 1e-6) & (got <= rng[:, 1] + 1e-6)).all()
    np.testing.assert_array_equal(got[lag:], np.array(want)[:-lag])
    np.testing.assert_array_equal(last, want[-1])
    for t in range(lag):
        np.testing.assert_array_equal(got[t], hold)


@pytest.mark.gpu
def test_compensated_bridge_on_card(cuda_device):
    """Bridge mode with compensation at lag 2 (the graphed solve with its
    in-flight queue, measured states through pinned staging): the stream
    is the eager compensated solve's, run by hand from the same states and
    normals with the queue primed from the placeholder, two ticks late,
    bit for bit; after a drain the queue is primed again."""
    from opendog_tpu_torch.physics import State, make_state
    from opendog_tpu_torch.solvers import RealtimeController, mpc, mppi
    m, cost = _go1_trot(cuda_device)
    cfg, lag = _bench_config(), 2
    normals = _normals(8, cfg, m.nu, cuda_device)
    plant = mpc._make_plant_step(m, 10, cuda_device)
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1])
    st, states = make_state(m, "home"), []
    for _ in range(len(normals)):
        states.append((st.qpos.cpu().numpy(), st.qvel.cpu().numpy(),
                       float(st.time)))
        st = plant(st, hold)
    solve_c = mpc._compensated_solver(
        mppi.make_solver(m, cost, cfg, device=cuda_device), plant, lag)
    rtc = RealtimeController(m, cost, cfg, lag=lag, plant_substeps=10,
                             compensate=True, device=cuda_device)
    ms, last = mppi.init_state(m, cfg), hold.cpu().numpy()
    for part in (slice(0, 5), slice(5, None)):  # a drain in between
        got = np.array([rtc.bridge_tick(*s, normals=n)
                        for s, n in zip(states[part], normals[part])])
        queue = torch.from_numpy(np.tile(last[None], (lag, 1))).to(
            cuda_device)
        want = []
        for (q, v, t), n in zip(states[part], normals[part]):
            s = State(qpos=torch.from_numpy(q).to(cuda_device),
                      qvel=torch.from_numpy(v).to(cuda_device),
                      time=torch.full((), t, device=cuda_device))
            ctrl, ms, stats = solve_c(s, ms, None, n, queue)
            queue = stats["queue"]
            want.append(ctrl.cpu().numpy())
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got[lag:], np.array(want)[:-lag])
        last = rtc.drain()
        np.testing.assert_array_equal(last, want[-1])


# -- the op-graph step and the op-graph engine on the card ------------------

@pytest.mark.gpu
def test_op_step_on_card_matches_cpu_and_kernel(cuda_device):
    """``dynamics.step`` on the card, on chip_smoke.py's random Go1 states
    at K=256 with one 2 ms substep: against the same step on the CPU on the
    same inputs (1e-4 qpos, 1e-3 qvel) and against the flat kernel K1 (the
    cross-engine tolerance of tests/test_pallas_core.py:59-75: 1e-4 qpos,
    5e-3 qvel)."""
    from opendog_tpu_torch.physics import State, dynamics
    m = load_go1("flat", device=cuda_device)
    mc = m.to("cpu")
    rows = random_batch(m, 256)
    qp, qv, ct = (torch.from_numpy(a.T.copy()) for a in rows)
    st = State(qpos=qp, qvel=qv, time=torch.zeros(256))
    want, _ = dynamics.step(mc, st, ct)
    got, info = dynamics.step(m, State(qpos=qp.to(cuda_device),
                                       qvel=qv.to(cuda_device),
                                       time=torch.zeros(256,
                                                        device=cuda_device)),
                              ct.to(cuda_device))
    np.testing.assert_allclose(got.qpos.cpu().numpy(), want.qpos.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.qvel.cpu().numpy(), want.qvel.numpy(),
                               rtol=0, atol=1e-3)
    kern = cuda_step.build_cuda_substep(m, m.timestep, 1, device=cuda_device)
    kq, kv = kern(*(torch.from_numpy(a).to(cuda_device) for a in rows))
    np.testing.assert_allclose(got.qpos.cpu().numpy(), kq.T.cpu().numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.qvel.cpu().numpy(), kv.T.cpu().numpy(),
                               rtol=0, atol=5e-3)
    assert torch.isfinite(info.contact.force_world).all()


@pytest.mark.gpu
def test_graph_ops_solve_equals_eager(cuda_device):
    """An ``engine="ops"`` solve of Go1 standing on the jump box (box
    contact, K=256, H=25, 2 x 10 ms) replayed from a CUDA graph equals the
    eager solve bit for bit on the same normals, and launches no kernel of
    the substep family."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import MPPIConfig, costs, graph_solve, mppi
    m = load_go1("jump", device=cuda_device)
    cost = costs.standing_cost(m, 0.265 + 0.18, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.12, temperature=0.3,
                     engine="ops")
    solve = mppi.make_solver(m, cost, cfg, device=cuda_device)
    st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
    st.qpos[0] += 1.0
    st.qpos[2] += 0.18
    normals = _normals(3, cfg, m.nu, cuda_device)
    gsolve = graph_solve(solve, st, ms0, normals[0])
    assert dict(gsolve.graph.launches) == {}
    ms_e = ms_g = ms0
    for n in normals:
        ce, ms_e, se = solve(st, ms_e, None, n)
        cg, ms_g, sg = gsolve(st, ms_g, None, n)
        assert torch.equal(ce, cg)
        assert torch.equal(ms_e.nominal, ms_g.nominal)
        assert torch.equal(se["best_cost"], sg["best_cost"])
        assert torch.isfinite(ce).all()


# -- whole-body iLQR on the card ----------------------------------------------

def _ilqr_trot_cycle(device, riccati, graphs):
    """Bench 3b in miniature: Go1 trotting under the contact schedule, 4
    stages of 2 x 2 ms substeps, 2 iterations, 3 tracked ticks of 2
    substeps, warm started from the gait reference."""
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.solvers import (ILQRConfig, costs,
                                           make_ilqr_tracker)
    m = load_go1("flat", device=device)
    home = m.key_qpos[0, 7:]
    pc = costs.TrotCostParams()
    cost = costs.contact_schedule_cost(m, costs.trot_schedule(pc), pc, home)
    cfg = ILQRConfig(horizon=4, n_substeps=2, rollout_dt=0.002,
                     iterations=2, riccati=riccati)
    cycle = make_ilqr_tracker(m, cost, cfg, track_ticks=3, plant_substeps=2,
                              u_ref_fn=costs.trot_gait_ref(m, pc, home),
                              device=device, graphs=graphs)
    st, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                          n_substeps=50)
    return cycle, st, m.key_ctrl[0][None].repeat(cfg.horizon, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("riccati", ["scan", "associative"])
def test_graph_ilqr_cycle_equals_eager(cuda_device, riccati):
    """Two replan + track cycles with every piece replayed from its CUDA
    graph equal two eager cycles bit for bit (the same kernels on the same
    inputs), and launch no kernel of the substep family."""
    runs = []
    for graphs in (False, True):
        cycle, st, U = _ilqr_trot_cycle(cuda_device, riccati, graphs)
        cuda_step.LAUNCHES.clear()
        outs = []
        for _ in range(2):
            st, U, traj = cycle(st, U)
            outs.append(dict(qpos=st.qpos.clone(), qvel=st.qvel.clone(),
                             U=U.clone(), **{k: v.clone() for k, v in
                                             cycle.stats.items()},
                             **{f"traj_{k}": v.clone()
                                for k, v in traj.items()}))
        assert dict(cuda_step.LAUNCHES) == {}
        runs.append(outs)
    for eager, graph in zip(*runs):
        for k in eager:
            assert torch.equal(eager[k], graph[k]), k
        assert torch.isfinite(eager["qpos"]).all()


@pytest.mark.gpu
def test_ilqr_solve_on_card_matches_cpu(cuda_device):
    """One solve (OpenDOG standing, 6 stages of 2 x 5 ms substeps, 2
    iterations: the CPU tests' solve) on the card against the same solve on
    the CPU: the same step size at each iteration, U 1e-4 and X 1e-3
    absolute, the costs 1e-4 relative, K_fb 1e-3 of its largest entry (the
    card's reductions round in other orders)."""
    from opendog_tpu_torch.physics import State, dynamics, make_state
    from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr
    cfg = ILQRConfig(horizon=6, n_substeps=2, rollout_dt=0.005, iterations=2)
    out = {}
    for dev in ("cpu", cuda_device):
        m = load_opendog("flat", device=dev)
        st, _ = dynamics.step(m.to("cpu"), make_state(m.to("cpu"), "home"),
                              m.key_ctrl[0].cpu(), n_substeps=200)
        qvel = st.qvel.clone()
        qvel[0] = 0.2
        solve = make_ilqr(m, costs.standing_cost(m, 0.0694,
                                                 m.key_qpos[0, 7:]),
                          cfg, device=dev, graphs=False)
        U0 = m.key_ctrl[0][None].repeat(cfg.horizon, 1) * 0.99
        U, X, stats = solve(State(qpos=st.qpos, qvel=qvel,
                                  time=torch.tensor(0.3)), U0)
        out[str(dev)] = dict(U=U.cpu(), X=X.cpu(),
                             **{k: v.cpu() for k, v in stats.items()})
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert card["pick_trace"].tolist() == cpu["pick_trace"].tolist()
    np.testing.assert_allclose(card["U"], cpu["U"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(card["X"], cpu["X"], rtol=0, atol=1e-3)
    for k in ("cost", "initial_cost", "cost_trace"):
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4)
    scale = float(cpu["K_fb"].abs().max())
    assert float((card["K_fb"] - cpu["K_fb"]).abs().max()) <= 1e-3 * scale


@pytest.mark.gpu
def test_graph_associative_solve_at_bench_horizon(cuda_device):
    """The associative Riccati pass captures at bench 3's horizon (51
    value-function blocks: batched solves that PyTorch would send to MAGMA,
    which a capture refuses, were it not for ``device.use_cusolver``), and
    the replayed one-iteration solve equals the eager one bit for bit."""
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr
    m = load_go1("flat", device=cuda_device)
    cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
    cfg = ILQRConfig(horizon=50, n_substeps=2, rollout_dt=0.01, iterations=1,
                     riccati="associative")
    st, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                          n_substeps=200)
    U0 = m.key_ctrl[0][None].repeat(cfg.horizon, 1)
    out = []
    for graphs in (False, True):
        U, X, stats = make_ilqr(m, cost, cfg, device=cuda_device,
                                graphs=graphs)(st, U0)
        out.append(dict(U=U, X=X, **stats))
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
    assert float(out[0]["cost"]) < float(out[0]["initial_cost"])


@pytest.mark.gpu
@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("K,dt,n", [(4096, 0.01, 2), (8, 0.002, 10)])
def test_distill_kernel_shapes_match_plain_on_card(cuda_device, K, dt, n,
                                                   with_payload):
    """K1 and K2 at the distiller's shapes: the batched expert over S x K =
    8 x 512 lanes at 2 x 10 ms, and the 8-scenario plant at 10 x 2 ms;
    equal to the plain version exactly."""
    m = load_go1("flat", device=cuda_device)
    qp, qv, ct = _random_rows(m, K, cuda_device)
    extra = {}
    if with_payload:
        extra["payload"] = torch.from_numpy(
            random_modes(m, K, False, True)[1]).to(cuda_device)
    kp, kv = cuda_step.build_cuda_substep(
        m, dt, n, device=cuda_device, with_payload=with_payload)(
            qp, qv, ct, **extra)
    pp, pv = cuda_step.build_plain_substep(m, dt, n, False, with_payload)(
        qp, qv, ct, **extra)
    torch.cuda.synchronize()
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


def _cmd_expert(cuda_device, K, H):
    """Go1's command setup with a smaller expert (the distiller's options:
    trot_cost_cmd, anchored to trot_gait_ref_cmd with anchor_w 15)."""
    from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup
    from opendog_tpu_torch.solvers import MPPIConfig
    setup = cmd_distill_setup("go1", engine="kernel", device=cuda_device)
    cfg = MPPIConfig(horizon=H, num_samples=K, n_substeps=2, rollout_dt=0.01,
                     noise_sigma=0.10, temperature=0.2)
    return setup._replace(mppi_config=cfg)


@pytest.mark.gpu
def test_graph_batched_solve_equals_eager(cuda_device):
    """The batched solver (S=3 scenarios of K=43: 129 lanes, a ragged last
    block) with payloads, commands and the anchor, replayed from a CUDA
    graph by graph_solve, equals the eager solve bit for bit on the same
    normals; one launch over all lanes per rollout step."""
    from opendog_tpu_torch.physics import State, make_state
    from opendog_tpu_torch.solvers import graph_solve, mppi
    S = 3
    setup = _cmd_expert(cuda_device, 43, 5)
    m, cfg = setup.model, setup.mppi_config
    solve = mppi.make_batched_solver(
        m, setup.cost, cfg, scenarios=S, device=cuda_device,
        with_payload=True, with_command=True, u_ref_fn=setup.u_ref,
        anchor_w=15.0)
    st = make_state(m, "home")
    states = State(qpos=st.qpos[None].repeat(S, 1),
                   qvel=torch.zeros(S, m.nv, device=cuda_device),
                   time=torch.tensor([0.0, 0.13, 0.37], device=cuda_device))
    payload = torch.tensor([0.0, 0.7, 1.4], device=cuda_device)
    cmds = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.0, 0.5],
                         [0.3, 0.0, -0.4]], device=cuda_device)
    ms0 = mppi.init_state(m, cfg, scenarios=S)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    normals = torch.randn((3, S, cfg.num_samples, cfg.horizon, m.nu),
                          generator=gen, device=cuda_device)
    gsolve = graph_solve(solve, states, ms0, normals[0], payload, cmds)
    assert dict(gsolve.graph.launches) == {
        cuda_step.launch_key(S * cfg.num_samples, 2, False, True):
        cfg.horizon}
    ms_e = ms_g = ms0
    for n in normals:
        ce, ms_e, se = solve(states, ms_e, None, n, payload, cmds)
        cg, ms_g, sg = gsolve(states, ms_g, None, n, payload, cmds)
        assert torch.equal(ce, cg)
        assert torch.equal(ms_e.nominal, ms_g.nominal)
        for k in se:
            assert torch.equal(se[k], sg[k]), k
        ms_g = mppi.MPPIState(nominal=ms_g.nominal.clone())


@pytest.mark.gpu
@pytest.mark.parametrize("payload", [False, True])
def test_graph_collect_tick_equals_eager(cuda_device, payload):
    """The distiller's collect tick (batched expert, student, mix, label,
    plant) replayed from one CUDA graph equals the eager tick bit for bit
    on the same injected normals and drive masks; 5 + 1 launches per
    tick."""
    from opendog_tpu_torch.physics import State, make_state
    from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
    from opendog_tpu_torch.solvers import mppi
    S, T = 4, 3
    setup = _cmd_expert(cuda_device, 32, 5)
    m, cfg = setup.model, setup.mppi_config
    dcfg = DistillConfig(num_scenarios=S, rollout_ticks=T, lr=1e-3,
                         batch_size=8, epochs_per_round=1)
    kw = dict(plant_substeps=10, action_ref_fn=setup.u_ref,
              with_prev_ctrl=True, command_dim=3, anchor_w=15.0,
              payload_range=(0.0, 1.5) if payload else None,
              device=cuda_device)
    st = make_state(m, "home")
    plants = State(qpos=st.qpos[None].repeat(S, 1),
                   qvel=torch.zeros(S, m.nv, device=cuda_device),
                   time=torch.zeros(S, device=cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    normals = torch.randn((T, S, cfg.num_samples, cfg.horizon, m.nu),
                          generator=gen, device=cuda_device)
    drive = torch.rand((T, S, 1), generator=gen, device=cuda_device) < 0.5
    cmds = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.0, 0.0], [0.3, 0.0, 0.4],
                         [0.25, 0.0, 0.0]], device=cuda_device)
    aux = dict(commands=cmds)
    if payload:
        aux["payloads"] = torch.tensor([0.0, 0.5, 1.0, 1.5],
                                       device=cuda_device)
    out, params = {}, None
    for graphs in (True, False):
        d = make_distiller(m, setup.cost, setup.obs_fn, setup.net, cfg,
                           dcfg, graphs=graphs, **kw)
        dstate = d.init(torch.Generator(device=cuda_device).manual_seed(0),
                        st, params=params)
        params = dstate.params
        for _ in range(2):  # the first graph call captures
            trace = {}
            before = collections.Counter(cuda_step.LAUNCHES)
            p2, ms2, _, obs, labels = d.collect(
                dstate, plants, mppi.init_state(m, cfg, scenarios=S), 0.5,
                normals=normals, drive=drive, trace=trace, **aux)
            torch.cuda.synchronize()
            launched = cuda_step.LAUNCHES - before
        assert dict(launched) == {
            cuda_step.launch_key(S * cfg.num_samples, 2, False, payload):
            cfg.horizon * T,
            cuda_step.launch_key(S, 10, False, payload): T}
        out[graphs] = dict(obs=obs, labels=labels, qpos=p2.qpos,
                           qvel=p2.qvel, nominal=ms2.nominal,
                           **{f"trace_{k}": v for k, v in trace.items()})
    for k in out[True]:
        assert torch.equal(out[True][k], out[False][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["walk", "sym"])
def test_graph_rollout_step_equals_eager(cuda_device, task):
    """A PPO chunk's rollout step replayed from its CUDA graph equals the
    eager step bit for bit on the same draws: every trajectory buffer,
    every env state field, the last observations (4 envs, 3 steps)."""
    from chip_smoke import ppo_pair_differences, ppo_rollout_pair
    pair = ppo_rollout_pair(torch, cuda_device, task, 4, 3)
    bad, n = ppo_pair_differences(torch, pair)
    assert not bad and n > 10, bad


@pytest.mark.gpu
def test_twin_graph_on_own_stream_equals_eager(cuda_device):
    """The DigitalTwin's advance, replayed from its CUDA graph on the
    twin's own stream, equals the eager op-graph step on the card bit for
    bit on the same angles; ``snapshot`` reads it to the host."""
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.sim2real.twin import DigitalTwin

    twin = DigitalTwin(load_opendog("flat"), device=cuda_device)
    assert twin._stream is not None
    rng = np.random.default_rng(0)
    st = make_state(twin.model, "home")
    for substeps in (10, 10, 2, 10):
        a = twin.cal.real_home_deg + rng.uniform(-10, 10, 8).astype(
            np.float32)
        st, _ = dynamics.step(twin.model, st, twin.real_angles_to_ctrl(a),
                              n_substeps=substeps)
        twin.mirror_once(a, substeps=substeps)
        snap = twin.snapshot()
        assert snap.qpos.device.type == "cpu"
        for k in ("qpos", "qvel", "time"):
            assert torch.equal(getattr(st, k).cpu(), getattr(snap, k)), k
    assert sorted(twin._graphs) == [2, 10]


@pytest.mark.gpu
def test_gait_replay_graphs_equal_eager(cuda_device):
    """replay_gait on the card (the 128- and 1-substep advances replayed
    from CUDA graphs) lands where eager single substeps do, bit for bit."""
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.sim2real import gait_designer as gd

    m = load_opendog("flat")
    _, sim, _ = gd.design_trot(m)
    got = gd.replay_gait(m, [130 * m.timestep, 3 * m.timestep], sim[1:3],
                         settle_steps=2, device=cuda_device)
    inv = np.argsort(gd.Calibration(m).model_actuator_index)
    st = make_state(m, "home")
    st, _ = dynamics.step(m, st, m.key_ctrl[0], None, n_substeps=2)
    for row, n in ((sim[1], 130), (sim[2], 3)):
        ctrl = torch.from_numpy(row[inv].copy()).to(cuda_device)
        for _ in range(n):
            st, _ = dynamics.step(m, st, ctrl, n_substeps=1)
    np.testing.assert_array_equal(got["trunk"][-1], st.qpos[:7].cpu().numpy())


@pytest.mark.gpu
def test_student_bridge_graph_equals_eager(cuda_device):
    """StudentBridge.act replays the command student from a CUDA graph:
    equal to the eager policy bit for bit on the card."""
    import os

    from opendog_tpu_torch.apps.mpc_bridge import StudentBridge
    from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup, load_student

    setup = cmd_distill_setup("opendog", engine="kernel", device=cuda_device)
    m = setup.model
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs", "distill_cmd_opendog",
        "student.msgpack")
    policy = load_student(path, setup, command_dim=3)
    sb = StudentBridge(m, policy, None, device=cuda_device)
    rng = np.random.default_rng(1)
    for i in range(3):
        q = m.numpy("key_qpos")[0] + rng.normal(0, 0.02, m.nq)
        v = rng.normal(0, 0.2, m.nv)
        sb.set_command(rng.uniform(-0.2, 0.2, 3))
        got = sb.act(q, v, 0.02 * i)
        want = policy(*(torch.as_tensor(np.asarray(a, np.float32)[None],
                                        device=cuda_device)
                        for a in (q, v, 0.02 * i, sb._prev, sb.cmd)))
        np.testing.assert_array_equal(got, want[0].cpu().numpy())
        sb._prev = got


@pytest.mark.gpu
def test_capture_survives_garbage_that_owns_a_graph(cuda_device):
    """An unreachable cycle that owns a captured graph, left for Python's
    cyclic collector, does not invalidate a later capture: GraphedTick
    holds the collector off while it captures (with the threshold at 1 a
    collection would otherwise run inside the capture and destroy the
    graph there)."""
    import gc

    from opendog_tpu_torch.solvers.graph import GraphedTick

    x = torch.ones(4, device=cuda_device)
    keep = [GraphedTick(lambda a: (a * 2,), (x,), cuda_device)]
    calls = [0]

    def fn(a):
        calls[0] += 1
        if calls[0] == 2:  # the captured call (the first is the warm-up)
            cycle = {"graph": keep.pop()}
            cycle["self"] = cycle
            del cycle
            junk = [[i] for i in range(100)]  # allocations: collector ticks
            del junk
        return (a + 1,)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = GraphedTick(fn, (x,), cuda_device)
        out = g(x)[0]
    finally:
        gc.set_threshold(*threshold)
    assert torch.equal(out.cpu(), torch.full((4,), 2.0))


@pytest.mark.gpu
def test_eval_capture_survives_garbage_that_owns_a_graph(cuda_device):
    """The same for the eval's step (``rl/evaluate.py::PolicyRollout``):
    its capture holds the collector off, so an unreachable cycle that owns
    a captured graph is not destroyed inside it (``chip_smoke.py``
    [ppo-policy] failed so once, after the PPO phases left their learners
    as cyclic garbage)."""
    import gc

    from opendog_tpu_torch.envs import WalkEnv
    from opendog_tpu_torch.rl.evaluate import PolicyRollout
    from opendog_tpu_torch.solvers.graph import GraphedTick

    env = WalkEnv(load_opendog("flat", device=cuda_device), frame_skip=2)
    x = torch.ones(4, device=cuda_device)
    keep = [GraphedTick(lambda a: (a * 2,), (x,), cuda_device)]
    calls = [0]

    def policy(obs):
        calls[0] += 1
        if calls[0] == 2:  # the captured call (the first is the warm-up)
            cycle = {"graph": keep.pop()}
            cycle["self"] = cycle
            del cycle
            junk = [[i] for i in range(100)]
            del junk
        return torch.zeros(obs.shape[0], env.action_dim, device=obs.device)

    run = PolicyRollout(env, policy, 3, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        metrics, physics, _ = run(env.draw_reset(gen, 1))
    finally:
        gc.set_threshold(*threshold)
    assert calls[0] == 2 and not keep
    assert torch.isfinite(physics.qpos).all()
    assert int(metrics["episode_len"]) >= 1


@pytest.mark.gpu
def test_nccl_world_size_1_sharded_solve_and_tick(cuda_device):
    """ROADMAP M14 on one card: an NCCL group of one rank.  The
    sample-sharded solve of bench_suite config 6 (Go1 flat trot, K=256, H=25,
    2 x 10 ms on K1) equals make_solver bit for bit on the same normals;
    the sharded make_mpc tick replayed from a CUDA graph, its NCCL
    all_reduce captured, equals the eager tick bit for bit with 26 launches
    per replay; a gloo group of the same rank cannot meet a graph path
    (graph_tick, graph_solve, RealtimeController raise)."""
    import socket

    import torch.distributed as dist

    from opendog_tpu_torch.parallel import (Mesh, initialize_distributed,
                                            sample_mesh)
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import (RealtimeController, graph_solve,
                                           graph_tick, make_mpc, mppi)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = sample_mesh(1)
        m, cost = _go1_trot(cuda_device)
        cfg = _bench_config()
        st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
        plain = mppi.make_solver(m, cost, cfg, device=cuda_device)
        sharded = mppi.make_solver(m, cost, cfg, mesh=mesh)
        for n in _normals(2, cfg, m.nu, cuda_device):
            a, b = plain(st, ms0, None, n), sharded(st, ms0, None, n)
            assert torch.equal(a[0], b[0])
            assert torch.equal(a[1].nominal, b[1].nominal)
            for k in a[2]:
                assert torch.equal(a[2][k], b[2][k]), k

        init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10, mesh=mesh)
        carry0 = init(torch.Generator(device=cuda_device).manual_seed(0), st)
        normals = _normals(3, cfg, m.nu, cuda_device)
        eager, carry = [], carry0
        for n in normals:
            carry, out = tick(carry, n)
            eager.append((out["ctrl"], carry.plant.qpos, carry.solver.nominal))
        gtick = graph_tick(tick, carry0, normals[0])
        assert sum(gtick.graph.launches.values()) == 26
        carry = carry0
        for n, want in zip(normals, eager):
            carry, out = gtick(carry, n)
            for a, b in zip((out["ctrl"], carry.plant.qpos,
                             carry.solver.nominal), want):
                assert torch.equal(a, b)

        gloo = Mesh(group=dist.new_group([0], backend="gloo"), axis="mp",
                    size=1, index=0, device=cuda_device)
        solve_g = mppi.make_solver(m, cost, cfg, mesh=gloo)
        _, tick_g, _ = make_mpc(m, cost, cfg, mesh=gloo)
        with pytest.raises(ValueError, match="gloo"):
            graph_solve(solve_g, st, ms0, normals[0])
        with pytest.raises(ValueError, match="gloo"):
            graph_tick(tick_g, carry0, normals[0])
        with pytest.raises(ValueError, match="gloo"):
            RealtimeController(m, cost, cfg, mesh=gloo)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_world_size_1_graphed_sharded_ilqr(cuda_device):
    """ROADMAP M14's horizon sharding on the CUDA default path: an NCCL
    group of one rank, ``make_ilqr(mesh=, graphs=True)`` at bench 3's
    horizon (Go1 standing, H=50, one iteration, associative Riccati), so
    that the Riccati piece's graph holds sharded_suffix_scan's two NCCL
    all_reduces.  Two solves (the capturing call and a replay) equal the
    unsharded graphed solve's bit for bit: U, X and every stat, the gains
    k_ff and K_fb among them."""
    import socket

    import torch.distributed as dist

    from opendog_tpu_torch.parallel import initialize_distributed, make_mesh
    from opendog_tpu_torch.physics import dynamics, make_state
    from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, "sp")
        m = load_go1("flat", device=cuda_device)
        cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
        cfg = ILQRConfig(horizon=50, n_substeps=2, rollout_dt=0.01,
                         iterations=1, riccati="associative")
        st, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                              n_substeps=200)
        U0 = m.key_ctrl[0][None].repeat(cfg.horizon, 1)
        plain = make_ilqr(m, cost, cfg, device=cuda_device, graphs=True)
        sharded = make_ilqr(m, cost, cfg, mesh=mesh, graphs=True)
        for _ in range(2):
            out = []
            for solve in (plain, sharded):
                U, X, stats = solve(st, U0)
                out.append(dict(U=U, X=X, **stats))
            for k in out[0]:
                assert torch.equal(out[0][k], out[1][k]), k
        assert float(out[0]["cost"]) < float(out[0]["initial_cost"])
    finally:
        dist.destroy_process_group()


def _perception_world(device):
    """OpenDOG's terrain scene on ``device`` and the generated terrain of
    generator seed 0 (a non-flat episode), on ``device`` and on the CPU."""
    from opendog_tpu_torch.physics import terrain as terrain_lib
    m = load_opendog("terrain", device=device)
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    return m, m.to("cpu"), terr, terr.to("cpu")


@pytest.mark.gpu
def test_render_depth_card_equals_cpu(cuda_device):
    """The ray march on the card against the CPU on the same poses (one and
    a batch): within 1e-5 m, the same NaN mask."""
    from opendog_tpu_torch.apps.slam import render_depth
    m, mc, terr, terr_c = _perception_world(cuda_device)
    poses = torch.tensor([[0.2, 0.1, 0.3], [0.3, -0.2, 0.2],
                          [-1.0, 0.7, 2.5]])
    got = render_depth(m, terr, poses.to(cuda_device)).cpu()
    want = render_depth(mc, terr_c, poses)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isfinite(want).all(-1).float().mean() > 0.8
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max() <= 1e-5
    one = render_depth(m, terr, poses[1].to(cuda_device)).cpu()
    assert torch.equal(torch.isnan(one), torch.isnan(got[1]))


@pytest.mark.gpu
def test_voxel_map_and_obstacles_card_equal_cpu(cuda_device):
    """Integer counts: equal exactly on the card and the CPU."""
    from opendog_tpu_torch.apps.mapping import VoxelMap, transform_points
    from opendog_tpu_torch.apps.obstacle import detect_obstacles
    from opendog_tpu_torch.apps.slam import render_depth
    m, _, terr, _ = _perception_world(cuda_device)
    vm = VoxelMap(device=cuda_device)
    vc = VoxelMap(device="cpu")
    for k in range(5):
        pose = (0.06 * k, 0.0, 0.05 * k)
        frame = render_depth(m, terr, pose)
        world = transform_points(frame, pose)
        vm = vm.integrate(world)
        vc = vc.integrate(world.cpu())
        c_card, n_card = detect_obstacles(frame)
        c_cpu, n_cpu = detect_obstacles(frame.cpu())
        assert torch.equal(n_card.cpu(), n_cpu)
        assert torch.equal(torch.isnan(c_card.cpu()), torch.isnan(c_cpu))
    assert vm.counts.device.type == "cuda"
    assert torch.equal(vm.counts.cpu(), vc.counts)
    assert int(vc.counts.sum()) > 100


@pytest.mark.gpu
def test_depth_cnn_forward_card_equals_cpu(cuda_device):
    """The same weights on cuDNN (TF32 off) and on the CPU: within 1e-4
    m."""
    from opendog_tpu_torch.apps.mono_depth import DepthCNN
    from opendog_tpu_torch.device import use_full_fp32
    use_full_fp32()
    net = DepthCNN(generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (12, 1, 24, 32)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = net.to(cuda_device)(x.to(cuda_device)).cpu()
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.gpu
def test_log_mel_card_equals_cpu(cuda_device):
    """The voice features on the card against the CPU within 1e-4 (the
    transform in float64 on both, the products in full float32), on a
    noise-free word (near-silent frames) and a noisy one."""
    from opendog_tpu_torch.apps import voice_frontend as vf
    for kw in (dict(f0=130.0, seed=17), dict(f0=125.0, noise=0.02, seed=1)):
        clip = vf.synthesize_word("perrito", **kw)
        got = vf.log_mel(clip, device=cuda_device)
        want = vf.log_mel(clip, device="cpu")
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4


@pytest.mark.gpu
def test_viewer_replayed_tick_equals_eager_tick(cuda_device):
    """The SimViewer's tick replayed from its CUDA graph against the same
    tick eager on the card: states and packets bit for bit, over a push
    and a set_state."""
    from opendog_tpu_torch.apps.viewer_cli import build_viewer
    graph = build_viewer("opendog", device=cuda_device)
    eager = build_viewer("opendog", device=cuda_device, graphs=False)
    try:
        for v in (graph, eager):
            v.pause()
        for step in range(3):
            if step == 1:
                for v in (graph, eager):
                    v.apply_wrench(force=(8.0, 0.0, 0.0), duration_s=0.04)
            if step == 2:
                q = graph.snapshot().qpos.numpy().copy()
                q[2] = 0.3
                for v in (graph, eager):
                    v.set_state(qpos=q)
            a, b = graph.step_once(2), eager.step_once(2)
            for f in ("qpos", "qvel", "time"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (step, f)
            assert graph._packet() == eager._packet()
        assert graph._graph is not None and eager._graph is None
    finally:
        graph.close()
        eager.close()


@pytest.mark.gpu
def test_cloning_graph_training_equals_eager(cuda_device):
    """train_cloned_policy's replayed steps against the same steps eager
    on the card (both with the capturable Adam): the same weights bit for
    bit after 50 steps."""
    from opendog_tpu_torch.apps import cloning
    draws = torch.from_numpy(np.random.default_rng(0).uniform(
        -30, 30, (50, 256, 1)).astype(np.float32)).to(cuda_device)
    nets = [cloning.train_cloned_policy(
        draws=draws, num_steps=50,
        generator=torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device, graphs=graphs) for graphs in (True, False)]
    for a, b in zip(*(n.parameters() for n in nets)):
        assert torch.equal(a, b)
