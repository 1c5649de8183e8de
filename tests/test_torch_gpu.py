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
@pytest.mark.parametrize("path", ["flat", "per_geom", "trunk"])
def test_graph_tick_equals_eager_tick(cuda_device, path):
    """The make_mpc tick replayed from a CUDA graph equals the eager tick
    bit for bit on the same normals from the same carry (it replays the
    same kernels), and each replay counts one tick's launches: 25 rollout
    launches and one plant launch."""
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import graph_tick, make_mpc
    if path == "flat":
        m, cost = _go1_trot(cuda_device)
        cfg, extra = _bench_config(), {}
        s0 = make_state(m, "home")
    else:
        m, terr, cost = _dog_terrain(cuda_device)
        cfg = _bench_config(0.08)
        extra = dict(terrain=terr, terrain_plant="kernel", plane_mode=path)
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
    assert dict(gtick.graph.launches) == {
        cuda_step.launch_key(256, 2, rollout): 25,
        cuda_step.launch_key(1, 10, False if path == "flat" else "per_geom"):
        1}
    cuda_step.LAUNCHES.clear()
    carry = carry0
    for n, want in zip(normals, eager):
        carry, out = gtick(carry, n)
        got = [out[k] for k in keys] + [carry.solver.nominal]
        for k, a, b in zip(keys + ("nominal",), got, want):
            assert torch.equal(a, b), k
    torch.cuda.synchronize()
    assert dict(cuda_step.LAUNCHES) == {
        k: v * len(normals) for k, v in gtick.graph.launches.items()}


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
