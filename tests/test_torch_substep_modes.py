"""The plane and payload modes of the port's substep (kernels K2-K4 and the
plane + payload instantiation) against the JAX package: its scalar core on
go1 and opendog, its Pallas kernel in interpret mode on mini, and its
op-graph step with exact bilinear contact on a ramp.  The properties of
tests/test_pallas_core.py:99-273 are held in the port, and the g++ build of
the kernels' arithmetic (csrc/substep_core.cuh) against the plain version
in every mode.  The kernels themselves are compared with the plain version
on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.ops import scalar_core as jax_scalar_core
from opendog_tpu.physics import State as JaxState
from opendog_tpu.physics import Terrain as JaxTerrain
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.utils.profiling import count_flops
from opendog_tpu_torch import assets
from opendog_tpu_torch.ops import build, cuda_step, scalar_core
from opendog_tpu_torch.physics import dynamics, terrain_from_numpy
from chip_smoke import random_batch, random_modes

torch.set_num_threads(1)

# plain version against a float32 reference of the same arithmetic (other
# rounding order or library sin / cos): max abs error, as for the flat mode
TIGHT = dict(qpos=1e-5, qvel=1e-4)
MODES = {  # name: (with_plane, with_payload)
    "plane": (True, False),
    "pergeom": ("per_geom", False),
    "payload": (False, True),
    "plane_payload": (True, True),
    "pergeom_payload": ("per_geom", True),
}
PORT = {"go1": lambda: assets.load_go1("flat", device="cpu"),
        "opendog": lambda: assets.load_opendog("flat", device="cpu"),
        "mini": lambda: assets.load_mini(device="cpu")}
JAX = {"go1": lambda: jax_assets.load_go1("flat"),
       "opendog": lambda: jax_assets.load_opendog("flat"),
       "mini": jax_assets.load_mini}


def _inputs(m, K, mode, seed=1):
    """(qpos, qvel, ctrl, plane or None, payload or None) numpy (rows, K):
    chip_smoke.py's random states with the feet on the ground, random
    planes near z = 0 and payloads U(0, 3) kg."""
    with_plane, with_payload = MODES[mode]
    plane, payload = random_modes(m, K, with_plane, with_payload, seed)
    return random_batch(m, K, seed, on_ground=True) + (plane, payload)


def _port_step(m, args, dt, mode, n=1):
    step = cuda_step.build_cuda_substep(m, dt, n, device="cpu",
                                        with_plane=MODES[mode][0],
                                        with_payload=MODES[mode][1])
    t = [None if a is None else torch.from_numpy(a) for a in args]
    qp, qv = step(*t)
    return qp.numpy(), qv.numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol["qpos"])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol["qvel"])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("robot", ["go1", "opendog"])
def test_plain_mode_matches_jax_scalar_core(robot, mode):
    """K=8, one substep at the model's timestep: the plain version against
    the JAX scalar core run eagerly, at the flat mode's tolerance."""
    jm, m = JAX[robot](), PORT[robot]()
    args = _inputs(m, 8, mode)
    sub = jax_scalar_core.build_substep(jm, jm.timestep,
                                        with_plane=MODES[mode][0],
                                        with_payload=MODES[mode][1])
    rows = lambda a: None if a is None else tuple(jnp.asarray(r) for r in a)
    plane = rows(args[3])
    payload = None if args[4] is None else jnp.asarray(args[4][0])
    with jax.disable_jit():
        qp, qv = sub(rows(args[0]), rows(args[1]), rows(args[2]), plane,
                     payload)
    want = (np.stack([np.asarray(r) for r in qp]),
            np.stack([np.asarray(r) for r in qv]))
    _close(_port_step(m, args, m.timestep, mode), want, TIGHT)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mini_plain_mode_matches_pallas_interpret(mode):
    """mini, K=8, one substep: against the JAX Pallas kernel in interpret
    mode, in each mode (the setup of the flat mode's test; mini's random
    states reach the 1e3 velocity clip, where two substeps put float32
    rounding of the two libraries above 1e-5)."""
    jm, m = JAX["mini"](), PORT["mini"]()
    args = _inputs(m, 8, mode, seed=3)
    with_plane, with_payload = MODES[mode]
    step = jax_pallas_step.build_pallas_substep(
        jm, jm.timestep, k_tile=8, n_substeps=1, interpret=True,
        with_plane=with_plane, with_payload=with_payload)
    qp, qv = step(*(None if a is None else jnp.asarray(a) for a in args))
    _close(_port_step(m, args, m.timestep, mode),
           (np.asarray(qp), np.asarray(qv)), TIGHT)


def test_plane_at_z0_equals_flat_and_a_lowered_plane_releases():
    """test_pallas_core.py:99-123 in the port: the plane z = 0 fed to the
    plane mode reproduces the flat mode (1e-5 qvel); the ground lowered
    0.5 m releases every contact and the base falls faster."""
    m = PORT["mini"]()
    K = 8
    qp, qv, ct = (torch.from_numpy(a) for a in random_batch(m, K, seed=3))
    flat = cuda_step.build_cuda_substep(m, m.timestep, device="cpu")
    planar = cuda_step.build_cuda_substep(m, m.timestep, device="cpu",
                                          with_plane=True)
    z0 = torch.tensor([0.0, 0.0, 1.0, 0.0])[:, None].repeat(1, K)
    qp_f, qv_f = flat(qp, qv, ct)
    qp_p, qv_p = planar(qp, qv, ct, z0)
    np.testing.assert_allclose(qv_p.numpy(), qv_f.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(qp_p.numpy(), qp_f.numpy(), rtol=0, atol=1e-5)
    lowered = torch.tensor([0.0, 0.0, 1.0, -0.5])[:, None].repeat(1, K)
    _, qv_r = planar(qp, qv, ct, lowered)
    assert float(qv_r[2].mean()) < float(qv_f[2].mean()) - 1e-3


@pytest.mark.parametrize("robot", ["mini", "opendog"])
def test_pergeom_with_equal_planes_equals_lane_plane(robot):
    """test_pallas_core.py:191-219 in the port: the same plane for every
    geom reproduces the per-lane plane mode (1e-5 qpos, 1e-4 qvel)."""
    m = PORT[robot]()
    K = 8
    qp, qv, ct = (torch.from_numpy(a)
                  for a in random_batch(m, K, seed=7, on_ground=True))
    lane = cuda_step.build_cuda_substep(m, m.timestep, device="cpu",
                                        with_plane=True)
    pg = cuda_step.build_cuda_substep(m, m.timestep, device="cpu",
                                      with_plane="per_geom")
    n = np.array([0.1, -0.05, 1.0])
    n = n / np.linalg.norm(n)
    row = np.array([n[0], n[1], n[2], -0.02], np.float32)
    lane_plane = torch.from_numpy(np.tile(row[:, None], (1, K)))
    pg_plane = torch.from_numpy(np.tile(np.tile(row, m.ngeom)[:, None],
                                        (1, K)))
    qp_l, qv_l = lane(qp, qv, ct, lane_plane)
    qp_g, qv_g = pg(qp, qv, ct, pg_plane)
    np.testing.assert_allclose(qp_g.numpy(), qp_l.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(qv_g.numpy(), qv_l.numpy(), rtol=0, atol=1e-4)


def test_payload_zero_equals_flat_and_heavy_reacts_less():
    """test_pallas_core.py:126-153 in the port: payload 0 is the flat mode
    (1e-5 qvel); in the air a 5 kg payload makes the base react less to the
    same torques."""
    m = PORT["mini"]()
    K = 8
    qpos, qvel, ctrl = random_batch(m, K, seed=5)
    qp, qv, ct = (torch.from_numpy(a) for a in (qpos, qvel, ctrl))
    flat = cuda_step.build_cuda_substep(m, m.timestep, device="cpu")
    loaded = cuda_step.build_cuda_substep(m, m.timestep, device="cpu",
                                          with_payload=True)
    zero = torch.zeros(1, K)
    _, qv_f = flat(qp, qv, ct)
    _, qv_0 = loaded(qp, qv, ct, payload=zero)
    np.testing.assert_allclose(qv_0.numpy(), qv_f.numpy(), rtol=0, atol=1e-5)
    air = qpos.copy()
    air[2] += 2.0  # no contact
    qp_a = torch.from_numpy(air)
    _, qv_l = loaded(qp_a, qv, ct, payload=zero)
    _, qv_h = loaded(qp_a, qv, ct, payload=torch.full((1, K), 5.0))
    dv_l = (qv_l[:6] - qv[:6]).abs().mean()
    dv_h = (qv_h[:6] - qv[:6]).abs().mean()
    assert dv_h < dv_l


def test_pergeom_plain_matches_exact_bilinear_step_on_ramp():
    """test_pallas_core.py:236-273 in the port: one substep of the per-geom
    plain version, fed the port's own planes, against the JAX op-graph step
    with exact bilinear contact on a linear ramp (where the per-geom planes
    are the surface): 1e-4 qpos, 1e-3 qvel."""
    half, n_cells, slope = 2.0, 9, 0.08
    jm = jax_assets.load_mini().replace(
        hfield_size=jnp.asarray([half, half, 1.0, 0.0], jnp.float32))
    m = PORT["mini"]().replace(hfield_size=torch.tensor([half, half, 1.0,
                                                         0.0]))
    xs = np.linspace(-half, half, n_cells, dtype=np.float32)
    height = np.tile(slope * xs[None, :], (n_cells, 1))
    jt = JaxTerrain(height=jnp.asarray(height))
    t = terrain_from_numpy(height, "cpu")
    K = 8
    rng = np.random.default_rng(2)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (K, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.01, (K, 3))
    qpos[:, 0] += rng.uniform(-1, 1, K)   # spread along the ramp
    qpos[:, 7:] += rng.normal(0, 0.05, (K, m.nq - 7))
    qvel = rng.normal(0, 0.2, (K, m.nv)).astype(np.float32)
    lo, hi = np.asarray(jm.actuator_ctrlrange).T
    ctrl = rng.uniform(lo, hi, (K, m.nu)).astype(np.float32)
    st = JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                  time=jnp.zeros(K))
    ref, _ = jax.jit(jax.vmap(
        lambda a, c: jax_dynamics.step(jm, a, c, jt, n_substeps=1)))(
        st, jnp.asarray(ctrl))
    planes = dynamics.geom_local_planes(m, t, torch.from_numpy(qpos))
    step = cuda_step.build_cuda_substep(m, m.timestep, device="cpu",
                                        with_plane="per_geom")
    qp, qv = step(torch.from_numpy(qpos.T.copy()),
                  torch.from_numpy(qvel.T.copy()),
                  torch.from_numpy(ctrl.T.copy()),
                  planes.reshape(K, -1).T.contiguous())
    np.testing.assert_allclose(qp.numpy().T, np.asarray(ref.qpos), atol=1e-4)
    np.testing.assert_allclose(qv.numpy().T, np.asarray(ref.qvel), atol=1e-3)


def _host_library():
    """g++ build of csrc/substep_core.cuh behind a host-only C shim (a
    test aid: no entry point of the package reaches it)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    built = build.build_library("substep_host", "substep_host.cpp", "g++",
                                build.GXX_FLAGS)
    lib = ctypes.CDLL(built.path)
    lib.substep_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    lib.substep_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("robot,dt,n,mode", [
    ("go1", 0.01, 2, "payload"),            # payload MPPI rollouts
    ("opendog", 0.01, 2, "plane"),          # trunk-plane terrain MPPI
    ("opendog", 0.01, 2, "pergeom"),        # per-geom terrain MPPI
    ("opendog", 0.002, 10, "pergeom"),      # terrain plant
    ("opendog", 0.002, 10, "plane_payload"),  # domain-randomised batch
    ("mini", 0.002, 1, "plane"),
    ("mini", 0.002, 1, "pergeom"),
    ("mini", 0.002, 1, "payload"),
    ("mini", 0.002, 1, "plane_payload"),
    ("opendog", 0.01, 2, "pergeom_payload"),  # per-geom terrain + payload
    ("mini", 0.002, 1, "pergeom_payload"),
])
def test_kernel_arithmetic_host_build_matches_plain(robot, dt, n, mode):
    """The kernels' substep arithmetic in each mode, compiled by g++,
    against the plain version on the same (rows, K) inputs, at the shapes
    of the paths that run each mode.  Tolerance: TIGHT plus four times
    what the plain version's own result moves, rollout by rollout, under
    a 1e-7 relative change of qvel.  g++'s sinf / cosf and PyTorch's may
    differ in the last bit, and contact states at 10 ms magnify one ulp
    (OpenDOG on a tilted plane: one rollout in eight moves by 8e-5)."""
    lib = _host_library()
    m = PORT[robot]()
    K = 8
    with_plane, with_payload = MODES[mode]
    args = [None if a is None else torch.from_numpy(a)
            for a in _inputs(m, K, mode)]
    plain = cuda_step.build_plain_substep(m, dt, n, with_plane, with_payload)
    want = plain(*args)
    nudged = plain(args[0], args[1] * (1 + 1e-7), *args[2:])
    spread = [(w - v).abs().max(dim=0).values for w, v in zip(want, nudged)]
    table = cuda_step.substep_table(m, dt)
    qp, qv, ct, plane, payload = args
    out_p, out_v = torch.empty_like(qp), torch.empty_like(qv)
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = lib.substep_host(ctypes.addressof(table), qp.data_ptr(),
                          qv.data_ptr(), ct.data_ptr(), ptr(plane),
                          ptr(payload), out_p.data_ptr(), out_v.data_ptr(),
                          K, n, cuda_step._PLANE_CODE[with_plane],
                          int(with_payload))
    assert rc == 0
    for name, got, ref, sp in zip(("qpos", "qvel"), (out_p, out_v), want,
                                  spread):
        err = (got - ref).abs().max(dim=0).values
        assert (err <= TIGHT[name] + 4 * sp).all(), (name, err, sp)


def test_step_checks_planes_and_payloads():
    """A plane passed to a flat step, a missing plane or payload, a wrong
    number of plane rows and an unknown mode all raise; per-geom planes
    with a payload need both; on the CPU no mode launches anything."""
    m = PORT["mini"]()
    K = 4
    qp, qv, ct = (torch.from_numpy(a) for a in random_batch(m, K))
    lane = torch.zeros(4, K)
    flat = cuda_step.build_cuda_substep(m, 0.002, device="cpu")
    with pytest.raises(ValueError, match="takes no plane"):
        flat(qp, qv, ct, lane)
    with pytest.raises(ValueError, match="takes no payload"):
        flat(qp, qv, ct, payload=torch.zeros(1, K))
    pg = cuda_step.build_cuda_substep(m, 0.002, device="cpu",
                                      with_plane="per_geom")
    with pytest.raises(ValueError, match="needs a plane"):
        pg(qp, qv, ct)
    with pytest.raises(ValueError, match="shape"):
        pg(qp, qv, ct, lane)
    loaded = cuda_step.build_cuda_substep(m, 0.002, device="cpu",
                                          with_payload=True)
    with pytest.raises(ValueError, match="needs a payload"):
        loaded(qp, qv, ct)
    with pytest.raises(ValueError, match="shape"):
        loaded(qp, qv, ct, payload=torch.zeros(2, K))
    with pytest.raises(ValueError, match="with_plane"):
        cuda_step.build_cuda_substep(m, 0.002, device="cpu",
                                     with_plane="trunk")
    pg_loaded = cuda_step.build_cuda_substep(m, 0.002, device="cpu",
                                             with_plane="per_geom",
                                             with_payload=True)
    assert pg_loaded.name == "substep_pergeom_payload"
    with pytest.raises(ValueError, match="needs a payload"):
        pg_loaded(qp, qv, ct, torch.zeros(4 * m.ngeom, K))
    before = dict(cuda_step.LAUNCHES)
    pg(qp, qv, ct, torch.zeros(4 * m.ngeom, K))
    pg_loaded(qp, qv, ct, torch.zeros(4 * m.ngeom, K), torch.zeros(1, K))
    assert dict(cuda_step.LAUNCHES) == before
    assert cuda_step.launch_key(256, 2, "per_geom") == \
        "substep_pergeom K=256 x2"
    assert cuda_step.launch_key(1, 10) == "substep_flat K=1 x10"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_op_count_of_each_mode_agrees_with_jax_static_count(mode):
    """The operation count behind each kernel's bound against the JAX
    package's static count of the same mode (utils/profiling.py), on mini:
    within 10%, as for the flat mode."""
    jm, m = JAX["mini"](), PORT["mini"]()
    with_plane, with_payload = MODES[mode]
    sub = jax_scalar_core.build_substep(jm, jm.timestep, with_plane,
                                        with_payload)
    row = lambda n: tuple(jnp.zeros(1) for _ in range(n))
    n_plane = scalar_core.plane_rows(m, with_plane)
    ref = count_flops(sub, row(jm.nq), row(jm.nv), row(jm.nu),
                      row(n_plane) if n_plane else None,
                      jnp.zeros(1) if with_payload else None)
    got = scalar_core.count_substep_ops(m, m.timestep, with_plane,
                                        with_payload)
    flat = scalar_core.count_substep_ops(m, m.timestep)
    assert abs(got - ref) <= 0.1 * ref, (got, ref)
    assert got > flat  # every mode does more than the flat substep
