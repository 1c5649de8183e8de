"""The rollouts' tracking-cost kernel on the CPU: its host build
(csrc/substep_host.cpp's ``tracking_cost_host``, the body of
``rollout_tracking_cost`` in csrc/substep_kernel.cu) against the op path,
``costs.tracking_cost``'s closure on the carry's (rows, L) layout, and the
dispatch of ``solvers/mppi.py``, which picks the kernel for a tagged
tracking cost on CUDA alone.  The kernel itself is compared with the op path
on the card by tests/test_torch_gpu.py.

The host build and the op path differ in two named places only: the host's
atan2f / asinf are libm's where the op path's on the CPU are PyTorch's
(Sleef), and its two sums over an axis add their terms in the order of
PyTorch's CUDA reduction where the CPU's add them in sequence.  With libm's
roll and pitch and the card's order put into the op path
(``_card_order``), the two agree bit for bit, NaN, Inf, the clamp of
sin(pitch), a discount and the running total included; the op path as it is
on the CPU lies within 4 ulp of the host build (relative 1e-6 below).
"""
import ctypes
import shutil

import pytest
import torch

from opendog_tpu_torch.assets import load_go1, load_opendog
from opendog_tpu_torch.ops import build, cuda_step
from opendog_tpu_torch.physics import State, make_state, spatial
from opendog_tpu_torch.physics import terrain as terrain_lib
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_solver, mppi

torch.set_num_threads(1)

L = 512
ROBOTS = {"opendog": (load_opendog, 0.0694), "go1": (load_go1, 0.265)}


@pytest.fixture(scope="module")
def host_lib():
    """g++ build of csrc/substep_host.cpp (a test aid: no entry point of
    the package reaches it), shared with tests/test_torch_substep_warp.py."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    built = build.build_library("substep_host", "substep_host.cpp", "g++",
                                build.GXX_FLAGS)
    lib = ctypes.CDLL(built.path)
    lib.tracking_cost_size.restype = ctypes.c_int
    lib.tracking_cost_host.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.tracking_cost_host.restype = ctypes.c_int
    return lib


def _host(lib, table, qp, qv, ctrl, prev, disc, total=None):
    """``TrackingCostKernel``'s call on the host build."""
    out = torch.empty(qp.shape[1]) if total is None else total
    assert lib.tracking_cost_host(
        ctypes.addressof(table), qp.data_ptr(), qv.data_ptr(),
        ctrl.data_ptr(), prev.data_ptr(), out.data_ptr(), qp.shape[1],
        disc, int(total is not None)) == 0
    return out


class _HostCost:
    """``cuda_step.TrackingCostKernel`` on the host build, for the CPU
    solve: the same call, counted in ``COST_LAUNCHES``."""
    lib = None

    def __init__(self, model, params, home, device):
        self.table = cuda_step.tracking_cost_table(model, params, home)

    def __call__(self, qpos, qvel, ctrl, prev, disc, total=None):
        cuda_step.COST_LAUNCHES[cuda_step.cost_launch_key(
            qpos.shape[1])] += 1
        return _host(self.lib, self.table, qpos, qvel, ctrl, prev, disc,
                     total)


_LIBM = ctypes.CDLL("libm.so.6")
_LIBM.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
_LIBM.atan2f.restype = ctypes.c_float
_LIBM.asinf.argtypes = [ctypes.c_float]
_LIBM.asinf.restype = ctypes.c_float


def _libm_roll_pitch(quat):
    """``spatial.euler_from_quat``'s roll and pitch with libm's atan2f and
    asinf (its yaw feeds no term of the tracking cost)."""
    q0, q1, q2, q3 = quat.unbind(-1)
    a = 2 * (q0 * q1 + q2 * q3)
    b = 1 - 2 * (q1 * q1 + q2 * q2)
    s = torch.clamp(2 * (q0 * q2 - q3 * q1), -1.0, 1.0)
    roll = torch.tensor([_LIBM.atan2f(x, y)
                         for x, y in zip(a.tolist(), b.tolist())])
    pitch = torch.tensor([_LIBM.asinf(x) for x in s.tolist()])
    return roll, pitch, torch.full_like(roll, float("nan"))


def _card_sum_sq(x):
    """``costs._sq_sum`` in the order of PyTorch's CUDA reduction: four
    accumulators a thread, and over the fastest axis a row of w threads and
    a shuffle tree at descending offsets (csrc/tracking_cost.cuh)."""
    sq = torch.square(x)
    n = sq.shape[-1]
    terms = sq.unbind(-1)
    zero = torch.zeros_like(terms[0])

    def four(ts):
        acc = [zero] * 4
        for j, t in enumerate(ts):
            acc[j % 4] = acc[j % 4] + t
        return ((acc[0] + acc[1]) + acc[2]) + acc[3]

    if sq.stride(-1) != 1:
        return four(terms)
    w = 1
    while 2 * w <= min(n, 32):
        w *= 2
    part = [four(terms[t::w]) for t in range(w)]
    off = w // 2
    while off > 0:
        for t in range(off):
            part[t] = part[t] + part[t + off]
        off //= 2
    return part[0]


@pytest.fixture
def _card_order(monkeypatch):
    monkeypatch.setattr(spatial, "euler_from_quat", _libm_roll_pitch)
    monkeypatch.setattr(costs, "_sq_sum", _card_sum_sq)


def _states(model, seed):
    """(qpos (nq, L), qvel (nv, L), candidates (L, 3, nu)) around the home
    keyframe, the rows as the substep kernels lay them out; lanes 0-31 with
    a quaternion scaled by 1.5 (|sin(pitch)| > 1 in some: the clamp), lane
    40 NaN in its height, lane 41 NaN in its quaternion, lane 42 an Inf
    velocity, lane 43 a NaN control."""
    g = torch.Generator().manual_seed(seed)
    qp = model.key_qpos[0][:, None].repeat(1, L)
    qp = qp + 0.3 * torch.randn(model.nq, L, generator=g)
    qp[3:7, :32] *= 1.5
    qv = torch.randn(model.nv, L, generator=g)
    cand = torch.randn(L, 3, model.nu, generator=g)
    qp[2, 40] = qp[4, 41] = float("nan")
    qv[0, 42] = float("inf")
    cand[43, 1, 0] = float("nan")
    return qp.contiguous(), qv.contiguous(), cand


def _op_path(cost, qp, qv, cand, h, disc, total=None):
    """The rollouts' op path at step h: the closure on the carry's view,
    times disc, added to total (rollout_costs_kernel before the kernel)."""
    st = State(qpos=qp.T, qvel=qv.T, time=torch.zeros(qp.shape[1]))
    c = cost(st, cand[:, h], cand[:, max(h - 1, 0)]) * disc
    return c if total is None else total + c


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_host_cost_is_the_op_path_bit_for_bit(host_lib, _card_order, robot):
    load, height = ROBOTS[robot]
    m = load("flat", device="cpu")
    cost = costs.standing_cost(m, height, m.key_qpos[0, 7:])
    table = cuda_step.tracking_cost_table(m, *cost.tracking)
    assert host_lib.tracking_cost_size() == ctypes.sizeof(table)
    qp, qv, cand = _states(m, 0)
    rows = cand.permute(1, 2, 0).contiguous()
    sinp = 2 * (qp[3] * qp[5] - qp[6] * qp[4])
    assert (sinp.abs() > 1).sum() >= 4
    want = got = None
    for h, disc in enumerate((1.0, 0.9, 0.81)):   # gamma = 0.9
        qp_h = qp + 0.01 * h
        want = _op_path(cost, qp_h, qv, cand, h, disc, want)
        got = _host(host_lib, table, qp_h, qv, rows[h], rows[max(h - 1, 0)],
                    disc, got)
    assert torch.isnan(got[[40, 41, 43]]).all() and torch.isinf(got[42])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_host_cost_is_the_cpu_op_path_within_ulps(host_lib, robot):
    """The op path as it runs on the CPU (Sleef's trigonometry, sequential
    sums) against the host build: within 4 ulp of every lane's cost."""
    load, height = ROBOTS[robot]
    m = load("flat", device="cpu")
    params = costs.TrackingCostParams(desired_vel_xy=(0.3, -0.1),
                                      desired_yaw_rate=0.2,
                                      target_height=height)
    cost = costs.tracking_cost(m, params, m.key_qpos[0, 7:])
    table = cuda_step.tracking_cost_table(m, *cost.tracking)
    qp, qv, cand = _states(m, 1)
    rows = cand.permute(1, 2, 0).contiguous()
    want = _op_path(cost, qp, qv, cand, 1, 1.0)
    got = _host(host_lib, table, qp, qv, rows[1], rows[0], 1.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0,
                               equal_nan=True)


def test_the_tag_names_the_closures_own_constants():
    m = load_opendog("flat", device="cpu")
    home = m.key_qpos[0, 7:]
    cost = costs.standing_cost(m, 0.0694, home)
    params, home_j = cost.tracking
    assert params.target_height == 0.0694 and params.w_vel == 20.0
    assert torch.equal(home_j, home)
    table = cuda_step.tracking_cost_table(m, params, home_j)
    assert (table.nq, table.nv, table.nu) == (m.nq, m.nv, m.nu)
    assert list(table.home_j)[:m.nq - 7] == home.tolist()
    with pytest.raises(ValueError, match="nq - 7"):
        cuda_step.tracking_cost_table(m, params, home[:3])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step.TrackingCostKernel(m, params, home_j, "cpu")


def test_only_a_tagged_cost_on_cuda_without_a_command_takes_the_kernel():
    m = load_go1("flat", device="cpu")
    home = m.key_qpos[0, 7:]
    trot = costs.TrotCostParams()
    standing = costs.standing_cost(m, 0.265, home)
    cuda = torch.device("cuda", 0)
    assert mppi.takes_cost_kernel(standing, False, cuda)
    assert mppi.takes_cost_kernel(standing, False, "cuda")
    assert not mppi.takes_cost_kernel(standing, False, "cpu")
    assert not mppi.takes_cost_kernel(standing, True, cuda)
    sched = costs.trot_schedule(trot)
    for other in (costs.trot_cost(m, trot, home),
                  costs.trot_cost_cmd(m, trot, home),
                  costs.contact_schedule_cost(m, sched, trot, home),
                  lambda st, c, p: standing(st, c, p)):
        assert not mppi.takes_cost_kernel(other, False, cuda)


def _solve(model, cost, terr, seed=0):
    """One CPU solve of OpenDOG on rough terrain (trunk planes, K3's plain
    version), gamma 0.9, with a terminal cost of the final time and
    height: (ctrl, nominal, stats)."""
    cfg = MPPIConfig(horizon=3, num_samples=8, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.08, gamma=0.9)
    solve = make_solver(model, cost, cfg, device="cpu", terrain=terr,
                        terminal_cost=lambda st: st.time + st.qpos[:, 2])
    st = make_state(model, "home")
    st.qpos[2] += 0.05
    normals = torch.randn((8, 3, model.nu),
                          generator=torch.Generator().manual_seed(seed))
    ctrl, ms, stats = solve(st, mppi.init_state(model, cfg), None, normals)
    return [ctrl, ms.nominal] + [stats[k] for k in sorted(stats)]


def test_the_kernel_path_of_a_solve_is_the_op_path(host_lib, _card_order,
                                                   monkeypatch):
    """A solve whose rollouts take the cost kernel (its host build standing
    in on the CPU: one call a control step, the previous step's control
    rows, the discount, the running total, the terminal cost at the final
    time) computes the op path's bits."""
    m = load_opendog("terrain", device="cpu")
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    cost = costs.standing_cost(m, 0.12, m.key_qpos[0, 7:])
    want = _solve(m, cost, terr)
    _HostCost.lib = host_lib
    monkeypatch.setattr(mppi, "TrackingCostKernel", _HostCost)
    monkeypatch.setattr(mppi, "takes_cost_kernel", lambda *a: True)
    cuda_step.COST_LAUNCHES.clear()
    got = _solve(m, cost, terr)
    assert dict(cuda_step.COST_LAUNCHES) == {
        cuda_step.cost_launch_key(8): 3}
    cuda_step.COST_LAUNCHES.clear()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
