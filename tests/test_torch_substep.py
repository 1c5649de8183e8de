"""The substep of the port (kernel K1 and its plain PyTorch version) against
the JAX package's scalar core, Pallas kernel and op-graph step.

On the CPU the port runs the plain version; the CUDA kernel's arithmetic
(csrc/substep_core.cuh) is also built with g++ through a host-only shim
and compared with the plain version.  The kernel itself is compared with
the plain version on the card by tests/test_torch_gpu.py (and by
chip_smoke.py).
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
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.utils.profiling import count_flops
from opendog_tpu_torch import assets
from opendog_tpu_torch.ops import build, cuda_step, scalar_core
# chip_smoke.py's random states near the home keyframe, (rows, K) numpy,
# built like tests/test_pallas_core.py::_random_batch
from chip_smoke import random_batch

torch.set_num_threads(1)

# kernel / plain version against a float32 reference of the same
# arithmetic (other rounding order or library sin/cos): max abs error
TIGHT = dict(qpos=1e-5, qvel=1e-4)


def _port_step(m, rows, dt, n=1):
    step = cuda_step.build_cuda_substep(m, dt, n, device="cpu")
    qp, qv = step(*(torch.from_numpy(a) for a in rows))
    return qp.numpy(), qv.numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol["qpos"])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol["qvel"])


def test_go1_plain_substep_matches_jax_scalar_core():
    """go1, K=8: the plain version against the JAX scalar core run
    eagerly (the pattern of test_pallas_core.py:59-75)."""
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    rows = random_batch(m, 8)
    sub = jax_scalar_core.build_substep(jm, jm.timestep)
    with jax.disable_jit():
        qp, qv = sub(*(tuple(jnp.asarray(r) for r in a) for a in rows))
    want = (np.stack([np.asarray(r) for r in qp]),
            np.stack([np.asarray(r) for r in qv]))
    _close(_port_step(m, rows, m.timestep), want, TIGHT)


def test_go1_plain_substep_matches_dynamics_step():
    """go1, K=8: against the op-graph step at the repo's tolerances
    (test_pallas_core.py:73-74: 1e-4 qpos, 5e-3 qvel)."""
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    qpos, qvel, ctrl = random_batch(m, 8)
    st = JaxState(qpos=jnp.asarray(qpos.T), qvel=jnp.asarray(qvel.T),
                  time=jnp.zeros(8))
    ref, _ = jax.jit(jax.vmap(
        lambda a, c: jax_dynamics.step(jm, a, c, n_substeps=1)))(
        st, jnp.asarray(ctrl.T))
    _close(_port_step(m, (qpos, qvel, ctrl), m.timestep),
           (np.asarray(ref.qpos).T, np.asarray(ref.qvel).T),
           dict(qpos=1e-4, qvel=5e-3))


def test_mini_plain_substep_matches_pallas_interpret():
    """mini, K=8: against the JAX Pallas kernel in interpret mode (the
    setup of test_pallas_core.py:82-96)."""
    jm = jax_assets.load_mini()
    m = assets.load_mini(device="cpu")
    rows = random_batch(m, 8)
    step = jax_pallas_step.build_pallas_substep(
        jm, jm.timestep, k_tile=8, n_substeps=1, interpret=True)
    qp, qv = step(*(jnp.asarray(a) for a in rows))
    _close(_port_step(m, rows, m.timestep),
           (np.asarray(qp), np.asarray(qv)), TIGHT)


def _host_library():
    """g++ build of csrc/substep_core.cuh behind a host-only C shim (a
    test aid: no entry point of the package reaches it)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    built = build.build_library("substep_host", "substep_host.cpp", "g++",
                                build.GXX_FLAGS)
    lib = ctypes.CDLL(built.path)
    lib.substep_model_size.restype = ctypes.c_int
    lib.substep_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    lib.substep_host.restype = ctypes.c_int
    assert lib.substep_model_size() == ctypes.sizeof(cuda_step.table_layout()[1])
    return lib


@pytest.mark.parametrize("robot,dt,n", [
    ("go1", 0.01, 2),    # the MPPI rollout step of the main path
    ("go1", 0.002, 10),  # the plant step of the main path
    ("mini", 0.002, 1),
])
def test_kernel_arithmetic_host_build_matches_plain(robot, dt, n):
    """The kernel's substep arithmetic, compiled by g++, against the plain
    version on the same (rows, K) inputs."""
    lib = _host_library()
    m = (assets.load_go1("flat", device="cpu") if robot == "go1"
         else assets.load_mini(device="cpu"))
    K = 8
    qp, qv, ct = (torch.from_numpy(a) for a in random_batch(m, K))
    want = cuda_step.build_plain_substep(m, dt, n)(qp, qv, ct)
    table = cuda_step.substep_table(m, dt)
    out_p, out_v = torch.empty_like(qp), torch.empty_like(qv)
    rc = lib.substep_host(ctypes.addressof(table), qp.data_ptr(),
                          qv.data_ptr(), ct.data_ptr(), out_p.data_ptr(),
                          out_v.data_ptr(), K, n)
    assert rc == 0
    _close((out_p.numpy(), out_v.numpy()),
           (want[0].numpy(), want[1].numpy()), TIGHT)


def test_cpu_step_runs_plain_version_without_launching():
    m = assets.load_mini(device="cpu")
    args = tuple(torch.from_numpy(a) for a in random_batch(m, 4))
    before = dict(cuda_step.LAUNCHES)
    step = cuda_step.build_cuda_substep(m, 0.004, 2, device="cpu")
    got = step(*args)
    want = cuda_step.build_plain_substep(m, 0.004, 2)(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dict(cuda_step.LAUNCHES) == before


def test_step_rejects_what_the_kernel_does_not_take():
    m = assets.load_mini(device="cpu")
    step = cuda_step.build_cuda_substep(m, 0.002, device="cpu")
    qp, qv, ct = (torch.from_numpy(a) for a in random_batch(m, 4))
    with pytest.raises(ValueError, match="float32"):
        step(qp.double(), qv, ct)
    with pytest.raises(ValueError, match="shape"):
        step(qp[:3], qv, ct)
    with pytest.raises(ValueError, match="contiguous"):
        step(qp, qv, ct.T.contiguous().T)
    with pytest.raises(ValueError, match="is on"):
        step(qp, qv, ct.to("meta"))
    with pytest.raises(ValueError, match="SC_NG_MAX"):
        cuda_step.substep_table(m.replace(ngeom=97), 0.002)
    with pytest.raises(NotImplementedError, match="K2-K4"):
        scalar_core.build_substep(m, 0.002, with_plane=True)


def test_cuda_step_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = assets.load_mini(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_step.build_cuda_substep(m, 0.002)


def test_row_layout_helpers_match_jax():
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    rows = cuda_step.rows_from_batch(torch.from_numpy(a))
    assert rows.is_contiguous()
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jax_pallas_step.rows_from_batch(a)))
    np.testing.assert_array_equal(cuda_step.batch_from_rows(rows).numpy(), a)


def test_op_count_agrees_with_jax_static_count():
    """The operation count behind the kernel's roofline bound against the
    JAX package's static count of the same substep (utils/profiling.py),
    on mini: within 10% (the two count comparisons and selects a little
    differently)."""
    jm = jax_assets.load_mini()
    m = assets.load_mini(device="cpu")
    sub = jax_scalar_core.build_substep(jm, jm.timestep)
    row = lambda n: tuple(jnp.zeros(1) for _ in range(n))
    ref = count_flops(sub, row(jm.nq), row(jm.nv), row(jm.nu))
    got = scalar_core.count_substep_ops(m, m.timestep)
    assert abs(got - ref) <= 0.1 * ref, (got, ref)
