"""The port's ``dynamics.step`` against physics and the MuJoCo oracle: the
checks of tests/test_dynamics.py on the port (the golden settles
``tests/golden/{go1,opendog}_settle.npz`` at the same tolerances, free fall,
the pendulum's period and energy, the standing weight support, landing on
the jump box, a positive definite mass matrix), and the cross-engine check
of tests/test_pallas_core.py:59-75: the op-graph step against the port's
plain substep (``ops/scalar_core.py``, the CUDA kernels' plain version) on
random Go1 states.

This file imports no JAX.
"""
import functools

import numpy as np
import torch

from opendog_tpu_torch.assets import load_go1, load_opendog
from opendog_tpu_torch.ops.cuda_step import build_plain_substep
from opendog_tpu_torch.physics import State, dynamics, load_model, make_state
from chip_smoke import random_batch

torch.set_num_threads(1)

PENDULUM = """
<mujoco>
  <option gravity="0 0 -9.81" timestep="0.001"/>
  <worldbody>
    <body name="link" pos="0 0 1">
      <inertial mass="1" pos="0 0 -0.5" diaginertia="1e-6 1e-6 1e-6"/>
      <joint name="pivot" type="hinge" axis="0 1 0" pos="0 0 0"/>
    </body>
  </worldbody>
</mujoco>
"""


@functools.lru_cache(maxsize=None)
def _settle(robot, n_ctrl_steps=50, substeps=10):
    """50 ticks of 10 substeps holding the home control from the home
    keyframe (tests/test_dynamics.py::_settle): (qpos per tick, last state,
    last StepInfo)."""
    m = (load_go1 if robot == "go1" else load_opendog)("flat", device="cpu")
    state = make_state(m, "home")
    ctrl = m.key_ctrl[0]
    traj = []
    for _ in range(n_ctrl_steps):
        state, info = dynamics.step(m, state, ctrl, n_substeps=substeps)
        traj.append(state.qpos.numpy().copy())
    return np.array(traj), state, info


def test_opendog_settle_matches_mujoco_golden():
    """tests/test_dynamics.py:68-81: final trunk height within 3 mm, joint
    angles within 0.01 rad, trunk height at 0.2 s and 0.4 s within 1 cm."""
    gold = np.load("tests/golden/opendog_settle.npz")["qpos"]
    traj, _, _ = _settle("opendog")
    assert abs(traj[-1][2] - gold[-1][2]) < 3e-3
    np.testing.assert_allclose(traj[-1][7:], gold[-1][7:], atol=1e-2)
    assert abs(traj[9][2] - gold[99][2]) < 1e-2
    assert abs(traj[19][2] - gold[199][2]) < 1e-2


def test_go1_settle_matches_mujoco_golden():
    """tests/test_dynamics.py:84-89: final trunk height within 3 mm, joint
    angles within 0.01 rad."""
    gold = np.load("tests/golden/go1_settle.npz")["qpos"]
    traj, _, _ = _settle("go1")
    assert abs(traj[-1][2] - gold[-1][2]) < 3e-3
    np.testing.assert_allclose(traj[-1][7:], gold[-1][7:], atol=1e-2)


def test_standing_contact_forces_support_weight():
    """The settled OpenDOG's feet carry its weight within 5%, every foot in
    contact (tests/test_dynamics.py:92-99), through
    ``foot_contact_summary`` of the last step's contact."""
    m = load_opendog("flat", device="cpu")
    _, _, info = _settle("opendog")
    fw, fb, ic = dynamics.foot_contact_summary(m, info.contact)
    total_fz = float(fw[:, 2].sum())
    weight = float(m.body_mass.sum()) * 9.81
    assert abs(total_fz - weight) / weight < 0.05
    assert bool(ic.all())
    assert fb.shape == fw.shape == (len(m.foot_body), 3)


def test_freefall_acceleration():
    """With no ground, the base accelerates at -g (tests/test_dynamics.py:
    56-65), to 0.2 m/s^2."""
    m = load_opendog("none", device="cpu")
    s = make_state(m, "home")
    qvel2, _ = dynamics.forward(m, s.qpos, s.qvel, m.key_ctrl[0],
                                dt=m.timestep)
    qacc = ((qvel2 - s.qvel) / m.timestep).numpy()
    assert abs(qacc[2] + 9.81) < 0.2
    assert abs(qacc[0]) < 0.2 and abs(qacc[1]) < 0.2


def test_pendulum_period_and_energy():
    """Point-mass pendulum (no free joint: the dense solve): period
    2 pi sqrt(L/g) = 1.419 s within 0.05 s, amplitude kept within 1% over
    the last 2 s (tests/test_dynamics.py:33-53)."""
    m = load_model(PENDULUM, device="cpu")
    state = State(qpos=torch.tensor([0.1]), qvel=torch.zeros(1),
                  time=torch.zeros(()))
    ctrl = torch.zeros(0)
    qs = []
    for _ in range(420):  # 4.2 s at 0.01 s per control step
        state, _ = dynamics.step(m, state, ctrl, n_substeps=10)
        qs.append(float(state.qpos[0]))
    qs = np.array(qs)
    crossings = np.where((qs[:-1] > 0) & (qs[1:] <= 0))[0]
    assert len(crossings) >= 2
    period = (crossings[1] - crossings[0]) * 0.01
    assert abs(period - 1.419) < 0.05
    assert np.max(np.abs(qs[-200:])) > 0.99 * 0.1


def test_jump_scene_box_contact():
    """Go1 dropped over the jump scene's cube lands on it: trunk above the
    cube's top (0.18 m) and above 0.3 m after 60 ticks
    (tests/test_dynamics.py:124-138)."""
    m = load_go1("jump", device="cpu")
    s = make_state(m, "home")
    qpos = s.qpos.clone()
    qpos[0], qpos[2] = 1.0, 0.6
    state = State(qpos=qpos, qvel=s.qvel, time=torch.zeros(()))
    for _ in range(60):
        state, _ = dynamics.step(m, state, m.key_ctrl[0], n_substeps=10)
    z = float(state.qpos[2])
    assert 0.18 < z < 0.6
    assert z > 0.3


def test_mass_matrix_positive_definite():
    """Symmetric to 1e-5, positive definite, and the translational block is
    the total mass (to 1e-3) at the Go1 keyframe
    (tests/test_dynamics.py:141-153)."""
    m = load_go1("flat", device="cpu")
    s = make_state(m, "home")
    xpos, xquat = dynamics.fk(m, s.qpos)
    S = dynamics.motion_subspace(m, xpos, xquat, xpos[0])
    I_O = dynamics._spatial_inertias(m, xpos, xquat, xpos[0])
    M = dynamics.mass_matrix(m, S, I_O).numpy()
    np.testing.assert_allclose(M, M.T, atol=1e-5)
    assert np.linalg.eigvalsh(M).min() > 0
    np.testing.assert_allclose(M[:3, :3],
                               np.eye(3) * float(m.body_mass.sum()),
                               atol=1e-3)


def test_step_matches_plain_substep_on_random_go1_states():
    """The cross-engine check of tests/test_pallas_core.py:59-75 on the
    port: one 2 ms substep of the op-graph step against the plain substep
    (the kernels' plain version) on the random Go1 states of
    ``_random_batch`` (K=8): 1e-4 qpos, 5e-3 qvel."""
    m = load_go1("flat", device="cpu")
    qpos, qvel, ctrl = (torch.from_numpy(a) for a in random_batch(m, 8))
    plain = build_plain_substep(m, m.timestep, 1)
    pq, pv = plain(qpos, qvel, ctrl)
    st, _ = dynamics.step(m, State(qpos=qpos.T, qvel=qvel.T,
                                   time=torch.zeros(8)), ctrl.T)
    np.testing.assert_allclose(st.qpos.numpy(), pq.T.numpy(), atol=1e-4)
    np.testing.assert_allclose(st.qvel.numpy(), pv.T.numpy(), atol=5e-3)
