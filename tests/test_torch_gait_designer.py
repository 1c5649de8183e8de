"""The port's trot designer and gait replay against the JAX package's:
``design_trot`` durations, sim controls and real degrees to 1e-6;
``replay_gait`` on a short gait against JAX op by op (``jax.disable_jit``:
jitted XLA fuses roundings of the stiff contact sums), trunk pose to 1e-5
and joint error to 1e-5; the 128-substep chunks equal single substeps bit
for bit; and the counterpart of
tests/test_golden_gait_replay.py::test_designed_trot_replays_in_both_engines
on the port (finite, trunk above 0.03 m), cut from 12 steps to 4."""
import numpy as np
import torch
import jax

from opendog_tpu import assets as jax_assets
from opendog_tpu.sim2real import gait_designer as jax_gd
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import dynamics, make_state
from opendog_tpu_torch.sim2real import gait_designer

torch.set_num_threads(1)

DESIGN_TOL = 1e-6
TRUNK_TOL, ERR_TOL = 1e-5, 1e-5
SHORT = dict(num_steps=2, initial_hold=0.02, phase_duration=0.02)


def _models():
    return jax_assets.load_opendog("flat"), assets.load_opendog(
        "flat", device="cpu")


def test_design_trot_matches_jax():
    jm, m = _models()
    for params in (gait_designer.TrotParams(),
                   gait_designer.TrotParams(**SHORT, thigh_forward=0.3,
                                            front_knee_lift=-0.9)):
        d, sim, deg = gait_designer.design_trot(m, params)
        jd, jsim, jdeg = jax_gd.design_trot(
            jm, jax_gd.TrotParams(*params))
        np.testing.assert_allclose(d, jd, rtol=0, atol=DESIGN_TOL)
        np.testing.assert_allclose(sim, jsim, rtol=0, atol=DESIGN_TOL)
        np.testing.assert_allclose(deg, jdeg, rtol=0, atol=DESIGN_TOL)
    assert len(d) == 4 and sim.shape == (4, 8)


def test_replay_gait_matches_jax_op_by_op():
    """The short gait with every row cut to 0.01 s (its return-home row
    is 1 s): four rows of 5 single substeps after a 4-substep settle."""
    jm, m = _models()
    d, sim, _ = gait_designer.design_trot(
        m, gait_designer.TrotParams(**SHORT))
    d = np.full(len(d), 0.01)
    with jax.disable_jit():
        want = jax_gd.replay_gait(jm, d, sim, settle_steps=4)
    got = gait_designer.replay_gait(m, d, sim, settle_steps=4, device="cpu")
    np.testing.assert_allclose(got["trunk"], want["trunk"], rtol=0,
                               atol=TRUNK_TOL)
    np.testing.assert_allclose(got["max_joint_err"], want["max_joint_err"],
                               rtol=0, atol=ERR_TOL)


def test_replay_gait_chunks_equal_single_substeps():
    """A row of 130 substeps (one 128-substep chunk and two single
    substeps) lands where 130 single substeps do, bit for bit."""
    m = assets.load_opendog("flat", device="cpu")
    d, sim, _ = gait_designer.design_trot(
        m, gait_designer.TrotParams(**SHORT))
    row = sim[1:2]
    got = gait_designer.replay_gait(m, [130 * m.timestep], row,
                                    settle_steps=2, device="cpu")
    inv = np.argsort(gait_designer.Calibration(m).model_actuator_index)
    ctrl = torch.from_numpy(row[0, inv].copy())
    st = make_state(m, "home")
    st, _ = dynamics.step(m, st, m.key_ctrl[0], None, n_substeps=2)
    for _ in range(130):
        st, _ = dynamics.step(m, st, ctrl, n_substeps=1)
    np.testing.assert_array_equal(got["trunk"][0], st.qpos[:7].numpy())

