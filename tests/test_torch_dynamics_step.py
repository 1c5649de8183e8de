"""The port's ``dynamics.step`` against the JAX package's, whole: one
substep on every case of ``tests/test_torch_dynamics.py`` (Go1, OpenDOG
flat and on a terrain, mini, the pendulum, Go1 on the jump box, the oracle
contact), and ten substeps on Go1 and on OpenDOG on the terrain, each on a
batch of 8 near-home states from numpy seeds, against the JAX step jitted
and vmapped.  Tolerance 1e-4 qpos / 1e-3 qvel, and for the last substep's
``StepInfo`` 1e-3 on qacc and the contact forces relative to their largest
magnitude; penetration 1e-5 and in_contact equal except where a sphere
sits within 1e-6 m of its surface.  Random states at 10 ms amplify float32
rounding (ROADMAP Queue 3), so none are used here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu.physics import State as JaxState
from opendog_tpu.physics import dynamics as jd
from opendog_tpu_torch.physics import State, dynamics as td
from test_torch_dynamics import MODELS, _t, case

torch.set_num_threads(1)

TOL = {"qpos": 1e-4, "qvel": 1e-3}


def _near_home_batch(name, seed=11):
    """The case's batch moved back toward rest: the same poses, qvel
    scaled to 0.05 of the case's (the case's controls)."""
    _, _, _, _, qpos, qvel, ctrl = case(name)
    return qpos, (0.05 * qvel).astype(np.float32), ctrl


def _compare(name, n_substeps):
    jm, m, jt, t = case(name)[:4]
    qpos, qvel, ctrl = _near_home_batch(name)
    jstep = jax.jit(jax.vmap(lambda s, c: jd.step(jm, s, c, jt,
                                                  n_substeps=n_substeps)))
    want, winfo = jstep(JaxState(qpos=jnp.asarray(qpos),
                                 qvel=jnp.asarray(qvel),
                                 time=jnp.zeros(len(qpos))),
                        jnp.asarray(ctrl))
    got, ginfo = td.step(m, State(qpos=_t(qpos), qvel=_t(qvel),
                                  time=torch.zeros(len(qpos))),
                         _t(ctrl), t, n_substeps=n_substeps)
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=TOL[k], err_msg=f"{name} {k}")
    np.testing.assert_allclose(got.time.numpy(), np.asarray(want.time),
                               rtol=1e-7)
    for k, a, b in (("qacc", ginfo.qacc, winfo.qacc),
                    ("force_world", ginfo.contact.force_world,
                     winfo.contact.force_world),
                    ("force_body", ginfo.contact.force_body,
                     winfo.contact.force_body)):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-3 * scale,
                                   err_msg=f"{name} {k}")
    np.testing.assert_allclose(ginfo.contact.penetration.numpy(),
                               np.asarray(winfo.contact.penetration),
                               rtol=0, atol=1e-5)
    pen = np.asarray(winfo.contact.penetration)
    settled = (pen > 1e-6) | (pen == 0)
    np.testing.assert_array_equal(
        ginfo.contact.in_contact.numpy()[settled],
        np.asarray(winfo.contact.in_contact)[settled])
    for k in ("xpos", "xquat", "qfrc_actuator"):
        np.testing.assert_allclose(getattr(ginfo, k).numpy(),
                                   np.asarray(getattr(winfo, k)), rtol=0,
                                   atol=1e-4, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", MODELS)
def test_one_substep_matches_jax(name):
    _compare(name, 1)


@pytest.mark.parametrize("name", ["go1", "opendog_terrain"])
def test_ten_substeps_match_jax(name):
    """The JAX step scans ten substeps (``lax.scan``, unroll 4); the port
    runs one Python loop for any count."""
    _compare(name, 10)


def test_unbatched_state_steps_like_a_batch_of_one():
    """A plant's (nq,) state steps as the (1, nq) batch does, at the
    module's tolerance: batched and unbatched products take other BLAS
    paths (measured: 5.1e-6 qvel after three substeps)."""
    _, m, _, t, qpos, qvel, ctrl = case("opendog_terrain")
    one, _ = td.step(m, State(qpos=_t(qpos[0]), qvel=_t(qvel[0]),
                              time=torch.zeros(())), _t(ctrl[0]), t,
                     n_substeps=3)
    batch, _ = td.step(m, State(qpos=_t(qpos[:1]), qvel=_t(qvel[:1]),
                                time=torch.zeros(1)), _t(ctrl[:1]), t,
                       n_substeps=3)
    torch.testing.assert_close(one.qpos, batch.qpos[0], rtol=0,
                               atol=TOL["qpos"])
    torch.testing.assert_close(one.qvel, batch.qvel[0], rtol=0,
                               atol=TOL["qvel"])
