"""The port's DigitalTwin against the JAX package's: the angle map with a
sign / offset table (1e-6) and three mirror ticks of 2 substeps each on
the same seeded angle sequence, JAX op by op (``jax.disable_jit``: jitted
XLA fuses roundings of the stiff contact sums), qpos to 1e-5 and qvel to
1e-4."""
import numpy as np
import torch
import jax

from opendog_tpu import assets as jax_assets
from opendog_tpu.sim2real import twin as jax_twin
from opendog_tpu_torch import assets
from opendog_tpu_torch.sim2real import twin

torch.set_num_threads(1)

CTRL_TOL = 1e-6
QPOS_TOL, QVEL_TOL = 1e-5, 1e-4


def _twins(**kw):
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    return jax_twin.DigitalTwin(jm, **kw), twin.DigitalTwin(m, device="cpu",
                                                            **kw)


def _angles(seed, n):
    """Real degrees around the calibration home pose, as an encoder would
    read them."""
    home = np.array([-45, 45, 45, 45, 45, -45, 45, -45], np.float32)
    rng = np.random.default_rng(seed)
    return (home + rng.uniform(-12, 12, (n, 8))).astype(np.float32)


def test_real_angles_to_ctrl_matches_jax():
    rng = np.random.default_rng(3)
    sign = np.where(rng.uniform(size=8) < 0.3, -1.0, 1.0)
    offset = rng.uniform(-5, 5, 8)
    jt, t = _twins(sign=sign, offset_deg=offset)
    for a in _angles(4, 6):
        np.testing.assert_allclose(
            t.real_angles_to_ctrl(a).numpy(),
            np.asarray(jt.real_angles_to_ctrl(a)), rtol=0, atol=CTRL_TOL)
    # far outside ctrlrange: both clamp
    big = np.full(8, 300.0, np.float32)
    np.testing.assert_allclose(t.real_angles_to_ctrl(big).numpy(),
                               np.asarray(jt.real_angles_to_ctrl(big)),
                               rtol=0, atol=CTRL_TOL)


def test_mirror_once_matches_jax_op_by_op():
    jt, t = _twins()
    for a in _angles(5, 3):
        with jax.disable_jit():
            js = jt.mirror_once(a, substeps=2)
        s = t.mirror_once(a, substeps=2)
        np.testing.assert_allclose(s.qpos.numpy(), np.asarray(js.qpos),
                                   rtol=0, atol=QPOS_TOL)
        np.testing.assert_allclose(s.qvel.numpy(), np.asarray(js.qvel),
                                   rtol=0, atol=QVEL_TOL)
        np.testing.assert_allclose(float(s.time), float(js.time), rtol=0,
                                   atol=1e-7)
    snap = t.snapshot()
    np.testing.assert_array_equal(snap.qpos.numpy(), t.state.qpos.numpy())
    assert snap.qpos is not t.state.qpos  # a copy, not the live state


def test_start_mirroring_follows_a_body():
    """The mirroring thread reads both ESPs' angles from a telemetry store
    and advances the twin; ``stop`` joins it."""
    import time

    class Body:
        def get_latest_motor_data_for_esp(self, i):
            return {"angles": [-45.0, 45.0, 45.0, 45.0] if i == 0
                    else [45.0, -45.0, 45.0, -45.0]}

    _, t = _twins()
    t0 = float(t.snapshot().time)
    t.start_mirroring(Body(), rate_hz=100.0)
    deadline = time.time() + 20.0
    while float(t.snapshot().time) == t0 and time.time() < deadline:
        time.sleep(0.05)
    t.stop()
    assert not t._thread.is_alive()
    assert float(t.snapshot().time) > t0
