"""The port's app control laws against the JAX package's on seeded inputs:
the policy loop's observation, action map and velocity estimate
(apps/run_policy.py), the trot and stabilization laws and the runners'
command sequences (apps/gaits.py), and ``MPCBridge.metrics`` on fixed
seeded latencies and commanded / measured degrees, both bridges built on a
stand-in controller and body so that no solve runs.  Everything is numpy
on the host: equal to 1e-6 (the metrics dict exactly)."""
import numpy as np
import pytest
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu.apps import gaits as jax_gaits
from opendog_tpu.apps import mpc_bridge as jax_bridge
from opendog_tpu.apps import run_policy as jax_rp
from opendog_tpu_torch import assets
from opendog_tpu_torch.apps import gaits, mpc_bridge, run_policy

torch.set_num_threads(1)

TOL = 1e-6


def test_build_observation_and_action_map_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ypr = rng.uniform(-180, 180, 3)
        angles = rng.uniform(-90, 90, 8)
        vx = float(rng.normal())
        np.testing.assert_allclose(
            run_policy.build_observation(ypr, angles, vx),
            jax_rp.build_observation(ypr, angles, vx), rtol=0, atol=TOL)
        action = rng.uniform(-1.5, 1.5, 8).astype(np.float32)
        got = run_policy.action_to_target_degrees(action)
        np.testing.assert_allclose(
            got, jax_rp.action_to_target_degrees(action), rtol=0, atol=TOL)
        home = np.array([-45, 45, 45, 45, 45, -45, 45, -45])
        assert np.all(np.abs(got - home) <= run_policy.MOTOR_LIMIT_DEG)


def test_velocity_estimator_matches_jax():
    rng = np.random.default_rng(1)
    est, jest = run_policy.VelocityEstimator(), jax_rp.VelocityEstimator()
    t = 100.0
    for ax in rng.normal(0, 2, 50):
        t += float(rng.uniform(0.05, 0.1))
        assert abs(est.update(ax, now=t) - jest.update(ax, now=t)) <= TOL
    assert est.vx != 0.0


def test_trot_and_stabilization_laws_match_jax():
    for err in np.linspace(-40, 40, 33):
        np.testing.assert_allclose(gaits.autocorrect_trot_cycle(err),
                                   jax_gaits.autocorrect_trot_cycle(err),
                                   rtol=0, atol=TOL)
    for roll in np.linspace(-30, 30, 25):
        np.testing.assert_allclose(gaits.stabilization_targets(roll),
                                   jax_gaits.stabilization_targets(roll),
                                   rtol=0, atol=TOL)
    assert gaits.stance_vector() == jax_gaits.stance_vector()


class _RecordingBody:
    """Records every SDK call; answers the IMU getter with a fixed yaw and
    roll."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args, **kw):
            self.calls.append((name, [np.round(np.asarray(a, float), 6)
                                      .tolist() if isinstance(
                                          a, (list, tuple, np.ndarray))
                                      else a for a in args], kw))
            if name == "get_latest_dmp_data_for_esp":
                return {"ypr_deg": {"yaw": 7.5, "pitch": 0.0, "roll": -3.0}}
            return True
        return call


@pytest.mark.parametrize("runner", ["bringup", "play", "walk", "shutdown"])
def test_runners_send_what_jax_sends(runner):
    rng = np.random.default_rng(2)
    targets = rng.uniform(-60, 60, (5, 8))
    durations = rng.uniform(0.1, 0.4, 5)
    out = []
    for mod in (gaits, jax_gaits):
        body = _RecordingBody()
        if runner == "bringup":
            mod.motor_bringup(body)
        elif runner == "play":
            assert mod.play_gait(body, durations, targets,
                                 sleep_fn=lambda s: None) == 5
        elif runner == "walk":
            mod.walk_straight(body, 3, target_yaw=2.0,
                              sleep_fn=lambda s: None)
        else:
            mod.safe_shutdown(body)
        out.append(body.calls)
    assert out[0] == out[1]
    assert out[0]


class _Controller:
    lag = 3
    compensate = True

    def drain(self):
        pass


def test_mpc_bridge_metrics_match_jax():
    rng = np.random.default_rng(3)
    n = 60
    lat = rng.uniform(0.002, 0.03, n)
    home = np.array([-45, 45, 45, 45, 45, -45, 45, -45], np.float32)
    cmd = np.round(home + rng.uniform(-10, 10, (n, 8))).astype(np.float32)
    # measured follows the command two ticks late, with noise and a gap
    meas = np.concatenate([np.tile(home, (2, 1)), cmd[:-2]]) + \
        rng.normal(0, 0.7, (n, 8)).astype(np.float32)
    meas[17] = np.nan
    b = mpc_bridge.MPCBridge(assets.load_opendog("flat", device="cpu"),
                             _Controller(), object(), device="cpu")
    jb = jax_bridge.MPCBridge(jax_assets.load_opendog("flat"), _Controller(),
                              object())
    for br in (b, jb):
        br._commanded = list(cmd)
        br._measured = list(meas)
    got = b.metrics(lat, overruns=4, rate_hz=50.0)
    want = jb.metrics(lat, overruns=4, rate_hz=50.0)
    assert got == want
    assert got["joint_track_delay_ticks"] == 2  # meas[k+2] tracks cmd[k]
    assert got["compensated"] and got["control_delay_ticks"] == 3


def test_bridge_command_map_matches_jax():
    """Sim ctrl -> calibrated real degrees on the wire, and what the
    firmware is recorded to have received."""
    rng = np.random.default_rng(4)
    m = assets.load_opendog("flat", device="cpu")
    b = mpc_bridge.MPCBridge(m, _Controller(), _RecordingBody(),
                             device="cpu")
    jb = jax_bridge.MPCBridge(jax_assets.load_opendog("flat"), _Controller(),
                              _RecordingBody())
    lo, hi = m.numpy("actuator_ctrlrange").T
    for _ in range(5):
        ctrl = rng.uniform(lo, hi).astype(np.float32)
        np.testing.assert_allclose(b._command(ctrl), jb._command(ctrl),
                                   rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.asarray(b._commanded),
                                  np.asarray(jb._commanded))
    assert b.body.calls == jb.body.calls
