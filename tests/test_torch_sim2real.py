"""The port's sim2real calibration and walk.json modules against the JAX
package's: the calibration vectors and maps (tensors and numpy), the
gait file's writer and reader (the same text), its transforms and the
inverse map to sim controls (1e-6), and the deterministic export rollout
of ``generate_walk_json`` on the symmetric walk at the cut substep counts
of tests/test_torch_envs_sim2real.py (rows to the file's 0.01 degree
rounding)."""
import json

import numpy as np
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu.sim2real import calibration as jax_cal
from opendog_tpu.sim2real import gait_json as jax_gait
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.sim2real import calibration, gait_json
from test_torch_envs_sim2real import _cut

torch.set_num_threads(1)


def test_calibration_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    jc, c = jax_cal.Calibration(jm), calibration.Calibration(m)
    for k in ("model_actuator_index", "sim_home_rad", "real_home_deg",
              "scale", "ctrl_lo", "ctrl_hi"):
        np.testing.assert_array_equal(getattr(c, k), getattr(jc, k), k)
    rng = np.random.default_rng(0)
    rad = (c.sim_home_rad + rng.uniform(-0.5, 0.5, (16, 8))).astype(
        np.float32)
    want = np.asarray(jc.sim_rad_to_real_deg(jnp.asarray(rad)))
    np.testing.assert_allclose(
        c.sim_rad_to_real_deg(torch.from_numpy(rad)).numpy(), want,
        rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(c.sim_rad_to_real_deg(rad), want, rtol=1e-6,
                               atol=1e-4)
    back = np.asarray(jc.real_deg_to_sim_rad(jnp.asarray(want)))
    np.testing.assert_allclose(
        c.real_deg_to_sim_rad(torch.from_numpy(want.copy())).numpy(), back,
        rtol=1e-6, atol=1e-6)
    model_order = rng.normal(size=(3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        c.reorder_from_model(torch.from_numpy(model_order)).numpy(),
        np.asarray(jc.reorder_from_model(model_order)))
    np.testing.assert_array_equal(
        c.reorder_to_model(model_order), jc.reorder_to_model(model_order))


def test_gait_json_round_trip_and_transforms_match_jax(tmp_path):
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    rng = np.random.default_rng(2)
    deg = rng.uniform(-60, 60, (5, 8))
    dur = [0.1] * 5
    gait_json.save_gait(str(tmp_path / "a.json"), dur, deg)
    jax_gait.save_gait(str(tmp_path / "b.json"), dur, deg)
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    d, t = gait_json.load_gait(str(tmp_path / "a.json"))
    jd, jt = jax_gait.load_gait(str(tmp_path / "a.json"))
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(t, jt)
    kw = dict(sign=np.where(np.arange(8) % 2, -1.0, 1.0), offset_deg=2.0,
              invert=("FR_tigh_actuator",))
    np.testing.assert_array_equal(gait_json.transform_gait(t, **kw),
                                  jax_gait.transform_gait(t, **kw))
    np.testing.assert_allclose(gait_json.gait_to_sim_ctrl(m, d, t),
                               jax_gait.gait_to_sim_ctrl(jm, jd, jt),
                               rtol=1e-6, atol=1e-6)


def test_generate_walk_json_matches_jax(tmp_path):
    """The deterministic export rollout of a fixed linear policy for 2
    steps: the same real-degree rows."""
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    jenv, env = _cut(jax_envs.SymWalkEnv(jm), envs.SymWalkEnv(m))
    W = np.random.default_rng(5).normal(0, 0.1, (22, 4)).astype(np.float32)

    with jax.disable_jit():
        n_j = jax_gait.generate_walk_json(
            lambda o: jnp.tanh(o @ jnp.asarray(W)), jenv,
            str(tmp_path / "jax.json"), num_steps=2)
    n = gait_json.generate_walk_json(
        lambda o: torch.tanh(o @ torch.from_numpy(W)), env,
        str(tmp_path / "port.json"), num_steps=2)
    assert n == n_j == 2
    a = json.loads((tmp_path / "port.json").read_text())
    b = json.loads((tmp_path / "jax.json").read_text())
    assert [s["duration"] for s in a] == [s["duration"] for s in b]
    for sa, sb in zip(a, b):
        for k, v in sb["targets_deg"].items():
            assert abs(sa["targets_deg"][k] - v) <= 0.011, (k, sa, sb)
