"""The port's actuator perturbation table against the JAX package's on the
same SymWalkEnv configuration (OpenDOG flat): the same rows, every
number within 1e-6, and the invariants of
tests/test_sim2real.py::test_actuator_perturbation_table_invariants."""
import numpy as np
import pytest
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu import envs as jax_envs
from opendog_tpu.sim2real import perturbation as jax_pert
from opendog_tpu_torch import assets, envs
from opendog_tpu_torch.sim2real import perturbation

torch.set_num_threads(1)

TOL = 1e-6
NUMBERS = ("sim_home_rad", "real_home_deg", "applied_sim_delta_rad",
           "sim_target_rad", "real_target_deg", "real_delta_deg")


@pytest.fixture(scope="module")
def tables():
    env = envs.SymWalkEnv(assets.load_opendog("flat", device="cpu"))
    jenv = jax_envs.SymWalkEnv(jax_assets.load_opendog("flat"))
    return {d: (perturbation.actuator_perturbation_table(env, d),
                jax_pert.actuator_perturbation_table(jenv, d))
            for d in (15.0, 40.0)}


@pytest.mark.parametrize("delta_deg", [15.0, 40.0])
def test_table_matches_jax(tables, delta_deg):
    rows, want = tables[delta_deg]
    assert len(rows) == len(want) == 4 * 2 * 2 * 8
    for r, w in zip(rows, want):
        for k in ("channel", "sign", "phase", "actuator"):
            assert r[k] == w[k], (k, r, w)
        for k in NUMBERS:
            assert abs(r[k] - w[k]) <= TOL, (k, r[k], w[k], r)


def test_table_invariants(tables):
    rows = tables[15.0][0]

    def delta(sel, actuator):
        m = [r for r in sel if r["actuator"] == actuator]
        assert len(m) == 1
        return m[0]["applied_sim_delta_rad"]

    def select(channel, sign, phase):
        return [r for r in rows if r["channel"] == channel
                and r["sign"] == sign and r["phase"] == phase]

    sel = select("FR_tigh_delta", 1, 0)
    d_fr = delta(sel, "FR_tigh_actuator")
    assert abs(d_fr - delta(sel, "BL_tigh_actuator")) < 1e-6
    assert abs(d_fr) > 0.1
    assert abs(delta(sel, "FL_tigh_actuator")) < 1e-6
    for knee in ("FR_knee_actuator", "FL_knee_actuator",
                 "BL_knee_actuator", "BR_knee_actuator"):
        assert abs(delta(sel, knee)) < 1e-6
    sel0 = select("Knee_P1(FR/BL)_sw_delta", 1, 0)
    d_frk = delta(sel0, "FR_knee_actuator")
    d_blk = delta(sel0, "BL_knee_actuator")
    assert d_frk > 0.1 and d_blk < -0.1
    assert abs(d_frk + d_blk) < 0.06
    sel1 = select("Knee_P1(FR/BL)_sw_delta", 1, 1)
    assert abs(delta(sel1, "FR_knee_actuator")) < 1e-6
    assert abs(delta(sel1, "BL_knee_actuator")) < 1e-6
    assert all(np.isfinite(r["real_delta_deg"]) for r in rows)
    assert all(abs(r["real_delta_deg"]) < 90 for r in rows)
