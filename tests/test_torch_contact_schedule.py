"""The port's contact schedules against the JAX package's: the trot and
landing tables equal exactly; ``contact_schedule_cost`` (cyclic and
clamped schedules) over random batches, the JAX cost vmapped per sample
and the port's batch-first, at relative tolerance 1e-5 (float32 sums in
another order); ``trot_gait_ref`` batch-first in time against the JAX
reference vmapped over the same times, at 1e-6 absolute (the same float32
operations)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State
from opendog_tpu_torch.solvers import costs

torch.set_num_threads(1)

K = 64
RTOL = 1e-5
REF_ATOL = 1e-6
LOADERS = {"go1": (jax_assets.load_go1, assets.load_go1),
           "opendog": (jax_assets.load_opendog, assets.load_opendog)}


@pytest.fixture(scope="module", params=sorted(LOADERS))
def models(request):
    jax_load, load = LOADERS[request.param]
    return request.param, jax_load("flat"), load("flat", device="cpu")


def _batch(m, seed):
    """Random states near the home keyframe, times over several gait
    periods (negative ones included: the cyclic wrap and the clamp), random
    controls."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.key_qpos[0]), (K, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.05, (K, 3)).astype(np.float32)
    quat = qpos[:, 3:7] + rng.normal(0, 0.2, (K, 4)).astype(np.float32)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.normal(0, 0.2, (K, m.nq - 7)).astype(np.float32)
    qvel = rng.normal(0, 0.5, (K, m.nv)).astype(np.float32)
    time = rng.uniform(-1.0, 3.0, K).astype(np.float32)
    time[:4] = (0.0, 0.1, 0.2, 0.4)  # slot boundaries and centres
    lo, hi = np.asarray(m.actuator_ctrlrange).T
    ctrl = rng.uniform(lo, hi, (K, m.nu)).astype(np.float32)
    prev = rng.uniform(lo, hi, (K, m.nu)).astype(np.float32)
    return qpos, qvel, time, ctrl, prev


def _same_schedule(got, want):
    assert got.stance == tuple(map(tuple, np.asarray(want.stance).tolist()))
    assert got.slot_dt == want.slot_dt
    assert got.cyclic == want.cyclic
    if want.thigh_offset is None:
        assert got.thigh_offset is None
    else:
        np.testing.assert_array_equal(np.asarray(got.thigh_offset),
                                      np.asarray(want.thigh_offset))
        assert np.asarray(got.thigh_offset).dtype == np.float32


@pytest.mark.parametrize("legs", ["go1", "opendog"])
@pytest.mark.parametrize("duty", [0.5, 0.625])
@pytest.mark.parametrize("params", [dict(), dict(thigh_amp=0.3,
                                                 period_s=0.5)])
def test_trot_schedule_tables_equal_jax(legs, duty, params):
    got = costs.trot_schedule(costs.TrotCostParams(**params), legs, duty)
    want = jax_costs.trot_schedule(jax_costs.TrotCostParams(**params), legs,
                                   duty)
    _same_schedule(got, want)


def test_trot_schedule_duty_must_be_known():
    for module in (costs, jax_costs):
        with pytest.raises(ValueError, match="duty must be 0.5 or 0.625"):
            module.trot_schedule(module.TrotCostParams(), "go1", 0.6)


@pytest.mark.parametrize("slot_dt", [0.25, 0.2])
def test_landing_schedule_equals_jax(slot_dt):
    _same_schedule(costs.landing_schedule(slot_dt),
                   jax_costs.landing_schedule(slot_dt))


SCHEDULES = {
    "trot": lambda c, p, legs: c.trot_schedule(p, legs),
    "walk_trot": lambda c, p, legs: c.trot_schedule(p, legs, duty=0.625),
    "landing": lambda c, p, legs: c.landing_schedule(0.2),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("params", [
    dict(desired_vel_xy=(0.5, 0.0), target_height=0.265),  # bench 3b
    dict(desired_vel_xy=(0.3, 0.1), desired_yaw=0.4, thigh_phase=-1.0,
         knee_lift=0.5),
])
def test_contact_schedule_cost_matches_jax(models, schedule, params):
    legs, jm, m = models
    home = np.asarray(jm.key_qpos[0])[7:]
    jp, p = jax_costs.TrotCostParams(**params), costs.TrotCostParams(**params)
    jcost = jax_costs.contact_schedule_cost(
        jm, SCHEDULES[schedule](jax_costs, jp, legs), jp, home, legs=legs,
        w_stance_vel=0.07)
    cost = costs.contact_schedule_cost(
        m, SCHEDULES[schedule](costs, p, legs), p, home, legs=legs,
        w_stance_vel=0.07)
    qpos, qvel, time, ctrl, prev = _batch(jm, 3)
    st = JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                  time=jnp.asarray(time))
    want = np.asarray(jax.vmap(jcost)(st, jnp.asarray(ctrl),
                                      jnp.asarray(prev)))
    t = torch.from_numpy
    got = cost(State(qpos=t(qpos), qvel=t(qvel), time=t(time)), t(ctrl),
               t(prev))
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    # one unbatched sample gives the same scalar
    one = cost(State(qpos=t(qpos[5]), qvel=t(qvel[5]),
                     time=torch.tensor(time[5])), t(ctrl[5]), t(prev[5]))
    assert one.shape == ()
    np.testing.assert_allclose(float(one), want[5], rtol=RTOL)


def test_contact_schedule_cost_wraps_and_clamps():
    """The cyclic cost repeats after a period; the clamped (landing) one
    holds its last slot, as the JAX package's own test has it."""
    m = assets.load_go1("flat", device="cpu")
    home = m.key_qpos[0, 7:]
    p = costs.TrotCostParams()
    cyc = costs.contact_schedule_cost(m, costs.trot_schedule(p), p, home)
    land = costs.contact_schedule_cost(m, costs.landing_schedule(0.2), p,
                                       home)
    t = torch.tensor([0.07, 0.07 + p.period_s, 10.0, 100.0])
    st = State(qpos=m.key_qpos[0].expand(4, -1),
               qvel=torch.zeros(4, m.nv), time=t)
    u = m.key_ctrl[0].expand(4, -1)
    c = cyc(st, u, u)
    np.testing.assert_allclose(float(c[0]), float(c[1]), rtol=1e-5)
    cl = land(st, u, u)
    np.testing.assert_allclose(float(cl[2]), float(cl[3]), rtol=1e-6)


@pytest.mark.parametrize("params", [
    dict(),
    dict(thigh_amp=0.3, knee_lift=0.5, period_s=0.5, lift_phase=np.pi / 2,
         thigh_phase=-1.0),
])
def test_trot_gait_ref_matches_jax(models, params):
    legs, jm, m = models
    home = np.asarray(jm.key_qpos[0])[7:]
    jref = jax_costs.trot_gait_ref(jm, jax_costs.TrotCostParams(**params),
                                   home, legs=legs)
    ref = costs.trot_gait_ref(m, costs.TrotCostParams(**params), home,
                              legs=legs)
    ts = np.random.default_rng(4).uniform(-1, 3, K).astype(np.float32)
    want = np.asarray(jax.vmap(jref)(jnp.asarray(ts)))
    got = ref(torch.from_numpy(ts))
    assert got.shape == (K, m.nu)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_ATOL)
    # a (2, K/2) batch of times and one time give the same targets
    np.testing.assert_allclose(
        ref(torch.from_numpy(ts.reshape(2, -1))).reshape(K, -1).numpy(),
        want, rtol=0, atol=REF_ATOL)
    np.testing.assert_allclose(ref(torch.tensor(ts[7])).numpy(), want[7],
                               rtol=0, atol=REF_ATOL)
