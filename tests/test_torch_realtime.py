"""The port's RealtimeController against the JAX package's, with shared
noise, on mini (the setup of
tests/test_torch_mppi_mpc.py::test_mini_mpc_ticks_match_jax_pallas_interpret:
engine="pallas" in interpret mode, H=4, K=8, 1 ms rollout steps, a
2-substep plant).

The JAX normals follow the controller's key chain: ``start`` splits the
controller's key and each tick splits the carry's key
(opendog_tpu/solvers/mpc.py:153, 273-279), each bridge tick splits the
controller's key (:307); every solve then draws one key per sample.  They
are handed to the port as ``normals``.

The JAX controller jits its tick and solves per instance
(``jax.jit`` at mpc.py:236-262), which on a CPU costs 15-30 s of tracing
and compiling each in interpret mode.  Here the JAX module's ``jit`` runs
the controller's glue as it is, and the two programs under it, the MPPI
solve and the kernel plant step, are jitted once and shared by every case:
the same functions on the same inputs, cut at other jit boundaries.
"""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mpc as jax_mpc
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state, terrain as terrain_lib
from opendog_tpu_torch.solvers import (MPPIConfig, RealtimeController,
                                       costs, mpc)

torch.set_num_threads(1)

BASE = dict(horizon=4, num_samples=8, n_substeps=1, rollout_dt=0.001,
            noise_sigma=0.05)
PLANT_SUBSTEPS = 2
N_TICKS = 5
CASES = [(lag, comp) for lag in (1, 2) for comp in (False, True)]
ATOL = 1e-5  # controls, as in the mini MPC test (measured here: 3e-8)
RANGE_TOL = 1e-6  # a softmax-weighted mean of clipped plans may round out


def _solve_normals(key, K, H, nu):
    """The (K, H, nu) standard normals one JAX solve draws from ``key``."""
    keys = jax.random.split(key, K)
    return np.array(jax.vmap(
        lambda k: jax.random.normal(k, (H, nu), dtype=jnp.float32))(keys))


def _chain_normals(key, n, nu):
    """The normals of ``n`` solves each drawn from ``key, sub =
    split(key)``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_solve_normals(sub, BASE["num_samples"], BASE["horizon"],
                                  nu))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX mini, its cost and config, with the controller's programs jitted
    once (see the module docstring); undone after the module."""
    jm = jax_assets.load_mini()
    cost = jax_costs.standing_cost(jm, 0.115, np.asarray(jm.key_qpos[0])[7:])
    cfg = JaxMPPIConfig(engine="pallas", **BASE)
    orig_build = jax_pallas_step.build_pallas_substep
    orig_solver = jax_mppi.make_solver
    orig_plant = jax_mpc._make_plant_step
    shared = {}

    def solver(*a, **k):
        if "solve" not in shared:
            shared["solve"] = jax.jit(orig_solver(*a, **k))
        return shared["solve"]

    def plant(*a, **k):
        if "plant" not in shared:
            shared["plant"] = jax.jit(orig_plant(*a, **k))
        return shared["plant"]

    glue = types.SimpleNamespace(jit=lambda f, **_: f, random=jax.random)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pallas_step, "build_pallas_substep",
                   lambda *a, **k: orig_build(*a, **{**k, "interpret": True}))
        mp.setattr(jax_mppi, "make_solver", solver)
        mp.setattr(jax_mpc, "_make_plant_step", plant)
        mp.setattr(jax_mpc, "jax", glue)
        yield jm, cost, cfg


@pytest.fixture(scope="module")
def mini():
    m = assets.load_mini(device="cpu")
    return m, costs.standing_cost(m, 0.115, m.key_qpos[0, 7:])


def _port(mini, lag, compensate):
    m, cost = mini
    return RealtimeController(m, cost, MPPIConfig(**BASE), lag=lag,
                              plant_substeps=PLANT_SUBSTEPS,
                              compensate=compensate, device="cpu")


def _check_stream(got, want, lag, m):
    rng = m.numpy("actuator_ctrlrange")
    hold = np.clip(m.numpy("key_ctrl")[0], rng[:, 0], rng[:, 1])
    got, want = np.array(got), np.array(want)
    for t in range(lag):  # the placeholder until the pipeline is primed
        np.testing.assert_array_equal(got[t], hold)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.isfinite(got).all()
    assert (got >= rng[:, 0] - RANGE_TOL).all()
    assert (got <= rng[:, 1] + RANGE_TOL).all()
    # the stream moved off the placeholder once primed
    assert np.abs(got[lag:] - hold).max() > 1e-4


@pytest.mark.parametrize("lag,compensate", CASES)
def test_benchmark_mode_matches_jax(jax_side, mini, lag, compensate):
    """start, N_TICKS ticks, then drain: every returned control against the
    JAX controller's."""
    jm, jcost, jcfg = jax_side
    key = jax.random.PRNGKey(0)
    jrtc = jax_mpc.RealtimeController(jm, jcost, jcfg, lag=lag,
                                      plant_substeps=PLANT_SUBSTEPS, key=key,
                                      compensate=compensate)
    jrtc.start(jax_make_state(jm, "home"))
    want = [np.array(jrtc.tick()) for _ in range(N_TICKS)]
    want.append(np.array(jrtc.drain()))

    _, sub = jax.random.split(key)  # start() hands the carry a split key
    normals = _chain_normals(sub, N_TICKS, jm.nu)
    rtc = _port(mini, lag, compensate)
    rtc.start(make_state(mini[0], "home"))
    got = [rtc.tick(torch.from_numpy(n)) for n in normals]
    got.append(rtc.drain())
    _check_stream(got, want, lag, mini[0])


def _measured_states(m, n):
    """What a standing mini reports: the plant's states, one per tick, from
    home pushed forward at 0.05 m/s under the hold control (numpy qpos,
    qvel, t).  Random states near home will not do: mini's plant at its
    2 ms step takes them to qvel in the hundreds within two substeps in both
    packages (ROADMAP, Queue 3), and the compensated solves plan from
    there."""
    plant = mpc._make_plant_step(m, PLANT_SUBSTEPS, torch.device("cpu"))
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1])
    st = make_state(m, "home")
    st.qvel[0] = 0.05
    out = []
    for _ in range(n):
        out.append((st.qpos.numpy().copy(), st.qvel.numpy().copy(),
                    float(st.time)))
        st = plant(st, hold)
    return out


@pytest.mark.parametrize("lag,compensate", CASES)
def test_bridge_mode_matches_jax(jax_side, mini, lag, compensate):
    """N_TICKS bridge ticks on measured states, a drain, and three more
    (after a drain the compensated controller re-primes its in-flight
    queue with the placeholder control): every returned control against
    the JAX controller's."""
    jm, jcost, jcfg = jax_side
    key = jax.random.PRNGKey(1)
    states = _measured_states(mini[0], N_TICKS + 3)
    jrtc = jax_mpc.RealtimeController(jm, jcost, jcfg, lag=lag,
                                      plant_substeps=PLANT_SUBSTEPS, key=key,
                                      compensate=compensate)
    want = [np.array(jrtc.bridge_tick(*s)) for s in states[:N_TICKS]]
    want.append(np.array(jrtc.drain()))
    want += [np.array(jrtc.bridge_tick(*s)) for s in states[N_TICKS:]]

    normals = [torch.from_numpy(n)
               for n in _chain_normals(key, len(states), jm.nu)]
    rtc = _port(mini, lag, compensate)
    got = [rtc.bridge_tick(*s, normals=n)
           for s, n in zip(states[:N_TICKS], normals)]
    got.append(rtc.drain())
    got += [rtc.bridge_tick(*s, normals=n)
            for s, n in zip(states[N_TICKS:], normals[N_TICKS:])]
    _check_stream(got, want, lag, mini[0])


def test_terrain_modes():
    """On a terrain the controller's plants are the exact-bilinear step, as
    in the JAX class: benchmark mode (lag 1) and a compensated controller
    (lag 2, benchmark and bridge modes) run, with finite, in-range controls
    and a finite internal plant; an uncompensated bridge solve (one trunk
    plane, K3's mode) runs too."""
    m = assets.load_opendog("terrain", device="cpu")
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=2, num_samples=4, n_substeps=1, rollout_dt=0.01,
                     noise_sigma=0.05)
    q = m.numpy("key_qpos")[0]
    rng = m.numpy("actuator_ctrlrange")
    for lag, comp in ((1, False), (2, True)):
        rtc = RealtimeController(m, cost, cfg, terrain=terr, lag=lag,
                                 compensate=comp, plant_substeps=2,
                                 generator=torch.Generator().manual_seed(2),
                                 device="cpu")
        rtc.start(make_state(m, "home"))
        ctrls = [rtc.tick() for _ in range(4)] + [rtc.drain()]
        assert torch.isfinite(rtc.plant.qpos).all()
        ctrls += [rtc.bridge_tick(q, np.zeros(m.nv), 0.02 * i)
                  for i in range(3)]
        ctrls.append(rtc.drain())
        ctrls = np.array(ctrls)
        assert np.isfinite(ctrls).all()
        assert (ctrls >= rng[:, 0] - RANGE_TOL).all()
        assert (ctrls <= rng[:, 1] + RANGE_TOL).all()
        assert np.abs(ctrls[lag:] - ctrls[0]).max() > 0
