"""The batched solver (``mppi.make_batched_solver``, the counterpart of
``jax.vmap(solve)``): on the CPU it equals S single solves on the same
normals exactly, on both engines, with a payload, a command, an anchor and
a terminal cost, and on a terrain in both plane modes; and it matches
``jax.vmap`` of the JAX solve (``"pallas"`` in interpret mode) to the
tolerances of the mini solves (ctrl and nominal 1e-5 abs, best_cost and
mean_cost 5e-5 relative, ess 5e-4 relative).  S x K = 3 x 8 lanes: not a
multiple of the card's four rollouts per block either, as at the card's
ragged K=257.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State, make_state
from opendog_tpu_torch.solvers import MPPIConfig, mppi
from test_torch_exact_plant import MINI, _interpret, _mini_ramp, _solve_normals
from test_torch_mppi_cmd import START_T, VARIANTS, _options, mini_pieces

torch.set_num_threads(1)

S = 3


def _scenarios(m, seed=0):
    """S mini states near home at their own times, nominals, payloads and
    commands (numpy)."""
    rng = np.random.default_rng(seed)
    q0 = m.numpy("key_qpos")[0] if hasattr(m, "numpy") else np.asarray(
        m.key_qpos[0])
    qpos = np.tile(q0, (S, 1)).astype(np.float32)
    qpos[:, 2] += rng.uniform(-0.005, 0.005, S)
    qpos[:, 7:] += rng.normal(0, 0.05, (S, qpos.shape[1] - 7))
    qvel = rng.normal(0, 0.1, (S, len(q0) - 1)).astype(np.float32)
    time = (START_T + 0.02 * np.arange(S)).astype(np.float32)
    ctrl0 = np.asarray(m.key_ctrl[0], np.float32)
    nominal = (ctrl0 + rng.normal(0, 0.05, (S, MINI["horizon"],
                                            len(ctrl0)))).astype(np.float32)
    payload = np.array([0.0, 0.6, 1.2], np.float32)
    command = np.stack([rng.uniform(0, 0.4, S), rng.uniform(-0.01, 0.01, S),
                        rng.uniform(-0.5, 0.5, S)], 1).astype(np.float32)
    return qpos, qvel.astype(np.float32), time, nominal, payload, command


CASES = {
    "kernel-all": ("kernel", "all", None),
    "ops-all": ("ops", "all_ops", None),
    "kernel-ramp-per_geom": ("kernel", "all", "per_geom"),
    "kernel-ramp-trunk": ("kernel", "anchor", "trunk"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_equals_single_solves_exactly(case):
    engine, variant, plane_mode = CASES[case]
    opts, (payload, command) = VARIANTS[variant]
    if plane_mode is None:
        m, terrain = assets.load_mini(device="cpu"), None
    else:
        _, m, _, terrain = _mini_ramp()
    cost, kw = _options(mini_pieces(torch, m, m.key_qpos[0, 7:]), opts)
    if terrain is not None:
        kw.update(terrain=terrain, plane_mode=plane_mode)
    cfg = MPPIConfig(engine=engine, **MINI)
    one = mppi.make_solver(m, cost, cfg, device="cpu", **kw)
    many = mppi.make_batched_solver(m, cost, cfg, scenarios=S, device="cpu",
                                    **kw)
    qpos, qvel, time, nominal, pay, cmd = (
        torch.from_numpy(a) for a in _scenarios(m))
    normals = torch.randn((S, cfg.num_samples, cfg.horizon, m.nu),
                          generator=torch.Generator().manual_seed(4))
    aux = (() if payload is None else (pay,)) + (
        () if command is None else (cmd,))
    ctrl, ms, stats = many(State(qpos=qpos, qvel=qvel, time=time),
                           mppi.MPPIState(nominal=nominal), None, normals,
                           *aux)
    assert ctrl.shape == (S, m.nu) and ms.nominal.shape == nominal.shape
    assert all(v.shape == (S,) for v in stats.values())
    for s in range(S):
        c1, ms1, st1 = one(State(qpos=qpos[s], qvel=qvel[s], time=time[s]),
                           mppi.MPPIState(nominal=nominal[s]), None,
                           normals[s], *(a[s] for a in aux))
        assert torch.equal(c1, ctrl[s]), s
        assert torch.equal(ms1.nominal, ms.nominal[s]), s
        for k in stats:
            assert torch.equal(st1[k], stats[k][s]), (s, k)


def test_batched_solver_matches_jax_vmap(monkeypatch):
    """``jax.vmap`` of the JAX solve (``"pallas"``, interpret mode) with a
    payload, a command, a command-indexed anchor and a terminal cost per
    scenario, against one batched solve on the same normals."""
    _interpret(monkeypatch)
    opts, _ = VARIANTS["all"]
    jm, m = jax_assets.load_mini(), assets.load_mini(device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    jcost, jkw = _options(mini_pieces(jnp, jm, home), opts)
    cost, kw = _options(mini_pieces(torch, m, home), opts)
    jcfg = JaxMPPIConfig(engine="pallas", **MINI)
    jsolve = jax.jit(jax.vmap(jax_mppi.make_solver(jm, jcost, jcfg, **jkw)))
    qpos, qvel, time, nominal, pay, cmd = _scenarios(jm)
    keys = jax.random.split(jax.random.PRNGKey(8), S)
    jctrl, jms, jstats = jsolve(
        JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                 time=jnp.asarray(time)),
        jax_mppi.MPPIState(nominal=jnp.asarray(nominal)), keys,
        jnp.asarray(pay), jnp.asarray(cmd))
    cfg = MPPIConfig(**MINI)
    many = mppi.make_batched_solver(m, cost, cfg, scenarios=S, device="cpu",
                                    **kw)
    normals = np.stack([_solve_normals(k, cfg.num_samples, cfg.horizon, m.nu)
                        for k in keys])
    t = torch.from_numpy
    ctrl, ms, stats = many(State(qpos=t(qpos), qvel=t(qvel), time=t(time)),
                           mppi.MPPIState(nominal=t(nominal)), None,
                           t(normals), t(pay), t(cmd))
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), atol=1e-5)
    np.testing.assert_allclose(ms.nominal.numpy(), np.asarray(jms.nominal),
                               atol=1e-5)
    for name, rtol in (("best_cost", 5e-5), ("mean_cost", 5e-5),
                       ("ess", 5e-4)):
        np.testing.assert_allclose(stats[name].numpy(),
                                   np.asarray(jstats[name]), rtol=rtol,
                                   err_msg=name)


def test_batched_solver_checks_shapes_and_draws():
    m = assets.load_mini(device="cpu")
    cost = mini_pieces(torch, m, m.key_qpos[0, 7:])[0]
    cfg = MPPIConfig(**MINI)
    many = mppi.make_batched_solver(m, cost, cfg, scenarios=S, device="cpu",
                                    with_payload=True)
    st = make_state(m, "home")
    states = State(qpos=st.qpos.expand(S, -1), qvel=st.qvel.expand(S, -1),
                   time=torch.zeros(S))
    ms = mppi.MPPIState(nominal=mppi.init_state(m, cfg).nominal.expand(
        S, -1, -1))
    with pytest.raises(ValueError, match="normals must have shape"):
        many(states, ms, None, torch.zeros(cfg.num_samples, cfg.horizon,
                                           m.nu), 0.5)
    with pytest.raises(ValueError, match="expected 3 scenarios"):
        many(State(qpos=states.qpos[:2], qvel=states.qvel[:2],
                   time=states.time[:2]), ms, None, None, 0.5)
    with pytest.raises(ValueError, match="scenarios must be >= 1"):
        mppi.make_batched_solver(m, cost, cfg, scenarios=0, device="cpu")
    # a float payload is every scenario's; draws come from the generator
    a = many(states, ms, torch.Generator().manual_seed(1), None, 0.5)[0]
    b = many(states, ms, torch.Generator().manual_seed(1), None,
             torch.full((S,), 0.5))[0]
    assert torch.equal(a, b) and torch.isfinite(a).all()
