"""The costs of the port's application scripts (scripts/torch_*.py) against
the JAX scripts' own, on the same numpy-seeded states and controls, to
1e-5 relative.

The JAX scripts define their costs as closures inside ``main()``.  The test
runs that ``main()`` in this process with ``sys.argv`` set and the package
function the script hands its cost to patched (``mppi.make_solver`` for
the jump and the landing, ``mpc.make_ilqr_tracker`` for the iLQR gait): the
patch keeps the closure and raises before any solve.  scripts/turn_mpc.py
runs at import, so the turn cost is held against the package's
``trot_cost`` with the script's parameters (turn_mpc.py:20-23), as is the
lag sweep's (lag_sweep.py:57-60).  One jump tick (an op-graph MPPI solve
with box contact, K=8, H=5, one substep, then the 10-substep plant) is
held against the same tick of jitted JAX on the same normals, to 1e-4.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mpc as jax_mpc
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State
from opendog_tpu_torch.solvers import MPPIConfig, mppi
from test_torch_exact_plant import _solve_normals

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
N = 64


def load_script(name):
    """scripts/<name>.py as a module (its ``main`` not run)."""
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("script_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def capture(monkeypatch, module, attr, script, argv):
    """Runs scripts/<script>.py's main with ``argv`` until it calls
    ``module.attr``: that call's arguments."""
    got = {}

    def fake(*args, **kwargs):
        got.update(args=args, kwargs=kwargs)
        raise _Captured

    monkeypatch.setattr(module, attr, fake)
    monkeypatch.setattr(sys, "argv", [script + ".py"] + argv)
    with pytest.raises(_Captured):
        load_script(script).main()
    return got["args"], got["kwargs"]


def random_inputs(m, n=N, seed=0, t_max=1.2):
    """Numpy (qpos, qvel, time, ctrl, prev_ctrl): home with noise, unit
    quaternions, times over [0, t_max) (every phase of a phased cost)."""
    rng = np.random.default_rng(seed)
    nq, nv = m.nq, m.nv
    qpos = np.tile(np.asarray(m.key_qpos[0], np.float32), (n, 1))
    qpos[:, :3] += rng.normal(0, 0.1, (n, 3))
    qpos[:, 3:7] += rng.normal(0, 0.2, (n, 4))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 7:] += rng.normal(0, 0.2, (n, nq - 7))
    qvel = rng.normal(0, 1.0, (n, nv))
    time = rng.uniform(0.0, t_max, n)
    lo, hi = np.asarray(m.actuator_ctrlrange).T
    ctrl, prev = (rng.uniform(lo, hi, (n, m.nu)) for _ in range(2))
    return tuple(np.asarray(x, np.float32)
                 for x in (qpos, qvel, time, ctrl, prev))


def held(jax_cost, port_cost, inputs):
    """Both costs on the same inputs (JAX vmapped over the batch, the port
    batch-first), to RTOL."""
    qpos, qvel, time, ctrl, prev = inputs
    want = np.asarray(jax.vmap(jax_cost)(
        JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                 time=jnp.asarray(time)), jnp.asarray(ctrl),
        jnp.asarray(prev)))
    t = [torch.from_numpy(x) for x in inputs]
    got = port_cost(State(qpos=t[0], qvel=t[1], time=t[2]), t[3],
                    t[4]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.ptp(want) > 0  # the inputs spread the cost


@pytest.mark.parametrize("name", ["jump", "landing"])
def test_mppi_script_costs_match_the_jax_closures(monkeypatch, name):
    """torch_jump_mpc.jump_cost / torch_landing_mpc.landing_cost against
    the ``step_cost`` closure of jump_mpc.py:58-83 / landing_mpc.py:44-56
    (captured at ``mppi.make_solver``), and the MPPI configuration the JAX
    script builds against the port script's."""
    (jm, jcost, jcfg), _ = capture(monkeypatch, jax_mppi, "make_solver",
                                   f"{name}_mpc", [])
    mod = load_script(f"torch_{name}_mpc")
    m = assets.load_go1(name, device="cpu")
    cost = mod.jump_cost(m) if name == "jump" else mod.landing_cost(m)
    held(jcost, cost, random_inputs(jm))
    want = dict(jcfg._asdict(), engine="ops")
    got = MPPIConfig(**mod.CONFIG)
    assert {k: getattr(got, k) for k in want} == want


def test_jump_cost_options_match_the_jax_closure(monkeypatch):
    """The jump cost's phase times and launch targets, passed on the
    command line of both scripts."""
    argv = ["--t_crouch", "0.3", "--t_launch", "0.6", "--vx", "1.8",
            "--vz", "2.5"]
    (jm, jcost, _), _ = capture(monkeypatch, jax_mppi, "make_solver",
                                "jump_mpc", argv)
    m = assets.load_go1("jump", device="cpu")
    cost = load_script("torch_jump_mpc").jump_cost(m, 0.3, 0.6, 1.8, 2.5)
    held(jcost, cost, random_inputs(jm, seed=1))


@pytest.mark.parametrize("arm", ["trot", "landing"])
def test_ilqr_gait_costs_match_the_jax_arms(monkeypatch, arm):
    """torch_ilqr_gait's arm costs against the contact-schedule costs that
    ilqr_gait.py builds (lines 59-64, 108-115; captured at
    ``make_ilqr_tracker``), and the arm's iLQR configuration and tracked
    ticks."""
    (jm, jcost, jcfg), kw = capture(monkeypatch, jax_mpc,
                                    "make_ilqr_tracker", "ilqr_gait",
                                    ["--arms", arm])
    mod = load_script("torch_ilqr_gait")
    m = assets.load_go1("flat", device="cpu")
    cost = (mod.trot_arm_cost if arm == "trot" else mod.landing_arm_cost)(m)
    held(jcost, cost, random_inputs(jm, seed=2, t_max=2.0))
    cfg = mod.TROT if arm == "trot" else mod.LANDING
    assert {k: getattr(jcfg, k) for k in cfg} == cfg
    assert kw == dict(track_ticks=cfg["horizon"], plant_substeps=10)


@pytest.mark.parametrize("name", ["turn", "lag"])
def test_trot_script_costs_match_the_package_cost(name):
    """The turn and the lag sweep hand the package's trot cost their
    parameters; the port's scripts build the same cost."""
    jm = jax_assets.load_go1("flat")
    home = np.asarray(jm.key_qpos[0])[7:]
    if name == "turn":
        p = jax_costs.TrotCostParams(desired_vel_xy=(0.25, 0.25),
                                     target_height=0.265,
                                     desired_yaw=np.pi / 4, w_heading=10.0,
                                     w_yaw_rate=0.5)
    else:
        p = jax_costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                     target_height=0.265)
    mod = load_script(f"torch_{name}_mpc" if name == "turn"
                      else "torch_lag_sweep")
    m = assets.load_go1("flat", device="cpu")
    cost = mod.turn_cost(m) if name == "turn" else mod.lag_cost(m)
    held(jax_costs.trot_cost(jm, p, home, legs="go1"), cost,
         random_inputs(jm, seed=3))


def test_jump_tick_matches_jitted_jax(monkeypatch):
    """One tick of torch_jump_mpc (the op-graph solve with sphere-vs-box
    contact on the jump scene, K=8, H=5, one substep, then the plant's 10
    substeps) against the same tick of the JAX script (jump_mpc.py:89-97,
    its captured cost) jitted at ``default_matmul_precision("highest")``,
    on the normals JAX draws: qpos after the tick and the next nominal to
    1e-4, the paws' contact equal."""
    (jm, jcost, _), _ = capture(monkeypatch, jax_mppi, "make_solver",
                                "jump_mpc", [])
    monkeypatch.undo()
    mod = load_script("torch_jump_mpc")
    m = assets.load_go1("jump", device="cpu")
    cfg = jax_mppi.MPPIConfig(**{k: v for k, v in mod.SMOKE.items()
                                 if k != "engine"}, engine="xla")
    jsolve = jax_mppi.make_solver(jm, jcost, cfg)

    @jax.jit
    def jtick(st, ms, key):
        with jax.default_matmul_precision("highest"):
            ctrl, ms, _ = jsolve(st, ms, key)
            st, info = jax_dynamics.step(jm, st, ctrl, None, n_substeps=10)
        _, _, ic = jax_dynamics.foot_contact_summary(jm, info.contact)
        return st.qpos, ms.nominal, ic.any()

    s0 = jax_mppi.init_state(jm, cfg)
    from opendog_tpu.physics import make_state as jax_make_state
    js = jax_make_state(jm, "home")
    js = js.replace(qpos=js.qpos.at[0].set(0.25))
    key = jax.random.PRNGKey(5)
    want_q, want_nom, want_ic = jtick(js, s0, key)

    normals = torch.from_numpy(_solve_normals(key, cfg.num_samples,
                                              cfg.horizon, m.nu))[None]
    tick = mod.make_tick(m, mod.jump_cost(m), mod.SMOKE, graphs=False)
    st = mod.start_state(m)
    nominal = mppi.init_state(m, MPPIConfig(**mod.SMOKE)).nominal
    q, _, _, nom, ic = tick(st.qpos, st.qvel, st.time, nominal, normals[0])
    np.testing.assert_allclose(nom.numpy(), np.asarray(want_nom), atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-4)
    assert bool(ic) == bool(want_ic)
    qs, contact = mod.run(m, 1, mod.SMOKE, normals=normals, graphs=False)
    np.testing.assert_array_equal(qs[0], q.numpy())
    assert contact.tolist() == [bool(ic)]
