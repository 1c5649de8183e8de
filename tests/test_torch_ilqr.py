"""The port's iLQR pieces against the JAX package's on the same inputs:

* ``_vf_combine`` (batched and broadcast blocks) at 1e-5 relative to the
  largest entry;
* ``associative_lqr_gains`` against the port's ``sequential_lqr_gains``
  (1e-3 relative to the largest gain: the two recursions round apart, and
  tests/test_ilqr.py holds the JAX pair at 2e-3) and against the JAX
  package's associative pass (1e-5), on the random LQR of
  tests/test_ilqr.py rebuilt from numpy;
* the dynamics Jacobians A, B and the cost expansion of a solve (its
  ``expand``: ``vmap(jacfwd)``, ``grad``, ``hessian``) against
  ``jax.jacfwd`` / ``jax.grad`` / ``jax.hessian`` of the JAX package's
  stage function, OpenDOG flat at 2 substeps of 2 ms: relative to each
  array's largest entry, 3e-5 for A and B (see JAC_REL) and 1e-5 for the
  cost expansion;
* the line-search pick against ``jnp.argmin``'s, NaN candidates included.

Whole solves are in test_torch_ilqr_solve*.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState, dynamics as jax_dynamics
from opendog_tpu.solvers import costs as jax_costs, ilqr as jax_ilqr
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import dynamics, make_state
from opendog_tpu_torch.solvers import costs, ilqr

torch.set_num_threads(1)

REL = 1e-5
SEQ_REL = 1e-3
# the Jacobians against JAX's jitted ones: on these inputs the JAX
# package's own jitted and op-by-op Jacobians of A differ by 1.9e-5 of the
# largest entry (XLA fuses products and sums into one rounding); the port
# reads 5.4e-6 from the op-by-op ones, which take 40 s to run
JAC_REL = 3e-5


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _random_blocks(rng, shape, nx):
    """Value-function blocks (F, c, C, eta, J), C and J symmetric PSD."""
    def psd():
        W = rng.normal(0, 0.3, shape + (nx, nx))
        return (W @ np.swapaxes(W, -1, -2)).astype(np.float32)

    F = (rng.normal(0, 0.3, shape + (nx, nx)) + np.eye(nx)).astype(
        np.float32)
    return (F, rng.normal(0, 1, shape + (nx,)).astype(np.float32), psd(),
            rng.normal(0, 1, shape + (nx,)).astype(np.float32), psd())


@pytest.mark.parametrize("earlier_shape,later_shape", [
    ((), ()), ((5,), (5,)), ((3,), ()), ((2, 3), (3,))])
def test_vf_combine_matches_jax(earlier_shape, later_shape):
    rng = np.random.default_rng(len(earlier_shape) * 10 + len(later_shape))
    nx = 6
    a = _random_blocks(rng, earlier_shape, nx)
    b = _random_blocks(rng, later_shape, nx)
    want = jax_ilqr._vf_combine(tuple(map(jnp.asarray, a)),
                                tuple(map(jnp.asarray, b)))
    got = ilqr._vf_combine(tuple(map(torch.from_numpy, a)),
                           tuple(map(torch.from_numpy, b)))
    for name, g, w in zip(("F", "c", "C", "eta", "J"), got, want):
        _close(g.numpy(), w, REL, name)


def test_vf_identity_is_neutral():
    rng = np.random.default_rng(1)
    e = tuple(map(torch.from_numpy, _random_blocks(rng, (), 5)))
    ident = ilqr._vf_identity(5)
    for out in (ilqr._vf_combine(e, ident), ilqr._vf_combine(ident, e)):
        for g, w in zip(out, e):
            _close(g.numpy(), w.numpy(), 1e-6)


def _random_lqr(seed, H, nx=6, nu=3):
    """tests/test_ilqr.py::_random_lqr's construction, from numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    A = (rng.normal(0, 0.3, (H, nx, nx)) + np.eye(nx)[None]).astype(f)
    B = rng.normal(0, 0.3, (H, nx, nu)).astype(f)
    lx = rng.normal(0, 1, (H, nx)).astype(f)
    lu = (rng.normal(0, 1, (H, nu)) * 0.1).astype(f)
    W = rng.normal(0, 0.3, (H, nx, nx))
    lxx = (np.einsum("hij,hkj->hik", W, W) + np.eye(nx)[None]).astype(f)
    Wu = rng.normal(0, 0.3, (H, nu, nu))
    luu = (np.einsum("hij,hkj->hik", Wu, Wu) + np.eye(nu)[None]).astype(f)
    lux = (rng.normal(0, 1, (H, nu, nx)) * 0.1).astype(f)
    vx = rng.normal(0, 1, nx).astype(f)
    vxx = (np.eye(nx) * 2.0).astype(f)
    return A, B, lx, lu, lxx, luu, lux, vx, vxx


@pytest.mark.parametrize("H", [12, 7, 1])
@pytest.mark.parametrize("reg", [1e-9, 1e-3])
def test_associative_gains_match_sequential_and_jax(H, reg):
    """12 stages (13 blocks with the terminal one: an odd scan), 7 (even)
    and 1."""
    lqr = _random_lqr(H, H)
    args = tuple(map(torch.from_numpy, lqr))
    k, K, dV = ilqr.associative_lqr_gains(*args, reg)
    ks, Ks, dVs = ilqr.sequential_lqr_gains(*args, reg)
    _close(k.numpy(), ks.numpy(), SEQ_REL, "k vs sequential")
    _close(K.numpy(), Ks.numpy(), SEQ_REL, "K vs sequential")
    _close(dV.numpy(), dVs.numpy(), SEQ_REL, "dV vs sequential")
    jk, jK, jdV = jax_ilqr.associative_lqr_gains(
        *map(jnp.asarray, lqr), reg)
    _close(k.numpy(), jk, REL, "k vs JAX")
    _close(K.numpy(), jK, REL, "K vs JAX")
    _close(dV.numpy(), jdV, REL, "dV vs JAX")


def test_suffix_scan_is_the_sequential_suffix():
    """Every prefix of the reverse scan composes its suffix of blocks."""
    rng = np.random.default_rng(5)
    blocks = tuple(map(torch.from_numpy, _random_blocks(rng, (6,), 4)))
    comp = ilqr._suffix_scan(blocks)
    acc = tuple(b[5] for b in blocks)
    for t in range(4, -1, -1):
        acc = ilqr._vf_combine(tuple(b[t] for b in blocks), acc)
        for g, w in zip(comp, acc):
            _close(g[t].numpy(), w.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# Jacobians and cost expansion: OpenDOG flat, the JAX iLQR tests' robot
# ---------------------------------------------------------------------------

H = 4
CFG = dict(horizon=H, n_substeps=2, rollout_dt=0.002)


@pytest.fixture(scope="module")
def dog():
    """Both models, the standing state settled for 200 substeps (by the
    port: the same numpy arrays go to both packages), a plan near the home control, kept off the clip bounds
    (OpenDOG's home thigh control lies just below its ctrlrange, and the
    packages may take other subgradients at a bound), the JAX rollout of
    that plan and the JAX Jacobians along it."""
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    s, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0],
                         n_substeps=200)
    rng = np.random.default_rng(0)
    cr = np.asarray(jm.actuator_ctrlrange)
    U = (np.asarray(jm.key_ctrl[0])[None]
         + rng.uniform(-0.05, 0.05, (H, jm.nu)))
    U = np.clip(U, cr[:, 0] + 0.02, cr[:, 1] - 0.02).astype(np.float32)
    x0 = torch.cat([s.qpos, s.qvel]).numpy()
    jf, _, _ = _jax_stage_functions(jm, None, CFG)
    X = np.asarray(_jax_rollout(jax.jit(jf), jnp.asarray(x0),
                                jnp.asarray(U)))
    A, B = jax.jit(jax.vmap(jax.jacfwd(jf, argnums=(0, 1))))(X[:-1], U)
    return jm, m, X, U, dict(A=np.asarray(A), B=np.asarray(B))


def _jax_stage_functions(jm, step_cost, cfg):
    """The JAX package's f and stage costs (solvers/ilqr.py:219-253), for
    its derivatives: make_ilqr keeps them inside its closure."""
    nq, nu = jm.nq, jm.nu
    rm = jm.replace(timestep=cfg["rollout_dt"])

    def f(x, u):
        st = JaxState(qpos=x[:nq], qvel=x[nq:], time=jnp.zeros(()))
        with jax.default_matmul_precision("highest"):
            st2, _ = jax_dynamics.step(rm, st, u, None,
                                       n_substeps=cfg["n_substeps"])
        return jnp.concatenate([st2.qpos, st2.qvel])

    def stage_cost(x, u, u_prev, t):
        st = JaxState(qpos=x[:nq], qvel=x[nq:], time=t)
        return step_cost(st, u, u_prev) + 1e-3 * jnp.sum(jnp.square(u))

    def term_cost(x, t):
        st = JaxState(qpos=x[:nq], qvel=x[nq:], time=t)
        return step_cost(st, jnp.zeros(nu), jnp.zeros(nu))

    return f, stage_cost, term_cost


def _jax_rollout(f, x0, U):
    xs = [x0]
    for u in U:
        xs.append(f(xs[-1], u))
    return jnp.stack(xs)


COSTS = {
    "standing": lambda c, m, home: c.standing_cost(m, 0.0694, home),
    "trot_schedule": lambda c, m, home: c.contact_schedule_cost(
        m, c.trot_schedule(c.TrotCostParams(target_height=0.07), "opendog"),
        c.TrotCostParams(target_height=0.07), home, legs="opendog"),
}


@pytest.mark.parametrize("cost_name", sorted(COSTS))
def test_expansion_matches_jax(dog, cost_name):
    jm, m, X, U, jac = dog
    home = np.asarray(jm.key_qpos[0])[7:]
    _, jstage, jterm = _jax_stage_functions(
        jm, COSTS[cost_name](jax_costs, jm, home), CFG)
    times = (0.13 + 0.01 * np.arange(H + 1)).astype(np.float32)
    Up = np.concatenate([U[:1], U[:-1]])
    args = tuple(map(jnp.asarray, (X[:-1], U, Up, times[:-1])))
    @jax.jit
    def expansion(args, xT, tT):
        """The JAX package's cost_expansion (solvers/ilqr.py:280-293)."""
        return dict(
            lx=jax.vmap(jax.grad(jstage, argnums=0))(*args),
            lu=jax.vmap(jax.grad(jstage, argnums=1))(*args),
            lxx=jax.vmap(jax.hessian(jstage, argnums=0))(*args),
            luu=jax.vmap(jax.hessian(jstage, argnums=1))(*args),
            lux=jax.vmap(jax.jacfwd(jax.grad(jstage, argnums=1),
                                    argnums=0))(*args),
            vx=jax.grad(jterm)(xT, tT), vxx=jax.hessian(jterm)(xT, tT))

    want = dict(jac, **expansion(args, X[-1], times[-1]))

    solve = ilqr.make_ilqr(m, COSTS[cost_name](costs, m, home),
                           ilqr.ILQRConfig(**CFG), device="cpu")
    got = solve.expand(torch.from_numpy(X), torch.from_numpy(U),
                       torch.from_numpy(times))
    for name, g in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux", "vx",
                        "vxx"), got):
        _close(g.numpy(), want[name], JAC_REL if name in "AB" else REL, name)
    # the cost of the whole plan too
    want_total = (np.sum(np.asarray(jax.vmap(jstage)(*args)))
                  + float(jterm(X[-1], times[-1])))
    got_total = solve.total_cost(*map(torch.from_numpy, (X, U, times)))
    np.testing.assert_allclose(float(got_total), want_total, rtol=REL)


@pytest.mark.parametrize("cands", [
    [3.0, 1.0, 1.0, 2.0, 5.0],               # a tie: the first minimum
    [3.0, np.nan, 0.5, 2.0, 5.0],            # a NaN is picked and loses
    [np.nan, np.nan, np.nan, np.nan, np.nan],
    [9.0, 8.0, 7.5, 9.5, 8.5],               # none improves on 7.0
    [np.inf, 6.0, -np.inf, 1.0, 2.0],
])
def test_pick_matches_jnp_argmin(cands):
    """The line search's choice on the device, against the JAX package's
    ``jnp.argmin`` / ``costs[best] < cost`` (solvers/ilqr.py:365-367)."""
    cost = np.float32(7.0)
    c = np.asarray(cands, np.float32)
    best, c_best, improved = ilqr._pick(torch.from_numpy(c),
                                        torch.tensor(cost))
    jbest = int(jnp.argmin(jnp.asarray(c)))
    assert int(best) == jbest
    np.testing.assert_array_equal(float(c_best), c[jbest])
    assert bool(improved) == bool(jnp.asarray(c)[jbest] < cost)
