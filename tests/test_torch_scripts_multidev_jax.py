"""scripts/torch_multiprocess_scaling.py's two programs against the JAX
package on the same inputs, on the CPU:

* the envs mode's start (the home qpos plus 0.02 standard normals of
  ``numpy.random.default_rng(0)``, as scripts/multiprocess_scaling.py's
  worker draws them) equal to the JAX worker's, and its tick (10 op-graph
  substeps under the home control) over 2 ticks at B = 4 envs against
  ``jax.vmap(dynamics.step(..., n_substeps=10))`` jitted: qpos 1e-4, qvel
  1e-3;
* the mppi mode's sharded solve at 2 gloo ranks x K = 8 (OpenDOG flat,
  standing_cost, H = 10, 2 x 10 ms, sigma 0.08) against the JAX worker's
  ``mppi.make_solver`` at K = 16 on the JAX solve's own normals, within
  tests/test_torch_sharded_mppi.py's SOLVE_TOLS (ctrl and nominal 1e-5,
  best_cost, mean_cost and ess 1e-4); every rank the same bits;
* the collective counter counts that solve's two all_reduces (pmin of the
  best cost, psum of the weighted sums: slot buffers of 2 x 4 and
  2 x 4 x (H nu + 3) bytes) and changes no result bit: the same solve
  with an uncounted all_reduce in its place gives the same bits.
"""
import os
import sys

import numpy as np
import pytest
import torch
import jax

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch.assets import load_opendog
from test_torch_mppi_mpc import _solve_normals
from test_torch_parallel_mesh import run_ranks, same_on_every_rank

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_multiprocess_scaling as mps  # noqa: E402

B, TICKS = 4, 2
ENV_TOL = dict(qpos=1e-4, qvel=1e-3)
SAMPLES, RANKS = 8, 2
SOLVE_TOLS = dict(ctrl=1e-5, nominal=1e-5, best_cost=1e-4, mean_cost=1e-4,
                  ess=1e-4)


def test_envs_tick_matches_jax():
    jm = jax_assets.load_opendog("flat")
    m = load_opendog("flat", device="cpu")
    # the JAX worker's start (scripts/multiprocess_scaling.py:91-95)
    qpos_full = np.tile(np.asarray(jm.key_qpos[0], np.float32), (B, 1))
    qpos_full += 0.02 * np.random.default_rng(0).standard_normal(
        qpos_full.shape).astype(np.float32)
    state, ctrl = mps.envs_start(m, B)
    np.testing.assert_array_equal(state.qpos.numpy(), qpos_full)
    np.testing.assert_array_equal(ctrl.numpy(), np.tile(
        np.asarray(jm.key_ctrl[0], np.float32), (B, 1)))

    jstep = jax.jit(jax.vmap(lambda a, c: jax_dynamics.step(
        jm, a, c, None, n_substeps=10)[0]))
    js = JaxState(qpos=qpos_full, qvel=np.zeros((B, jm.nv), np.float32),
                  time=np.zeros(B, np.float32))
    tick = mps.envs_tick(m)
    carry = (state.qpos, state.qvel, state.time)
    with torch.no_grad():
        for t in range(TICKS):
            js = jstep(js, np.asarray(ctrl.numpy()))
            carry = tick(*carry, ctrl)
            for k, got in zip(("qpos", "qvel"), carry):
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(getattr(js, k)), rtol=0,
                    atol=ENV_TOL[k], err_msg=f"tick {t}: {k}")
    assert np.isfinite(carry[0].numpy()).all()


RANK_BODY = """
sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
import torch_multiprocess_scaling as mps
from opendog_tpu_torch.parallel import collectives, sample_mesh
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import mppi
inp = load_inputs()
mesh = sample_mesh(device="cpu")
m, cfg, solve = mps.mppi_setup(N, inp["samples"], inp["horizon"], "cpu",
                               mesh)


def one():
    c, ms, st = solve(make_state(m, "home"), mppi.init_state(m, cfg),
                      None, inp["normals"])
    return dict(ctrl=c, nominal=ms.nominal, **st)


collectives.TRAFFIC.clear()
out = one()
counts = {f"{what} x{numel}": torch.tensor(calls) for (what, _, numel),
          calls in collectives.TRAFFIC.items()}


def uncounted(what, buf, mesh):
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)


collectives._all_reduce = uncounted
again = one()
same = all(torch.equal(out[k], again[k]) for k in out)
save(dict(solve=out, counts=counts, same=dict(same=torch.tensor(same))))
"""


def test_mppi_mode_solve_matches_jax_at_two_ranks(tmp_path):
    jm = jax_assets.load_opendog("flat")
    K = SAMPLES * RANKS
    cfg = JaxMPPIConfig(horizon=mps.HORIZON, num_samples=K, n_substeps=2,
                        rollout_dt=0.01, noise_sigma=0.08)
    cost = jax_costs.standing_cost(jm, 0.0694, np.asarray(jm.key_qpos[0])[7:])
    key = jax.random.PRNGKey(0)
    c, ms, st = jax.jit(jax_mppi.make_solver(jm, cost, cfg))(
        jax_make_state(jm, "home"), jax_mppi.init_state(jm, cfg), key)
    want = dict(ctrl=c, nominal=ms.nominal, **st)
    normals = torch.from_numpy(_solve_normals(key, K, mps.HORIZON, jm.nu))
    results = run_ranks(tmp_path, RANK_BODY, RANKS, inputs=dict(
        normals=normals, samples=SAMPLES, horizon=mps.HORIZON))
    got = same_on_every_rank(results, "solve")
    for k, tol in SOLVE_TOLS.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    row = mps.HORIZON * jm.nu + 3
    for res in results:
        assert bool(res["same"]["same"])
        assert {k: int(v) for k, v in res["counts"].items()} == {
            "pmin x2": 1, f"psum x{RANKS * row}": 1}
