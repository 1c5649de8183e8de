"""The horizon-sharded iLQR solve (``make_ilqr(..., mesh=)``) at 2 and 4
gloo ranks on the CPU against the JAX package's on 8 virtual devices and
the port's one-process associative solve: OpenDOG flat, standing_cost,
horizon 8, one substep of 4 ms, one iteration
(tests/test_sharded_solvers.py:167-188).  Tolerances are the JAX test's:
U 5e-4, cost 1e-4.  Every rank returns the same bits.  A file of its own:
the jitted JAX solve takes most of a minute to compile on a CPU."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import ilqr as jax_ilqr
from test_torch_parallel_mesh import run_ranks, same_on_every_rank

torch.set_num_threads(1)

CFG = dict(horizon=8, n_substeps=1, rollout_dt=0.004, iterations=1,
           riccati="associative")

SOLVE = """
import torch
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr


def solve(cfg, mesh):
    m = assets.load_opendog("flat", device="cpu")
    s = make_ilqr(m, costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:]),
                  ILQRConfig(**cfg), device="cpu", graphs=False, mesh=mesh)
    U0 = m.key_ctrl[0][None].repeat(cfg["horizon"], 1)
    U, X, stats = s(make_state(m, "home"), U0)
    return dict(U=U, X=X, cost=stats["cost"],
                initial_cost=stats["initial_cost"])
"""

RANK_BODY = SOLVE + """
from opendog_tpu_torch.parallel import make_mesh
save(dict(solve=solve(load_inputs(), make_mesh(axis="sp", device="cpu"))))
"""


@pytest.fixture(scope="module")
def refs(devices8):
    jm = jax_assets.load_opendog("flat")
    cost = jax_costs.standing_cost(jm, 0.0694, np.asarray(jm.key_qpos[0])[7:])
    cfg = jax_ilqr.ILQRConfig(**CFG)
    U0 = jnp.tile(jnp.asarray(jm.key_ctrl[0])[None], (cfg.horizon, 1))
    mesh = JaxMesh(np.array(jax.devices()[:8]), axis_names=("sp",))
    U, X, st = jax.jit(jax_ilqr.make_ilqr(jm, cost, cfg, mesh=mesh))(
        jax_make_state(jm, "home"), U0)
    ns = {}
    exec(SOLVE, ns)
    return dict(U=U, cost=st["cost"]), ns["solve"](CFG, None), ns


@pytest.mark.parametrize("n", [2, 4])
def test_horizon_sharded_solve_matches_jax_and_one_process(refs, n,
                                                           tmp_path):
    want, one, _ = refs
    results = run_ranks(tmp_path, RANK_BODY, n, inputs=CFG)
    got = same_on_every_rank(results, "solve")
    assert float(got["cost"]) <= float(got["initial_cost"]) + 1e-3
    for ref, what in ((want, "JAX"), (one, "one process")):
        np.testing.assert_allclose(got["U"].numpy(), np.asarray(ref["U"]),
                                   rtol=5e-4, atol=5e-4, err_msg=what)
        np.testing.assert_allclose(float(got["cost"]), float(ref["cost"]),
                                   rtol=1e-4, atol=1e-4, err_msg=what)


def test_one_rank_mesh_is_the_unsharded_solve_and_needs_assoc(refs):
    """A mesh of one rank (no process group): the unsharded associative
    solve bit for bit; the sequential sweep cannot be sharded."""
    from opendog_tpu_torch import assets
    from opendog_tpu_torch.parallel import make_mesh
    from opendog_tpu_torch.solvers import ILQRConfig, costs, make_ilqr

    _, one, ns = refs
    got = ns["solve"](CFG, make_mesh(axis="sp", device="cpu"))
    for k, v in one.items():
        assert torch.equal(got[k], v), k
    m = assets.load_opendog("flat", device="cpu")
    with pytest.raises(ValueError, match="associative"):
        make_ilqr(m, costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:]),
                  ILQRConfig(**dict(CFG, riccati="scan")), device="cpu",
                  mesh=make_mesh(axis="sp", device="cpu"))
