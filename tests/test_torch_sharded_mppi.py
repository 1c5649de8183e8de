"""Sample-sharded MPPI (``mppi.make_solver(..., mesh=)``,
``make_mpc(..., mesh=)``) at 2 and 4 gloo ranks on the CPU, against the
JAX package's sharded solve on 8 virtual devices and against the port's
one-process solve, on the JAX solve's own normals
(``test_torch_mppi_mpc._solve_normals``):

* one solve, OpenDOG flat, standing_cost, K=32, H=4 (the setup of
  tests/test_sharded_solvers.py:27-52; the port on the substep kernel's
  plain version, the JAX solve on its default op-graph engine);
* three receding solves, K=16, H=3 (:55-74);
* per-geom terrain planes on the mini robot's ramp, K=16, H=3, the JAX
  kernel in interpret mode (:76-128);
* three ``make_mpc(mesh=)`` ticks with a plant of 2 substeps, against the
  one-process ``make_mpc``.

Tolerances are the JAX tests' (the sums of the update in another order):
ctrl and nominal 1e-5, best_cost / mean_cost / ess 1e-4, the receding
controls 1e-4; the MPC ticks 1e-5 (ctrl, plant qpos) and 1e-4 (stats).
Every rank's outputs are the same bits.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import opendog_tpu.ops.pallas_step as jax_pallas_step
from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import Terrain as JaxTerrain
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mppi as jax_mppi
from test_torch_mppi_mpc import _solve_normals
from test_torch_parallel_mesh import run_ranks, same_on_every_rank

torch.set_num_threads(1)

FLAT = dict(horizon=4, num_samples=32, n_substeps=1, rollout_dt=0.01,
            noise_sigma=0.1, temperature=0.3)
TICKS = dict(horizon=3, num_samples=16, n_substeps=1, rollout_dt=0.01)
PERGEOM = dict(horizon=3, num_samples=16, n_substeps=1, rollout_dt=0.004,
               noise_sigma=0.05)
MPC = dict(horizon=4, num_samples=16, n_substeps=1, rollout_dt=0.01,
           noise_sigma=0.05)
N_TICKS = 3

# the port's side, run by every rank (mesh) and by this process (None)
CASES = """
import torch
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state, terrain_from_numpy
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc, mppi


def run_cases(inp, mesh):
    out = {}
    m = assets.load_opendog("flat", device="cpu")
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    home = make_state(m, "home")
    cfg = MPPIConfig(**inp["flat"])
    solve = mppi.make_solver(m, cost, cfg, device="cpu", mesh=mesh)
    c, ms, st = solve(home, mppi.init_state(m, cfg),
                      normals=inp["flat_normals"])
    out["flat"] = dict(ctrl=c, nominal=ms.nominal, **st)

    cfg = MPPIConfig(**inp["ticks"])
    solve = mppi.make_solver(m, cost, cfg, device="cpu", mesh=mesh)
    ms, ctrls = mppi.init_state(m, cfg), []
    for normals in inp["tick_normals"]:
        c, ms, _ = solve(home, ms, normals=normals)
        ctrls.append(c)
    out["ticks"] = dict(ctrl=torch.stack(ctrls), nominal=ms.nominal)

    mini = assets.load_mini(device="cpu").replace(
        hfield_size=torch.tensor([2.0, 2.0, 1.0, 0.0]))
    cfg = MPPIConfig(**inp["pergeom"])
    solve = mppi.make_solver(
        mini, costs.standing_cost(mini, 0.115, mini.key_qpos[0, 7:]), cfg,
        device="cpu", terrain=terrain_from_numpy(inp["ramp"], "cpu"),
        plane_mode="per_geom", mesh=mesh)
    c, ms, st = solve(make_state(mini, "home"), mppi.init_state(mini, cfg),
                      normals=inp["pergeom_normals"])
    out["pergeom"] = dict(ctrl=c, nominal=ms.nominal, **st)

    init, _, run = make_mpc(m, cost, MPPIConfig(**inp["mpc"]),
                            plant_substeps=2, device="cpu", mesh=mesh)
    _, out["mpc"] = run(init(None, home), len(inp["mpc_normals"]),
                        normals=inp["mpc_normals"])
    return out
"""

RANK_BODY = CASES + """
from opendog_tpu_torch.parallel import sample_mesh
mesh = sample_mesh(device="cpu")
out = run_cases(load_inputs(), mesh)
m = assets.load_opendog("flat", device="cpu")
try:  # K must divide over the ranks (mppi.py:138)
    mppi.make_solver(m, costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:]),
                     MPPIConfig(num_samples=4 * N + 1), device="cpu",
                     mesh=mesh)
    out["raises"] = dict(ragged_k=torch.tensor(False))
except ValueError:
    out["raises"] = dict(ragged_k=torch.tensor(True))
save(out)
"""


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:8]), axis_names=("mp",))


@pytest.fixture(scope="module")
def refs(devices8):
    """The inputs of every case, the JAX sharded solves on 8 virtual
    devices and the port's one-process solves."""
    jm = jax_assets.load_opendog("flat")
    jcost = jax_costs.standing_cost(jm, 0.0694, np.asarray(jm.key_qpos[0])[7:])
    jstate = jax_make_state(jm, "home")
    nu = jm.nu
    inp = dict(flat=FLAT, ticks=TICKS, pergeom=PERGEOM, mpc=MPC)
    want = {}

    key = jax.random.PRNGKey(7)
    inp["flat_normals"] = torch.from_numpy(_solve_normals(key, 32, 4, nu))
    cfg = JaxMPPIConfig(**FLAT)
    c, ms, st = jax.jit(jax_mppi.make_solver(jm, jcost, cfg,
                                             mesh=_jax_mesh()))(
        jstate, jax_mppi.init_state(jm, cfg), key)
    want["flat"] = dict(ctrl=c, nominal=ms.nominal, **st)

    cfg = JaxMPPIConfig(**TICKS)
    solve = jax.jit(jax_mppi.make_solver(jm, jcost, cfg, mesh=_jax_mesh()))
    ms, key, ctrls, normals = jax_mppi.init_state(jm, cfg), \
        jax.random.PRNGKey(0), [], []
    for _ in range(N_TICKS):
        key, sub = jax.random.split(key)
        normals.append(_solve_normals(sub, 16, 3, nu))
        c, ms, _ = solve(jstate, ms, sub)
        ctrls.append(c)
    inp["tick_normals"] = torch.from_numpy(np.stack(normals))
    want["ticks"] = dict(ctrl=np.stack(ctrls), nominal=ms.nominal)

    xs = np.linspace(-2.0, 2.0, 9, dtype=np.float32)
    inp["ramp"] = np.tile(0.05 * xs[None, :], (9, 1))
    mini = jax_assets.load_mini().replace(
        hfield_size=jnp.asarray([2.0, 2.0, 1.0, 0.0], jnp.float32))
    cfg = JaxMPPIConfig(engine="pallas", **PERGEOM)
    key = jax.random.PRNGKey(3)
    inp["pergeom_normals"] = torch.from_numpy(
        _solve_normals(key, 16, 3, mini.nu))
    orig = jax_pallas_step.build_pallas_substep
    try:
        jax_pallas_step.build_pallas_substep = lambda *a, **k: orig(
            *a, **{**k, "interpret": True})
        solve = jax.jit(jax_mppi.make_solver(
            mini, jax_costs.standing_cost(mini, 0.115,
                                          np.asarray(mini.key_qpos[0])[7:]),
            cfg, terrain=JaxTerrain(height=jnp.asarray(inp["ramp"])),
            plane_mode="per_geom", mesh=_jax_mesh()))
        c, ms, st = solve(jax_make_state(mini, "home"),
                          jax_mppi.init_state(mini, cfg), key)
    finally:
        jax_pallas_step.build_pallas_substep = orig
    want["pergeom"] = dict(ctrl=c, nominal=ms.nominal, **st)

    inp["mpc_normals"] = torch.from_numpy(np.random.default_rng(5).normal(
        size=(N_TICKS, 16, 4, nu)).astype(np.float32))
    ns = {}
    exec(CASES, ns)
    return inp, want, ns["run_cases"](inp, None)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, refs, tmp_path_factory):
    """The cases on ``n`` gloo ranks: rank 0's outputs, after checking that
    every rank returned the same bits."""
    n = request.param
    results = run_ranks(tmp_path_factory.mktemp(f"mppi{n}"), RANK_BODY, n,
                        inputs=refs[0])
    assert all(bool(r["raises"]["ragged_k"]) for r in results)
    return n, {case: same_on_every_rank(results, case)
               for case in ("flat", "ticks", "pergeom", "mpc")}


def _close(got, want, keys, what):
    """``got[k]`` against ``want[k]`` at rtol = atol = tol, as the JAX
    tests compare."""
    for k, tol in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=f"{what}: {k}")


SOLVE_TOLS = (("ctrl", 1e-5), ("nominal", 1e-5), ("best_cost", 1e-4),
              ("mean_cost", 1e-4), ("ess", 1e-4))


@pytest.mark.parametrize("case", ["flat", "pergeom"])
def test_sharded_solve_matches_jax_and_one_process(refs, ranks, case):
    """One sharded solve (flat; per-geom planes on the ramp) against the
    JAX 8-device solve and the port's one-process solve."""
    _, want, one = refs
    n, got = ranks
    _close(got[case], want[case], SOLVE_TOLS, f"{case} vs JAX, n={n}")
    _close(got[case], one[case], SOLVE_TOLS,
           f"{case} vs one process, n={n}")


def test_sharded_multi_tick_stays_consistent(refs, ranks):
    """Three receding solves track the JAX sharded plan and the port's
    one-process plan (1e-4, tests/test_sharded_solvers.py:73)."""
    _, want, one = refs
    n, got = ranks
    keys = (("ctrl", 1e-4), ("nominal", 1e-4))
    _close(got["ticks"], want["ticks"], keys, f"ticks vs JAX, n={n}")
    _close(got["ticks"], one["ticks"], keys,
           f"ticks vs one process, n={n}")


def test_sharded_mpc_ticks_match_one_process(refs, ranks):
    """make_mpc(mesh=): the plant runs redundantly on every rank; three
    ticks against the one-process loop on the same normals."""
    one = refs[2]["mpc"]
    n, got = ranks
    _close(got["mpc"], one, (("ctrl", 1e-5), ("qpos", 1e-5), ("qvel", 1e-4),
                             ("best_cost", 1e-4), ("mean_cost", 1e-4),
                             ("ess", 1e-4)), f"mpc, n={n}")


def test_one_rank_mesh_is_the_unsharded_solve_bit_for_bit(refs):
    """A mesh of one rank (no process group) computes what the unsharded
    solver computes, bit for bit, in every case; a mesh whose ranks do not
    divide K is refused."""
    from opendog_tpu_torch.parallel import Mesh, sample_mesh
    from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
    from opendog_tpu_torch import assets

    inp, _, one = refs
    ns = {}
    exec(CASES, ns)
    got = ns["run_cases"](inp, sample_mesh(device="cpu"))
    for case, want in one.items():
        for k, v in want.items():
            assert torch.equal(got[case][k], v), (case, k)
    m = assets.load_opendog("flat", device="cpu")
    cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
    three = Mesh(group=None, axis="mp", size=3, index=0,
                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        mppi.make_solver(m, cost, MPPIConfig(**FLAT), device="cpu",
                         mesh=three)
