"""scripts/torch_bench_suite.py (the port's counterpart of
scripts/bench_suite.py) against the JAX package and the JAX script.

Config 1's hold step meets ``dynamics.step`` (op by op), and config 2 /
2b's MPC tick JAX ``make_mpc`` on the same normals, with the JAX kernel's
body in place of the Pallas kernel (config 4's step and the fused
configs' inputs meet the JAX package in
tests/test_torch_bench_suite_kernels.py).  The inputs of 4b,
4c and 4d, and the records of 3b, 2e and 2f, are held to what the JAX
script's own ``main()`` builds and reduces, run in this process with the
physics, the kernel, the tracker or the sub-scripts it calls replaced by
cheap deterministic stand-ins.  Last, the port's command line:
``--skip`` / ``--only``, the merge of ``--out`` and its default.
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import pallas_step as jax_pallas_step
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import make_mpc as jax_make_mpc
from opendog_tpu.solvers import mpc as jax_mpc
from opendog_tpu.utils import compile_cache as jax_compile_cache
from opendog_tpu_torch import assets
from opendog_tpu_torch.ops import cuda_step
from opendog_tpu_torch.physics import make_state
from test_torch_mppi_mpc import _eager_scalar_core_step, _tick_normals

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's physics against JAX's, op by op, a few substeps from the
# keyframe (float32 sums in another order): max abs error
STEP_TOL = dict(qpos=1e-5, qvel=1e-4)


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


suite = load(os.path.join(REPO, "scripts", "torch_bench_suite.py"),
             "torch_bench_suite")
# the suite puts scripts/ on the path
from torch_app_common import run_ticks  # noqa: E402


def run_jax_suite(monkeypatch, tmp_path, keys, backend="cpu"):
    """scripts/bench_suite.py's ``main()`` in this process with only
    ``keys`` run (``--skip`` the rest) and ``jax.default_backend`` reading
    ``backend``: its records, as written to ``--out``."""
    jax_suite = load(os.path.join(REPO, "scripts", "bench_suite.py"),
                     "jax_bench_suite")
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: "")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    out = tmp_path / "jax_suite.json"
    monkeypatch.setattr(sys, "argv", [
        "bench_suite.py", "--out", str(out),
        "--skip", *[k for k in suite.KEYS if k not in keys]])
    jax_suite.main()
    with open(out) as f:
        return json.load(f)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=0, atol=tol["qpos"])
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=0, atol=tol["qvel"])


def test_hold_step_matches_jax_dynamics_step():
    """Config 1's step (OpenDOG from ``home`` under the unclipped
    keyframe control), cut to 2 substeps, against
    ``dynamics.step(m, s, m.key_ctrl[0], n_substeps=2)`` op by op."""
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    s = make_state(m, "home")
    got = suite.hold_step(m, 2)(s.qpos, s.qvel, s.time)
    with jax.disable_jit():
        want, _ = jax_dynamics.step(jm, jax_make_state(jm, "home"),
                                    jnp.asarray(jm.key_ctrl[0]),
                                    n_substeps=2)
    _close(got, (want.qpos, want.qvel), STEP_TOL)
    assert float(got[2]) == pytest.approx(float(want.time), abs=1e-9)


def _scalar_core_step(*args, **kw):
    """A stand-in for build_pallas_substep: the JAX kernel's body (the
    scalar core, ``_eager_scalar_core_step``) op by op, with jit on inside
    it so that the core's own lax loops run compiled; under the loop's
    ``jax.disable_jit`` they would run as Python loops (~5 s a Go1
    substep here against ~1 s)."""
    step = _eager_scalar_core_step(*args, **kw)

    def call(*x):
        with jax.disable_jit(False):
            return step(*x)
    return call


def test_trot_ticks_match_jax_make_mpc(monkeypatch):
    """Configs 2 / 2b's MPC (Go1 trot at 0.5 m/s, 2 x 10 ms rollout
    substeps, sigma 0.12, temperature 0.3, plant 10 x 2 ms) at K=8, H=2:
    one tick on the normals the JAX loop draws from PRNGKey(0), against
    JAX ``make_mpc`` run op by op with the JAX kernel's body (the scalar
    core, eagerly, in place of the Pallas kernel, in the rollouts and the
    plant): the noise, rollouts, cost, update, receding shift and plant of
    the two loops.  Tolerances: ctrl and plant qpos 1e-5 abs (float32
    sums of the costs in another order; measured here 8.2e-7 and
    1.2e-7)."""
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        _scalar_core_step)
    jm = jax_assets.load_go1("flat")
    m = assets.load_go1("flat", device="cpu")
    K, H, n = 8, 2, 1
    p = jax_costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                 target_height=0.265)
    jcfg = JaxMPPIConfig(horizon=H, num_samples=K, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.12, temperature=0.3,
                         engine="pallas")
    jinit, _, jrun = jax_make_mpc(
        jm, jax_costs.trot_cost(jm, p, np.asarray(jm.key_qpos[0])[7:]),
        jcfg, plant_substeps=10)
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        _, want = jrun(jinit(key, jax_make_state(jm, "home")), n)

    init, tick, cfg = suite.trot_mpc(m, K, horizon=H)
    assert (cfg.num_samples, cfg.horizon, cfg.n_substeps, cfg.rollout_dt,
            cfg.noise_sigma, cfg.temperature, cfg.engine) == (
        K, H, 2, 0.01, 0.12, 0.3, "kernel")
    normals = torch.from_numpy(_tick_normals(key, n, K, H, m.nu))
    _, got = run_ticks(tick, init(None, make_state(m, "home")), n,
                             normals, keys=("ctrl", "qpos"))
    for name in ("ctrl", "qpos"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)


def _recording_pallas(calls):
    """A stand-in for build_pallas_substep that records each built step's
    first inputs (numpy) under its mode and returns the state unchanged."""
    def build(model, dt, k_tile=256, n_substeps=1, interpret=False,
              with_plane=False, with_payload=False, unroll=True):
        def step(qpos, qvel, ctrl, *modes):
            calls.setdefault((with_plane, with_payload, qpos.shape[1]), [
                np.asarray(x) for x in (qpos, qvel, ctrl, *modes)])
            return qpos, qvel
        return step
    return build


def test_kernel_inputs_equal_the_jax_scripts(monkeypatch, tmp_path):
    """The inputs of configs 4b, 4c and 4d at full width, bit for bit
    against the JAX script's (its ``main()`` with 4 and 4d run, the
    op-graph step an identity and the Pallas kernel a stand-in that
    records its inputs): 4b's rows are config 4's start from jax's
    PRNGKey(0) draw, 4c's planes and payloads ``domrand_modes`` from a
    fresh numpy seed 0, 4d's five arrays ``batch_inputs``."""
    calls = {}
    monkeypatch.setattr(jax_pallas_step, "build_pallas_substep",
                        _recording_pallas(calls))
    monkeypatch.setattr(jax_dynamics, "step",
                        lambda m, st, ctrl, *a, **k: (st, None))
    recs = run_jax_suite(monkeypatch, tmp_path, {"4", "4d"}, backend="gpu")
    assert {"4b_batch4096_fused", "4c_batch4096_domrand_planes_payloads",
            "4d_batch32k_domrand"} <= set(recs)
    m = assets.load_opendog("flat", device="cpu")
    B = suite.BATCH
    draws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (B, m.nq)))
    rows = [cuda_step.rows_from_batch(x).numpy()
            for x in suite.batch_start(m, draws)]
    for got, want in zip(rows, calls[(False, False, B)]):
        np.testing.assert_array_equal(got, want)
    plane, payload = suite.domrand_modes(B, np.random.default_rng(0))
    want = calls[(True, True, B)]
    np.testing.assert_array_equal(want[2], rows[2])
    np.testing.assert_array_equal(plane, want[3])
    np.testing.assert_array_equal(payload, want[4])
    for got, want in zip(suite.batch_inputs(m, suite.BATCH_32K),
                         calls[(True, True, suite.BATCH_32K)]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _tracker_stub(dx, z0, dz):
    """A stand-in for make_ilqr_tracker: ``cycle(plant, U)`` tracks 25
    ticks that move the trunk forward by ``dx`` each and bob its height
    around ``z0`` by ``dz``; jit-able, deterministic."""
    def cycle(plant, U):
        k = jnp.arange(25, dtype=jnp.float32)
        q = jnp.tile(plant.qpos[None], (25, 1))
        q = q.at[:, 0].set(plant.qpos[0] + dx * (k + 1))
        q = q.at[:, 2].set(z0 + dz * jnp.sin(3.0 * plant.time + 0.7 * k))
        return (plant.replace(qpos=q[-1], time=plant.time + 0.5), U,
                {"qpos": q})
    return cycle


def _settle_stub(m, st, ctrl, *a, **k):
    return st.replace(time=st.time + 0.4), None


@pytest.mark.parametrize("dx,z0,dz", [(0.004, 0.25, 0.04),   # trots, healthy
                                      (0.0, 0.2, 0.1)])       # dips, stands
def test_trot_ilqr_record_matches_jax(monkeypatch, tmp_path, dx, z0, dz):
    """Config 3b's reductions (scripts/bench_suite.py:374-394): the JAX
    script's record of the tracker stand-in's trajectories against
    ``trot_ilqr_record`` of the same ones, every key but the two wall-clock
    ones (the scripts' rounding: 1e-3)."""
    stub = _tracker_stub(dx, z0, dz)
    monkeypatch.setattr(jax_mpc, "make_ilqr_tracker", lambda *a, **k: stub)
    monkeypatch.setattr(jax_dynamics, "step", _settle_stub)
    want = run_jax_suite(monkeypatch, tmp_path, {"3b"})[
        "3b_scheduled_ilqr_trot"]
    jm = jax_assets.load_go1("flat")
    s, _ = _settle_stub(jm, jax_make_state(jm, "home"), None)
    plant = s.replace(time=jnp.zeros(()))
    U = jnp.zeros((25, jm.nu))
    plant, U, _ = stub(plant, U)
    x0 = float(np.asarray(plant.qpos)[0])
    trajs = []
    for _ in range(10):
        plant, U, traj = stub(plant, U)
        trajs.append(np.asarray(traj["qpos"]))
    got = suite.trot_ilqr_record(1.0, 10, x0, np.asarray(plant.qpos), trajs)
    assert set(got) == set(want) - {"_provenance"}
    for k, v in want.items():
        if k in ("_provenance", "cycle_seconds", "realtime_factor"):
            continue
        if isinstance(v, bool):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, abs=1e-3), k
    assert want["healthy"] == (dx > 0)


FIDELITY = {"metric": "terrain_planning_fidelity", "ticks": 200,
            "plane_arm": "local_plane",
            "exact": {"final_x_mean": 0.41, "realized_cost_mean": 0.83,
                      "success_rate": 1.0},
            "local_plane": {"final_x_mean": 0.38, "realized_cost_mean": 0.9,
                            "success_rate": 1.0},
            "per_geom": {"final_x_mean": 0.4, "realized_cost_mean": 0.85,
                         "success_rate": 0.5},
            "distance_ratio_plane_vs_exact": 0.927,
            "cost_ratio_plane_vs_exact": 1.084,
            "distance_ratio_pergeom_vs_exact": 0.976,
            "cost_ratio_pergeom_vs_exact": 1.024}
LAGS = {"results": [{"lag": 0, "final_x_mean": 1.62, "fall_rate": 0.0},
                    {"lag": 3, "final_x_mean": 1.07, "fall_rate": 0.0}],
        "final_x_lag3_vs_lag0": 0.66}
LAG_COMPENSATED = {"results": [{"lag": 3, "final_x_mean": 1.43,
                                "fall_rate": 0.0}],
                   "final_x_lag3_vs_lag0": None}


def _canned(argv):
    """The summary a stand-in sub-script prints for ``argv``."""
    if "--lags" not in argv:
        return FIDELITY
    return LAG_COMPENSATED if "--compensate" in argv else LAGS


def test_fidelity_and_lag_records_match_jax(monkeypatch, tmp_path):
    """Configs 2e and 2f: the JAX script's records built from its
    sub-scripts' last lines (stand-ins loaded in place of
    terrain_fidelity.py and lag_sweep.py that print canned summaries)
    against the port's, built from the same lines, and the port passes
    its sub-scripts the JAX script's arguments."""
    argvs = {}
    for name in ("terrain_fidelity", "lag_sweep"):
        path = tmp_path / f"{name}.py"
        path.write_text(
            "import json\n"
            f"FIDELITY = json.loads({json.dumps(FIDELITY)!r})\n"
            f"LAGS = json.loads({json.dumps(LAGS)!r})\n"
            f"COMPENSATED = json.loads({json.dumps(LAG_COMPENSATED)!r})\n"
            "def main(argv):\n"
            "    out = (FIDELITY if '--lags' not in argv else COMPENSATED\n"
            "           if '--compensate' in argv else LAGS)\n"
            "    print('progress')\n"
            "    print(json.dumps(out))\n")
    real = importlib.util.spec_from_file_location

    def spec_from_file_location(name, location, *a, **k):
        base = os.path.basename(str(location))[:-3]
        if base in ("terrain_fidelity", "lag_sweep"):
            location = str(tmp_path / f"{base}.py")
        return real(name, location, *a, **k)

    monkeypatch.setattr(importlib.util, "spec_from_file_location",
                        spec_from_file_location)
    want = run_jax_suite(monkeypatch, tmp_path, {"2e", "2f"}, backend="gpu")
    monkeypatch.undo()

    def last_line(name, argv):
        argvs.setdefault(name, []).append(argv)
        return _canned(argv)

    monkeypatch.setattr(suite, "script_last_line", last_line)
    cpu = torch.device("cpu")
    got = {"2e_terrain_fidelity": suite.config_2e(cpu, str(tmp_path)),
           "2f_lag_price": suite.config_2f(cpu, str(tmp_path))}
    for name, rec in got.items():
        assert rec == {k: v for k, v in want[name].items()
                       if k != "_provenance"}, name
    fid, = argvs["torch_terrain_fidelity"]
    assert fid[:5] == ["--ticks", "200", "--seeds", "0", "2"]
    lag, comp = argvs["torch_lag_sweep"]
    assert lag[:4] + lag[6:9] == ["--ticks", "300", "--seeds", "1",
                                  "--lags", "0", "3"]
    assert comp[6:9] == ["--lags", "3", "--compensate"]
    for argv in (fid, lag, comp):
        assert argv[argv.index("--device") + 1] == "cpu"
        out = argv[argv.index("--out") + 1]
        assert os.path.dirname(out) == str(tmp_path)


def test_cli_skip_only_merge_and_out(monkeypatch, tmp_path, capsys):
    """``--only`` runs the configs it names less ``--skip``; configs of the
    card are skipped on the CPU; ``--out`` keeps what a run did not
    touch and stamps what it did with the device; the default path is
    under runs/torch_bench_suite/ and the repository's BENCH_SUITE.json
    is refused."""
    ran = []

    def run_config(key, dev, out_dir):
        ran.append(key)
        return [(suite.NAMES.get(key, key), {"ran": key})]

    monkeypatch.setattr(suite, "run_config", run_config)
    out = tmp_path / "suite.json"
    out.write_text(json.dumps({"old": {"kept": True},
                               "1_standing_hold": {"stale": True}}))
    suite.main(["--only", "1", "2", "2b", "--skip", "2", "--out", str(out),
                "--device", "cpu"])
    assert ran == ["1"]  # 2 skipped, 2b runs on the card only
    recs = json.loads(out.read_text())
    assert recs["old"] == {"kept": True}
    assert recs["1_standing_hold"]["ran"] == "1"
    assert recs["1_standing_hold"]["_provenance"]["device"] == "cpu"
    assert "seconds" in recs["1_standing_hold"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["config"] == "1_standing_hold"

    ran.clear()
    suite.main(["--skip", *[k for k in suite.KEYS if k not in ("3", "5")],
                "--out", str(out), "--device", "cpu"])
    assert ran == ["3", "5"]
    assert set(json.loads(out.read_text())) == {
        "old", "1_standing_hold", "3_ilqr_replan_track", "5_distill_round"}

    assert suite.DEFAULT_OUT == os.path.join("runs", "torch_bench_suite",
                                             "BENCH_SUITE.json")
    committed = os.path.join(REPO, "BENCH_SUITE.json")
    with open(committed, "rb") as f:
        before = f.read()
    with pytest.raises(SystemExit):
        suite.main(["--out", committed, "--device", "cpu"])
    with open(committed, "rb") as f:
        assert f.read() == before
    with pytest.raises(SystemExit):
        suite.main(["--help"])
    assert "--only" in capsys.readouterr().out
    assert ran == ["3", "5"]
