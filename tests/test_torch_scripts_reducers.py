"""The metric reducers of the port's application scripts against the JAX
scripts' own: each JAX script's ``main()`` runs in this process with the
physics, the solver or the policy it drives replaced by a cheap
deterministic stand-in (patched on the JAX package), so that it reduces
known trajectories to its record; the port script's reducer gets the same
trajectories, and the records must agree (numbers to the scripts'
rounding, flags and shapes exactly).  Wall-clock fields are left out.
"""
import collections
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu import solvers as jax_solvers
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.rl import distill_zoo as jax_zoo
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu.utils import compile_cache as jax_compile_cache
from opendog_tpu_torch import assets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL = {"wall_s", "solves_per_sec", "seconds", "device", "engine",
        "recorded_at", "cycle_seconds", "realtime_factor", "compile_s",
        "student"}


def load_script(name):
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("script_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def agree(got, want, path="", atol=2e-4):
    """Records equal but for WALL keys; numbers within ``atol`` (the
    scripts round to 3-4 decimals)."""
    if isinstance(want, dict):
        assert set(got) - WALL == set(want) - WALL, path
        for k in set(want) - WALL:
            agree(got[k], want[k], f"{path}.{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            agree(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, (path, got, want)
    else:
        assert abs(float(got) - float(want)) <= atol * max(1.0, abs(want)), \
            (path, got, want)


Info = collections.namedtuple("Info", "contact")


def fake_step(m, st, ctrl, terrain=None, n_substeps=1, **kw):
    """A deterministic stand-in for ``dynamics.step``: time advances, the
    trunk moves forward by a control-dependent stride, sinks toward a
    standing height (0.07 m for OpenDOG, 0.27 m for Go1) with a bob, and
    yaws; ``info.contact`` carries the trunk height."""
    t = st.time + 0.002 * n_substeps
    z_stand = 0.07 if m.nq == 15 else 0.27
    yaw = 0.4 * jnp.sin(0.7 * t)
    pitch = 0.05 * jnp.sin(3.0 * t)
    q = st.qpos.at[..., 0].add(0.002 * n_substeps * (
        1.0 + 0.1 * jnp.sum(jnp.abs(ctrl), axis=-1)))
    q = q.at[..., 1].add(0.0004 * n_substeps)
    q = q.at[..., 2].set(0.3 * st.qpos[..., 2] + 0.7 * z_stand
                         + 0.01 * jnp.sin(2.0 * t))
    quat = jnp.stack([jnp.cos(yaw / 2) * jnp.cos(pitch / 2),
                      -jnp.sin(yaw / 2) * jnp.sin(pitch / 2),
                      jnp.cos(yaw / 2) * jnp.sin(pitch / 2),
                      jnp.sin(yaw / 2) * jnp.cos(pitch / 2)], axis=-1)
    q = q.at[..., 3:7].set(quat)
    qv = st.qvel.at[..., :6].set(0.3 * jnp.cos(t)[..., None]
                                 * jnp.arange(1.0, 7.0))
    return st.replace(qpos=q, qvel=qv, time=t), Info(contact=q[..., 2])


def fake_contact(m, contact):
    """(force_world (4, 3), force_body, in_contact (4,)) from the trunk
    height: paws touch below 0.3 m."""
    fw = jnp.stack([jnp.zeros(4), jnp.zeros(4),
                    300.0 * (0.4 - contact) * jnp.arange(1.0, 5.0)], axis=-1)
    return fw, fw, contact < 0.3 + 0.01 * jnp.arange(4.0)


def unrolled(m, s, ctrls, n_substeps=10):
    """The stand-in's states under a control sequence, eagerly."""
    out = []
    for c in ctrls:
        s, _ = fake_step(m, s, c, n_substeps=n_substeps)
        out.append(s)
    return out


def test_lag_sweep_reducer_matches_jax(monkeypatch, tmp_path):
    """lag_sweep.py's per-lag records and summary (lines 78-124) from
    canned trajectories of ``make_mpc``'s ``run``, one table per lag and
    seed, against torch_lag_sweep's ``lag_record`` and ``summarize``."""
    lags, seeds, ticks = [0, 1, 3], 3, 12
    rng = np.random.default_rng(0)
    tables = {}
    for lag in lags:
        for seed in list(range(seeds)) + [99]:
            qpos = np.tile(np.float32(0.27), (ticks, 19)).astype(np.float32)
            qpos[:, 0] = np.cumsum(rng.uniform(0.0, 0.02 * (4 - lag), ticks))
            qpos[:, 2] = 0.27 + rng.normal(0, 0.08 if lag == 3 else 0.01,
                                           ticks)
            tables[lag, seed] = dict(
                qpos=qpos.astype(np.float32),
                qvel=rng.normal(0.4, 0.2, (ticks, 18)).astype(np.float32),
                mean_cost=rng.uniform(100, 300, ticks).astype(np.float32))

    def fake_make_mpc(model, cost, cfg, plant_substeps=10, ctrl_lag=0,
                      lag_compensation=False):
        def run(carry, n):
            seed = int(carry)
            return carry, {k: jnp.asarray(v) for k, v in
                           tables[ctrl_lag, seed].items()}
        return (lambda key, s: int(key[1])), None, run

    monkeypatch.setattr(jax_solvers, "make_mpc", fake_make_mpc)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    out = tmp_path / "jax.json"
    load_script("lag_sweep").main(
        ["--ticks", str(ticks), "--seeds", str(seeds), "--lags",
         *map(str, lags), "--out", str(out)])
    monkeypatch.undo()
    want = json.loads(out.read_text())
    mod = load_script("torch_lag_sweep")
    results = [mod.lag_record(lag, ticks, [tables[lag, s]
                                           for s in range(seeds)], 1.0, 0.5)
               for lag in lags]
    got = mod.summarize(results, "kernel", "cpu", False)
    agree(got, want)
    assert want["results"][2]["fall_rate"] > 0  # a lag falls


def test_opendog_sweep_reducer_matches_jax(monkeypatch, tmp_path):
    """opendog_walk_sweep.py's per-configuration records and summary
    (lines 156-180) over its default grid of 16, each run a canned qpos
    table (some fall), against torch_opendog_walk_sweep's
    ``config_record`` and ``summarize``."""
    ticks = 20
    rng = np.random.default_rng(1)
    tables = []
    for i in range(16):
        q = np.zeros((ticks, 15), np.float32)
        q[:, 0] = np.cumsum(rng.uniform(0.0, 0.01, ticks))
        q[:, 2] = 0.07 + rng.normal(0, 0.03 if i % 5 == 0 else 0.005, ticks)
        tables.append(q)
    calls = []

    def fake_make_mpc(model, cost, cfg, plant_substeps=10):
        i = len(calls)
        calls.append(cfg)
        return (lambda key, s: 0), None, (
            lambda c, n: (c, {"qpos": jnp.asarray(tables[i])}))

    monkeypatch.setattr(jax_solvers, "make_mpc", fake_make_mpc)
    monkeypatch.setattr(jax_dynamics, "step", fake_step)
    out = tmp_path / "jax.json"
    load_script("opendog_walk_sweep").main(
        ["--ticks", str(ticks), "--out", str(out)])
    monkeypatch.undo()
    want = json.loads(out.read_text())
    mod = load_script("torch_opendog_walk_sweep")
    grid = mod.combos(mod.GRIDS["default"])
    assert [{k: r[k] for k in g} for r, g in
            zip(want["results"], grid)] == grid
    assert [c.noise_sigma for c in calls] == [g["noise_sigma"] for g in grid]
    results = [mod.config_record(g, q, r["z_stance"], 0.0)
               for g, q, r in zip(grid, tables, want["results"])]
    agree(mod.summarize(results, ticks, len(grid), "cpu"), want)
    assert any(r["fell"] for r in want["results"])


def test_soak_reducer_matches_jax(monkeypatch, tmp_path):
    """soak_cmd.py's segment records and health (lines 146-180) from the
    stand-in plant under a stand-in policy, against torch_soak_cmd's
    ``summarize`` on the same trajectory."""
    monkeypatch.setattr(jax_dynamics, "step", fake_step)
    monkeypatch.setattr(jax_zoo, "load_student",
                        lambda path, setup, command_dim=0:
                        lambda q, v, t, prev, cmd: prev + 0.1 * cmd[0])
    monkeypatch.setattr(sys, "argv", ["soak_cmd.py", "--smoke", "--out",
                                      str(tmp_path)])
    load_script("soak_cmd").main()
    monkeypatch.undo()
    want = json.loads((tmp_path / "soak.json").read_text())
    mod = load_script("torch_soak_cmd")
    jm = jax_zoo.cmd_distill_setup("go1", engine="xla").model
    home = jnp.asarray(np.clip(np.asarray(jm.key_ctrl[0]),
                               *np.asarray(jm.actuator_ctrlrange).T))
    s, _ = fake_step(jm, jax_make_state(jm, "home"), home, n_substeps=150)
    s = s.replace(qvel=s.qvel * 0.0, time=jnp.zeros(()))
    schedule = mod.SCHEDULE_BY_ROBOT["go1"]
    cmds = np.repeat(np.asarray(schedule, np.float32), 5, axis=0)
    prev, qs = home, []
    for c in cmds:
        u = prev + 0.1 * jnp.asarray(c)[0]
        s, _ = fake_step(jm, s, u, n_substeps=10)
        prev = u
        qs.append(np.asarray(s.qpos))
    q = np.stack(qs)
    got = mod.summarize("go1", schedule, 5, q[:, :3], q[:, 3:7],
                        (0.12, 0.45))
    agree(got, {k: v for k, v in want.items()
                if k not in ("engine", "payload_kg")})
    assert want["segments_total"] == 19 and want["ticks"] == 95


@pytest.mark.parametrize("name", ["jump", "landing"])
def test_mppi_script_reducers_match_jax(monkeypatch, tmp_path, name):
    """jump_mpc.py's (lines 124-149) and landing_mpc.py's (lines 107-122)
    records from the stand-in plant and paw contacts under a stand-in
    solve, against torch_jump_mpc's / torch_landing_mpc's ``summarize``."""
    def fake_make_solver(m, cost, cfg, **kw):
        def solve(st, ms, key):
            return jnp.asarray(m.key_ctrl[0]) * 0.9, ms, {}
        return solve

    monkeypatch.setattr(jax_mppi, "make_solver", fake_make_solver)
    monkeypatch.setattr(jax_dynamics, "step", fake_step)
    monkeypatch.setattr(jax_dynamics, "foot_contact_summary", fake_contact)
    ticks = 12
    monkeypatch.setattr(sys, "argv", [f"{name}_mpc.py", "--ticks",
                                      str(ticks), "--out", str(tmp_path)])
    load_script(f"{name}_mpc").main()
    monkeypatch.undo()
    want = json.loads((tmp_path / "metrics.json").read_text())
    from opendog_tpu import assets as jax_assets
    jm = jax_assets.load_go1(name)
    m = assets.load_go1(name, device="cpu")
    mod = load_script(f"torch_{name}_mpc")
    ctrl = jnp.asarray(jm.key_ctrl[0]) * 0.9
    if name == "jump":
        s = jax_make_state(jm, "home")
        s = s.replace(qpos=s.qpos.at[0].set(0.25))
        states = unrolled(jm, s, [ctrl] * ticks)
        qps = np.stack([np.asarray(x.qpos) for x in states])
        contact = np.array([bool(np.asarray(fake_contact(jm, x.qpos[2])[2])
                                 .any()) for x in states])
        got = mod.summarize(m, qps, contact, ticks, 0.0)
    else:
        states = unrolled(jm, jax_make_state(jm, "descent"), [ctrl] * ticks)
        states += unrolled(jm, states[-1], [jnp.asarray(jm.key_ctrl[0])]
                           * mod.HOLD_TICKS)
        qps = np.stack([np.asarray(x.qpos) for x in states])
        tw = np.stack([np.asarray(x.qvel[:6]) for x in states])
        fmax = np.array([float(np.abs(np.asarray(
            fake_contact(jm, x.qpos[2])[0])[:, 2]).max())
            for x in states[:ticks]])
        got = mod.summarize(m, qps, tw, fmax, ticks, 0.0)
    agree(got, want)


def test_calibration_reducer_matches_jax(monkeypatch, tmp_path):
    """calibrate_cmd_gait.py's per-probe records and fitted law (lines
    150-201) from the stand-in plant driven open loop by the command gait,
    against torch_calibrate_cmd_gait's ``probe_records`` and ``fit_law``
    (the implied stride scales from its ``implied_scales``)."""
    ticks, settle = 30, 5
    monkeypatch.setattr(jax_dynamics, "step", fake_step)
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a: None)
    monkeypatch.setattr(sys, "argv", [
        "calibrate_cmd_gait.py", "--ticks", str(ticks), "--settle",
        str(settle), "--out", str(tmp_path)])
    load_script("calibrate_cmd_gait").main()
    monkeypatch.undo()
    want = json.loads((tmp_path / "opendog.json").read_text())
    mod = load_script("torch_calibrate_cmd_gait")
    setup = jax_zoo.cmd_distill_setup("opendog", engine="xla")
    jm = setup.model
    pm = assets.load_opendog("flat", device="cpu")
    from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup
    psetup = cmd_distill_setup("opendog", engine="kernel", device="cpu")
    pc = mod.cost_params(psetup)
    v_nom = float(np.hypot(*pc.desired_vel_xy))
    cmds_list = mod.probe_commands("opendog", v_nom)
    lo, hi = (jnp.asarray(x) for x in np.asarray(jm.actuator_ctrlrange).T)
    s0, _ = fake_step(jm, jax_make_state(jm, "home"), jnp.asarray(np.clip(
        np.asarray(jm.key_ctrl[0]), np.asarray(lo), np.asarray(hi))),
        n_substeps=150)
    S = len(cmds_list)
    plants = s0.replace(qpos=jnp.tile(s0.qpos[None], (S, 1)),
                        qvel=jnp.zeros((S, jm.nv)), time=jnp.zeros(S))
    cmds = jnp.asarray(np.asarray(cmds_list, np.float32))
    xyz, yaws = [], []
    from opendog_tpu.physics import spatial as jax_spatial

    @jax.jit
    def tick(plants):   # the script's jitted tick on the stand-in plant
        ctrl = jax.vmap(lambda t, c: jnp.clip(setup.u_ref(t, c), lo, hi))(
            plants.time, cmds)
        plants, _ = fake_step(jm, plants, ctrl, n_substeps=10)
        return plants, jax.vmap(
            lambda q: jax_spatial.euler_from_quat(q[3:7])[2])(plants.qpos)

    for _ in range(ticks):
        plants, yaw = tick(plants)
        xyz.append(np.asarray(plants.qpos[:, :3]))
        yaws.append(np.asarray(yaw))
    per = mod.probe_records(np.stack(xyz), np.stack(yaws), cmds_list,
                            mod.implied_scales(pm, pc, v_nom, cmds_list),
                            psetup.z_band, settle, ticks, 0.02)
    agree(per, want["per_probe"])
    agree(mod.fit_law(per), want["fit"])
    assert len(want["fit"]["amp_knots"]) >= 3


def test_terrain_fidelity_reducer_matches_jax(monkeypatch, tmp_path):
    """terrain_fidelity.py's static tangent plane (lines 81-92), its cost
    at the start's height, its per-arm records (lines 141-155) and the
    summary (lines 176-212), with the stand-in plant under a stand-in
    solve, against torch_terrain_fidelity's ``static_plane``,
    ``fidelity_cost``, ``arm_record`` and ``summarize`` on the JAX
    package's terrain."""
    seen = []

    def fake_make_solver(m, cost, cfg, terrain=None, plane_mode="trunk"):
        seen.append((cost, terrain))

        def solve(st, ms, key):
            return jnp.asarray(m.key_ctrl[0]) * 0.95, ms, {
                "best_cost": jnp.float32(0.0)}
        return solve

    monkeypatch.setattr(jax_mppi, "make_solver", fake_make_solver)
    monkeypatch.setattr(jax_dynamics, "step", fake_step)
    out = tmp_path / "jax.json"
    load_script("terrain_fidelity").main(
        ["--smoke", "--plane_xla", "--seeds", "2", "--out", str(out)])
    monkeypatch.undo()
    want = json.loads(out.read_text())
    mod = load_script("torch_terrain_fidelity")
    from opendog_tpu.physics.dynamics import _terrain_height_normal
    from opendog_tpu_torch.physics import State, Terrain
    from opendog_tpu import assets as jax_assets
    jm = jax_assets.load_opendog("terrain")
    m = assets.load_opendog("terrain", device="cpu")
    (jcost, jterr), (_, jplane) = seen
    terr = Terrain(height=torch.from_numpy(np.array(jterr.height)))
    np.testing.assert_allclose(mod.static_plane(m, terr).height.numpy(),
                               np.asarray(jplane.height), rtol=1e-5,
                               atol=1e-6)
    cost = mod.fidelity_cost(m, terr)
    # the start: home 8 cm above the ground under the origin, then the
    # 25-tick settle and the smoke run's 3 ticks of the stand-in plant
    h0 = float(_terrain_height_normal(jm, jterr, jnp.zeros((1, 2)))[0][0])
    s = jax_make_state(jm, "home")
    s = s.replace(qpos=s.qpos.at[2].set(0.08 + h0))
    prev0 = jnp.asarray(np.clip(np.asarray(jm.key_ctrl[0]),
                                *np.asarray(jm.actuator_ctrlrange).T))
    s = unrolled(jm, s, [prev0] * 25)[-1]
    ctrl = jnp.asarray(jm.key_ctrl[0]) * 0.95
    states = unrolled(jm, s, [ctrl] * want["ticks"])
    qpos = np.stack([np.asarray(x.qpos) for x in states])
    t = [torch.from_numpy(np.stack([np.asarray(getattr(x, k))
                                    for x in states])) for k in
         ("qpos", "qvel", "time")]
    prev = torch.from_numpy(np.stack([np.asarray(prev0)]
                                     + [np.asarray(ctrl)] * (len(states)
                                                              - 1)))
    c_real = cost(State(qpos=t[0], qvel=t[1], time=t[2]),
                  torch.from_numpy(np.array(ctrl)).expand_as(prev),
                  prev).numpy()
    jc = np.asarray(jax.vmap(jcost, in_axes=(0, None, 0))(
        jax.tree.map(lambda *x: jnp.stack(x), *states), ctrl,
        jnp.asarray(prev.numpy())))
    np.testing.assert_allclose(c_real, jc, rtol=1e-5)
    rec = mod.arm_record(qpos, c_real, mod.height_under(m, terr,
                                                        qpos[:, :2]))
    per_arm = {a: [dict(rec, seed=2, terrain_key=want["per_seed"][a][0][
        "terrain_key"], relief=want["per_seed"][a][0]["relief"])]
        for a in ("exact", "static_plane")}
    agree(mod.summarize(per_arm, ["exact", "static_plane"], want["ticks"],
                        "cpu"), want)
