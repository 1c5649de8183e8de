"""The port's distiller against the JAX package's, on mini at a 1 ms step:
one ``train_on`` on the same data and permutations, and a DAgger round
(``round_fn``: ``collect`` then ``train_on``) and a student-only
``eval_fn`` on JAX's own draws -- the expert's normals, the drive masks and
the permutations made from the JAX key chain exactly as the JAX distiller
splits it -- in the command-conditioned variant with a command-scaled
residual base, anchored and not, on the op-graph engine (JAX ``"xla"``).
The student's parameters start from JAX's, carried by
``networks.load_flax_params``.  The payload variant, on the kernel engine
(JAX ``"pallas"`` in interpret mode), is in
tests/test_torch_distill_payload.py.

Tolerances: Adam's update in float32 in another order moves a parameter by
about 1e-7 of its size per step; after one ``train_on`` (2 epochs of 4
minibatches) parameters agree to 2e-6 abs and 1e-5 relative, the loss to
1e-5 relative.  The round's plant states agree to 1e-5 abs (the mini
solves' tolerance), its labels and observations to 1e-5 abs and relative
(mini's legs reach ~200 rad/s under random students), the students it
trains as functions on its data to 1e-5 abs and 1e-4 relative; the eval's
trajectories, driven by students trained in each package, to 1e-4 abs and
1e-5 relative, its action RMSE to 1e-3 relative.
"""
import concurrent.futures

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import State as JaxState
from opendog_tpu.rl import distill as jax_distill
from opendog_tpu.rl.networks import MLPActorCritic as JaxMLP
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from torch.func import functional_call

from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State
from opendog_tpu_torch.rl import distill
from opendog_tpu_torch.rl.networks import MLPActorCritic, load_flax_params
from opendog_tpu_torch.solvers import MPPIConfig
from test_torch_exact_plant import MINI, _solve_normals
from test_torch_mppi_cmd import mini_pieces

torch.set_num_threads(1)

S = 2
DCFG = dict(num_scenarios=S, rollout_ticks=3, lr=1e-3, batch_size=4,
            epochs_per_round=2, beta_decay=0.7)
HIDDEN = (16, 16)
ROUND = 1            # beta 0.7: the student drives some ticks
EVAL_TICKS = 3
COMMANDS = np.array([[0.3, 0.005, 0.1], [0.0, -0.01, -0.2]], np.float32)
PAYLOADS = np.array([0.0, 1.0], np.float32)


def _jax_obs(qp, qv, t):
    return jnp.concatenate([qp[2:], qv])


def _obs(qp, qv, t):
    return torch.cat([qp[..., 2:], qv], dim=-1)


def _models():
    """mini at a 1 ms step in both packages (at its 2 ms a perturbed mini
    plant blows up within a few ticks in both)."""
    return (jax_assets.load_mini().replace(timestep=0.001),
            assets.load_mini(device="cpu").replace(timestep=0.001))


def build(variant, engine="kernel"):
    """(JAX distiller, port distiller, JAX network, port network, options)
    of a variant: "command" (command-scaled residual base), "anchored"
    (the same, anchor_w = 15), "payload" (payload_range (0, 1), standing
    cost, time-indexed base), "ops" (op-graph engine, anchored to the
    time-indexed base)."""
    jm, m = _models()
    home = np.asarray(jm.key_qpos[0])[7:]
    jp = mini_pieces(jnp, jm, home)
    tp = mini_pieces(torch, m, m.key_qpos[0, 7:])
    kw = dict(plant_substeps=2, with_prev_ctrl=True)
    pick = {}
    if variant in ("command", "anchored"):
        kw.update(command_dim=3, anchor_w=15.0 if variant == "anchored"
                  else 0.0)
        pick = dict(cost=1, ref=3)
    elif variant == "payload":
        kw.update(payload_range=(0.0, 1.0))
        pick = dict(cost=0, ref=2)
    elif variant == "ops":
        kw.update(anchor_w=15.0)
        pick = dict(cost=0, ref=2)
    obs_dim = (m.nq - 2) + m.nv + m.nu + kw.get("command_dim", 0)
    jnet = JaxMLP(action_dim=m.nu, hidden=HIDDEN, squash_mean=False)
    net = MLPActorCritic(obs_dim, m.nu, hidden=HIDDEN, squash_mean=False)
    jd = jax_distill.make_distiller(
        jm, jp[pick["cost"]], _jax_obs, jnet,
        mppi_config=JaxMPPIConfig(
            engine="pallas" if engine == "kernel" else "xla", **MINI),
        config=jax_distill.DistillConfig(**DCFG),
        action_ref_fn=jp[pick["ref"]], **kw)
    td = distill.make_distiller(
        m, tp[pick["cost"]], _obs, net,
        mppi_config=MPPIConfig(engine=engine, **MINI),
        config=distill.DistillConfig(**DCFG),
        action_ref_fn=tp[pick["ref"]], device="cpu", **kw)
    return jd, td, jnet, net, kw, (jm, m)


def _plants(jm):
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (S, 1)).astype(np.float32)
    qpos[:, 7:] += rng.normal(0, 0.03, (S, jm.nq - 7)).astype(np.float32)
    time = np.array([0.1, 0.13], np.float32)
    return qpos, np.zeros((S, jm.nv), np.float32), time


def _round_draws(key, beta, n, m_cfg, nu):
    """The JAX round's draws from its key: per tick the expert's normals
    and the drive mask, then the permutations of its train_on."""
    normals, drive = [], []
    for _ in range(DCFG["rollout_ticks"]):
        key, k1, k2 = jax.random.split(key, 3)
        normals.append(np.stack([
            _solve_normals(k, m_cfg["num_samples"], m_cfg["horizon"], nu)
            for k in jax.random.split(k1, S)]))
        drive.append(np.asarray(jax.random.bernoulli(k2, beta, (S, 1))))
    key, sub = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(sub,
                                                DCFG["epochs_per_round"])])
    return np.stack(normals), np.stack(drive), perms, key


def _eval_draws(key, ticks, m_cfg, nu):
    out = []
    for _ in range(ticks):
        key, k1 = jax.random.split(key)
        out.append(np.stack([
            _solve_normals(k, m_cfg["num_samples"], m_cfg["horizon"], nu)
            for k in jax.random.split(k1, S)]))
    return np.stack(out)


def carried(net, jparams):
    """{name: tensor} of ``net`` with JAX's parameters."""
    load_flax_params(net, jax.tree.map(np.asarray, jparams))
    return {k: v.detach().clone() for k, v in net.named_parameters()}


def assert_params_close(net, params, jparams, atol=2e-6, rtol=1e-5):
    want = carried(net, jparams)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def test_train_on_matches_optax_adam():
    """One train_on (2 epochs, n = 19 rows in minibatches of 4: the last
    3 rows of each permutation dropped) on random data with JAX's
    permutations: the port's Adam against optax's."""
    jd, td, jnet, net, _, (jm, m) = build("command", engine="ops")
    rng = np.random.default_rng(0)
    n = 19
    obs = rng.normal(0, 1, (n, net.obs_dim)).astype(np.float32)
    labels = rng.normal(0, 0.1, (n, m.nu)).astype(np.float32)
    q0 = jnp.asarray(jm.key_qpos[0])
    jstate = jd.init(jax.random.PRNGKey(0), JaxState(
        qpos=q0, qvel=jnp.zeros(jm.nv), time=jnp.zeros(())))
    key = jax.random.PRNGKey(7)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(key, 2)])
    jstate2, jloss = jax.jit(jd.train_on)(jstate, jnp.asarray(obs),
                                          jnp.asarray(labels), key)
    dstate = td.init(None, State(qpos=m.key_qpos[0], qvel=torch.zeros(m.nv),
                                 time=torch.zeros(())),
                     params=carried(net, jstate.params))
    before = {k: v.detach().clone() for k, v in dstate.params.items()}
    dstate, loss = td.train_on(dstate, torch.from_numpy(obs),
                               torch.from_numpy(labels),
                               perms=torch.from_numpy(perms))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_params_close(net, dstate.params, jstate2.params)
    moved = max(float((dstate.params[k] - before[k]).abs().max())
                for k in before if k.startswith("actor"))
    assert moved > 1e-4
    # the critic and the log-std take no gradient from the regression
    for k in before:
        if not k.startswith("actor"):
            assert torch.equal(dstate.params[k], before[k]), k


def run_round_and_eval(variant, engine):
    """The JAX round -- its collect, then its train_on on the key that
    round_fn splits off (opendog_tpu/rl/distill.py:324-336), each jitted
    -- and eval against the port's round_fn, collect and eval_fn on JAX's
    draws; every compared output within the tolerances of the module
    docstring."""
    jd, td, jnet, net, kw, (jm, m) = build(variant, engine)
    qpos, qvel, time = _plants(jm)
    jplants = JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                       time=jnp.asarray(time))
    plants = State(qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel),
                   time=torch.from_numpy(time))
    aux, jaux = {}, {}
    if "payload_range" in kw:
        aux["payloads"], jaux["payloads"] = (torch.from_numpy(PAYLOADS),
                                             jnp.asarray(PAYLOADS))
    if kw.get("command_dim"):
        aux["commands"], jaux["commands"] = (torch.from_numpy(COMMANDS),
                                             jnp.asarray(COMMANDS))
    jstate = jd.init(jax.random.PRNGKey(0), JaxState(
        qpos=jnp.asarray(qpos[0]), qvel=jnp.zeros(jm.nv),
        time=jnp.zeros(())))
    dstate = td.init(None, State(qpos=m.key_qpos[0], qvel=torch.zeros(m.nv),
                                 time=torch.zeros(())),
                     params=carried(net, jstate.params))
    beta = DCFG["beta_decay"] ** ROUND
    n = DCFG["rollout_ticks"] * S
    normals, drive, perms, key_after = _round_draws(jstate.key, beta, n,
                                                    MINI, m.nu)
    assert drive.any() and not drive.all()  # expert and student both drive

    jms = jax.vmap(lambda _: jax_distill.mppi.init_state(
        jm, JaxMPPIConfig(**MINI)))(jnp.arange(S))
    # the JAX eval's compile (its own copy of the solve, ~30 s on the CPU
    # with the kernel in interpret mode) runs in a thread beside the
    # collect's, on the avals of the trained state it will take
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jeval = pool.submit(lambda: jax.jit(
            jd.eval_fn, static_argnums=2).lower(
                jstate, jplants, EVAL_TICKS, **jaux).compile())
        jplants2, _, key, jobs, jlabels = jax.jit(jd.collect)(
            jstate, jplants, jms, jnp.float32(beta), **jaux)
        jeval = jeval.result()
    key, sub = jax.random.split(key)
    assert np.array_equal(np.asarray(key), np.asarray(key_after))
    jstate2, jloss = jax.jit(jd.train_on)(jstate.replace(key=key), jobs,
                                          jlabels, sub)
    t = torch.from_numpy
    trace = {}
    _, _, _, obs, labels = td.collect(
        dstate, plants, distill.mppi.init_state(m, MPPIConfig(**MINI),
                                                scenarios=S),
        beta, normals=t(normals), drive=t(drive), trace=trace, **aux)
    for got, want in ((obs, jobs), (labels, jlabels)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    dstate, plants2, metrics = td.round_fn(
        dstate, plants, ROUND, normals=t(normals), drive=t(drive),
        perms=t(perms), **aux)
    assert metrics["beta"] == beta
    np.testing.assert_allclose(float(metrics["distill_loss"]), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(plants2.qpos.numpy(),
                               np.asarray(jplants2.qpos), atol=1e-5)
    np.testing.assert_allclose(plants2.time.numpy(),
                               np.asarray(jplants2.time), atol=1e-6)
    # the trained students agree as functions on the round's data; their
    # raw parameters need not: Adam steps a weight whose gradient sits at
    # rounding level (one on an observation entry that is zero up to
    # rounding) by up to lr in either direction
    pred = functional_call(net, dstate.params, (obs,),
                           {"value": False})[0].detach()
    jpred = jnet.apply(jstate2.params, jobs)[0]
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-5,
                               rtol=1e-4)
    # the applied controls stay in ctrlrange
    rng = m.actuator_ctrlrange
    assert bool(((trace["ctrl"] >= rng[:, 0] - 1e-6)
                 & (trace["ctrl"] <= rng[:, 1] + 1e-6)).all())

    # eval from the round's start, on the trained students
    enorm = _eval_draws(key_after, EVAL_TICKS, MINI, m.nu)
    jout = jeval(jstate2, jplants, **jaux)
    out = td.eval_fn(dstate, plants, EVAL_TICKS, normals=t(enorm), **aux)
    for k in ("qpos_traj", "ctrl_traj", "final_x", "final_z"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-4, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(out["action_rmse"]),
                               float(jout["action_rmse"]), rtol=1e-3)
    assert out["qpos_traj"].shape == (EVAL_TICKS, S, m.nq)


@pytest.mark.parametrize("variant", ["command", "anchored"])
def test_round_and_eval_match_jax(variant):
    """The command-conditioned distiller, anchored and not, on the
    op-graph engine (JAX ``"xla"``)."""
    run_round_and_eval(variant, "ops")


def test_distiller_checks_options():
    jm, m = _models()
    tp = mini_pieces(torch, m, m.key_qpos[0, 7:])
    net = MLPActorCritic(m.nq - 2 + m.nv, m.nu, hidden=HIDDEN)
    cfg = distill.DistillConfig(**DCFG)
    with pytest.raises(ValueError, match="payload_range needs"):
        distill.make_distiller(m, tp[0], _obs, net, MPPIConfig(
            engine="ops", **MINI), cfg, payload_range=(0, 1), device="cpu")
    with pytest.raises(ValueError, match="anchor_w anchors"):
        distill.make_distiller(m, tp[0], _obs, net, MPPIConfig(**MINI), cfg,
                               anchor_w=1.0, device="cpu")
    with pytest.raises(ValueError, match="needs command_dim"):
        distill.make_distiller(m, tp[0], _obs, net, MPPIConfig(**MINI), cfg,
                               action_ref_fn=tp[3], device="cpu")
    # the observation width must be the network's
    d = distill.make_distiller(m, tp[0], _obs, net, MPPIConfig(**MINI), cfg,
                               with_prev_ctrl=True, device="cpu")
    with pytest.raises(ValueError, match="observations are"):
        d.init(torch.Generator().manual_seed(0), State(
            qpos=m.key_qpos[0], qvel=torch.zeros(m.nv),
            time=torch.zeros(())))
