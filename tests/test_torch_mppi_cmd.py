"""M10 in the port's MPPI solver: command-conditioned, anchored and
terminal-cost solves against the JAX package's on the same normals, on the
kernel engine (JAX ``"pallas"`` in interpret mode) and on the op-graph
engine (JAX ``"xla"``), on mini.  Go1 with the distiller's expert is in
tests/test_torch_mppi_cmd_go1.py, the batched solver in
tests/test_torch_mppi_batched.py.

mini has two legs, so its command cost, anchor references and terminal
cost are written here in both packages: a velocity and height command on
top of ``standing_cost``, a swing reference ``u_ref(t)`` and its
command-scaled ``u_ref(t, cmd)``.  Tolerances: those of the mini solves
of tests/test_torch_terrain_mpc.py (ctrl and nominal 1e-5 abs, best_cost,
mean_cost 5e-5 relative, ess 5e-4 relative); on the op-graph engine
those of tests/test_torch_ops_engine.py (ctrl and nominal 1e-4 abs).
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.solvers import MPPIConfig as JaxMPPIConfig
from opendog_tpu.solvers import costs as jax_costs
from opendog_tpu.solvers import mppi as jax_mppi
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
from test_torch_exact_plant import MINI, _interpret, _solve_normals

torch.set_num_threads(1)

START_T = 0.37   # a solve-from time off the slot grid: the anchor's base


def mini_pieces(np_mod, m, home):
    """(standing cost, command cost, u_ref(t), u_ref(t, cmd), terminal
    cost) for mini in one package: ``np_mod`` is jnp (per sample) or torch
    (batch-first)."""
    if np_mod is jnp:
        base = jax_costs.standing_cost(m, 0.115, home)
        ctrl0 = jnp.asarray(m.key_ctrl[0])
        sq, sin = jnp.square, jnp.sin
        sign = jnp.asarray([1.0, -1.0])

        def cmd_cost(st, c, p, cmd):
            return (base(st, c, p) + 3.0 * sq(st.qvel[0] - cmd[0])
                    + 40.0 * sq(st.qpos[2] - 0.115 - cmd[1]))

        def u_t(t):
            return ctrl0 + 0.1 * sin(2.0 * math.pi * t / 0.4) * sign

        def u_cmd(t, cmd):
            return ctrl0 + cmd[0] * sin(2.0 * math.pi * t / 0.4) * sign

        def term(st):
            return 50.0 * sq(st.qpos[2] - 0.115) + sq(st.qvel[0])
    else:
        base = costs.standing_cost(m, 0.115, home)
        ctrl0 = m.key_ctrl[0]
        sq, sin = torch.square, torch.sin
        sign = torch.tensor([1.0, -1.0])

        def cmd_cost(st, c, p, cmd):
            return (base(st, c, p) + 3.0 * sq(st.qvel[..., 0] - cmd[..., 0])
                    + 40.0 * sq(st.qpos[..., 2] - 0.115 - cmd[..., 1]))

        def u_t(t):
            return ctrl0 + 0.1 * sin(2.0 * math.pi * t / 0.4)[..., None] * sign

        def u_cmd(t, cmd):
            return ctrl0 + cmd[..., :1] * sin(
                2.0 * math.pi * t / 0.4)[..., None] * sign

        def term(st):
            return (50.0 * sq(st.qpos[..., 2] - 0.115)
                    + sq(st.qvel[..., 0]))
    return base, cmd_cost, u_t, u_cmd, term


# name: (solver options, trailing args (payload, command) or None)
VARIANTS = {
    "command": (dict(with_command=True), (None, (0.3, 0.01, 0.0))),
    "anchor": (dict(u_ref="t", anchor_w=15.0), (None, None)),
    "anchor_cmd": (dict(with_command=True, u_ref="cmd", anchor_w=15.0),
                   (None, (0.2, -0.005, 0.1))),
    "terminal": (dict(terminal=True), (None, None)),
    "all": (dict(with_payload=True, with_command=True, u_ref="cmd",
                 anchor_w=5.0, terminal=True), (0.6, (0.25, 0.0, 0.0))),
    # the op-graph engine carries no payload
    "all_ops": (dict(with_command=True, u_ref="cmd", anchor_w=5.0,
                     terminal=True), (None, (0.25, 0.0, -0.2))),
}
KERNEL_VARIANTS = ["all", "anchor", "anchor_cmd", "command", "terminal"]


def _options(pieces, opts):
    """make_solver keyword arguments of a variant in one package."""
    base, cmd_cost, u_t, u_cmd, term = pieces
    kw = {k: v for k, v in opts.items() if k in ("with_command",
                                                  "with_payload",
                                                  "anchor_w")}
    if "u_ref" in opts:
        kw["u_ref_fn"] = u_t if opts["u_ref"] == "t" else u_cmd
    if opts.get("terminal"):
        kw["terminal_cost"] = term
    cost = cmd_cost if opts.get("with_command") else base
    return cost, kw


def _solve_both(variant, engine):
    """(port outputs, JAX outputs, port solve inputs) of one solve of a
    variant from a state at t = 0.37 s on the same normals."""
    opts, (payload, command) = VARIANTS[variant]
    jm, m = jax_assets.load_mini(), assets.load_mini(device="cpu")
    home = np.asarray(jm.key_qpos[0])[7:]
    jcost, jkw = _options(mini_pieces(jnp, jm, home), opts)
    cost, kw = _options(mini_pieces(torch, m, home), opts)
    jcfg = JaxMPPIConfig(engine="pallas" if engine == "kernel" else "xla",
                         **MINI)
    jsolve = jax.jit(jax_mppi.make_solver(jm, jcost, jcfg, **jkw))
    cfg = MPPIConfig(engine=engine, **MINI)
    solve = mppi.make_solver(m, cost, cfg, device="cpu", **kw)
    key = jax.random.PRNGKey(5)
    jst = jax_make_state(jm, "home").replace(time=jnp.float32(START_T))
    st = make_state(m, "home")
    st.time = torch.tensor(START_T)
    jaux, aux = (), ()
    if payload is not None:
        jaux, aux = (jnp.float32(payload),), (payload,)
    if command is not None:
        jaux += (jnp.asarray(command, jnp.float32),)
        aux += (torch.tensor(command),)
    want = jsolve(jst, jax_mppi.init_state(jm, jcfg), key, *jaux)
    normals = torch.from_numpy(_solve_normals(key, cfg.num_samples,
                                              cfg.horizon, m.nu))
    got = solve(st, mppi.init_state(m, cfg), None, normals, *aux)
    return got, want, (m, cfg, st, normals, payload, aux)


def _check(got, want, atol):
    (ctrl, ms, stats), (jctrl, jms, jstats) = got, want
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), atol=atol)
    np.testing.assert_allclose(ms.nominal.numpy(), np.asarray(jms.nominal),
                               atol=atol)
    for name, rtol in (("best_cost", 5e-5), ("mean_cost", 5e-5),
                       ("ess", 5e-4)):
        np.testing.assert_allclose(float(stats[name]), float(jstats[name]),
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_mini_kernel_solve_matches_jax_pallas_interpret(monkeypatch,
                                                        variant):
    """One solve per variant, kernel engine against JAX ``"pallas"`` in
    interpret mode (jitted)."""
    _interpret(monkeypatch)
    got, want, (m, cfg, st, normals, payload, aux) = _solve_both(variant,
                                                                 "kernel")
    _check(got, want, 1e-5)
    # the option changes the solve: the plain solve on the same normals
    # lands elsewhere
    plain = mppi.make_solver(
        m, mini_pieces(torch, m, m.key_qpos[0, 7:])[0], cfg, device="cpu",
        with_payload=payload is not None)
    _, _, s0 = plain(st, mppi.init_state(m, cfg), None, normals,
                     *aux[:int(payload is not None)])
    assert abs(float(s0["best_cost"]) - float(got[2]["best_cost"])) > 1e-6


@pytest.mark.parametrize("variant", ["all_ops", "anchor"])
def test_mini_ops_solve_matches_jax_xla(variant):
    """The op-graph engine against JAX ``"xla"`` (jitted): a command with
    a command-indexed anchor and a terminal cost, and a time-indexed
    anchor."""
    got, want, _ = _solve_both(variant, "ops")
    _check(got, want, 1e-4)


def test_solver_checks_m10_arguments():
    m = assets.load_mini(device="cpu")
    home = m.key_qpos[0, 7:]
    base, cmd_cost, u_t, u_cmd, term = mini_pieces(torch, m, home)
    cfg = MPPIConfig(**MINI)
    with pytest.raises(ValueError, match="needs with_command=True"):
        mppi.make_solver(m, base, cfg, device="cpu", u_ref_fn=u_cmd,
                         anchor_w=1.0)
    # a command-indexed reference without a weight is no anchor
    mppi.make_solver(m, base, cfg, device="cpu", u_ref_fn=u_cmd)
    solve = mppi.make_solver(m, cmd_cost, cfg, device="cpu",
                             with_payload=True, with_command=True)
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    with pytest.raises(ValueError, match="expected 2 trailing args"):
        solve(st, ms, None, None, torch.zeros(3))
    ctrl, _, _ = solve(st, ms, torch.Generator().manual_seed(0), None, 0.5,
                       torch.zeros(3))
    assert torch.isfinite(ctrl).all()
