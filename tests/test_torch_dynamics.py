"""The port's op-graph physics (``opendog_tpu_torch.physics.dynamics`` and
the spatial algebra under it) against the JAX package's, function by
function, and the cases and comparisons that
``test_torch_dynamics_scenes.py``, ``test_torch_dynamics_opendog.py`` and
``test_torch_dynamics_step.py`` import from here (split so that each file
runs in under a minute).  Here: every function of the step on Go1 and on a
hinge pendulum (the dense solve), and the spatial algebra, the unrolled
Cholesky solve and the leg inverses on their own.

The cases are every robot and scene the step must handle: Go1, OpenDOG on
flat ground and on a generated terrain, mini, a hinge pendulum (no free
joint), Go1 on the ``jump`` scene with states on and inside its box, and
Go1 with the oracle foot contact (progressive impedance, torsional and
rolling friction).

Each JAX function runs vmapped over a batch of 8 states made from numpy
seeds, op by op; the port's function takes the same batch as its leading
axis.  Each function gets the same inputs on both sides (its upstream
quantities are computed once, by the JAX package), so a test reads that
function's own error.  Tolerance: 1e-5 relative and 1e-5 absolute, except
for the contact damping matrices D, sums over up to 78 spheres of entries
up to ~1e3 that cancel to small ones: there the absolute tolerance is 1e-5
of the largest entry of the batch's D (measured: 6.9e-5 absolute on an
entry near 2 of a D whose largest entry is 451, Go1 on the jump box).
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import dynamics as jd
from opendog_tpu.physics import load_model as jax_load_model
from opendog_tpu.physics import spatial as jsp
from opendog_tpu.physics import terrain as jax_terrain
from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import (Contact, dynamics as td,
                                       load_model, spatial as tsp,
                                       terrain_from_numpy)

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
B = 8

PENDULUM = """
<mujoco>
  <option gravity="0 0 -9.81" timestep="0.001"/>
  <worldbody>
    <body name="link" pos="0 0 1">
      <inertial mass="1" pos="0 0 -0.5" diaginertia="1e-6 1e-6 1e-6"/>
      <joint name="pivot" type="hinge" axis="0 1 0" pos="0 0 0"/>
    </body>
  </worldbody>
</mujoco>
"""

MODELS = ("go1", "opendog", "opendog_terrain", "mini", "pendulum",
          "go1_jump", "go1_oracle")


def _lowest_sphere(jm, qpos):
    """Height of the lowest collision sphere's bottom above z = 0."""
    xpos, xquat = jd.fk(jm, jnp.asarray(qpos))
    R = np.asarray(jsp.quat_to_mat(xquat))
    gb = np.asarray(jm.geom_body)
    z = np.asarray(xpos)[gb, 2] + np.einsum("gj,gj->g", R[gb, 2, :],
                                            np.asarray(jm.geom_pos))
    return float((z - np.asarray(jm.geom_radius)).min())


def _near_home(jm, rng, qvel_sigma=0.2, sink=0.004):
    """B states around the home keyframe with the lowest sphere ``sink``
    below the ground (so that contacts are active): qpos noise as in
    tests/test_pallas_core.py::_random_batch, qvel ~N(0, qvel_sigma)."""
    home = np.asarray(jm.key_qpos[0], np.float32)
    qpos = np.tile(home, (B, 1))
    qpos[:, 2] -= _lowest_sphere(jm, home) + sink
    qpos[:, :3] += rng.normal(0, 0.003, (B, 3))
    qpos[:, 7:] += rng.normal(0, 0.05, (B, jm.nq - 7))
    qvel = rng.normal(0, qvel_sigma, (B, jm.nv))
    return qpos.astype(np.float32), qvel.astype(np.float32)


@functools.lru_cache(maxsize=None)
def case(name):
    """(jax model, port model, jax terrain or None, port terrain or None,
    numpy qpos (B, nq), qvel (B, nv), ctrl (B, nu))."""
    rng = np.random.default_rng(MODELS.index(name))
    jt = t = None
    if name == "pendulum":
        jm, m = jax_load_model(PENDULUM), load_model(PENDULUM, device="cpu")
        qpos = rng.uniform(-1.0, 1.0, (B, 1)).astype(np.float32)
        qvel = rng.normal(0, 1.0, (B, 1)).astype(np.float32)
        return jm, m, None, None, qpos, qvel, np.zeros((B, 0), np.float32)
    if name == "mini":
        jm, m = jax_assets.load_mini(), assets.load_mini(device="cpu")
    elif name.startswith("opendog"):
        scene = "terrain" if name == "opendog_terrain" else "flat"
        jm = jax_assets.load_opendog(scene)
        m = assets.load_opendog(scene, device="cpu")
    else:
        scene = "jump" if name == "go1_jump" else "flat"
        jm, m = jax_assets.load_go1(scene), assets.load_go1(scene,
                                                            device="cpu")
        if name == "go1_oracle":
            jm = jax_assets.go1_oracle_contact(jm)
            m = assets.go1_oracle_contact(m)
    qpos, qvel = _near_home(jm, rng)
    if name == "opendog_terrain":
        jt = jax_terrain.generate_terrain(jax.random.PRNGKey(0), jm)
        t = terrain_from_numpy(np.asarray(jt.height), "cpu")
        qpos[:, :2] += rng.uniform(-1.0, 1.0, (B, 2))
        h, _ = jd._terrain_height_normal(jm, jt, jnp.asarray(qpos[:, :2]))
        qpos[:, 2] += np.asarray(h)
    if name == "go1_jump":
        # over the platform (x in [0.6, 1.4], top at z = 0.18): on it, over
        # its edge, and sunk up to 3.5 cm into it (sphere centers inside)
        qpos[:, 0] += rng.uniform(0.55, 1.45, B)
        qpos[:, 2] += 0.18 - rng.uniform(0.0, 0.035, B)
    lo, hi = np.asarray(jm.actuator_ctrlrange).T
    ctrl = rng.uniform(lo, hi, (B, jm.nu)).astype(np.float32)
    return jm, m, jt, t, qpos.astype(np.float32), qvel, ctrl


@functools.lru_cache(maxsize=None)
def upstream(name):
    """The JAX package's intermediate quantities of ``forward`` on the
    case's batch (numpy), fed to both sides of each function test."""
    jm, _, jt, _, qpos, qvel, ctrl = case(name)
    out = jax.jit(functools.partial(_upstream, jm, jt))(
        *(jnp.asarray(a) for a in (qpos, qvel, ctrl)))
    return {k: (jax.tree.map(np.asarray, a) if k == "contact"
                else np.asarray(a)) for k, a in out.items()}


def _upstream(jm, jt, qp, qv, ct):
    v = jax.vmap
    xpos, xquat = v(lambda q: jd.fk(jm, q))(qp)
    origin = xpos[:, 0]
    S = v(lambda a, b, o: jd.motion_subspace(jm, a, b, o))(xpos, xquat,
                                                          origin)
    V = v(lambda s, q: jd.body_velocities(jm, s, q))(S, qv)
    I_O = v(lambda a, b, o: jd._spatial_inertias(jm, a, b, o))(xpos, xquat,
                                                              origin)
    M = v(lambda s, i: jd.mass_matrix(jm, s, i))(S, I_O)
    _, D_con, contact = v(lambda a, b, s, vv, o: jd.contact_terms(
        jm, a, b, s, vv, o, jt))(xpos, xquat, S, V, origin)
    _, d_diag = v(lambda a, b: jd.passive_terms(jm, a, b))(qp, qv)
    dt = jm.timestep
    A = M + dt * (D_con + v(jnp.diag)(d_diag))
    rhs = v(lambda a, b: a @ b)(M, qv) + dt * qv
    return dict(qpos=qp, qvel=qv, ctrl=ct, xpos=xpos, xquat=xquat,
                origin=origin, S=S, V=V, I_O=I_O, A=A, rhs=rhs,
                contact=contact)


def _vmap(fn, *args):
    """``fn`` vmapped over the batch, op by op (jitted, XLA may fuse a
    product and a sum into one rounding where the port rounds twice)."""
    return jax.vmap(fn)(*(jax.tree.map(jnp.asarray, a) for a in args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if what.endswith(": D"):  # see the module docstring
        atol = ATOL * float(np.abs(want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


def _contact_pairs(got: Contact, want):
    return [(getattr(got, f), getattr(want, f), f)
            for f in ("force_world", "force_body", "penetration",
                      "in_contact")]


# -- one function against its JAX counterpart, on one case --------------

def _fn_fk(jm, m, jt, t, u):
    want = _vmap(lambda q: jd.fk(jm, q), u["qpos"])
    got = td.fk(m, _t(u["qpos"]))
    return zip(got, want, ("xpos", "xquat"))


def _fn_motion_subspace(jm, m, jt, t, u):
    got = td.motion_subspace(m, _t(u["xpos"]), _t(u["xquat"]),
                             _t(u["origin"]))
    return [(got, u["S"], "S")]


def _fn_body_velocities(jm, m, jt, t, u):
    got = td.body_velocities(m, _t(u["S"]), _t(u["qvel"]))
    return [(got, u["V"], "V")]


def _fn_site_positions(jm, m, jt, t, u):
    want = _vmap(lambda a, b: jd.site_positions(jm, a, b), u["xpos"],
                 u["xquat"])
    return [(td.site_positions(m, _t(u["xpos"]), _t(u["xquat"])), want,
             "sites")]


def _fn_spatial_inertias(jm, m, jt, t, u):
    got = td._spatial_inertias(m, _t(u["xpos"]), _t(u["xquat"]),
                               _t(u["origin"]))
    return [(got, u["I_O"], "I_O")]


def _fn_mass_matrix(jm, m, jt, t, u):
    want = _vmap(lambda s, i: jd.mass_matrix(jm, s, i), u["S"], u["I_O"])
    return [(td.mass_matrix(m, _t(u["S"]), _t(u["I_O"])), want, "M")]


def _fn_bias_forces(jm, m, jt, t, u):
    args = [u[k] for k in ("S", "V", "I_O", "qvel")]
    want = _vmap(lambda *a: jd.bias_forces(jm, *a), *args)
    return [(td.bias_forces(m, *(_t(a) for a in args)), want, "C")]


def _fn_actuator_forces(jm, m, jt, t, u):
    args = [u[k] for k in ("qpos", "qvel", "ctrl")]
    want = _vmap(lambda *a: jd.actuator_forces(jm, *a), *args)
    return [(td.actuator_forces(m, *(_t(a) for a in args)), want, "tau")]


def _fn_passive_terms(jm, m, jt, t, u):
    # joint angles pushed past their limits, so that the limit springs
    # and the limit damping engage
    qpos = u["qpos"].copy()
    if jm.nq > 7:
        qpos[:, 7:] *= np.linspace(0.5, 2.0, B, dtype=np.float32)[:, None]
    want = _vmap(lambda a, b: jd.passive_terms(jm, a, b), qpos, u["qvel"])
    got = td.passive_terms(m, _t(qpos), _t(u["qvel"]))
    return zip(got, want, ("tau_limit", "d_diag"))


def _fn_dof_positions(jm, m, jt, t, u):
    want = _vmap(lambda q: jd._dof_positions(jm, q), u["qpos"])
    return [(td._dof_positions(m, _t(u["qpos"])), want, "qj")]


def _fn_contact_geometry(jm, m, jt, t, u):
    want = _vmap(lambda a, b: jd._contact_geometry(jm, a, b, jt),
                 u["xpos"], u["xquat"])
    got = td._contact_geometry(m, _t(u["xpos"]), _t(u["xquat"]), t)
    return zip(got, want, ("phi", "normal", "point", "R"))


def _fn_contact_terms(jm, m, jt, t, u):
    args = [u[k] for k in ("xpos", "xquat", "S", "V", "origin")]
    want = _vmap(lambda *a: jd.contact_terms(jm, *a, jt), *args)
    got = td.contact_terms(m, *(_t(a) for a in args), t)
    return ([(got[0], want[0], "qfrc"), (got[1], want[1], "D")]
            + _contact_pairs(got[2], want[2]))


def _fn_tree_solve(jm, m, jt, t, u):
    want = _vmap(lambda a, b: jd.tree_solve(jm, a, b), u["A"], u["rhs"])
    return [(td.tree_solve(m, _t(u["A"]), _t(u["rhs"])), want, "x")]


def _fn_arrow_solve(jm, m, jt, t, u):
    want = _vmap(lambda a, b: jd.arrow_solve(jm, a, b), u["A"], u["rhs"])
    return [(td.arrow_solve(m, _t(u["A"]), _t(u["rhs"])), want, "x")]


def _fn_forward(jm, m, jt, t, u):
    args = [u[k] for k in ("qpos", "qvel", "ctrl")]
    qv, aux = _vmap(lambda *a: jd.forward(jm, *a, jt), *args)
    gqv, gaux = td.forward(m, *(_t(a) for a in args), t)
    return ([(gqv, qv, "qvel_next")]
            + [(gaux[k], aux[k], k) for k in ("xpos", "xquat",
                                              "qfrc_actuator",
                                              "mass_matrix")]
            + _contact_pairs(gaux["contact"], aux["contact"]))


def _fn_integrate(jm, m, jt, t, u):
    dt = 0.01
    want = _vmap(lambda a, b: jd.integrate(jm, a, b, dt), u["qpos"],
                 u["qvel"])
    return [(td.integrate(m, _t(u["qpos"]), _t(u["qvel"]), dt), want,
             "qpos_next")]


def _fn_foot_contact_summary(jm, m, jt, t, u):
    c = u["contact"]
    want = _vmap(lambda cc: jd.foot_contact_summary(jm, cc), c)
    got = td.foot_contact_summary(m, Contact(
        force_world=_t(c.force_world), force_body=_t(c.force_body),
        penetration=_t(c.penetration), in_contact=_t(c.in_contact)))
    return zip(got, want, ("force_world", "force_body", "in_contact"))


def _fn_dof_ancestors(jm, m, jt, t, u):
    assert td._dof_ancestors(m) == jd._dof_ancestors(jm)
    return [(td._dof_ancestor_matrix(m), jd._dof_ancestor_matrix(jm), "D"),
            (td._body_ancestor_matrix(m), jd._body_ancestor_matrix(jm), "A")]


FUNCTIONS = {name[4:]: fn for name, fn in dict(globals()).items()
             if name.startswith("_fn_")}
# the pendulum has no feet: the JAX function stacks an empty list
NOT_APPLICABLE = {("foot_contact_summary", "pendulum")}


def check_function(function, model):
    """``function`` of the port against the JAX package's on the case's
    batch of 8, at the module's tolerances; booleans equal."""
    jm, m, jt, t = case(model)[:4]
    pairs = list(FUNCTIONS[function](jm, m, jt, t, upstream(model)))
    assert pairs
    for got, want, what in pairs:
        _close(got, want, what=f"{function} {model}: {what}")


def function_cases(models):
    """(function, model) pairs of ``models`` that the JAX package can run."""
    return [(f, m) for f in sorted(FUNCTIONS) for m in models
            if (f, m) not in NOT_APPLICABLE]


@pytest.mark.parametrize("function,model",
                         function_cases(("go1", "pendulum")))
def test_function_matches_jax(function, model):
    """``function`` of the port against the JAX package's on the case's
    batch of 8: 1e-5 relative and 1e-5 absolute, booleans equal."""
    check_function(function, model)


def test_cases_reach_every_branch():
    """The cases exercise what they are there for (read through the port's
    own functions): contacts in every case with geoms, sphere centers
    inside the jump box and beside it, the terrain's normals off vertical,
    and every leg-inverse size (n = 1, 2, 3, and the pendulum's dense
    solve)."""
    for name in MODELS:
        _, m, _, t, qpos, qvel, ctrl = case(name)
        _, aux = td.forward(m, _t(qpos), _t(qvel), _t(ctrl), t)
        if name != "pendulum":
            assert aux["contact"].in_contact.any(), name
    _, m, _, _, qpos, _, _ = case("go1_jump")
    xpos, xquat = td.fk(m, _t(qpos))
    R = tsp.quat_to_mat(xquat)
    gb = m.geom_body.long()
    c = (xpos[:, gb] + torch.einsum("bgij,gj->bgi", R[:, gb],
                                    m.geom_pos)).numpy()
    in_box = (np.abs(c[..., 0] - 1.0) < 0.4) & (np.abs(c[..., 1]) < 0.4)
    assert (in_box & (c[..., 2] < 0.18)).any()  # centers inside the box
    assert (~in_box & (c[..., 2] < 0.18)).any()  # and beside it
    _, m, _, t, qpos, _, _ = case("opendog_terrain")
    _, n = td._terrain_height_normal(m, t, _t(qpos[:, :2]))
    assert (n[:, 2] < 0.999).any()
    sizes = {name: td._arrow_structure(case(name)[1]) for name in
             ("mini", "opendog", "go1", "pendulum")}
    assert sizes["pendulum"] is None
    assert [sizes[k][1].shape[1] for k in ("mini", "opendog", "go1")] \
        == [1, 2, 3]


# -- the spatial algebra ----------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _unit_quats(seed):
    q = _rand((B, 4), seed)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


SPATIAL = {
    "quat_conj": lambda s: (_unit_quats(s),),
    "quat_rotate_inv": lambda s: (_unit_quats(s), _rand((B, 3), s + 1)),
    # rotation vectors down to zero length (the sinc-safe branch)
    "quat_exp": lambda s: (_rand((B, 3), s) * np.logspace(
        -12, 0, B, dtype=np.float32)[:, None],),
    "quat_integrate": lambda s: (_unit_quats(s), _rand((B, 3), s + 1),
                                 0.01),
    "skew": lambda s: (_rand((B, 3), s),),
    "spatial_inertia_at_origin": lambda s: (
        np.abs(_rand((B,), s)), _rand((B, 3), s + 1),
        _rand((B, 3, 3), s + 2)),
    "motion_cross": lambda s: (_rand((B, 6), s), _rand((B, 6), s + 1)),
    "force_cross": lambda s: (_rand((B, 6), s), _rand((B, 6), s + 1)),
    "point_velocity": lambda s: (_rand((B, 6), s), _rand((B, 3), s + 1)),
}


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_matches_jax(name):
    """Each spatial function of the step on random batches (B=8):
    1e-5 relative and 1e-5 absolute."""
    args = SPATIAL[name](7)
    want = getattr(jsp, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args))
    got = getattr(tsp, name)(*(_t(a) if isinstance(a, np.ndarray) else a
                               for a in args))
    _close(got, want, what=name)


@pytest.mark.parametrize("m", [1, 2, 3, 6])
def test_chol_solve_unrolled_matches_jax(m):
    """The unrolled Cholesky solve on SPD systems, and with a pivot driven
    negative (the sqrt(max(s, 1e-9)) clamp): 1e-5 relative and absolute."""
    X = _rand((B, m, m), m)
    S = X @ X.transpose(0, 2, 1) + 0.5 * np.eye(m, dtype=np.float32)
    S[0] = -np.eye(m, dtype=np.float32)  # every pivot clamped
    y = _rand((B, m), m + 10)
    want = jax.vmap(jd._chol_solve_unrolled)(jnp.asarray(S), jnp.asarray(y))
    got = td._chol_solve_unrolled(_t(S), _t(y))
    _close(got, want, what=f"m={m}")
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("n", [2, 3])
def test_leg_inverse_clamps_singular_blocks(n):
    """A singular leg block takes the |det| < 1e-12 clamp in both packages:
    the arrow solve of a system whose first leg block is all zero gives
    the JAX package's (finite) values."""
    name = "opendog" if n == 2 else "go1"
    jm, m = case(name)[:2]
    u = upstream(name)
    A = u["A"].copy()
    chains = td._arrow_structure(m)[1]
    A[0][np.ix_(chains[0], chains[0])] = 0.0
    want = jax.vmap(lambda a, b: jd.arrow_solve(jm, a, b))(
        jnp.asarray(A), jnp.asarray(u["rhs"]))
    got = td.arrow_solve(m, _t(A), _t(u["rhs"]))
    _close(got[1:], np.asarray(want)[1:], what="regular rows")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                               rtol=1e-4)
