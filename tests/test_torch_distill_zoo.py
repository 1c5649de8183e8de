"""The port's distillation setups and student deployment against the JAX
package's: the msgpack reader against ``flax.serialization`` on every
committed student, the recipes of the setups against their artifacts'
``metrics.json`` (the pins of tests/test_distill.py:154-229) and against
the JAX setups, ``load_student``'s policy against JAX's at random states
(1e-5 abs: float32 products summed in another order, through the 512-256
MLP), and the committed Go1 student driving the op-graph plant forward for
100 ticks (tests/test_distill.py:75-108's gates)."""
import glob
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import serialization

from opendog_tpu.rl import distill_zoo as jax_zoo
from opendog_tpu_torch.physics import dynamics, make_state
from opendog_tpu_torch.rl import distill_zoo, student_io

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STUDENTS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "runs", "*", "student.msgpack")))
# (artifact, robot, command-conditioned)
DEPLOYED = [("runs/distill_go1", "go1", False),
            ("runs/distill_opendog", "opendog", False),
            ("runs/distill_cmd", "go1", True),
            ("runs/distill_cmd_opendog", "opendog", True),
            ("runs/distill_cmd_payload", "go1", True)]


def _same_tree(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b))


def test_committed_students_exist():
    assert len(STUDENTS) >= 6, STUDENTS


@pytest.mark.parametrize("path", STUDENTS)
def test_msgpack_reader_matches_flax(path):
    with open(os.path.join(ROOT, path), "rb") as f:
        data = f.read()
    assert _same_tree(student_io.loads(data),
                      serialization.msgpack_restore(data))


def test_msgpack_reader_on_every_type_flax_writes():
    """A tree with every leaf kind flax serialises: arrays of several
    dtypes and ranks (a 0-d one too), numpy scalars, Python ints of every
    width, floats, strings, bools, None, nested dicts and lists."""
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.array(3.5, np.float64),
                  "d": np.arange(5, dtype=np.int32),
                  "e": np.ones((2, 1, 3), np.float16)},
            "f": np.float32(2.25), "g": 7, "h": -3, "i": 300, "j": -70000,
            "k": 2 ** 40, "l": 1.5, "m": "name", "n": True, "o": None,
            "p": [1, 2, {"q": np.zeros(2, np.uint8)}]}
    data = serialization.msgpack_serialize(tree)
    got, want = student_io.loads(data), serialization.msgpack_restore(data)

    def same(x, y):
        if isinstance(y, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in y)
        if isinstance(y, list):
            return len(x) == len(y) and all(map(same, x, y))
        if isinstance(y, (np.ndarray, np.generic)):
            return (np.asarray(x).dtype == np.asarray(y).dtype
                    and np.array_equal(x, y))
        return x == y and type(x) is type(y)

    assert same(got, want)
    with pytest.raises(ValueError, match="ends inside"):
        student_io.loads(data[:-3])
    with pytest.raises(ValueError, match="after the msgpack"):
        student_io.loads(data + b"\x00")


@pytest.mark.parametrize("robot", ["go1", "opendog"])
def test_setup_recipes_match_artifacts_and_jax(robot):
    """The port's recipes equal the JAX setups' and, normalised, what the
    committed walking and command students were trained with (their
    metrics.json; the command runs add the script's anchor_w and
    payload_range)."""
    for port_fn, jax_fn in ((distill_zoo.trot_distill_setup,
                             jax_zoo.trot_distill_setup),
                            (distill_zoo.cmd_distill_setup,
                             jax_zoo.cmd_distill_setup)):
        got = port_fn(robot, device="cpu").recipe
        want = json.loads(json.dumps(jax_fn(robot).recipe))
        assert distill_zoo.normalize_recipe(got) == \
            jax_zoo.normalize_recipe(want)
        assert json.loads(json.dumps(got)) == want
    runs = {"go1": ["distill_go1", "distill_cmd", "distill_cmd_payload"],
            "opendog": ["distill_opendog", "distill_cmd_opendog"]}[robot]
    for run in runs:
        with open(os.path.join(ROOT, "runs", run, "metrics.json")) as f:
            rec = json.load(f).get("recipe")
        if rec is None:
            continue  # trained before recipes were recorded
        extras = {k: rec[k] for k in ("anchor_w", "payload_range")
                  if k in rec}
        setup = (distill_zoo.cmd_distill_setup if rec.get(
            "command_conditioned") else distill_zoo.trot_distill_setup)
        current = dict(setup(robot, device="cpu").recipe, **extras)
        assert distill_zoo.normalize_recipe(rec) == \
            distill_zoo.normalize_recipe(current), run


def _random_inputs(m, B, seed):
    rng = np.random.default_rng(seed)
    q0 = m.numpy("key_qpos")[0]
    qpos = np.tile(q0, (B, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.02, (B, 3))
    quat = qpos[:, 3:7] + rng.normal(0, 0.05, (B, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.normal(0, 0.1, (B, m.nq - 7))
    qvel = rng.normal(0, 0.5, (B, m.nv)).astype(np.float32)
    t = rng.uniform(0, 4, B).astype(np.float32)
    lo, hi = m.numpy("actuator_ctrlrange").T
    prev = rng.uniform(lo, hi, (B, m.nu)).astype(np.float32)
    cmd = np.stack([rng.uniform(0, 0.6, B), np.zeros(B),
                    rng.uniform(-0.5, 0.5, B)], 1).astype(np.float32)
    return qpos.astype(np.float32), qvel, t, prev, cmd


@pytest.mark.parametrize("run,robot,cmd", DEPLOYED)
def test_load_student_matches_jax(run, robot, cmd):
    path = os.path.join(ROOT, run, "student.msgpack")
    setup_fn = (distill_zoo.cmd_distill_setup if cmd
                else distill_zoo.trot_distill_setup)
    jsetup_fn = (jax_zoo.cmd_distill_setup if cmd
                 else jax_zoo.trot_distill_setup)
    setup = setup_fn(robot, device="cpu")
    command_dim = 3 if cmd else 0
    policy = distill_zoo.load_student(path, setup, command_dim=command_dim)
    jpolicy = jax.jit(jax_zoo.load_student(path, jsetup_fn(robot),
                                           command_dim=command_dim))
    B = 16
    qpos, qvel, t, prev, c = _random_inputs(setup.model, B, 5)
    T = torch.from_numpy
    got = policy(T(qpos), T(qvel), T(t), T(prev), T(c) if cmd else None)
    assert got.shape == (B, setup.model.nu)
    for i in range(B):
        jargs = (jnp.asarray(qpos[i]), jnp.asarray(qvel[i]),
                 jnp.float32(t[i]), jnp.asarray(prev[i]))
        if cmd:
            jargs += (jnp.asarray(c[i]),)
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(jpolicy(*jargs)), atol=1e-5,
                                   rtol=0, err_msg=str(i))
    lo, hi = setup.model.numpy("actuator_ctrlrange").T
    assert ((got.numpy() >= lo - 1e-6).all()
            and (got.numpy() <= hi + 1e-6).all())
    # unbatched gives the same
    one = policy(T(qpos[2]), T(qvel[2]), torch.tensor(t[2]), T(prev[2]),
                 T(c[2]) if cmd else None)
    np.testing.assert_allclose(one.numpy(), got[2].numpy(), atol=1e-6)


def test_load_student_checks_the_command_width():
    setup = distill_zoo.cmd_distill_setup("go1", device="cpu")
    with pytest.raises(ValueError, match="command_dim=0"):
        distill_zoo.load_student(os.path.join(ROOT, "runs", "distill_cmd",
                                              "student.msgpack"), setup)


def test_walking_student_drives_the_plant_forward():
    """tests/test_distill.py:75-108 on the port: the committed Go1 student
    drives the op-graph plant (10 x 2 ms) for 100 ticks, finite, trunk z
    in (0.12, 0.45), more than 0.15 m forward."""
    setup = distill_zoo.trot_distill_setup("go1", device="cpu")
    m = setup.model
    policy = distill_zoo.load_student(os.path.join(
        ROOT, "runs", "distill_go1", "student.msgpack"), setup)
    rng = m.actuator_ctrlrange
    prev = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1])
    st = make_state(m, "home")
    zs = []
    for _ in range(100):
        u = policy(st.qpos, st.qvel, st.time, prev)
        st = dynamics.step(m, st, u, n_substeps=10)[0]
        prev = u
        zs.append(float(st.qpos[2]))
    assert np.isfinite(zs).all()
    assert min(zs) > 0.12 and max(zs) < 0.45, (min(zs), max(zs))
    assert float(st.qpos[0]) > 0.15, float(st.qpos[0])
