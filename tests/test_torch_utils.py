"""The port's training utilities against the JAX package's: the metrics
writer (the same JSONL records but the wall time), the checkpointer's
step bookkeeping against Orbax's (``max_to_keep``, a step already on disk
skipped, the latest step), the stick-figure renderer (the same frame,
pixel for pixel up to anti-aliasing at moved edges), and ``train.py``'s
task table (models, envs, action and observation sizes, widths, squash,
losses)."""
import json

import matplotlib.pyplot as plt
import numpy as np
import torch

from opendog_tpu import train as jax_train
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.utils import checkpoint as jax_checkpoint
from opendog_tpu.utils import metrics as jax_metrics
from opendog_tpu.utils import render as jax_render
from opendog_tpu_torch import train
from opendog_tpu_torch.assets import load_opendog
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.utils import checkpoint, metrics, render

torch.set_num_threads(1)


def test_metrics_writer_matches_jax(tmp_path):
    rows = [(0, {"a": 1.5, "b": np.float32(2.0)}, "train"),
            (1, {"episode_return": 3.25}, "eval"), (2, {"c": -1}, "")]
    for mod, d in ((metrics, "port"), (jax_metrics, "jax")):
        w = mod.MetricsWriter(str(tmp_path / d), use_tensorboard=False)
        for step, m, prefix in rows:
            w.write(step, m, prefix=prefix)
        w.close()
    got, want = ([{k: v for k, v in json.loads(line).items() if k != "time"}
                  for line in (tmp_path / d / "metrics.jsonl").read_text()
                  .splitlines()] for d in ("port", "jax"))
    assert got == want and len(got) == 3


def test_checkpointer_steps_match_orbax(tmp_path):
    port = checkpoint.Checkpointer(str(tmp_path / "port"), max_to_keep=2)
    orb = jax_checkpoint.Checkpointer(str(tmp_path / "orbax"), max_to_keep=2)
    for step in (1, 2, 3, 3, 5):
        tree = {"x": np.full(3, float(step), np.float32)}
        saved = (port.save(step, {"x": torch.from_numpy(tree["x"])},
                           force=True),
                 orb.save(step, tree, force=True))
        assert saved[0] == bool(saved[1]), step
        assert port.latest_step() == orb.latest_step()
        assert port.all_steps() == sorted(orb._mgr.all_steps())
    np.testing.assert_array_equal(port.restore()["x"].numpy(),
                                  np.asarray(orb.restore()["x"]))
    port.close()
    orb.close()


def test_render_frame_matches_jax():
    from opendog_tpu.assets import load_opendog as jax_load_opendog
    jm, m = jax_load_opendog("flat"), load_opendog("flat", device="cpu")
    rng = np.random.default_rng(0)
    qpos = np.asarray(jm.key_qpos[0], np.float32).copy()
    qpos[7:] += rng.normal(0, 0.2, jm.nq - 7).astype(np.float32)
    frames = []
    for mod, state in (
            (jax_render, jax_make_state(jm).replace(qpos=qpos)),
            (render, type(make_state(m))(qpos=torch.from_numpy(qpos),
                                         qvel=torch.zeros(m.nv),
                                         time=torch.zeros(())))):
        ax = mod.render_frame(jm if mod is jax_render else m, state)
        ax.figure.canvas.draw()
        frames.append(np.asarray(ax.figure.canvas.buffer_rgba())[..., :3]
                      .astype(int))
        plt.close(ax.figure)
    differ = np.any(frames[0] != frames[1], axis=-1)
    assert frames[0].shape == frames[1].shape
    assert differ.mean() < 1e-3, differ.mean()


def test_task_table_matches_jax():
    assert sorted(train.TASKS) == sorted(jax_train.TASKS)
    for task, spec in train.TASKS.items():
        jspec = jax_train.TASKS[task]
        for k in ("action_dim", "hidden", "squash", "loss"):
            assert spec[k] == jspec[k], (task, k)
        assert spec["env"].__name__ == jspec["env"].__name__, task
        model, env, net = train.build(task, "cpu")
        jmodel = jspec["model"]()
        jenv = jspec["env"](jmodel)
        assert (model.nq, model.nu, model.ngeom, model.hfield_nrow) == (
            jmodel.nq, jmodel.nu, jmodel.ngeom, jmodel.hfield_nrow), task
        assert env.obs_size == jenv.obs_size == net.obs_dim, task
        assert net.action_dim == jspec["action_dim"] == env.action_dim
