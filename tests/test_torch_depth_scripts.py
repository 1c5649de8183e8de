"""The port's depth evals (``scripts/torch_depth_{offdist,crossfam}_eval.py``)
at ``--device cpu`` and a tiny size write ``metrics.json`` with the keys of
the JAX scripts (``scripts/depth_{offdist,crossfam}_eval.py``, as their
committed ``runs/depth_{offdist,crossfam}/metrics.json`` hold them), each
arm's numbers, and the device."""
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--train_frames", "4", "--eval_frames", "2", "--steps", "3"]
ARM_KEYS = {"rmse_m", "mean_depth_baseline_rmse_m", "beats_baseline"}


def _run(script, out):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                     script),
                        "--out", str(out), "--device", "cpu"] + TINY,
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["offdist", "crossfam"])
def test_depth_eval_script_writes_the_jax_keys(tmp_path, name):
    with open(os.path.join(REPO, "runs", f"depth_{name}",
                           "metrics.json")) as f:
        want = json.load(f)
    got = _run(f"torch_depth_{name}_eval.py", tmp_path)
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"device", "seconds"}
    assert got["device"] == "cpu" and got["seconds"] > 0
    assert got["train"].keys() == want["train"].keys()
    assert got["train"]["train_frames"] == 4 and got["train"]["steps"] == 3
    arms = [k for k, v in want.items() if isinstance(v, dict)
            and k != "train"]
    assert len(arms) == 3
    for k in arms:
        assert set(got[k]) == ARM_KEYS == set(want[k]), k
        assert got[k]["mean_depth_baseline_rmse_m"] > 0
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
