"""The port's voice evals (``scripts/torch_voice_{offdist,crossfam}_eval.py``)
at ``--device cpu`` and a tiny size write ``metrics.json`` with the keys of
the JAX scripts (``scripts/voice_{offdist,crossfam}_eval.py``, as their
committed ``runs/voice_{offdist,crossfam}/metrics.json`` hold them), plus
the device and the seconds."""
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"offdist": ["--seeds", "1", "--words", "1", "--noise_bursts", "2"],
        "crossfam": ["--seeds", "1", "--words", "1"]}


def _run(name, out):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", f"torch_voice_{name}_eval.py"), "--out", str(out),
        "--device", "cpu"] + TINY[name], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["offdist", "crossfam"])
def test_voice_eval_script_writes_the_jax_keys(tmp_path, name):
    with open(os.path.join(REPO, "runs", f"voice_{name}",
                           "metrics.json")) as f:
        want = json.load(f)
    got = _run(name, tmp_path)
    assert set(got) - set(want) == {"device", "seconds"}
    assert set(want) <= set(got)
    assert got["device"] == "cpu" and got["seconds"] > 0
    assert got["vocabulary_size"] == 1 and got["seeds_per_cell"] == 1
    assert set(got["speaker_matrix"]) == set(want["speaker_matrix"])
    for v in got["speaker_matrix"].values():
        assert 0.0 <= v <= 1.0
    assert [set(r) for r in got["snr_sweep"]] == \
        [set(r) for r in want["snr_sweep"]]
    for k, v in want.items():
        if isinstance(v, dict) and k != "speaker_matrix":
            assert set(got[k]) == set(v), k
        if isinstance(v, str):
            assert got[k] == v
