"""The port's application scripts (scripts/torch_*.py) run as a user runs
them, at ``--device cpu`` and their smoke size: each writes its record
with the keys of the JAX script's committed record (``runs/<name>/...``)
plus ``device`` and ``seconds``, and numbers that are finite.  The
scripts of a file run one after another in one subprocess (one
interpreter and one import of torch).  This file: the turn, the lag
sweep, the jump and the landing (the other scripts:
tests/test_torch_scripts_run_b.py and _c.py).
"""
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADDED = {"device", "seconds"}


RUNNER = r"""
import json, runpy, sys, traceback
res = {}
for key, path, args in json.loads(sys.argv[1]):
    sys.argv = [path] + args
    try:
        runpy.run_path(path, run_name="__main__")
        res[key] = "ok"
    except BaseException:
        res[key] = traceback.format_exc()[-4000:]
print("RESULTS " + json.dumps(res))
"""


def run_scripts(jobs, timeout=600):
    """Runs ``python3 scripts/torch_<name>.py --device cpu ARGS`` for each
    ``(key, name, args)`` job, as ``__main__``, one after another in one
    subprocess from the repository root, one thread (one interpreter and
    one import of torch for the file's scripts): ``{key: "ok" or the
    traceback}``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    spec = [[key, os.path.join(REPO, "scripts", f"torch_{name}.py"),
             ["--device", "cpu"] + args] for key, name, args in jobs]
    r = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(spec)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=timeout)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULTS ")]
    assert r.returncode == 0 and lines, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(lines[-1][len("RESULTS "):])


def committed(path):
    with open(os.path.join(REPO, "runs", path)) as f:
        return json.load(f)


def read(path):
    with open(path) as f:
        return json.load(f)


def finite_numbers(rec):
    """Every number in a record (nested) is finite."""
    if isinstance(rec, dict):
        return all(finite_numbers(v) for v in rec.values())
    if isinstance(rec, list):
        return all(finite_numbers(v) for v in rec)
    if isinstance(rec, float):
        return math.isfinite(rec)
    return True


def has_jax_keys(got, want, added=ADDED):
    """The record has the JAX record's keys and adds ``added`` only; the
    port's device line on the CPU is ``cpu``."""
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert set(got) - set(want) == added, sorted(set(got) - set(want))
    assert got["device"] == "cpu" and got["seconds"] > 0
    assert finite_numbers(got)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This file's scripts, run once: (results, output directory)."""
    out = tmp_path_factory.mktemp("scripts_a")
    return run_scripts([
        ("turn", "turn_mpc", ["--smoke", "--out", str(out / "turn")]),
        ("lag", "lag_sweep", ["--smoke", "--ticks", "1", "--seeds", "1",
                              "--lags", "2", "--out",
                              str(out / "lag.json")]),
        ("jump", "jump_mpc", ["--smoke", "--out", str(out / "jump")]),
        ("landing", "landing_mpc", ["--smoke", "--out",
                                    str(out / "landing")]),
    ]), out


def test_turn_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["turn"] == "ok", res["turn"]
    got = read(out / "turn" / "metrics.json")
    has_jax_keys(got, committed("turn_mpc/metrics.json"))
    assert got["ticks"] == 1 and got["yaw_target_deg"] == 45.0
    assert len(got["yaw_traj_deg"]) == 1 and got["all_finite"]


def test_lag_sweep_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["lag"] == "ok", res["lag"]
    got = read(out / "lag.json")
    want = committed("lag_sweep/metrics_compensated.json")
    has_jax_keys(got, want, {"seconds"})
    assert got["device"] == "cpu" and got["engine"] == "kernel"
    assert not got["compensated"] and got["final_x_lag3_vs_lag0"] is None
    (rec,) = got["results"]
    assert set(rec) == set(want["results"][0])
    assert rec["lag"] == 2 and rec["ticks"] == 1 and rec["seeds"] == 1
    assert rec["solves_per_sec"] > 0


@pytest.mark.parametrize("name", ["jump", "landing"])
def test_box_scene_scripts_write_the_jax_keys(runs, name):
    res, out = runs
    assert res[name] == "ok", res[name]
    got = read(out / name / "metrics.json")
    has_jax_keys(got, committed(f"{name}_mpc/metrics.json"))
    assert got["ticks"] == 3 and got["all_finite"]
