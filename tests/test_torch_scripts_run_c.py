"""The port's OpenDOG sweep, gait calibration, trot distillation, soak and
32k-scenario distill round at ``--device cpu`` and their smoke size, in one
subprocess (see tests/test_torch_scripts_run_a.py)."""
import os

import pytest

from test_torch_scripts_run_a import (committed, has_jax_keys, read,
                                      run_scripts)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This file's scripts, run once: (results, output directory)."""
    out = tmp_path_factory.mktemp("scripts_c")
    return run_scripts([
        ("sweep", "opendog_walk_sweep", ["--smoke", "--ticks", "2",
                                         "--samples", "8", "--out",
                                         str(out / "sweep.json")]),
        ("calib", "calibrate_cmd_gait", ["--ticks", "3", "--settle", "1",
                                         "--out", str(out / "calib")]),
        ("distill", "distill_walk", ["--smoke", "--robot", "opendog",
                                     "--out", str(out / "distill")]),
        ("soak", "soak_cmd", ["--smoke", "--out", str(out / "soak")]),
        ("32k", "distill_cmd_32k", ["--scenarios", "4", "--out",
                                    str(out / "32k")]),
    ]), out


def test_opendog_sweep_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["sweep"] == "ok", res["sweep"]
    got = read(out / "sweep.json")
    want = committed("opendog_sweep/metrics_cpu_rank.json")
    has_jax_keys(got, want, {"seconds"})
    assert got["device"] == "cpu" and got["configs"] == 1
    assert set(got["results"][0]) == set(want["results"][0])
    assert got["best"] == got["results"][0]


def test_calibration_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["calib"] == "ok", res["calib"]
    got = read(out / "calib" / "opendog.json")
    want = committed("cmd_calibration/opendog.json")
    has_jax_keys(got, want)
    assert len(got["per_probe"]) == len(want["per_probe"]) == 17
    for g, w in zip(got["per_probe"], want["per_probe"]):
        assert set(g) == set(w)
        assert g["cmd"] == w["cmd"]   # the same probe grid
    assert got["cost_params"]["amp_knots"]  # the calibrated OpenDOG law


def test_distill_walk_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["distill"] == "ok", res["distill"]
    d = out / "distill"
    got = read(d / "metrics.json")
    want = committed("distill_opendog/metrics.json")
    has_jax_keys(got, want)
    assert set(got["recipe"]) == set(want["recipe"])
    assert got["eval_ticks"] == 1 and got["rounds"] == 1
    assert os.path.exists(d / "student.pt")
    assert os.path.exists(d / "walk_distilled.json")
    assert not os.path.exists(d / "student.msgpack")


def test_soak_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["soak"] == "ok", res["soak"]
    got = read(out / "soak" / "soak.json")
    # the committed record predates the two keys soak_cmd.py:176-177 now
    # writes (payload_kg, student)
    want = dict(committed("distill_cmd/soak.json"), payload_kg=0.0,
                student="")
    has_jax_keys(got, want)
    assert got["segments_total"] == 1 and got["ticks"] == 2
    assert set(got["segments"][0]) == set(want["segments"][0])
    assert got["student"] == "runs/distill_cmd/student.msgpack"


def test_distill_32k_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["32k"] == "ok", res["32k"]
    got = read(out / "32k" / "metrics.json")
    assert list(got) == ["cpu"]
    rec = got["cpu"]
    has_jax_keys(rec, committed("distill_cmd_32k/metrics.json")["cpu"])
    assert rec["scenarios"] == 4 and rec["ticks"] == 2
    assert rec["labels_collected"] == 8 and rec["all_finite"]
