"""The port's iLQR gait, terrain fidelity, terrain profile and precision
audit scripts at ``--device cpu`` and their smoke size, in one subprocess
(see tests/test_torch_scripts_run_a.py)."""
import pytest

from test_torch_scripts_run_a import (committed, has_jax_keys, read,
                                      run_scripts)

# scripts/terrain_fidelity.py's summary (lines 176-212 with the kernel
# arms): no record of it is committed
FIDELITY_KEYS = {
    "metric", "ticks", "plane_arm", "exact", "per_seed", "device",
    "local_plane", "per_geom", "distance_ratio_plane_vs_exact",
    "cost_ratio_plane_vs_exact", "distance_ratio_pergeom_vs_exact",
    "cost_ratio_pergeom_vs_exact"}
ARM_KEYS = {"final_x", "realized_cost_mean", "min_rel_z", "success",
            "seed", "terrain_key", "relief"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This file's scripts, run once: (results, output directory)."""
    out = tmp_path_factory.mktemp("scripts_b")
    return run_scripts([
        ("ilqr", "ilqr_gait", ["--smoke", "--out", str(out / "ilqr")]),
        ("fidelity", "terrain_fidelity", ["--smoke", "--out",
                                          str(out / "fidelity.json")]),
        ("terrain_profile", "terrain_profile", ["--smoke", "--out",
                                                str(out / "profile")]),
        ("precision_audit", "precision_audit", [
            "--batch", "8", "--ticks", "2", "--out",
            str(out / "audit.json")]),
    ]), out


def test_ilqr_gait_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["ilqr"] == "ok", res["ilqr"]
    got = read(out / "ilqr" / "metrics.json")
    want = committed("ilqr_gait/metrics.json")
    has_jax_keys(got, want)
    for arm in ("trot", "landing"):
        assert set(got[arm]) == set(want[arm]), arm
    assert got["trot"]["cycles"] == 2
    assert set(got["landing"]["touchdown_s"]) == {"FR", "FL", "RR", "RL"}


def test_terrain_fidelity_script_writes_the_jax_keys(runs):
    res, out = runs
    assert res["fidelity"] == "ok", res["fidelity"]
    got = read(out / "fidelity.json")
    has_jax_keys(got, FIDELITY_KEYS - {"device"}, {"device", "seconds"})
    assert set(got["per_seed"]) == {"exact", "local_plane", "per_geom"}
    for recs in got["per_seed"].values():
        (rec,) = recs
        assert set(rec) == ARM_KEYS and rec["seed"] == 0
    assert got["ticks"] == 3 and got["plane_arm"] == "local_plane"


@pytest.mark.parametrize("name", ["terrain_profile", "precision_audit"])
def test_profile_scripts_write_the_jax_keys(runs, name):
    res, out = runs
    assert res[name] == "ok", res[name]
    if name == "terrain_profile":
        got = read(out / "profile" / "metrics.json")
    else:
        got = read(out / "audit.json")
        assert got["backend"] == "cpu" and got["batch"] == 8
        # on the CPU the two settings coincide
        assert got["substep_qvel_err_max_default"] \
            == got["substep_qvel_err_max_highest"]
    want = committed(f"{name}/metrics.json")
    has_jax_keys(got, want)
    if name == "terrain_profile":
        assert set(got["derived"]) == set(want["derived"])
        assert got["_provenance"]["device"] == "cpu"
