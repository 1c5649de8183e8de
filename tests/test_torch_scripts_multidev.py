"""The port's multi-device scripts (scripts/torch_multiprocess_scaling.py,
torch_scaling_bench.py, torch_comm_volume.py) run as a user runs them, at
``--device cpu`` (gloo ranks on the CPU) at 1 and 2 ranks and tiny depth:

* each record has the keys of the JAX script's record
  (runs/multiprocess_scaling/metrics.json, the JSON that
  scripts/scaling_bench.py prints on a virtual mesh, the three sections of
  SCALING.json with the measured ``collective_us`` and ``solve_ms`` in
  place of the modelled fields) plus ``device`` and ``seconds``, and
  finite results on the backend gloo;
* the collective counter (``parallel.collectives.TRAFFIC``) counts the same
  calls at 1 and 2 ranks, with the bytes that the collectives hand to
  ``dist.all_reduce``: n times the value for psum, pmin and all_gather (a
  slot buffer), the value itself for pmean; the counts follow from the
  programs' shapes, and at full width and one rank they are the counts
  that chip_smoke.py's [multidev] requires of the card;
* comm volume's 2-rank agreement checks pass.

The scripts run in one subprocess each, started together (each starts its
own ranks).
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADDED = {"device", "seconds"}

JOBS = {
    "multiprocess_scaling": ["--nprocs", "1", "2", "--ticks", "1",
                             "--samples", "8", "--horizon", "3"],
    "scaling_bench": ["--device-counts", "1", "2", "--steps", "2",
                      "--envs-per-device", "4"],
    "comm_volume_1": ["--ranks", "1", "--smoke", "--reps", "1"],
    "comm_volume_2": ["--ranks", "2", "--smoke", "--reps", "1"],
}
# Go1 (the MPPI and iLQR programs) and the PPO network (33 observations, 8
# actions, 64-64)
GO1_NX, GO1_NU, PPO_PARAMS = 37, 12, 13265


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Each job's record, the jobs started together."""
    tmp = tmp_path_factory.mktemp("multidev")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = {}
    for key, args in JOBS.items():
        name = key.rsplit("_", 1)[0] if key.startswith("comm") else key
        procs[key] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts",
                                          f"torch_{name}.py"),
             "--device", "cpu", *args, "--out", str(tmp / key)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for key, p in procs.items():
            log = p.communicate(timeout=240)[0]
            assert p.returncode == 0, f"{key}:\n{log[-4000:]}"
            with open(tmp / key / "metrics.json") as f:
                out[key] = json.load(f)
            out[key + "_log"] = log
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def committed(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


def test_multiprocess_scaling_record(records):
    got, want = records["multiprocess_scaling"], committed(
        "runs/multiprocess_scaling/metrics.json")
    assert set(want) | ADDED | {"backend", "host_cores"} <= set(got)
    assert set(want["provenance"]) <= set(got["provenance"])
    assert got["device"] == "cpu" and got["backend"] == "gloo"
    for key in ("mppi_weak_scaling", "env_rollout_weak_scaling"):
        entries = got[key]
        assert [e["nproc"] for e in entries] == [1, 2]
        for e in entries:
            assert set(want[key][0]) <= set(e), (key, e)
            assert e["finite"] and math.isfinite(e["weak_scaling_efficiency"])
            assert len(e["rank_affinity"]) == e["nproc"]
        assert entries[0]["weak_scaling_efficiency"] == 1.0
    assert [e["samples_per_solve"] for e in got["mppi_weak_scaling"]] == \
        [8, 16]
    assert [e["envs"] for e in got["env_rollout_weak_scaling"]] == \
        [128, 256]


def test_scaling_bench_record(records):
    got = records["scaling_bench"]
    # scripts/scaling_bench.py's JSON on a virtual mesh
    assert got["virtual_mesh"] is True
    for n in ("1", "2"):
        assert set(got[n]) == {"env_steps_per_sec", "sharding_path_ok"}
        assert got[n]["sharding_path_ok"] and got[n]["env_steps_per_sec"] > 0
    assert ADDED | {"backend", "meets_80pct_target", "finite"} <= set(got)
    assert got["backend"] == "gloo" and got["meets_80pct_target"] is None
    assert "devices=2:" in records["scaling_bench_log"]


def expected_counts(program, cfg, n):
    """The calls and bytes that one pass of ``program`` at ``n`` ranks hands
    to dist.all_reduce, from its shapes."""
    if program == "mppi":
        row = cfg["horizon"] * GO1_NU + 3   # the plan, denom, sums of costs
        return dict(psum=dict(calls=1, bytes=n * 4 * row),
                    pmin=dict(calls=1, bytes=n * 4))
    if program == "ilqr":
        block = 3 * GO1_NX ** 2 + 2 * GO1_NX   # one value-function block
        per_rank = -(-(cfg["horizon"] + 1) // n)
        passes = cfg["iterations"] + 1         # + the final gains
        return dict(all_gather=dict(
            calls=2 * passes,
            bytes=passes * n * 4 * block * (1 + per_rank)))
    samples = cfg["num_envs"] * cfg["n_steps"] // n
    minibatches = cfg["num_epochs"] * (
        samples // min(cfg["minibatch_size"] // n, samples))
    # the advantage and return moments (4 scalars), the metrics (7), one
    # gradient vector per minibatch
    return dict(pmean=dict(calls=5 + minibatches,
                           bytes=4 * (4 + 7 + minibatches * PPO_PARAMS)))


SECTIONS = dict(mppi="mppi_sample_sharded_k4096",
                ilqr="ilqr_horizon_sharded_h64",
                ppo="ppo_dp_gradient_allreduce")


@pytest.mark.parametrize("n", [1, 2])
def test_comm_volume_counts_and_record(records, n):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_comm_volume as cv
    got = records[f"comm_volume_{n}"]
    want = committed("SCALING.json")
    assert ADDED | {"backend", "agreement", "methodology"} <= set(got)
    assert got["backend"] == "gloo" and got["ok"]
    for program, section in SECTIONS.items():
        rec = got[section]
        modelled = {"modeled_collective_us", "measured_solve_ms_single_chip",
                    "measured_replan_ms_single_chip",
                    "projected_efficiency_8dev", "note", "sensitivity_note"}
        assert set(want[section]) - modelled <= set(rec), section
        unit = "chunk_ms" if program == "ppo" else "solve_ms"
        assert {"collective_us", unit, f"{unit}_one_rank",
                f"efficiency_{n}dev"} <= set(rec), section
        assert rec["ranks"] == n and rec["collective_us"] > 0
        assert rec[unit] > 0 and rec[f"efficiency_{n}dev"] > 0
        counts = expected_counts(program, cv.SMOKE[program], n)
        assert rec["by_collective"] == counts, section
        assert rec["collectives"] == sum(c["calls"] for c in counts.values())
        unit = "bytes_per_chunk" if program == "ppo" else "bytes_per_solve"
        assert rec[unit] == sum(c["bytes"] for c in counts.values())
    if n == 2:
        for program in SECTIONS:
            check = got["agreement"][program]["2"]
            assert check["ok"] and check["ranks_bit_equal"], check
    else:
        assert got["agreement"] == {}


def test_comm_volume_counts_at_full_width_are_the_smoke_runs():
    """The counts at the JAX shapes and one rank: what [multidev] holds the
    card's run to."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_comm_volume as cv
    full = dict(mppi=cv.MPPI, ilqr=cv.ILQR, ppo=cv.PPO)
    assert {SECTIONS[p]: expected_counts(p, cfg, 1)
            for p, cfg in full.items()} == chip_smoke.COMM_COUNTS_1


def test_program_sizes():
    """GO1_NX, GO1_NU and PPO_PARAMS are Go1's state and control widths and
    the 64-64 network's parameter count."""
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.rl.networks import MLPActorCritic
    m = load_go1("flat", device="cpu")
    assert (m.nq + m.nv, m.nu) == (GO1_NX, GO1_NU)
    net = MLPActorCritic(33, 8, hidden=(64, 64))
    assert sum(p.numel() for p in net.parameters()) == PPO_PARAMS
