"""The check that decides ``correct`` catches the faults a cell can have.
Each test drives a whole run of the harness on the CPU at a small size
(K=8, H=2; the harness's look for a card skipped), with the program broken
underneath, and sees ``correct`` come out false; the same run unbroken
comes out true.  The faults: the plant returns its state unchanged; half
of the rollouts are left out, the update taken over the rest; the control
altered where the solver produces it; on four ranks, the exchange between
them left out."""
import time

import pytest

from benchmark.harness import cli, spec

SMALL = dict(num_samples=8, horizon=2, warmup_s=0, estimate_ticks=1, check_ticks=1)


def run(cell_name, seed=2 ** 31 + 7, **kw):
    cell = spec.Cell(cell_name)
    return cli.run_cell(cell, seed, 1.0, False, time.time(), device="cpu",
                        overrides=SMALL, **kw)


def plant_unchanged(monkeypatch):
    from opendog_tpu_torch.physics import State
    from opendog_tpu_torch.solvers import mpc

    def make(model, n, *a, **k):
        return lambda st, ctrl: State(qpos=st.qpos.clone(),
                                      qvel=st.qvel.clone(),
                                      time=st.time + n * model.timestep)

    monkeypatch.setattr(mpc, "_make_plant_step", make)


def half_the_rollouts(monkeypatch):
    from opendog_tpu_torch.ops import cuda_step
    call = cuda_step.CudaSubstep.__call__

    def halved(self, qpos, *a, **k):
        qp, qv = call(self, qpos, *a, **k)
        K = qp.shape[1]
        if K > 1:
            qp, qv = qp.clone(), qv.clone()
            qp[:, K // 2:] = float("nan")
            qv[:, K // 2:] = float("nan")
        return qp, qv

    monkeypatch.setattr(cuda_step.CudaSubstep, "__call__", halved)


def control_altered(monkeypatch):
    from opendog_tpu_torch.solvers import mppi
    make = mppi.make_solver

    def altered(*a, **k):
        solve = make(*a, **k)

        def solve2(*b, **kk):
            ctrl, state, stats = solve(*b, **kk)
            return ctrl + 1e-3, state, stats

        solve2.mesh = solve.mesh
        return solve2

    monkeypatch.setattr(mppi, "make_solver", altered)


@pytest.mark.parametrize("cell_name", ["go1_trot_k256",
                                       "opendog_terrain_exact"])
def test_an_unbroken_run_is_correct(cell_name):
    out = run(cell_name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell_name,fault", [
    ("go1_trot_k256", plant_unchanged),
    ("go1_trot_k256", half_the_rollouts),
    ("go1_trot_k256", control_altered),
    ("opendog_terrain_exact", plant_unchanged),
    ("opendog_terrain_exact", half_the_rollouts),
    ("opendog_terrain_exact", control_altered)])
def test_a_broken_run_is_not_correct(cell_name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell_name)
    assert not out["correct"], out["checks"]


def test_four_ranks_without_their_exchange_are_not_correct():
    good = run("go1_trot_k4096_x4")
    assert good["correct"], good["checks"]
    bad = run("go1_trot_k4096_x4",
              rank_module="benchmark.tests._rank_without_exchange")
    assert not bad["correct"], bad["checks"]
    assert bad["checks"]["rank_gap"]["value"] > 0


def test_a_window_that_misses_a_sampled_tick_is_not_correct(monkeypatch):
    """A window that ends before a tick drawn for judging leaves it
    unjudged, and the run is not correct."""
    from benchmark.harness import window
    monkeypatch.setattr(window, "sample_ticks",
                        lambda seed, n_est, count: [10 ** 9])
    out = run("go1_trot_k256")
    assert not out["correct"], out["checks"]
    assert out["checks"]["unjudged_ticks"]["value"] == 1
