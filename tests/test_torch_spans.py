"""The port's own spans (``utils/profiling.py``: ``span``, ``SPANS``,
``set_spans``) on the CPU: the store's round trip (nesting, the ring's
bound, the flag), the stage spans of an eager ``make_mpc`` tick in order
(with lag compensation too, and on a two-rank gloo mesh with the
all-reduces inside the update), and a tick's outputs bit for bit the same
with the spans on and off.  The card's side (spans inside a replayed graph,
the counters, the profiler's clock) is in ``test_torch_gpu.py``."""
import pytest
import torch

from opendog_tpu_torch.assets import load_go1
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
from opendog_tpu_torch.utils import profiling
from test_torch_parallel_mesh import run_ranks, same_on_every_rank

torch.set_num_threads(1)

STAGES = ("mppi.sample", "mppi.rollout", "mppi.update", "mpc.plant")
CFG = dict(horizon=2, num_samples=8, n_substeps=1, rollout_dt=0.01,
           noise_sigma=0.12)


@pytest.fixture
def spans():
    """The process's store, empty, with the spans on; restored after."""
    was = profiling.set_spans(True)
    profiling.SPANS.clear()
    yield profiling.SPANS
    profiling.SPANS.clear()
    profiling.set_spans(was)


def _go1_mpc(**kw):
    m = load_go1("flat", device="cpu")
    cost = costs.trot_cost(m, costs.TrotCostParams(), m.key_qpos[0, 7:])
    cfg = MPPIConfig(**CFG)
    init, tick, run = make_mpc(m, cost, cfg, plant_substeps=2, device="cpu",
                               **kw)
    normals = torch.randn((3, cfg.num_samples, cfg.horizon, m.nu),
                          generator=torch.Generator().manual_seed(4))
    return m, init(None, make_state(m, "home")), tick, run, normals


def _in_order(spans, names):
    """Every host record of ``names``, ordered by start: [(name, start,
    end)]."""
    rows = [(n, s, e) for n in names for s, e in spans.host(n)]
    return sorted(rows, key=lambda r: r[1])


def test_span_store_round_trip(spans, monkeypatch):
    """A span records (start, end) on the profiler's clock; a nested span
    lies inside its parent; a name keeps its newest SPAN_RING records,
    oldest first; with the spans off nothing is recorded; a
    ``record_function`` range is opened only while a profiler runs, and
    then shows in its trace under the span's name, around the span's own
    record (the same clock)."""
    before = torch.profiler.record_function
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or before(name))
    with profiling.span("outer"):
        with profiling.span("inner"):
            torch.ones(4).sum()
        with profiling.span("inner"):
            pass
    (o_start, o_end), = spans.host("outer")
    inner = spans.host("inner")
    assert len(inner) == 2 and inner[0][1] <= inner[1][0]
    assert all(o_start <= s <= e <= o_end for s, e in inner)
    assert spans.device("inner") == [] and spans.host("other") == []
    assert opened == []

    n = profiling.SPAN_RING + 10
    for _ in range(n):
        with profiling.span("many"):
            pass
    rows = spans.host("many")
    assert len(rows) == profiling.SPAN_RING
    assert all(a[0] <= b[0] for a, b in zip(rows, rows[1:]))
    for i in range(5):
        spans.add_device("dev", i, float(i))
    assert spans.device("dev") == [(i, float(i)) for i in range(5)]

    assert profiling.set_spans(False) is True
    with profiling.span("off"):
        pass
    assert spans.host("off") == [] and not profiling.spans_on()
    profiling.set_spans(True)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("traced"):
                torch.ones(4).sum()
    assert opened == ["traced"] * 3
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "traced"]
    assert len(ranges) == 3
    for (s, e), ev in zip(spans.host("traced"), ranges):
        assert ev.start_ns() <= s <= e <= ev.end_ns()


def test_eager_tick_records_the_stage_spans_in_order(spans):
    """An eager make_mpc tick opens mppi.sample, mppi.rollout, mppi.update
    and mpc.plant once each, one after the other; with lag compensation
    the same (the roll-forward opens no span), and the compensated solve of
    bridge mode opens the solver's three."""
    _, carry, tick, _, normals = _go1_mpc()
    for n in normals[:2]:
        carry, _ = tick(carry, n)
    rows = _in_order(spans, STAGES)
    assert [r[0] for r in rows] == list(STAGES) * 2
    assert all(a[2] <= b[1] for a, b in zip(rows, rows[1:]))

    spans.clear()
    _, carry, tick, _, normals = _go1_mpc(ctrl_lag=2, lag_compensation=True)
    tick(carry, normals[0])
    assert [r[0] for r in _in_order(spans, STAGES)] == list(STAGES)

    spans.clear()
    from opendog_tpu_torch.solvers import RealtimeController
    m = load_go1("flat", device="cpu")
    cost = costs.trot_cost(m, costs.TrotCostParams(), m.key_qpos[0, 7:])
    rtc = RealtimeController(m, cost, MPPIConfig(**CFG), lag=1,
                             compensate=True, device="cpu")
    home = make_state(m, "home")
    rtc.bridge_tick(home.qpos.numpy(), home.qvel.numpy(), 0.0,
                    normals=normals[0])
    assert [r[0] for r in _in_order(spans, STAGES)] == [
        "mppi.sample", "mppi.rollout", "mppi.update"]


def test_spans_change_no_bits(spans):
    """Three ticks with the spans on and off: the same bits out."""
    outs = {}
    for on in (True, False):
        profiling.set_spans(on)
        _, carry, _, run, normals = _go1_mpc()
        carry, traj = run(carry, len(normals), normals=normals)
        outs[on] = dict(traj, nominal=carry.solver.nominal)
    assert outs[True].keys() == outs[False].keys()
    for k, v in outs[True].items():
        assert torch.equal(v, outs[False][k]), k


RANK_BODY = """
from opendog_tpu_torch.assets import load_opendog
from opendog_tpu_torch.parallel import collectives, sample_mesh
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
from opendog_tpu_torch.utils import profiling

mesh = sample_mesh(device="cpu")
m = load_opendog("flat", device="cpu")
cost = costs.standing_cost(m, 0.0694, m.key_qpos[0, 7:])
cfg = MPPIConfig(horizon=2, num_samples=8, n_substeps=1, rollout_dt=0.01,
                 noise_sigma=0.05)
init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=2, device="cpu",
                         mesh=mesh)
carry = init(None, make_state(m, "home"))
normals = torch.randn((2, 8, 2, m.nu),
                      generator=torch.Generator().manual_seed(1))
profiling.SPANS.clear()
collectives.TRAFFIC.clear()
for n in normals:
    carry, out = tick(carry, n)
names = ("mppi.sample", "mppi.rollout", "mppi.update", "mpc.plant",
         "collectives.all_reduce")
rows = sorted((s, e, names.index(k)) for k in names
              for s, e in profiling.SPANS.host(k))
save(dict(spans=torch.tensor(rows, dtype=torch.int64),
          calls=torch.tensor(sum(collectives.TRAFFIC.values())),
          ctrl=out["ctrl"]))
"""


def test_all_reduce_spans_nest_in_the_update_on_two_gloo_ranks(tmp_path):
    """Two eager sharded ticks on two gloo ranks: on each rank the
    update's pmin and psum each open collectives.all_reduce inside
    mppi.update, and the stages run in order."""
    results = run_ranks(tmp_path, RANK_BODY, 2)
    same_on_every_rank(results, "ctrl")
    for res in results:
        rows = res["spans"].tolist()
        assert int(res["calls"]) == 4
        order = [k for _, _, k in rows]
        # sample, rollout, update (all_reduce, all_reduce), plant; twice
        assert order == [0, 1, 2, 4, 4, 3] * 2, order
        for i, (s, e, k) in enumerate(rows):
            if k == 4:
                us, ue, _ = next(r for r in reversed(rows[:i]) if r[2] == 2)
                assert us <= s <= e <= ue
