"""The per-geom terrain MPC tick of the port on the CPU (``make_mpc`` with
``plane_mode="per_geom"`` and ``terrain_plant="kernel"``: K4 in the
rollouts and in the plant): the rollouts' plane build opens the
``mppi.planes`` span inside ``mppi.rollout``; every rollout lane contacts
the planes of the solve-from state (``dynamics.geom_local_planes``); the
plant's planes are rebuilt from the plant state every tick.  The substep
calls are watched through ``CudaSubstep.__call__`` (the plain version on
the CPU)."""
import pytest
import torch

from opendog_tpu_torch.assets import load_opendog
from opendog_tpu_torch.ops import cuda_step
from opendog_tpu_torch.physics import dynamics, make_state, terrain
from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
from opendog_tpu_torch.utils import profiling

torch.set_num_threads(1)

K, H, TICKS = 8, 2, 2


@pytest.fixture
def spans():
    """The process's store, empty, with the spans on; restored after."""
    was = profiling.set_spans(True)
    profiling.SPANS.clear()
    yield profiling.SPANS
    profiling.SPANS.clear()
    profiling.set_spans(was)


@pytest.fixture
def calls(monkeypatch):
    """Every substep call as (K, the plane rows passed, a copy of qpos)."""
    seen = []
    call = cuda_step.CudaSubstep.__call__

    def watched(self, qpos, qvel, ctrl, plane=None, payload=None):
        seen.append((qpos.shape[1], None if plane is None else plane.clone(),
                     qpos.clone()))
        return call(self, qpos, qvel, ctrl, plane, payload)

    monkeypatch.setattr(cuda_step.CudaSubstep, "__call__", watched)
    return seen


def _pergeom_ticks(n):
    """``n`` per-geom ticks of OpenDOG standing on a rough terrain from the
    lifted home keyframe: (model, terrain, the plant states the ticks
    started from)."""
    m = load_opendog("terrain", device="cpu")
    terr = terrain.generate_terrain(m, torch.Generator().manual_seed(0))
    h0 = float(dynamics._terrain_height_normal(m, terr,
                                               torch.zeros(1, 2))[0])
    cost = costs.standing_cost(m, 0.0694 + h0, m.key_qpos[0, 7:])
    cfg = MPPIConfig(horizon=H, num_samples=K, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.08)
    init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=10, device="cpu",
                             terrain=terr, terrain_plant="kernel",
                             plane_mode="per_geom")
    st = make_state(m, "home")
    st.qpos[2] += h0
    carry = init(None, st)
    normals = torch.randn((n, K, H, m.nu),
                          generator=torch.Generator().manual_seed(3))
    starts = []
    for z in normals:
        starts.append(carry.plant.qpos.clone())
        carry, _ = tick(carry, z)
    return m, terr, starts


def test_the_plane_build_opens_its_span_inside_the_rollouts(spans):
    _pergeom_ticks(1)
    (p_start, p_end), = spans.host("mppi.planes")
    (r_start, r_end), = spans.host("mppi.rollout")
    assert r_start <= p_start <= p_end <= r_end


def test_every_rollout_lane_contacts_the_planes_of_the_start_state(calls):
    m, terr, starts = _pergeom_ticks(TICKS)
    rollouts = [c for c in calls if c[0] == K]
    assert len(rollouts) == TICKS * H
    for t, q in enumerate(starts):
        want = dynamics.geom_local_planes(m, terr, q[None]).reshape(-1)
        assert want.shape == (4 * m.ngeom,)
        for _, plane, _ in rollouts[t * H:(t + 1) * H]:
            assert plane.shape == (4 * m.ngeom, K)
            assert torch.equal(plane, want[:, None].expand(-1, K))


def test_the_plant_rebuilds_its_planes_from_the_plant_state(calls):
    m, terr, starts = _pergeom_ticks(TICKS)
    plants = [c for c in calls if c[0] == 1]
    assert len(plants) == TICKS
    for (_, plane, qpos), q in zip(plants, starts):
        assert torch.equal(qpos[:, 0], q)
        want = dynamics.geom_local_planes(m, terr, q).reshape(-1, 1)
        assert torch.equal(plane, want)
    # the plant moved between the ticks, and its planes with it
    assert not torch.equal(starts[0], starts[1])
    assert not torch.equal(plants[0][1], plants[1][1])
