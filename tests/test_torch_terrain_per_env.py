"""One terrain per env: the batched terrain generation (draws with a
leading env axis) equals the generation of each env's terrain alone, bit
for bit, and the heightfield lookup on a (B, nrow, ncol) terrain equals a
loop of single-terrain lookups, bit for bit; a whole op-graph step on it
(the terrain walk env's contact) equals single steps to 1e-6 qpos and
1e-5 qvel (batched and unbatched products take other BLAS paths,
tests/test_torch_dynamics_step.py).  The single-terrain path is the one
tests/test_torch_terrain*.py and test_torch_exact_plant.py hold to the
JAX package."""
import numpy as np
import torch

from opendog_tpu_torch import assets
from opendog_tpu_torch.physics import State, Terrain, dynamics, terrain

torch.set_num_threads(1)

B = 3


def _terrains():
    m = assets.load_opendog("terrain", device="cpu")
    draws = terrain.draw_terrain(m, torch.Generator().manual_seed(2),
                                 batch_shape=(B,))
    batched = terrain.generate_terrain(m, draws=draws)
    single = [terrain.generate_terrain(m, draws=type(draws)(
        *(f[b] for f in draws))) for b in range(B)]
    return m, batched, single


def test_batched_generation_equals_one_at_a_time():
    m, batched, single = _terrains()
    assert batched.height.shape == (B, m.hfield_nrow, m.hfield_ncol)
    for b in range(B):
        assert torch.equal(batched.height[b], single[b].height), b
    stds = [float(t.height.std()) for t in single]
    assert len(set(stds)) > 1  # distinct terrains


def test_per_env_lookup_equals_single_lookups():
    m, batched, single = _terrains()
    xy = torch.from_numpy(np.random.default_rng(0).uniform(
        -3.0, 3.0, (B, 24, 2)).astype(np.float32))
    h, n = dynamics._terrain_height_normal(m, batched, xy)
    for b in range(B):
        hb, nb = dynamics._terrain_height_normal(m, single[b], xy[b])
        assert torch.equal(h[b], hb) and torch.equal(n[b], nb), b


def test_per_env_step_equals_single_steps():
    m, batched, single = _terrains()
    rng = np.random.default_rng(1)
    home = m.key_qpos[0].numpy()
    qpos = np.tile(home, (B, 1))
    qpos[:, :2] += rng.uniform(-0.5, 0.5, (B, 2))
    for b in range(B):
        h, _ = dynamics._terrain_height_normal(
            m, single[b], torch.from_numpy(qpos[b:b + 1, :2]))
        qpos[b, 2] += float(h[0]) - 0.14
    qpos = torch.from_numpy(qpos.astype(np.float32))
    qvel = torch.from_numpy(rng.normal(0, 0.1, (B, m.nv)).astype(np.float32))
    ctrl = m.key_ctrl[0].expand(B, m.nu)
    st, info = dynamics.step(m, State(qpos, qvel, torch.zeros(B)), ctrl,
                             batched, n_substeps=2)
    assert bool(info.contact.in_contact.any())
    for b in range(B):
        sb, _ = dynamics.step(m, State(qpos[b:b + 1], qvel[b:b + 1],
                                       torch.zeros(1)), ctrl[b:b + 1],
                              Terrain(height=single[b].height), n_substeps=2)
        torch.testing.assert_close(st.qpos[b:b + 1], sb.qpos, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(st.qvel[b:b + 1], sb.qvel, rtol=0,
                                   atol=1e-5)
