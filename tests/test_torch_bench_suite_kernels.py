"""scripts/torch_bench_suite.py's domain-randomised batch against the JAX
package: config 4's start and batched op-graph step against ``jax.vmap``
of ``dynamics.step`` (op by op), and the inputs of the fused configs 4b,
4c and 4d through the port's plain kernels against the JAX kernel's body
(``ops/scalar_core.build_substep``, what ``build_pallas_substep`` runs in
each lane), run eagerly: compiling the Pallas kernel for OpenDOG in
interpret mode takes ~94 s a mode on this CPU.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu import assets as jax_assets
from opendog_tpu.ops import scalar_core as jax_scalar_core
from opendog_tpu.physics import State as JaxState
from opendog_tpu.physics import dynamics as jax_dynamics
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu_torch import assets
from opendog_tpu_torch.ops import cuda_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's physics against JAX's, op by op, a few substeps from the
# keyframe (float32 sums in another order): max abs error
STEP_TOL = dict(qpos=1e-5, qvel=1e-4)
# the plain kernel against the JAX kernel body, one substep (other
# rounding order or library sin / cos), as tests/test_torch_substep.py
# holds it
KERNEL_TOL = dict(qpos=1e-5, qvel=1e-4)

_spec = importlib.util.spec_from_file_location(
    "torch_bench_suite", os.path.join(REPO, "scripts",
                                      "torch_bench_suite.py"))
suite = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(suite)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=0, atol=tol["qpos"])
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=0, atol=tol["qvel"])


def test_batch_start_and_step_match_jax_vmap():
    """Config 4 at B=4: the start from jax's PRNGKey(0) draw equals the JAX
    script's (``home`` plus 0.02 x the draw on all of qpos) bit for bit,
    and one 2-substep batched op-graph step matches ``jax.vmap`` of
    ``dynamics.step`` op by op."""
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    B = 4
    s = jax_make_state(jm, "home")
    qpos = jnp.tile(s.qpos[None], (B, 1))
    draws = jax.random.normal(jax.random.PRNGKey(0), qpos.shape)
    qpos = qpos + 0.02 * draws
    ctrls = jnp.tile(jnp.asarray(jm.key_ctrl[0])[None], (B, 1))
    qp, qv, ct = suite.batch_start(m, np.asarray(draws))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qpos))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(ctrls))
    assert not qv.any()
    want = jax.vmap(lambda a, c: jax_dynamics.step(jm, a, c, n_substeps=2)[0])(
        JaxState(qpos=qpos, qvel=jnp.zeros((B, jm.nv)), time=jnp.zeros(B)),
        ctrls)
    got = suite.batch_step(m, ct, 2)(qp, qv, torch.zeros(B))
    _close(got, (want.qpos, want.qvel), STEP_TOL)


@pytest.mark.parametrize("config", ["4b", "4c", "4d"])
def test_kernel_inputs_through_plain_match_jax_kernel_body(config):
    """Each fused config's inputs at B=8 (4b: config 4's start; 4c: it
    with ``domrand_modes`` of a fresh numpy seed 0; 4d: ``batch_inputs``)
    through the port's plain kernel, K1 for 4b and K2+K3 for 4c and 4d,
    one substep of 2 ms, against the JAX kernel body on the same arrays."""
    jm = jax_assets.load_opendog("flat")
    m = assets.load_opendog("flat", device="cpu")
    B = 8
    draws = np.random.default_rng(3).standard_normal((B, m.nq))
    start = tuple(cuda_step.rows_from_batch(x).numpy()
                  for x in suite.batch_start(m, draws))
    if config == "4b":
        arrays = start
    elif config == "4c":
        arrays = start + suite.domrand_modes(B, np.random.default_rng(0))
    else:
        arrays = suite.batch_inputs(m, B)
    modes = len(arrays) == 5
    step = cuda_step.build_cuda_substep(m, m.timestep, 1, device="cpu",
                                        with_plane=modes, with_payload=modes)
    got = step(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    sub = jax_scalar_core.build_substep(jm, jm.timestep, with_plane=modes,
                                        with_payload=modes)
    rows = [tuple(jnp.asarray(r) for r in a) for a in arrays[:3]]
    extra = ((tuple(jnp.asarray(r) for r in arrays[3]),
              jnp.asarray(arrays[4][0])) if modes else (None, None))
    with jax.disable_jit():
        qp, qv = sub(*rows, *extra)
    want = (np.stack([np.asarray(r) for r in qp]),
            np.stack([np.asarray(r) for r in qv]))
    _close([g.numpy() for g in got], want, KERNEL_TOL)
