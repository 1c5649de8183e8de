"""The horizon-sharded Riccati sweep at 2 and 4 gloo ranks on the CPU
(``ilqr.sharded_suffix_scan``, ``associative_lqr_gains(..., mesh=)``),
against the JAX package's on 8 virtual devices and the port's one-process
scan, on the JAX tests' random inputs:

* the blocked suffix scan of random value-function blocks, L=16 (divides
  every mesh) and L=13 (identity padding), nx=5
  (tests/test_sharded_solvers.py:130-143): 2e-4;
* the gains of a random LQR problem, H=24, nx=6, nu=3 (:145-165): 1e-4.

Every rank returns the same bits, and a mesh of one rank returns the
unsharded scan and gains bit for bit.
"""
import numpy as np
import pytest
import torch
import jax
from jax.sharding import Mesh as JaxMesh

from opendog_tpu.solvers import ilqr as jax_ilqr
from opendog_tpu_torch.parallel import make_mesh
from opendog_tpu_torch.solvers import ilqr
from test_ilqr import _random_lqr
from test_sharded_solvers import _random_vf_elems
from test_torch_parallel_mesh import run_ranks, same_on_every_rank

torch.set_num_threads(1)

LENGTHS = (16, 13)
REG = 1e-9

RANK_BODY = """
from opendog_tpu_torch.parallel import make_mesh
from opendog_tpu_torch.solvers import ilqr
mesh = make_mesh(axis="sp", device="cpu")
inp = load_inputs()
out = {f"scan{L}": dict(enumerate(ilqr.sharded_suffix_scan(e, mesh)))
       for L, e in inp["elems"].items()}
out["gains"] = dict(enumerate(ilqr.associative_lqr_gains(
    *inp["lqr"], inp["reg"], mesh=mesh)))
save(out)
"""


def _t(tree):
    return tuple(torch.from_numpy(np.array(x)) for x in tree)


@pytest.fixture(scope="module")
def refs(devices8):
    """The inputs, the JAX sharded results (8 devices) and the port's
    one-process ones."""
    mesh = JaxMesh(np.array(jax.devices()[:8]), axis_names=("sp",))
    elems = {L: _random_vf_elems(jax.random.PRNGKey(L), L, 5)
             for L in LENGTHS}
    lqr = _random_lqr(jax.random.PRNGKey(3), H=24, nx=6, nu=3)
    want = {f"scan{L}": jax.jit(
        lambda e: jax_ilqr.sharded_suffix_scan(e, mesh, "sp"))(e)
        for L, e in elems.items()}
    want["gains"] = jax.jit(lambda *a: jax_ilqr.associative_lqr_gains(
        *a, REG, mesh=mesh, horizon_axis="sp"))(*lqr)
    inp = dict(elems={L: _t(e) for L, e in elems.items()}, lqr=_t(lqr),
               reg=REG)
    one = {f"scan{L}": ilqr._suffix_scan(e) for L, e in inp["elems"].items()}
    one["gains"] = ilqr.associative_lqr_gains(*inp["lqr"], REG)
    return inp, want, one


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, refs, tmp_path_factory):
    n = request.param
    results = run_ranks(tmp_path_factory.mktemp(f"ilqr{n}"), RANK_BODY, n,
                        inputs=refs[0])
    return n, {k: same_on_every_rank(results, k) for k in results[0]}


@pytest.mark.parametrize("L", LENGTHS)
def test_sharded_suffix_scan_matches_jax_and_one_process(refs, ranks, L):
    _, want, one = refs
    n, got = ranks
    for i, (w, o) in enumerate(zip(want[f"scan{L}"], one[f"scan{L}"])):
        g = got[f"scan{L}"][i].numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=f"L={L} n={n} block {i} vs JAX")
        np.testing.assert_allclose(g, o.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=f"L={L} n={n} block {i}")


def test_sharded_gains_match_jax_and_one_process(refs, ranks):
    _, want, one = refs
    n, got = ranks
    for i, name in enumerate(("k", "K", "dV")):
        g = got["gains"][i].numpy()
        np.testing.assert_allclose(g, np.asarray(want["gains"][i]),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} n={n} vs JAX")
        np.testing.assert_allclose(g, one["gains"][i].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{name} n={n}")


def test_one_rank_mesh_is_the_unsharded_sweep_bit_for_bit(refs):
    """A mesh of one rank: the unsharded scan and gains, bit for bit."""
    inp, _, one = refs
    mesh = make_mesh(axis="sp", device="cpu")
    for L, e in inp["elems"].items():
        for a, b in zip(ilqr.sharded_suffix_scan(e, mesh), one[f"scan{L}"]):
            assert torch.equal(a, b), L
    for a, b in zip(ilqr.associative_lqr_gains(*inp["lqr"], REG, mesh=mesh),
                    one["gains"]):
        assert torch.equal(a, b)
