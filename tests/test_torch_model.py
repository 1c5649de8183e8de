"""The port's model loaders against the JAX package's, field by field, plus
the carry-across ``model_from_arrays`` and the small physics helpers."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opendog_tpu import assets as jax_assets
from opendog_tpu.physics import dynamics as jax_dyn
from opendog_tpu.physics import make_state as jax_make_state
from opendog_tpu.physics import spatial as jax_spatial
from opendog_tpu_torch import assets, device
from opendog_tpu_torch.physics import dynamics, make_state, spatial
from opendog_tpu_torch.physics.model import (
    ARRAY_FIELDS, INT_ARRAY_FIELDS, OPTIONAL_ARRAY_FIELDS, STATIC_FIELDS,
    model_from_arrays)

torch.set_num_threads(1)

LOADERS = {
    "go1": (lambda: jax_assets.load_go1("flat"),
            lambda: assets.load_go1("flat", device="cpu")),
    "mini": (jax_assets.load_mini, lambda: assets.load_mini(device="cpu")),
    "opendog": (lambda: jax_assets.load_opendog("flat"),
                lambda: assets.load_opendog("flat", device="cpu")),
    "opendog_terrain": (lambda: jax_assets.load_opendog("terrain"),
                        lambda: assets.load_opendog("terrain", device="cpu")),
}


def _assert_same_model(ref, port):
    """Static fields equal; int arrays exact; float arrays to 1e-7."""
    for name in STATIC_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    for name in ARRAY_FIELDS + OPTIONAL_ARRAY_FIELDS:
        a, b = getattr(ref, name), getattr(port, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, name
        if name in INT_ARRAY_FIELDS:
            assert b.dtype == np.int32 and np.array_equal(a, b), name
        else:
            assert b.dtype == np.float32, name
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("robot", sorted(LOADERS))
def test_loader_matches_jax_loader(robot):
    ref_fn, port_fn = LOADERS[robot]
    port = port_fn()
    assert port.device == torch.device("cpu")
    _assert_same_model(ref_fn(), port)


@pytest.mark.parametrize("robot", sorted(LOADERS))
def test_model_from_arrays_round_trip(robot):
    """The JAX model's fields, as numpy arrays, rebuild the port's model."""
    ref_fn, port_fn = LOADERS[robot]
    ref = ref_fn()
    static = {name: getattr(ref, name) for name in STATIC_FIELDS}
    arrays = {name: (None if getattr(ref, name) is None
                     else np.asarray(getattr(ref, name)))
              for name in ARRAY_FIELDS + OPTIONAL_ARRAY_FIELDS}
    carried = model_from_arrays(static, arrays, "cpu")
    _assert_same_model(ref, carried)
    _assert_same_model(ref, port_fn())


def test_go1_main_path_dimensions():
    m = assets.load_go1("flat", device="cpu")
    assert (m.nq, m.nv, m.nu, m.nbody, m.ngeom) == (19, 18, 12, 13, 78)
    base, chains = dynamics._arrow_structure(m)
    assert chains.shape == (4, 3)


def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    """No quiet fallback: asking for (or defaulting to) CUDA without a
    card raises; the CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assets.load_go1("flat")
    assert device.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("robot", sorted(LOADERS))
def test_topology_helpers_match_jax(robot):
    ref_fn, port_fn = LOADERS[robot]
    ref, port = ref_fn(), port_fn()
    np.testing.assert_array_equal(dynamics._body_ancestor_matrix(port),
                                  jax_dyn._body_ancestor_matrix(ref))
    base_r, chains_r = jax_dyn._arrow_structure(ref)
    base_p, chains_p = dynamics._arrow_structure(port)
    np.testing.assert_array_equal(base_p, base_r)
    np.testing.assert_array_equal(chains_p, chains_r)


@pytest.mark.parametrize("robot", sorted(LOADERS))
def test_make_state_matches_jax(robot):
    ref_fn, port_fn = LOADERS[robot]
    ref, port = jax_make_state(ref_fn()), make_state(port_fn())
    np.testing.assert_array_equal(port.qpos.numpy(), np.asarray(ref.qpos))
    np.testing.assert_array_equal(port.qvel.numpy(), np.asarray(ref.qvel))
    assert port.time.shape == () and float(port.time) == 0.0


def test_orientation_helpers_match_jax():
    """quat_to_ypr / euler_from_quat on random unit quaternions, to 1e-6
    (float32 atan2 / asin of the two libraries)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ref = jax_spatial.quat_to_ypr(jnp.asarray(q))
    port = spatial.quat_to_ypr(torch.from_numpy(q))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-6)
    ref = jax_spatial.euler_from_quat(jnp.asarray(q))
    port = spatial.euler_from_quat(torch.from_numpy(q))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-6)
