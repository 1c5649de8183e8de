"""Tests of the port that need a CUDA card: every substep kernel against its
plain PyTorch version on the card, at the shapes of the paths that launch
it (and, for the warp-design kernels, at the edges of their grid), and the
launch counter.  Where there is no card they skip (decided inside a
fixture, so that every worker collects the same tests).

This file imports neither JAX nor the JAX package, so that it runs on the
GPU machine, where the repository's conftest.py (which imports JAX) is left
out:  python -m pytest --noconftest -o addopts="" -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from opendog_tpu_torch.assets import load_go1, load_opendog
from opendog_tpu_torch.ops import cuda_step
from chip_smoke import random_batch, random_modes

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_rows(model, K, device):
    """chip_smoke.py's random states, (rows, K), on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in random_batch(model, K))


# the warp-design kernels: (robot, with_plane, with_payload)
WARP_KERNELS = {"flat": ("go1", False, False),         # K1
                "payload": ("go1", False, True),       # K2
                "plane": ("opendog", True, False),     # K3
                "pergeom": ("opendog", "per_geom", False)}  # K4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(WARP_KERNELS))
@pytest.mark.parametrize("K,dt,n", [
    (K, 0.01, n) for K in (1, 31, 256, 257) for n in (1, 2)
] + [(1, 0.002, 10)])
def test_kernel_matches_plain_on_card(cuda_device, K, dt, n, mode):
    """The warp-design kernels K1-K4 equal their plain version exactly
    (the same operations in the same order, built with -fmad=false): at
    one rollout, a partial warp group (K=31), the MPPI paths' K=256, a
    ragged last block (K=257) and the plant step.  K1 and K2 on random Go1
    states, payloads U(0, 3) kg; K3 and K4 on random OpenDOG states on the
    ground, with random planes per rollout or per geom and rollout."""
    robot, with_plane, with_payload = WARP_KERNELS[mode]
    if robot == "go1":
        m = load_go1("flat", device=cuda_device)
        qp, qv, ct = _random_rows(m, K, cuda_device)
    else:
        m = load_opendog("flat", device=cuda_device)
        qp, qv, ct = (torch.from_numpy(a).to(cuda_device)
                      for a in random_batch(m, K, on_ground=True))
    extra = {name: torch.from_numpy(a).to(cuda_device)
             for name, a in zip(("plane", "payload"),
                                random_modes(m, K, with_plane, with_payload))
             if a is not None}
    key = cuda_step.launch_key(K, n, with_plane, with_payload)
    before = cuda_step.LAUNCHES[key]
    kp, kv = cuda_step.build_cuda_substep(
        m, dt, n, device=cuda_device, with_plane=with_plane,
        with_payload=with_payload)(qp, qv, ct, **extra)
    pp, pv = cuda_step.build_plain_substep(m, dt, n, with_plane,
                                           with_payload)(qp, qv, ct, **extra)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES[key] == before + 1
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


@pytest.mark.gpu
def test_kernel_rejects_cpu_tensors(cuda_device):
    m = load_go1("flat", device=cuda_device)
    step = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device)
    qp, qv, ct = _random_rows(m, 4, "cpu")
    with pytest.raises(ValueError, match="is on"):
        step(qp, qv, ct)


@pytest.mark.gpu
@pytest.mark.parametrize("robot,K,dt,n,with_plane,with_payload", [
    ("go1", 256, 0.01, 2, False, True),            # K2: payload MPPI
    ("opendog", 256, 0.01, 2, True, False),        # K3: trunk-plane MPPI
    ("opendog", 256, 0.01, 2, "per_geom", False),  # K4: per-geom MPPI
    ("opendog", 1, 0.002, 10, "per_geom", False),  # K4: terrain plant
    ("opendog", 4096, 0.002, 10, True, True),      # K2 + K3: batch
    ("opendog", 256, 0.01, 2, "per_geom", True),   # K2 + K4: per-geom
])
def test_mode_kernel_matches_plain_on_card(cuda_device, robot, K, dt, n,
                                           with_plane, with_payload):
    """Each plane / payload instantiation against its plain version on
    random states on the ground, random planes and payloads: 1e-4 qpos,
    1e-3 qvel, as for the flat kernel."""
    m = (load_go1 if robot == "go1" else load_opendog)("flat",
                                                       device=cuda_device)
    qp, qv, ct = (torch.from_numpy(a).to(cuda_device)
                  for a in random_batch(m, K, on_ground=True))
    extra = {name: torch.from_numpy(a).to(cuda_device)
             for name, a in zip(("plane", "payload"),
                                random_modes(m, K, with_plane, with_payload))
             if a is not None}
    key = cuda_step.launch_key(K, n, with_plane, with_payload)
    before = cuda_step.LAUNCHES[key]
    kp, kv = cuda_step.build_cuda_substep(
        m, dt, n, device=cuda_device, with_plane=with_plane,
        with_payload=with_payload)(qp, qv, ct, **extra)
    pp, pv = cuda_step.build_plain_substep(m, dt, n, with_plane,
                                           with_payload)(qp, qv, ct, **extra)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES[key] == before + 1
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert (kp - pp).abs().max().item() <= 1e-4
    assert (kv - pv).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_payload_kernel_at_zero_is_the_flat_kernel(cuda_device):
    """A zero payload leaves the trunk's mass and com as they are, so the
    payload kernel's result is the flat kernel's, bit for bit."""
    m = load_go1("flat", device=cuda_device)
    qp, qv, ct = _random_rows(m, 256, cuda_device)
    flat = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device)
    loaded = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                          with_payload=True)
    a = flat(qp, qv, ct)
    b = loaded(qp, qv, ct, payload=torch.zeros(1, 256, device=cuda_device))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
