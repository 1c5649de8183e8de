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


# the kernels, all on the warp design: (robot, with_plane, with_payload)
WARP_KERNELS = {"flat": ("go1", False, False),         # K1
                "payload": ("go1", False, True),       # K2
                "plane": ("opendog", True, False),     # K3
                "pergeom": ("opendog", "per_geom", False),  # K4
                "plane_payload": ("opendog", True, True),   # K2 + K3
                "pergeom_payload": ("opendog", "per_geom", True)}  # K2 + K4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(WARP_KERNELS))
@pytest.mark.parametrize("K,dt,n", [
    (K, 0.01, n) for K in (1, 31, 256, 257) for n in (1, 2)
] + [(1, 0.002, 10)])
def test_kernel_matches_plain_on_card(cuda_device, K, dt, n, mode):
    """The six kernels equal their plain version exactly (the same
    operations in the same order, built with -fmad=false): at one rollout,
    a partial warp group (K=31), the MPPI paths' K=256, a ragged last block
    (K=257) and the plant step.  K1 and K2 on random Go1 states, payloads
    U(0, 3) kg; K3, K4 and the plane modes with a payload on random OpenDOG
    states on the ground, with random planes per rollout or per geom and
    rollout (OpenDOG's plane + payload kernel is the small-class one)."""
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
    random states on the ground, random planes and payloads, at the shapes
    of its paths (the K=4096 batch and the per-geom payload rollout
    included): equal exactly, as every warp-design kernel is."""
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
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


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


@pytest.mark.gpu
@pytest.mark.parametrize("with_plane", [True, "per_geom"])
def test_plane_payload_kernel_at_zero_is_the_plane_kernel(cuda_device,
                                                          with_plane):
    """A zero payload leaves the trunk as it is, so the plane and per-geom
    kernels with a payload (the former on the small workspace class for
    OpenDOG) give the payload-free kernels' result bit for bit."""
    m = load_opendog("flat", device=cuda_device)
    qp, qv, ct = (torch.from_numpy(a).to(cuda_device)
                  for a in random_batch(m, 256, on_ground=True))
    plane = torch.from_numpy(random_modes(m, 256, with_plane)[0]).to(
        cuda_device)
    bare = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                        with_plane=with_plane)
    loaded = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device,
                                          with_plane=with_plane,
                                          with_payload=True)
    a = bare(qp, qv, ct, plane)
    b = loaded(qp, qv, ct, plane,
               payload=torch.zeros(1, 256, device=cuda_device))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_batch_kernel_size_classes_agree(cuda_device):
    """The plane + payload kernel in its two workspace size classes (the
    launcher picks the small one for OpenDOG's 24 spheres; a sphere count
    above SC_NG_SMALL picks the full one) on the batch's shape, K=4096 x 10
    substeps of 2 ms: bit for bit, each resident on an SM, the small one
    with less shared memory per rollout."""
    m = load_opendog("flat", device=cuda_device)
    K, n = 4096, 10
    arrays = (random_batch(m, K, on_ground=True)
              + random_modes(m, K, True, True))
    qp, qv, ct, plane, payload = (torch.from_numpy(a).to(cuda_device)
                                  for a in arrays)
    lib, _ = cuda_step.cuda_library()
    n_max = cuda_step.table_layout()[0]["SC_NG_MAX"]
    raw = bytearray(memoryview(cuda_step.substep_table(m, 0.002)).cast("B"))
    table = torch.frombuffer(raw, dtype=torch.uint8).to(cuda_device)
    outs = {}
    for ngeom in (m.ngeom, n_max):
        op, ov = torch.empty_like(qp), torch.empty_like(qv)
        rc = lib.substep_launch(
            table.data_ptr(), qp.data_ptr(), qv.data_ptr(), ct.data_ptr(),
            plane.data_ptr(), payload.data_ptr(), op.data_ptr(),
            ov.data_ptr(), K, n, 1, 1, ngeom,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        assert lib.substep_warp_occupancy(1, 1, ngeom) >= 1
        outs[ngeom] = (op, ov)
    torch.cuda.synchronize()
    small, full = outs[m.ngeom], outs[n_max]
    assert torch.isfinite(small[0]).all() and torch.isfinite(small[1]).all()
    assert torch.equal(small[0], full[0]) and torch.equal(small[1], full[1])
    per_rollout = {ngeom: lib.substep_warp_smem_bytes(1, 1, ngeom)
                   / lib.substep_warps_per_block(1, 1, ngeom)
                   for ngeom in (m.ngeom, n_max)}
    assert per_rollout[m.ngeom] < per_rollout[n_max]
