"""Tests of the port that need a CUDA card: the substep kernel against its
plain PyTorch version on the card, at the main path's two shapes, and the
launch counter.  Where there is no card they skip (decided inside a
fixture, so that every worker collects the same tests).

This file imports neither JAX nor the JAX package, so that it runs on the
GPU machine, where the repository's conftest.py (which imports JAX) is left
out:  python -m pytest --noconftest -o addopts="" -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from opendog_tpu_torch.assets import load_go1
from opendog_tpu_torch.ops import cuda_step
from chip_smoke import random_batch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_rows(model, K, device):
    """chip_smoke.py's random Go1 states, (rows, K), on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in random_batch(model, K))


@pytest.mark.gpu
@pytest.mark.parametrize("K,dt,n", [(256, 0.01, 2), (1, 0.002, 10)])
def test_kernel_matches_plain_on_card(cuda_device, K, dt, n):
    """Max abs error 1e-4 qpos / 1e-3 qvel, the tolerance of chip_smoke.py
    (random states at dt = 0.01 are ill-conditioned: see ops/build.py)."""
    m = load_go1("flat", device=cuda_device)
    qp, qv, ct = _random_rows(m, K, cuda_device)
    key = cuda_step.launch_key(K, n)
    before = cuda_step.LAUNCHES[key]
    kp, kv = cuda_step.build_cuda_substep(m, dt, n, device=cuda_device)(
        qp, qv, ct)
    pp, pv = cuda_step.build_plain_substep(m, dt, n)(qp, qv, ct)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES[key] == before + 1
    assert torch.isfinite(kp).all() and torch.isfinite(kv).all()
    assert (kp - pp).abs().max().item() <= 1e-4
    assert (kv - pv).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_kernel_rejects_cpu_tensors(cuda_device):
    m = load_go1("flat", device=cuda_device)
    step = cuda_step.build_cuda_substep(m, 0.01, 2, device=cuda_device)
    qp, qv, ct = _random_rows(m, 4, "cpu")
    with pytest.raises(ValueError, match="is on"):
        step(qp, qv, ct)
