"""Card tests of the port's CUDA ICP-moments kernel against its plain
PyTorch version. Marked `gpu`: they skip where torch.cuda.is_available() is
False. This file imports neither jax nor the JAX package, so on a machine
with a card and no jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from icp4dradar_tpu_torch.geom import se3_exp
from icp4dradar_tpu_torch.ops import icp_fused
from icp4dradar_tpu_torch.ops.icp_fused import (
    icp_iteration_moments,
    icp_iteration_moments_plain,
)

pytestmark = pytest.mark.gpu

# Same selections and products on both sides; only the order of the
# f32/f64 sums differs (per-block double partials vs one double sum).
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, B, N, M, device):
    xi = rng.normal(0.0, [1.0, 1.0, 0.2, 0.02, 0.02, 0.1], (B, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).contiguous()
    src = torch.from_numpy(rng.normal(0, 15, (B, N, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(0, 15, (B, M, 3)).astype(np.float32))
    sm = torch.from_numpy((rng.uniform(size=(B, N)) > 0.2).astype(np.float32))
    tm = torch.from_numpy((rng.uniform(size=(B, M)) > 0.3).astype(np.float32))
    return [x.to(device) for x in (T, src, sm, tgt, tm)]


@pytest.mark.parametrize("B,N,M", [(1, 1, 1), (3, 257, 1025), (5, 700, 2048)])
def test_kernel_matches_plain(cuda, B, N, M):
    args = _case(np.random.default_rng(N + M), B, N, M, cuda)
    before = icp_fused.ICP_MOMENTS_LAUNCHES
    k = icp_iteration_moments(*args)
    torch.cuda.synchronize()
    assert icp_fused.ICP_MOMENTS_LAUNCHES == before + 1
    p = icp_iteration_moments_plain(*args)
    torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)


def test_fully_masked_pairs(cuda):
    T, src, sm, tgt, tm = _case(np.random.default_rng(1), 3, 300, 400, cuda)
    tm[1] = 0.0
    sm[2] = 0.0
    k = icp_iteration_moments(T, src, sm, tgt, tm)
    p = icp_iteration_moments_plain(T, src, sm, tgt, tm)
    torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)
    assert k[1, 0].item() == 0.0 and k[2].abs().max().item() == 0.0


def test_exact_ties_average(cuda):
    tgt = torch.tensor([[1.0, 2.0, 0.0], [1.0, -2.0, 0.0], [50.0, 50.0, 50.0]],
                       device=cuda)
    m = icp_iteration_moments(torch.eye(4, device=cuda),
                              torch.zeros((1, 3), device=cuda),
                              torch.ones(1, device=cuda), tgt,
                              torch.ones(3, device=cuda))
    assert m.shape == (19,)
    torch.testing.assert_close(m[4:7], torch.tensor([1.0, 0.0, 0.0], device=cuda))
    assert m[16].item() == 5.0


def test_rejects_what_the_kernel_does_not_take(cuda):
    T, src, sm, tgt, tm = _case(np.random.default_rng(2), 2, 64, 64, cuda)
    with pytest.raises(ValueError):
        icp_iteration_moments(T, src.double(), sm, tgt, tm)
    with pytest.raises(ValueError):
        icp_iteration_moments(T, src.transpose(0, 1).contiguous().transpose(0, 1),
                              sm, tgt, tm)
    with pytest.raises(ValueError):
        icp_iteration_moments(T, src, sm.cpu(), tgt, tm)
