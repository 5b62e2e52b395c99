"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The kernels are CUDA C++ for sm_90a and have no CPU mode, so every
test here is marked ``gpu`` and skips without a card (their plain
versions are held to the JAX package on the CPU in
tests/test_torch_flash_attention.py).  This file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

Tolerance: atol 1e-5 in float32 — kernel and plain version sum in
different orders."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a "
                    "and has no CPU mode (its plain version is held to the JAX "
                    "package in tests/test_torch_flash_attention.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s_q,s_kv,d", [(1, 1, 64), (1, 300, 64),
                                        (5, 129, 32), (3, 1000, 128),
                                        (1, 77, 80)])
def test_cuda_kernel_matches_plain_version(cuda, s_q, s_kv, d):
    rng = np.random.RandomState(s_kv)
    b, h = 3, 4
    q = torch.from_numpy(rng.randn(b * h, s_q, d).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.randn(b * h, s_kv, d).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.randn(b * h, s_kv, d).astype(np.float32)).to(cuda)
    lengths = torch.tensor([s_kv, 0, max(1, s_kv // 3)], dtype=torch.int32,
                           device=cuda)
    before = fa.launches
    out, lse = fa.flash_fwd(q, k, v, lengths, h, d ** -0.5)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, lengths, h, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert float((out - ref).abs().max()) <= ATOL
    assert torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5)
    assert float(out.view(b, h, s_q, d)[1].abs().max()) == 0.0
