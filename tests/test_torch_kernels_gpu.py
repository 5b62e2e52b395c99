"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The kernels are CUDA C++ for sm_90a and have no CPU mode, so every
test here is marked ``gpu`` and skips without a card (their plain
versions are held to the JAX package on the CPU in
tests/test_torch_flash_attention.py).  This file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

Tolerance: atol 1e-5 in float32 — kernel and plain version sum in
different orders.  The embedding-cache kernels: the slab row gather is a
copy and must match exactly; the segment-sum must match its plain version
(``index_add_``, atomics on the card) within rtol 2e-5 / atol 1e-6 and the
host cache's ``_segment_sum`` exactly."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu_torch.ops.kernels import emb_cache as emb  # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from hetu_tpu_torch.ops.kernels import segment_sum as seg  # noqa: E402
from hetu_tpu_torch.ps.dist_store import _segment_sum  # noqa: E402

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


def _train_inputs(cuda, s, d, masked, seed):
    """BH = 2 x 3 rows of (s, d) float32 with, when ``masked``, a ragged
    key mask whose second batch row masks every key."""
    rng = np.random.RandomState(seed)
    b, h = 2, 3

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)

    q, k, v, do = t(b * h, s, d), t(b * h, s, d), t(b * h, s, d), \
        t(b * h, s, d)
    km = None
    if masked:
        m = (rng.rand(b, s) < 0.7).astype(np.int32)
        m[0, 0] = 1
        m[1] = 0
        km = torch.from_numpy(m).to(cuda)
    return q, k, v, do, km


TRAIN_CASES = [(s, d, masked) for d in (32, 64, 128) for s in (1, 77, 512)
               for masked in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,masked", TRAIN_CASES)
def test_forward_kernel_matches_plain_version(cuda, s, d, masked):
    q, k, v, _, km = _train_inputs(cuda, s, d, masked, seed=s + d)
    before = fa.fwd_launches
    out, lse = fa.flash_fwd_masked(q, k, v, km, d ** -0.5)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, 3, d ** -0.5,
                                      key_mask=km)
    torch.cuda.synchronize()
    assert fa.fwd_launches == before + 1
    assert float((out - ref).abs().max()) <= ATOL
    assert float((lse - lse_ref).abs().max()) <= ATOL
    if masked:
        assert float(out[3:].abs().max()) == 0.0     # no valid key: zero


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,masked", TRAIN_CASES)
def test_backward_kernels_match_plain_version(cuda, s, d, masked):
    """dQ / dK / dV within allclose(rtol=1e-4, atol=1e-5) of the plain
    formulas; masked keys and rows with no valid key get exact zeros, and
    the result is the same from run to run (no atomics)."""
    q, k, v, do, km = _train_inputs(cuda, s, d, masked, seed=7 * s + d)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, None, 3, scale, key_mask=km)
    delta = (do * out).sum(-1)
    before = (fa.dq_launches, fa.dkv_launches)
    dq = fa.flash_bwd_dq(q, k, v, km, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q, k, v, km, out, lse, do,
                                                scale)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
            float((got - want).abs().max())
    if masked:
        assert float(dq[3:].abs().max()) == 0.0
        dead = (km == 0).repeat_interleave(3, dim=0)
        assert float(dk[dead].abs().max()) == 0.0
        assert float(dv[dead].abs().max()) == 0.0
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.gpu
def test_autograd_function_launches_all_three_kernels(cuda):
    q, k, v, do, km = _train_inputs(cuda, 77, 64, True, seed=3)
    q4, k4, v4 = (t.view(2, 3, 77, 64).requires_grad_(True)
                  for t in (q, k, v))
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(q4, k4, v4, key_mask=km)
    grads = torch.autograd.grad(out, (q4, k4, v4), do.view(2, 3, 77, 64))
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
@pytest.mark.parametrize("n,w,rows", [(53248, 16, 63249), (1000, 13, 77),
                                      (255, 128, 300), (1, 4, 1), (0, 16, 8)])
def test_gather_kernel_matches_plain_version(cuda, n, w, rows):
    rng = np.random.RandomState(n + w)
    slab = torch.from_numpy(rng.randn(rows, w).astype(np.float32)).to(cuda)
    slots = torch.from_numpy(rng.randint(0, rows, n).astype(np.int32)).to(cuda)
    before = emb.launches
    out = emb.gather_rows(slab, slots)
    ref = emb.gather_rows_plain(slab, slots)
    torch.cuda.synchronize()
    assert emb.launches == before + (1 if n else 0)
    assert out.shape == (n, w) and torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("n,w,kind", [(53248, 16, "zipf"), (1000, 13, "zipf"),
                                      (257, 128, "distinct"), (300, 16, "one"),
                                      (1, 16, "one")])
def test_segment_sum_kernel_matches_plain_and_host(cuda, n, w, kind):
    rng = np.random.RandomState(n + w)
    if kind == "zipf":
        p = 1.0 / np.arange(1, 4001) ** 1.1
        ids = rng.choice(4000, n, p=p / p.sum())
    else:
        ids = rng.permutation(10 * n)[:n] if kind == "distinct" \
            else np.zeros(n, np.int64)
    uk, inv, cnt = np.unique(ids, return_inverse=True, return_counts=True)
    ii = torch.from_numpy(inv.astype(np.int32)).to(cuda)
    order = torch.sort(ii, stable=True)
    # rows at the scale of a CTR step's embedding gradients (1e-4), where
    # the tolerance against the atomics of index_add_ holds; at unit scale
    # a run of thousands of rows cancels and only the exact host check
    # applies
    for scale in (1e-4, 1.0):
        g = (rng.randn(n, w) * scale).astype(np.float32)
        gg = torch.from_numpy(g).to(cuda)
        before = seg.launches
        out = emb.scatter_add_grads(gg, ii)
        ref = seg.sorted_segment_sum_plain(gg.index_select(0, order.indices),
                                           order.values, n)
        torch.cuda.synchronize()
        assert seg.launches == before + 1
        if scale < 1:
            assert torch.allclose(out, ref, rtol=2e-5, atol=1e-6), \
                float((out - ref).abs().max())
        host = out.cpu().numpy()
        assert np.array_equal(host[:uk.size], _segment_sum(g, inv, cnt))
        assert not host[uk.size:].any()
        assert torch.equal(out, emb.scatter_add_grads(gg, ii))  # run to run
