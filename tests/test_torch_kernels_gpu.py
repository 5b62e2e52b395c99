"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The kernels are CUDA C++ for sm_90a and have no CPU mode, so every
test here is marked ``gpu`` and skips without a card (their plain
versions are held to the JAX package on the CPU in
tests/test_torch_flash_attention.py).  This file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

Tolerance: atol 1e-5 in float32 — kernel and plain version sum in
different orders.  The causal and full-mask specializations are held the
same way at equal, unequal and ragged (S_q, S_kv), with rows that see no
key.  The additive-bias specializations are held with their dbias /
dkbias (allclose rtol 1e-4, atol 1e-5), dbias exactly 0 where a row sees
no key; so is the full-mask backward, alone and with a bias of another
group mode (Longformer's and XLNet's calls).  Every specialization also
runs in bfloat16 against its bf16 plain version within rtol = atol = 2e-2
(``BF16_TOL``).  The float32 forward is also held where it skips
key tiles that hold no visible pair (sparse masks, dead key-mask tails,
causal).  The embedding-cache kernels: the slab row gather is a
copy and must match exactly; the segment-sum must match its plain version
(``index_add_``, atomics on the card) within rtol 2e-5 / atol 1e-6 and the
host cache's ``_segment_sum`` exactly, also on runs longer than the
kernel's shared-memory chunk.  The MoE row gather is a copy with
zero rows and must match exactly; so must the sparse dispatch and combine
built from it, forward and backward, kernel against plain gather.  The
executor's ``run_steps(sync=False)`` on the card (feeds copied ahead from
pinned memory on a side stream, a window of CUDA events) gives the plain
loop's bits."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu_torch.ops.kernels import emb_cache as emb  # noqa: E402
from hetu_tpu_torch.ops import moe as tmoe  # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from hetu_tpu_torch.ops.kernels import moe_dispatch as md  # noqa: E402
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
    before = fa.launches, fa.merge_launches
    out, lse = fa.flash_fwd(q, k, v, lengths, h, d ** -0.5)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, lengths, h, d ** -0.5)
    torch.cuda.synchronize()
    n_split, _ = fa.decode_split_plan(b * h, s_q, s_kv,
                                      fa._build.sm_count(cuda))
    assert (fa.launches, fa.merge_launches) == (before[0] + 1,
                                                before[1] + (n_split > 1))
    assert float((out - ref).abs().max()) <= ATOL
    assert torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5)
    assert float(out.view(b, h, s_q, d)[1].abs().max()) == 0.0


#: the decode kernels line's shape: B 8, H 12, a 1024-row cache, D 64
DB, DH, DL = 8, 12, 1024
#: lengths 0, 1, a partial tile, a full cache, tile edges, the last row
DECODE_LENS = [0, 1, 37, DL, 64, 65, 700, DL - 1]
#: split plans (n_split, split_tiles) of the 16 key tiles: None is the
#: wrapper's own; (16, 1) splits at every tile; (3, 6) leaves the last
#: split short; (32, 1) adds splits past the cache (all empty)
DECODE_PLANS = [None, (1, 16), (2, 8), (4, 4), (3, 6), (16, 1), (32, 1)]


def _decode_inputs(cuda, s_q, d, seed, s_kv=DL, lens=DECODE_LENS):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)

    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return (t(DB * DH, s_q, d), t(DB * DH, s_kv, d), t(DB * DH, s_kv, d),
            lengths)


def _nan_past_lengths(x, lens):
    """``x`` (B*H, S_kv, D) with NaN in every row at or past its length."""
    x = x.clone().view(len(lens), -1, *x.shape[1:])
    for b, n in enumerate(lens):
        x[b, :, max(n, 0):] = float("nan")
    return x.view(-1, *x.shape[2:])


def _decode_call(q, k, v, lengths, plan):
    """flash_fwd under ``plan``; checks it launched the split kernel once
    and the merge once exactly when the plan has more than one split."""
    before = fa.launches, fa.merge_launches
    out, lse = fa.flash_fwd(q, k, v, lengths, DH, q.shape[2] ** -0.5,
                            plan=plan)
    torch.cuda.synchronize()
    n_split = plan[0] if plan is not None else fa.decode_split_plan(
        q.shape[0], q.shape[1], k.shape[1], fa._build.sm_count(q.device))[0]
    assert (fa.launches, fa.merge_launches) == (before[0] + 1,
                                                before[1] + (n_split > 1))
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("plan", DECODE_PLANS)
@pytest.mark.parametrize("s_q,d", [(1, 64), (4, 64), (1, 80), (1, 128)])
def test_decode_kernel_splits_match_plain_version(cuda, s_q, d, plan):
    """Every split plan against the plain version and the plain split
    version: out within ATOL, lse within 1e-5, a row of length 0 exactly 0
    with lse -1e30."""
    q, k, v, lengths = _decode_inputs(cuda, s_q, d, seed=d + s_q)
    out, lse = _decode_call(q, k, v, lengths, plan)
    scale = d ** -0.5
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, lengths, DH, scale)
    used = plan or fa.decode_split_plan(DB * DH, s_q, DL,
                                        fa._build.sm_count(cuda))
    sref, slse = fa.flash_fwd_split_plain(q, k, v, lengths, DH, scale, used)
    for want, wlse in ((ref, lse_ref), (sref, slse)):
        assert float((out - want).abs().max()) <= ATOL
        assert torch.allclose(lse, wlse, rtol=1e-5, atol=1e-5)
    assert float(out[:DH].abs().max()) == 0.0
    assert bool((lse[:DH] == fa.NEG_INF).all())


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [None, (1, 16), (4, 4), (16, 1), (32, 1)])
@pytest.mark.parametrize("s_q", [1, 4])
def test_decode_kernel_ignores_nan_past_lengths(cuda, s_q, plan):
    """NaN in every K and V row at or past a length changes no output bit."""
    q, k, v, lengths = _decode_inputs(cuda, s_q, 64, seed=3)
    out, lse = _decode_call(q, k, v, lengths, plan)
    kn, vn = (_nan_past_lengths(x, DECODE_LENS) for x in (k, v))
    out_n, lse_n = _decode_call(q, kn, vn, lengths, plan)
    assert torch.equal(out, out_n) and torch.equal(lse, lse_n)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [None, (4, 4), (32, 1)])
def test_decode_kernel_is_the_same_from_run_to_run(cuda, plan):
    """No atomics: the split kernel and the merge give the same bits every
    run."""
    q, k, v, lengths = _decode_inputs(cuda, 1, 64, seed=4)
    first = _decode_call(q, k, v, lengths, plan)
    for _ in range(3):
        again = _decode_call(q, k, v, lengths, plan)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


@pytest.mark.gpu
def test_decode_kernel_refuses_a_plan_short_of_the_cache(cuda):
    """A plan that leaves keys uncovered is refused by the C entry."""
    q, k, v, lengths = _decode_inputs(cuda, 1, 64, seed=5)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_fwd(q, k, v, lengths, DH, 0.125, plan=(2, 4))


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


# -- causal and full mask ------------------------------------------------------

#: equal, ragged and unequal lengths; (200, 64) leaves the first 136 query
#: rows with no visible key, (1, 130) is one row against a ragged cache
CAUSAL_PAIRS = [(1024, 1024), (200, 200), (64, 200), (200, 64), (1, 130)]
CAUSAL_CASES = [(s_q, s_kv, d, masked) for s_q, s_kv in CAUSAL_PAIRS
                for d, masked in ((64, False), (64, True), (128, False))]


def _causal_inputs(cuda, s_q, s_kv, d, masked, seed):
    rng = np.random.RandomState(seed)
    b, h = 2, 3

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)

    q, do = t(b * h, s_q, d), t(b * h, s_q, d)
    k, v = t(b * h, s_kv, d), t(b * h, s_kv, d)
    km = None
    if masked:
        m = (rng.rand(b, s_kv) < 0.7).astype(np.int32)
        m[0, 0] = 1
        m[1] = 0
        km = torch.from_numpy(m).to(cuda)
    return q, k, v, do, km


@pytest.mark.gpu
@pytest.mark.parametrize("s_q,s_kv,d,masked", CAUSAL_CASES)
def test_causal_forward_kernel_matches_plain_version(cuda, s_q, s_kv, d,
                                                     masked):
    q, k, v, _, km = _causal_inputs(cuda, s_q, s_kv, d, masked, s_q + s_kv)
    before = (fa.fwd_launches, fa.fwd_causal_launches)
    out, lse = fa.flash_fwd_masked(q, k, v, km, d ** -0.5, causal=True)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, 3, d ** -0.5,
                                      key_mask=km, causal=True)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.fwd_causal_launches) == (before[0],
                                                         before[1] + 1)
    assert float((out - ref).abs().max()) <= ATOL
    assert float((lse - lse_ref).abs().max()) <= ATOL
    empty = max(0, s_q - s_kv)          # rows that see no key
    if empty:
        assert float(out[:, :empty].abs().max()) == 0.0
        assert bool((lse[:, :empty] == fa.NEG_INF).all())
    if masked:
        assert float(out[3:].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("s_q,s_kv,d,masked", CAUSAL_CASES)
def test_causal_backward_kernels_match_plain_version(cuda, s_q, s_kv, d,
                                                     masked):
    """Causal dQ / dK / dV within allclose(rtol=1e-4, atol=1e-5) of the
    plain formulas; rows that see no key and keys that no row sees get
    exact zeros; the same from run to run."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked,
                                     3 * s_q + s_kv)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, None, 3, scale, key_mask=km,
                                  causal=True)
    delta = (do * out).sum(-1)
    before = (fa.dq_causal_launches, fa.dkv_causal_launches)
    dq = fa.flash_bwd_dq(q, k, v, km, do, lse, delta, scale, causal=True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale,
                              causal=True)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q, k, v, km, out, lse, do,
                                                scale, causal=True)
    torch.cuda.synchronize()
    assert (fa.dq_causal_launches, fa.dkv_causal_launches) == (
        before[0] + 1, before[1] + 1)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert bool(torch.isfinite(got).all())
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
            float((got - want).abs().max())
    empty = max(0, s_q - s_kv)
    if empty:
        assert float(dq[:, :empty].abs().max()) == 0.0
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale,
                                causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.gpu
def test_causal_autograd_function_launches_the_causal_kernels(cuda):
    q, k, v, do, _ = _causal_inputs(cuda, 200, 200, 64, False, seed=4)
    q4, k4, v4 = (t.view(2, 3, 200, 64).requires_grad_(True)
                  for t in (q, k, v))
    before = (fa.fwd_causal_launches, fa.dq_causal_launches,
              fa.dkv_causal_launches)
    out = fa.flash_attention(q4, k4, v4, causal=True)
    grads = torch.autograd.grad(out, (q4, k4, v4), do.view(2, 3, 200, 64))
    torch.cuda.synchronize()
    assert (fa.fwd_causal_launches, fa.dq_causal_launches,
            fa.dkv_causal_launches) == tuple(n + 1 for n in before)
    assert all(torch.isfinite(g).all() for g in grads)


FULLMASK_CASES = [(gmode, s_q, s_kv, d, causal, masked)
                  for gmode in ("one", "h", "b", "bh")
                  for s_q, s_kv, d, causal, masked in (
                      (32, 512, 64, False, False),
                      (77, 130, 128, False, True),
                      (200, 200, 32, True, True),
                      (1, 65, 64, False, False))]


@pytest.mark.gpu
@pytest.mark.parametrize("gmode,s_q,s_kv,d,causal,masked", FULLMASK_CASES)
def test_fullmask_forward_kernel_matches_plain_version(cuda, gmode, s_q, s_kv,
                                                       d, causal, masked):
    b, h = 2, 3
    q, k, v, _, km = _causal_inputs(cuda, s_q, s_kv, d, masked,
                                    s_q + 2 * s_kv)
    rng = np.random.RandomState(s_q)
    g = fa._group_rows(gmode, b * h, h)
    m = (rng.rand(g, s_q, s_kv) < 0.6).astype(np.uint8)
    m[0, 0] = 0                          # a row with every key masked
    mask = torch.from_numpy(m).to(cuda)
    before = fa.fwd_mask_launches
    out, lse = fa.flash_fwd_fullmask(q, k, v, mask, gmode, h, d ** -0.5,
                                     key_mask=km, causal=causal)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, h, d ** -0.5,
                                      key_mask=km, causal=causal, mask=mask,
                                      gmode=gmode)
    torch.cuda.synchronize()
    assert fa.fwd_mask_launches == before + 1
    assert float((out - ref).abs().max()) <= ATOL
    assert float((lse - lse_ref).abs().max()) <= ATOL
    assert float(out[0, 0].abs().max()) == 0.0
    assert float(lse[0, 0]) == float(np.float32(fa.NEG_INF))


@pytest.mark.gpu
def test_fullmask_entry_launches_the_mask_backward(cuda):
    """``flash_attention(mask=)`` with a gradient: the full-mask forward,
    dQ and dK/dV launch once each and match autograd of the plain
    attention; without a gradient only the forward launches."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    q, k, v, do, _ = _causal_inputs(cuda, 32, 96, 64, False, seed=6)
    q4, k4, v4 = (t.view(2, 3, -1, 64).clone().requires_grad_(True)
                  for t in (q, k, v))
    mask = torch.rand(2, 1, 32, 96, device=cuda) < 0.5
    mask[0, 0, 0] = False                # a row with every key masked
    names = ("fwd_mask_launches", "dq_mask_launches", "dkv_mask_launches")
    before = [getattr(fa, n) for n in names]
    with torch.no_grad():
        fa.flash_attention(q4, k4, v4, mask=mask)
    out = fa.flash_attention(q4, k4, v4, mask=mask)
    grads = torch.autograd.grad(out, (q4, k4, v4), do.view(2, 3, 32, 64))
    torch.cuda.synchronize()
    assert [getattr(fa, n) for n in names] == [before[0] + 2, before[1] + 1,
                                               before[2] + 1]
    ref = sdpa_reference(q4, k4, v4, mask=mask)
    want = torch.autograd.grad(ref, (q4, k4, v4), do.view(2, 3, 32, 64))
    assert float((out - ref).detach().abs().max()) <= ATOL
    for got, w in zip(grads, want):
        assert torch.allclose(got, w, rtol=1e-4, atol=1e-5), \
            float((got - w).abs().max())
    assert float(grads[0][0, :, 0].abs().max()) == 0.0


#: (mask gmode, bias kind or None, bias gmode, S_q, S_kv, D, causal, key
#: mask): the full-mask backward alone in each group (Longformer's is
#: group one), and with a bias or strip whose group differs from the
#: mask's (XLNet: mask b, bias h), causal, ragged, rows that see no key
MASK_BWD_CASES = [("one", None, None, 512, 512, 64, False, False),
                  ("h", None, None, 77, 130, 128, False, True),
                  ("b", None, None, 200, 200, 32, True, True),
                  ("bh", None, None, 200, 64, 64, True, False),
                  ("b", "bias", "h", 512, 512, 64, False, False),
                  ("one", "bias", "bh", 77, 130, 128, False, True),
                  ("h", "bias", "b", 200, 200, 64, True, False),
                  ("bh", "bias", "one", 200, 64, 32, True, True),
                  ("b", "kbias", "one", 128, 128, 64, False, False),
                  ("one", "kbias", "b", 200, 200, 64, True, True),
                  ("h", "kbias", "bh", 64, 200, 128, True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("gmode,kind,bgmode,s_q,s_kv,d,causal,masked",
                         MASK_BWD_CASES)
def test_fullmask_backward_kernels_match_plain_version(
        cuda, gmode, kind, bgmode, s_q, s_kv, d, causal, masked):
    """The full-mask forward, dQ (with dbias) and dK/dV (with dkbias),
    alone or with a bias of another group mode, against their plain
    versions (out / lse atol 1e-5; gradients allclose(rtol=1e-4,
    atol=1e-5)); rows that see no key give out = dQ = 0 and a dbias row of
    0; dbias exactly 0 on every masked pair; the same from run to run."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked,
                                     s_q + 7 * s_kv + d)
    rng = np.random.RandomState(s_kv + d)
    m = (rng.rand(fa._group_rows(gmode, 6, 3), s_q, s_kv) < 0.4)
    m[0, 0] = False                      # a row with every key masked
    mask = torch.from_numpy(m.astype(np.uint8)).to(cuda)
    bias = kbias = None
    if kind is not None:
        bias, kbias = _bias_of(cuda, kind, bgmode, s_q, s_kv, seed=s_q)
    sfx = "" if kind is None else "_" + kind
    names = [f"{n}_mask{sfx}_launches" for n in ("fwd", "dq", "dkv")]
    if kind is None:
        names[0] = "fwd_mask_launches"
    before = [getattr(fa, n) for n in names]
    scale = 0.37
    kw = dict(causal=causal, bias=bias, kbias=kbias, bgmode=bgmode or "bh")
    out, lse = fa.flash_fwd_fullmask(q, k, v, mask, gmode, 3, scale,
                                     key_mask=km, **kw)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, 3, scale, key_mask=km,
                                      causal=causal, mask=mask, gmode=gmode,
                                      bias=bias, kbias=kbias,
                                      bgmode=bgmode or "bh")
    delta = (do * out).sum(-1)
    args = (q, k, v, km, mask, gmode, 3, do, lse, delta, scale)
    dq, dbias = fa.flash_bwd_dq_mask(*args, **kw)
    dk, dv, dkbias = fa.flash_bwd_dkv_mask(*args, **kw)
    want = fa.flash_bwd_bias_plain(q, k, v, km, bias, kbias, bgmode or "bh",
                                   3, out, lse, do, scale, causal=causal,
                                   mask=mask, gmode=gmode)
    torch.cuda.synchronize()
    assert [getattr(fa, n) for n in names] == [n + 1 for n in before]
    assert float((out - ref).abs().max()) <= ATOL
    assert float((lse - lse_ref).abs().max()) <= ATOL
    for got, ref_g in zip((dq, dk, dv, dbias, dkbias), want):
        assert (got is None) == (ref_g is None)
        if got is None:
            continue
        assert bool(torch.isfinite(got).all())
        assert torch.allclose(got, ref_g, rtol=1e-4, atol=1e-5), \
            float((got - ref_g).abs().max())
    valid = fa._valid(6, s_q, s_kv, cuda, key_mask=km, causal=causal,
                      mask=mask, gmode=gmode, heads=3).expand(6, s_q, s_kv)
    blind = ~valid.any(-1)
    assert bool(blind.any())
    assert float(out[blind].abs().max()) == 0.0
    assert float(dq[blind].abs().max()) == 0.0
    if dbias is not None:
        assert int(torch.count_nonzero(dbias[~valid])) == 0
    dk2, dv2, dkb2 = fa.flash_bwd_dkv_mask(*args, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if dkbias is not None:
        assert torch.equal(dkbias, dkb2)


@pytest.mark.gpu
def test_mask_bias_autograd_function_launches_the_mask_bias_kernels(cuda):
    """XLNet's call: ``flash_attention(mask=, bias=)`` with a (B, 1, S, S)
    permutation mask (group b) and a (1, H, S, S) bias (group h) at S =
    96; the mask-bias forward, dQ and dK/dV launch once each and the
    bias's gradient, summed over the batch, matches autograd of the plain
    attention."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    q, k, v, do, _ = _causal_inputs(cuda, 96, 96, 64, False, seed=9)
    q = q / 8.0
    rng = np.random.RandomState(9)
    rank = np.stack([rng.permutation(96) for _ in range(2)])
    mask = torch.from_numpy(rank[:, None, None, :]
                            < rank[:, None, :, None]).to(cuda)
    bias = torch.randn(1, 3, 96, 96, device=cuda)
    q4, k4, v4, b4 = (t.reshape(-1, 3, 96, t.shape[-1]).clone()
                      .requires_grad_(True) for t in (q, k, v, bias))
    names = ("fwd_mask_bias_launches", "dq_mask_bias_launches",
             "dkv_mask_bias_launches")
    before = [getattr(fa, n) for n in names]
    out = fa.flash_attention(q4, k4, v4, mask=mask, bias=b4)
    grads = torch.autograd.grad(out, (q4, k4, v4, b4), do.view(2, 3, 96, 64))
    torch.cuda.synchronize()
    assert [getattr(fa, n) for n in names] == [n + 1 for n in before]
    ref = sdpa_reference(q4, k4, v4, mask=mask, bias=b4)
    want = torch.autograd.grad(ref, (q4, k4, v4, b4), do.view(2, 3, 96, 64))
    assert float((out - ref).detach().abs().max()) <= ATOL
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        assert torch.allclose(got, w, rtol=1e-4, atol=1e-5), \
            float((got - w).abs().max())


# -- additive bias (T5) ----------------------------------------------------------

#: (kind, gmode, S_q, S_kv, D, causal, key mask): the T5 encoder (group h,
#: key mask) and decoder (causal, S = 114) shapes cut in batch, the groups,
#: rows that see no key (200, 64), one row, and the key-bias strip
BIAS_CASES = [("bias", "h", 512, 512, 64, False, True),
              ("bias", "h", 114, 114, 64, True, False),
              ("bias", "one", 77, 130, 128, False, False),
              ("bias", "b", 200, 64, 32, True, True),
              ("bias", "bh", 1, 130, 64, False, True),
              ("kbias", "one", 128, 128, 64, False, False),
              ("kbias", "b", 200, 200, 64, True, True),
              ("kbias", "bh", 64, 200, 128, True, False)]


def _bias_of(cuda, kind, gmode, s_q, s_kv, seed, b=2, h=3):
    rng = np.random.RandomState(seed)
    g = fa._group_rows(gmode, b * h, h)
    x = torch.from_numpy(rng.randn(g, s_q if kind == "bias" else 1,
                                   s_kv).astype(np.float32)).to(cuda)
    return (x, None) if kind == "bias" else (None, x)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,gmode,s_q,s_kv,d,causal,masked", BIAS_CASES)
def test_bias_kernels_match_plain_version(cuda, kind, gmode, s_q, s_kv, d,
                                          causal, masked):
    """Forward, dQ with dbias and dK/dV with dkbias against the plain
    versions (out / lse atol 1e-5; gradients allclose(rtol=1e-4,
    atol=1e-5)); dbias exactly 0 on the pairs a row does not see (the
    causal kernel skips those key tiles and writes their zeros); the same
    from run to run."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked,
                                     s_q + 5 * s_kv + d)
    bias, kbias = _bias_of(cuda, kind, gmode, s_q, s_kv, seed=s_kv)
    scale = 0.37
    names = [f"{k}_{'kbias' if kind == 'kbias' else 'bias'}"
             f"{'_causal' if causal and kind == 'bias' else ''}_launches"
             for k in ("fwd", "dq", "dkv")]
    before = [getattr(fa, n) for n in names]
    out, lse = fa.flash_fwd_bias(q, k, v, km, bias, kbias, gmode, 3, scale,
                                 causal=causal)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, 3, scale, key_mask=km,
                                      causal=causal, bias=bias, kbias=kbias,
                                      bgmode=gmode)
    delta = (do * out).sum(-1)
    dq, dbias = fa.flash_bwd_dq_bias(q, k, v, km, bias, kbias, gmode, 3, do,
                                     lse, delta, scale, causal=causal)
    dk, dv, dkbias = fa.flash_bwd_dkv_bias(q, k, v, km, bias, kbias, gmode,
                                           3, do, lse, delta, scale,
                                           causal=causal)
    want = fa.flash_bwd_bias_plain(q, k, v, km, bias, kbias, gmode, 3, out,
                                   lse, do, scale, causal=causal)
    torch.cuda.synchronize()
    assert [getattr(fa, n) for n in names] == [n + 1 for n in before]
    assert float((out - ref).abs().max()) <= ATOL
    assert float((lse - lse_ref).abs().max()) <= ATOL
    for got, ref_g in zip((dq, dk, dv, dbias, dkbias), want):
        assert (got is None) == (ref_g is None)
        if got is None:
            continue
        assert bool(torch.isfinite(got).all())
        assert torch.allclose(got, ref_g, rtol=1e-4, atol=1e-5), \
            float((got - ref_g).abs().max())
    if dbias is not None:
        valid = fa._valid(6, s_q, s_kv, cuda, key_mask=km, causal=causal)
        if valid is not None:     # pairs no row sees: exactly 0
            assert int(torch.count_nonzero(
                dbias[~valid.expand_as(dbias)])) == 0
        if causal:
            above = torch.ones(s_q, s_kv, dtype=torch.bool,
                               device=cuda).triu(s_kv - s_q + 1)
            assert int(torch.count_nonzero(dbias[:, above])) == 0
    dk2, dv2, dkb2 = fa.flash_bwd_dkv_bias(q, k, v, km, bias, kbias, gmode, 3,
                                           do, lse, delta, scale,
                                           causal=causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if dkbias is not None:
        assert torch.equal(dkbias, dkb2)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_bias_autograd_function_launches_the_bias_kernels(cuda, causal):
    """``flash_attention(bias=)`` with T5's (1, H, S, S) bias at T5's
    scale 1.0: the bias kernels launch once each and the bias's gradient,
    summed over the batch, matches autograd of the plain attention.  The
    queries are divided by sqrt(D), as T5's query init does, so the
    unscaled logits are O(1): at standard deviation sqrt(64) the rows are
    near one-hot and dS = P (dP - delta) cancels, so any two summation
    orders differ by ~1 % in dQ (tests/test_torch_t5.py)."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    q, k, v, do, km = _causal_inputs(cuda, 114, 114, 64, not causal, seed=8)
    q = q / 8.0
    bias = torch.randn(1, 3, 114, 114, device=cuda)
    q4, k4, v4, b4 = (t.reshape(-1, 3, 114, t.shape[-1]).clone()
                      .requires_grad_(True) for t in (q, k, v, bias))
    mask = None if km is None else km[:, None, None, :]
    names = [f"{k}_bias{'_causal' if causal else ''}_launches"
             for k in ("fwd", "dq", "dkv")]
    before = [getattr(fa, n) for n in names]
    out = fa.flash_attention(q4, k4, v4, causal=causal, scale=1.0,
                             key_mask=km, bias=b4)
    grads = torch.autograd.grad(out, (q4, k4, v4, b4), do.view(2, 3, 114, 64))
    torch.cuda.synchronize()
    assert [getattr(fa, n) for n in names] == [n + 1 for n in before]
    ref = sdpa_reference(q4, k4, v4, causal=causal, scale=1.0, mask=mask,
                         bias=b4)
    want = torch.autograd.grad(ref, (q4, k4, v4, b4), do.view(2, 3, 114, 64))
    assert float((out - ref).detach().abs().max()) <= ATOL
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        assert torch.allclose(got, w, rtol=1e-4, atol=1e-5), \
            float((got - w).abs().max())


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
                                      (1, 16, "one"), (20000, 16, "one"),
                                      (3000, 128, "one"), (5001, 13, "one"),
                                      (53248, 13, "zipf")])
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


# the float32 forward walks only the key tiles that hold a visible pair
# (tile_maps): masks with whole empty key tiles, a query tile whose rows
# see nothing, ragged edges, a key mask with dead tail tiles, causal with
# S_q != S_kv; (kind, gmode, s_q, s_kv, d, causal, masked)
SKIP_CASES = [("mask", "one", 300, 520, 64, False, False),
              ("mask", "b", 200, 333, 64, True, True),
              ("mask", "bh", 130, 77, 128, False, True),
              ("mask", "h", 512, 512, 32, False, False),
              ("mask_bias", "b", 256, 300, 64, False, True),
              ("key_mask", None, 300, 520, 64, False, True),
              ("key_mask", None, 130, 700, 64, True, True),
              ("bias", "h", 200, 450, 64, False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,gmode,s_q,s_kv,d,causal,masked", SKIP_CASES)
def test_forward_skips_empty_tiles_and_matches_plain_version(
        cuda, kind, gmode, s_q, s_kv, d, causal, masked):
    b, h = 2, 3
    rng = np.random.RandomState(s_q * 7 + s_kv)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)

    q, k, v = t(b * h, s_q, d), t(b * h, s_kv, d), t(b * h, s_kv, d)
    km = None
    if masked:
        n_live = np.array([s_kv - 3, max(1, s_kv // 5)])
        kmn = (np.arange(s_kv)[None, :] < n_live[:, None]).astype(np.int32)
        kmn[0, 64:128] = 0                 # a dead key tile inside the row
        km = torch.from_numpy(kmn).to(cuda)
    mask = None
    if kind.startswith("mask"):
        g = fa._group_rows(gmode, b * h, h)
        m = rng.rand(g, s_q, s_kv) < 0.05
        m[:, :, -1] = True                 # the ragged last key tile
        m[:, :, 64:192] = False            # empty key tiles
        m[:, 64:128, :] = False            # a query tile that sees nothing
        mask = torch.from_numpy(m.astype(np.uint8)).to(cuda)
    bias = None
    if kind.endswith("bias"):
        bias = t(fa._group_rows("h", b * h, h), s_q, s_kv)
    scale = d ** -0.5
    walk = fa.walked_tiles(b * h, h, s_q, s_kv, key_mask=km, causal=causal,
                           mask=mask, gmode=gmode or "bh")
    assert 0 < int(walk.sum()) < walk.numel()
    if mask is not None:
        out, lse = fa.flash_fwd_fullmask(q, k, v, mask, gmode, h, scale,
                                         key_mask=km, causal=causal,
                                         bias=bias, bgmode="h")
    elif bias is not None:
        out, lse = fa.flash_fwd_bias(q, k, v, km, bias, None, "h", h, scale,
                                     causal=causal)
    else:
        out, lse = fa.flash_fwd_masked(q, k, v, km, scale, causal=causal)
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, h, scale, key_mask=km,
                                      causal=causal, mask=mask,
                                      gmode=gmode or "bh", bias=bias,
                                      bgmode="h")
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= ATOL
    assert float((lse - lse_ref).abs().max()) <= ATOL
    valid = fa._valid(b * h, s_q, s_kv, q.device, key_mask=km, causal=causal,
                      mask=mask, gmode=gmode or "bh", heads=h)
    blind = ~valid.expand(b * h, s_q, s_kv).any(-1)
    assert int(blind.sum()) > 0 or kind in ("bias", "key_mask")
    if int(blind.sum()):
        assert float(out[blind].abs().max()) == 0.0
        assert bool((lse[blind] == fa.NEG_INF).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,rows", [(20480, 512, 8192), (8192, 512, 20480),
                                      (37, 13, 20), (1, 4, 1), (0, 16, 8),
                                      (100, 16, 0)])
def test_row_gather_kernel_matches_plain_version(cuda, n, m, rows):
    rng = np.random.RandomState(n + m)
    src = torch.from_numpy(rng.randn(rows, m).astype(np.float32)).to(cuda)
    idx = rng.randint(-1, rows, n) if rows else np.full(n, -1)
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    before = md.launches
    out = md.row_gather(src, idx)
    ref = md.row_gather_plain(src, idx)
    torch.cuda.synchronize()
    assert md.launches == before + (1 if n else 0)
    assert out.shape == (n, m) and torch.equal(out, ref)
    assert not out[idx < 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_sparse_dispatch_and_combine_kernel_equals_plain(cuda, k):
    """Forward and backward of both autograd functions, the kernel's
    gather against the plain one on the same card: bit for bit (every
    direction is a gather, no scatter and no atomics).  3k + 2 launches."""
    rng = np.random.RandomState(k)
    s, d, e = 1024, 64, 8
    cap = int(np.ceil(k * 1.25 * s / e))
    logits = torch.from_numpy(
        (rng.randn(s, e) + np.linspace(1, -1, e)).astype(np.float32)).to(cuda)
    tos, sot, kos, gate_w, _ = tmoe._topk_sparse_indices(logits, k, cap)
    assert bool((tos < 0).any())
    x = torch.from_numpy(rng.randn(s, d).astype(np.float32)).to(cuda)
    w1 = torch.from_numpy((rng.randn(d, d) * 0.1).astype(np.float32)).to(cuda)
    gw = gate_w.detach()
    g_out = torch.from_numpy(rng.randn(s, d).astype(np.float32)).to(cuda)

    def run(gather):
        xx, ww, gg = (t.clone().requires_grad_(True) for t in (x, w1, gw))
        buf = md.sparse_dispatch(xx, tos, sot, gather=gather)
        out = md.sparse_combine(torch.tanh(buf @ ww), gg, sot, tos, kos,
                                gather=gather)
        grads = torch.autograd.grad(out, (xx, ww, gg), g_out)
        return (buf, out) + grads

    before = md.launches
    got = run(md.row_gather)
    assert md.launches == before + 3 * k + 2
    want = run(md.row_gather_plain)
    torch.cuda.synchronize()
    for a, b, name in zip(got, want, ("buffers", "out", "d_tokens", "d_w1",
                                      "d_gate_w")):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,rows,offset", [
    (20480, 512, 8192, 0), (8192, 512, 20480, 0), (37, 13, 20, 0),
    (37, 16, 20, 1), (1, 8, 1, 0), (0, 16, 8, 0), (100, 16, 0, 0)])
def test_row_gather_bf16_kernel_matches_plain_version(cuda, n, m, rows,
                                                      offset):
    """The bf16 instantiation: bit-equal to the plain version, its own
    launch counter; width 13 and a source that starts ``offset`` values
    into its buffer (not 16-byte aligned) take the one-value path."""
    rng = np.random.RandomState(n + m + offset)
    buf = torch.from_numpy(rng.randn(rows * m + offset).astype(np.float32))
    src = buf.to(cuda, torch.bfloat16)[offset:].view(rows, m)
    idx = rng.randint(-1, rows, n) if rows else np.full(n, -1)
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    before, before32 = md.bf16_launches, md.launches
    out = md.row_gather(src, idx)
    ref = md.row_gather_plain(src, idx)
    torch.cuda.synchronize()
    assert md.bf16_launches == before + (1 if n else 0)
    assert md.launches == before32
    assert out.dtype == torch.bfloat16 and out.shape == (n, m)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert not out[idx < 0].any()


#: the launch plan's edges (gather_plan), each (name, n, width, source
#: rows, offset in values): n not a multiple of a block's rows, a block
#: whose every index is -1, a source one value off 16-byte alignment,
#: widths 13 and 2048, and more blocks than the grid takes in one round
PLAN_EDGES = [("n off the block", 8193, 512, 3000, 0),
              ("a block all -1", 8192, 512, 3000, 0),
              ("src off alignment", 4099, 16, 5000, 1),
              ("w=13", 4099, 13, 5000, 0), ("w=2048", 3001, 2048, 2000, 0),
              ("rounds", 300000, 16, 70000, 0)]


def _plan_case(cuda, dtype, n, width, rows, offset, slab=False):
    """Source, indices and the plan the MoE gather's wrapper makes for
    them (with ``slab``, every index valid, as the slab gather's)."""
    rng = np.random.RandomState(n + width + offset)
    buf = torch.from_numpy(rng.randn(rows * width + offset).astype(
        np.float32)).to(cuda, dtype)
    src = buf[offset:].view(rows, width)
    idx = rng.randint(0 if slab else -1, rows, n).astype(np.int32)
    plan = md.gather_plan(n, width, src.element_size(), src.data_ptr(), 0,
                          md._build.sm_count(src.device))
    return src, torch.from_numpy(idx).to(cuda), plan


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,width,rows,offset", PLAN_EDGES,
                         ids=[e[0] for e in PLAN_EDGES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_kernel_at_the_plan_edges(cuda, dtype, name, n, width,
                                             rows, offset):
    """B6 at the plan's edges, by the route the plan picks: bit-equal to
    the plain version, one launch on its dtype's counter."""
    src, idx, plan = _plan_case(cuda, dtype, n, width, rows, offset)
    if name == "a block all -1":
        assert plan[1] > 0
        idx[plan[1]:2 * plan[1]] = -1
    counter = "bf16_launches" if dtype == torch.bfloat16 else "launches"
    before = getattr(md, counter)
    out = md.row_gather(src, idx)
    torch.cuda.synchronize()
    assert getattr(md, counter) == before + 1
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    ref = md.row_gather_plain(src, idx)
    assert out.dtype == dtype and out.shape == (n, width)
    assert torch.equal(out.view(bits), ref.view(bits))
    assert not out[idx < 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,width,rows,offset",
                         [e for e in PLAN_EDGES if e[0] != "a block all -1"],
                         ids=[e[0] for e in PLAN_EDGES
                              if e[0] != "a block all -1"])
def test_slab_gather_kernel_at_the_plan_edges(cuda, name, n, width, rows,
                                              offset):
    """B4 at the same edges (every slot valid; more chunks than its
    grid-stride grid takes at once at "rounds"): equal to the plain
    version, one launch."""
    slab, slots, _ = _plan_case(cuda, torch.float32, n, width, rows,
                                offset, slab=True)
    before = emb.launches
    out = emb.gather_rows(slab, slots)
    torch.cuda.synchronize()
    assert emb.launches == before + 1
    assert torch.equal(out, emb.gather_rows_plain(slab, slots))


@pytest.mark.gpu
def test_sparse_dispatch_and_combine_bf16_kernel_equals_plain(cuda):
    """The bf16 step's mix: bf16 tokens and expert rows, float32 gate
    weights, so the combine's output and the gradient d_buffers gathers
    are float32.  Kernel against plain gather, bit for bit; 2k + 3 bf16
    launches (dispatch forward and backward, combine forward, d_w) and one
    float32 (d_buffers)."""
    rng = np.random.RandomState(7)
    s, d, e, k = 1024, 64, 8, 2
    cap = int(np.ceil(k * 1.25 * s / e))
    bf = torch.bfloat16
    x = torch.from_numpy(rng.randn(s, d).astype(np.float32)).to(cuda, bf)
    wg = torch.from_numpy(rng.randn(d, e).astype(np.float32)).to(cuda, bf)
    w1 = torch.from_numpy((rng.randn(d, d) * 0.1).astype(np.float32)).to(
        cuda, bf)
    g_out = torch.from_numpy(rng.randn(s, d).astype(np.float32)).to(cuda)
    tos, sot, kos, gate_w, _ = tmoe._topk_sparse_indices(x @ wg, k, cap)
    assert gate_w.dtype == torch.float32 and bool((tos < 0).any())
    gw = gate_w.detach()

    def run(gather):
        xx, ww, gg = (t.clone().requires_grad_(True) for t in (x, w1, gw))
        buf = md.sparse_dispatch(xx, tos, sot, gather=gather)
        out = md.sparse_combine(torch.tanh(buf @ ww), gg, sot, tos, kos,
                                gather=gather)
        grads = torch.autograd.grad(out, (xx, ww, gg), g_out)
        return (buf, out) + grads

    before, before32 = md.bf16_launches, md.launches
    got = run(md.row_gather)
    assert md.bf16_launches == before + 3 * k + 1
    assert md.launches == before32 + 1
    want = run(md.row_gather_plain)
    torch.cuda.synchronize()
    assert [t.dtype for t in got] == [bf, torch.float32, bf, bf,
                                      torch.float32]
    for a, b, name in zip(got, want, ("buffers", "out", "d_tokens", "d_w1",
                                      "d_gate_w")):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


# -- bfloat16 (the mixed-precision training path) ---------------------------------

#: bf16 kernel vs its bf16 plain version: both round P and dS to bf16 and
#: their outputs to bf16, but from scores summed in another order and, in the
#: forward, P relative to the running (kernel) or the row's (plain) max, so
#: an element may differ by an ulp of bf16; test_pallas.py holds the TPU
#: kernel's bf16 instantiation to its reference at the same 2e-2
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

#: (kind, mask gmode, bias gmode, S_q, S_kv, D, causal, key mask): every
#: specialization the templates cover, at small shapes with ragged tiles;
#: head dims the tensor-core kernels pad (40 to 48 in shared memory) or take
#: in one k-step (16), both sequence axes off the 64-row tile, causal with
#: S_q > S_kv, odd S_kv (the bias read one float at a time, the mask staged
#: byte by byte)
BF16_CASES = [("dense", None, None, 512, 512, 64, False, False),
              ("dense", None, None, 200, 200, 64, False, True),
              ("dense", None, None, 1024, 1024, 64, True, False),
              ("dense", None, None, 200, 64, 128, True, True),
              ("bias", None, "h", 114, 114, 64, True, False),
              ("bias", None, "h", 200, 130, 64, False, True),
              ("kbias", None, "b", 200, 200, 64, True, True),
              ("mask", "b", None, 96, 96, 64, False, False),
              ("mask", "one", None, 200, 64, 64, True, True),
              ("mask_bias", "b", "h", 96, 96, 64, False, False),
              ("mask_kbias", "h", "one", 130, 200, 64, True, False),
              ("dense", None, None, 200, 200, 40, False, True),
              ("dense", None, None, 100, 150, 16, False, False),
              ("dense", None, None, 150, 70, 40, True, False),
              ("dense", None, None, 77, 101, 96, True, True),
              ("bias", None, "bh", 77, 101, 40, False, True),
              ("kbias", None, "h", 150, 70, 16, True, False),
              ("mask", "bh", None, 130, 90, 40, True, False),
              ("mask_bias", "b", "h", 100, 150, 16, False, True),
              ("mask_kbias", "one", "b", 77, 101, 120, False, False)]


def _bf16(*xs):
    return tuple(None if x is None else x.to(torch.bfloat16) for x in xs)


def _run_kernels(fa_kind, q, k, v, do, km, mask, mgmode, bias, kbias,
                 bgmode, causal, scale, lengths=None):
    """(out, lse, dq, dk, dv, dbias, dkbias) of the kernels for one case
    (H = 3), with ``lengths`` (B,) when given."""
    if fa_kind.startswith("mask"):
        kw = dict(causal=causal, bias=bias, kbias=kbias, bgmode=bgmode,
                  lengths=lengths)
        out, lse = fa.flash_fwd_fullmask(q, k, v, mask, mgmode, 3, scale,
                                         key_mask=km, **kw)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, km, mask, mgmode, 3, do, lse, delta, scale)
        dq, dbias = fa.flash_bwd_dq_mask(*args, **kw)
        dk, dv, dkbias = fa.flash_bwd_dkv_mask(*args, **kw)
    elif fa_kind in ("bias", "kbias"):
        out, lse = fa.flash_fwd_bias(q, k, v, km, bias, kbias, bgmode, 3,
                                     scale, causal=causal, lengths=lengths)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, km, bias, kbias, bgmode, 3, do, lse, delta, scale)
        dq, dbias = fa.flash_bwd_dq_bias(*args, causal=causal,
                                         lengths=lengths)
        dk, dv, dkbias = fa.flash_bwd_dkv_bias(*args, causal=causal,
                                               lengths=lengths)
    else:
        out, lse = fa.flash_fwd_masked(q, k, v, km, scale, causal=causal,
                                       lengths=lengths)
        delta = (do.float() * out.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, km, do, lse, delta, scale,
                             causal=causal, lengths=lengths)
        dk, dv = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale,
                                  causal=causal, lengths=lengths)
        dbias = dkbias = None
    return out, lse, dq, dk, dv, dbias, dkbias


@pytest.mark.gpu
@pytest.mark.parametrize("kind,mgmode,bgmode,s_q,s_kv,d,causal,masked",
                         BF16_CASES)
def test_bf16_kernels_match_plain_version(cuda, kind, mgmode, bgmode, s_q,
                                          s_kv, d, causal, masked):
    """Every bfloat16 instantiation (forward, dQ with dbias, dK/dV with
    dkbias) against its bf16 plain version: out, dQ, dK, dV bf16 within
    ``BF16_TOL``; lse within 1e-4 and dbias / dkbias (float32, from the
    unrounded t) within ``BF16_TOL``; each launch counted under its
    ``bf16_`` counter and none under the float32 one; rows that see no
    key give out = dQ = 0."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked,
                                     s_q + 3 * s_kv + d)
    q, k, v, do = _bf16(q, k, v, do)
    mask = None
    if mgmode is not None:
        rng = np.random.RandomState(s_kv + d)
        m = rng.rand(fa._group_rows(mgmode, 6, 3), s_q, s_kv) < 0.4
        m[0, 0] = False                  # a row with every key masked
        mask = torch.from_numpy(m.astype(np.uint8)).to(cuda)
    bias = kbias = None
    if bgmode is not None:
        bias, kbias = _bias_of(cuda, "kbias" if kind.endswith("kbias")
                               else "bias", bgmode, s_q, s_kv, seed=s_q)
    scale = 0.37
    counters = [n for n in vars(fa) if n.endswith("launches")]
    before = {n: getattr(fa, n) for n in counters}
    got = _run_kernels(kind, q, k, v, do, km, mask, mgmode or "bh", bias,
                       kbias, bgmode or "bh", causal, scale)
    torch.cuda.synchronize()
    moved = {n: getattr(fa, n) - before[n] for n in counters
             if getattr(fa, n) != before[n]}
    assert len(moved) == 3 and all(n.startswith("bf16_") and c == 1
                                   for n, c in moved.items()), moved
    out, lse, dq, dk, dv, dbias, dkbias = got
    for t in (out, dq, dk, dv):
        assert t.dtype == torch.bfloat16
    ref, lse_ref = fa.flash_fwd_plain(
        q, k, v, None, 3, scale, key_mask=km, causal=causal, mask=mask,
        gmode=mgmode or "bh", bias=bias, kbias=kbias, bgmode=bgmode or "bh")
    want = fa.flash_bwd_bias_plain(q, k, v, km, bias, kbias, bgmode or "bh",
                                   3, out, lse, do, scale, causal=causal,
                                   mask=mask, gmode=mgmode or "bh")
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    for g, w, name in zip((dq, dk, dv, dbias, dkbias), want,
                          ("dq", "dk", "dv", "dbias", "dkbias")):
        assert (g is None) == (w is None), name
        if g is not None:
            assert bool(torch.isfinite(g.float()).all()), name
            torch.testing.assert_close(g.float(), w.float(), **BF16_TOL,
                                       msg=name)
    valid = fa._valid(6, s_q, s_kv, cuda, key_mask=km, causal=causal,
                      mask=mask, gmode=mgmode or "bh", heads=3)
    if valid is not None:
        blind = ~valid.expand(6, s_q, s_kv).any(-1)
        if bool(blind.any()):
            assert float(out[blind].float().abs().max()) == 0.0
            assert float(dq[blind].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,mgmode,bgmode,s_q,s_kv,d,causal,masked",
                         [("dense", None, None, 512, 512, 64, False, True),
                          ("dense", None, None, 1024, 1024, 64, True, False),
                          ("kbias", None, "b", 200, 200, 40, True, True),
                          ("mask_kbias", "h", "one", 130, 200, 64, True,
                           False)])
def test_bf16_dkv_is_the_same_from_run_to_run(cuda, kind, mgmode, bgmode,
                                              s_q, s_kv, d, causal, masked):
    """The bf16 dK/dV kernel owns its keys and sums in a fixed order (no
    atomics): two runs on the same inputs give dK, dV and dkbias equal bit
    for bit."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked, s_q + d)
    q, k, v, do = _bf16(q, k, v, do)
    mask = None
    if mgmode is not None:
        rng = np.random.RandomState(s_kv)
        mask = torch.from_numpy(
            (rng.rand(fa._group_rows(mgmode, 6, 3), s_q, s_kv) < 0.4)
            .astype(np.uint8)).to(cuda)
    bias = kbias = None
    if bgmode is not None:
        bias, kbias = _bias_of(cuda, "kbias", bgmode, s_q, s_kv, seed=s_kv)
    runs = []
    for _ in range(2):
        got = _run_kernels(kind, q, k, v, do, km, mask, mgmode or "bh",
                           bias, kbias, bgmode or "bh", causal, 0.37)
        runs.append((got[3], got[4], got[6]))       # dk, dv, dkbias
    torch.cuda.synchronize()
    for a, b, name in zip(runs[0], runs[1], ("dk", "dv", "dkbias")):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind,mgmode,bgmode,s_q,s_kv,d,causal,masked",
                         [("dense", None, None, 512, 512, 64, False, True),
                          ("bias", None, "h", 200, 130, 64, False, True),
                          ("mask_bias", "b", "h", 100, 150, 40, False, True),
                          ("dense", None, None, 1024, 1024, 64, True, False)])
def test_bf16_dq_is_the_same_from_run_to_run(cuda, kind, mgmode, bgmode,
                                             s_q, s_kv, d, causal, masked):
    """The bf16 dQ kernel owns its query rows and sums in a fixed order (no
    atomics): two runs on the same inputs give dQ and dbias equal bit for
    bit."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked, s_q + d)
    q, k, v, do = _bf16(q, k, v, do)
    mask = None
    if mgmode is not None:
        rng = np.random.RandomState(s_kv)
        mask = torch.from_numpy(
            (rng.rand(fa._group_rows(mgmode, 6, 3), s_q, s_kv) < 0.4)
            .astype(np.uint8)).to(cuda)
    bias = kbias = None
    if bgmode is not None:
        bias, kbias = _bias_of(cuda, "bias", bgmode, s_q, s_kv, seed=s_kv)
    runs = []
    for _ in range(2):
        got = _run_kernels(kind, q, k, v, do, km, mask, mgmode or "bh",
                           bias, kbias, bgmode or "bh", causal, 0.37)
        runs.append((got[2], got[5]))               # dq, dbias
    torch.cuda.synchronize()
    for a, b, name in zip(runs[0], runs[1], ("dq", "dbias")):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_autograd_function_matches_the_cpu_route(cuda, causal):
    """``flash_attention`` on bfloat16 (B, H, S, D) tensors with a key mask
    (BERT) or ``causal`` (GPT-2): the bf16 forward, dQ and dK/dV launch
    once each, and the output and gradients match the same call on the
    CPU (the plain versions) within ``BF16_TOL``."""
    q, k, v, do, km = _causal_inputs(cuda, 200, 200, 64, not causal, seed=3)
    q4, k4, v4, do4 = (t.view(2, 3, 200, 64) for t in _bf16(q, k, v, do))
    names = [f"bf16_{n}{'_causal' if causal else ''}_launches"
             for n in ("fwd", "dq", "dkv")]
    before = [getattr(fa, n) for n in names]
    res = {}
    for dev in ("cuda", "cpu"):
        x = [t.to(dev).detach().requires_grad_(True) for t in (q4, k4, v4)]
        out = fa.flash_attention(*x, causal=causal,
                                 key_mask=None if km is None else km.to(dev))
        res[dev] = (out,) + torch.autograd.grad(out, x, do4.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert [getattr(fa, n) for n in names] == [n + 1 for n in before]
    for g, w in zip(res["cuda"], res["cpu"]):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.detach().float().cpu(),
                                   w.detach().float(), **BF16_TOL)


@pytest.mark.gpu
def test_bf16_head_dim_must_be_a_multiple_of_8(cuda):
    q, k, v, _, _ = _causal_inputs(cuda, 64, 64, 68, False, seed=1)
    fa.flash_fwd_masked(q, k, v, None, 0.1)         # float32 takes D = 68
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd_masked(*_bf16(q, k, v), None, 0.1)


# -- lengths with every other rule (sdpa_varlen_op), float32 and bf16 ------

#: (kind, mask gmode, bias gmode, S_q, S_kv, D, causal, key mask, lengths of
#: the two batch rows): ``lengths`` alone and with each rule the templates
#: combine it with, at ragged shapes with S_q != S_kv; lengths 0, 1, ragged,
#: a whole number of tiles, = S_kv and > S_kv
LEN_CASES = [("dense", None, None, 200, 200, 64, False, False, (77, 200)),
             ("dense", None, None, 130, 333, 64, False, False, (0, 383)),
             ("dense", None, None, 200, 200, 64, True, False, (1, 150)),
             ("dense", None, None, 200, 130, 40, True, False, (130, 64)),
             ("dense", None, None, 200, 300, 64, False, True, (256, 17)),
             ("mask", "b", None, 96, 150, 64, False, False, (100, 0)),
             ("mask", "one", None, 200, 200, 64, True, True, (128, 200)),
             ("mask", "h", None, 130, 200, 64, False, False, (65, 999)),
             ("mask", "bh", None, 77, 101, 96, True, False, (1, 64)),
             ("bias", None, "h", 200, 130, 64, False, True, (100, 129)),
             ("bias", None, "bh", 114, 114, 64, True, False, (50, 114)),
             ("kbias", None, "b", 200, 200, 64, True, True, (190, 3)),
             ("mask_bias", "b", "h", 96, 96, 64, False, False, (70, 96)),
             ("mask_kbias", "h", "one", 130, 200, 64, True, False, (129, 0))]


def _len_case(cuda, kind, mgmode, bgmode, s_q, s_kv, d, masked, lens,
              dtype, seed):
    """Inputs of one ``LEN_CASES`` case in ``dtype``: (q, k, v, do, key
    mask, lengths, mask, bias, kbias)."""
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, masked, seed)
    if dtype == torch.bfloat16:
        q, k, v, do = _bf16(q, k, v, do)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    mask = None
    if mgmode is not None:
        rng = np.random.RandomState(seed + 1)
        m = rng.rand(fa._group_rows(mgmode, 6, 3), s_q, s_kv) < 0.6
        m[0, 0] = False                  # a row with every key masked
        mask = torch.from_numpy(m.astype(np.uint8)).to(cuda)
    bias = kbias = None
    if bgmode is not None:
        bias, kbias = _bias_of(cuda, "kbias" if kind.endswith("kbias")
                               else "bias", bgmode, s_q, s_kv, seed=seed + 2)
    return q, k, v, do, km, lengths, mask, bias, kbias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,mgmode,bgmode,s_q,s_kv,d,causal,masked,lens",
                         LEN_CASES)
def test_lengths_kernels_match_plain_version(cuda, kind, mgmode, bgmode, s_q,
                                             s_kv, d, causal, masked, lens,
                                             dtype):
    """Every kernel with ``lengths`` (forward, dQ with dbias, dK/dV with
    dkbias) against its plain version on the same inputs: float32 out and
    lse within 1e-5 and the gradients allclose(rtol=1e-4, atol=1e-5);
    bf16 within ``BF16_TOL``, lse within 1e-4.  dK and dV are exactly 0 at
    every key at or past the length, dkbias too, dbias on every pair no row
    sees; a row that sees no key gives out = dQ = 0 and lse = -1e30; each
    launch counts under its ``_len`` counter of the dtype."""
    q, k, v, do, km, lengths, mask, bias, kbias = _len_case(
        cuda, kind, mgmode, bgmode, s_q, s_kv, d, masked, lens, dtype,
        seed=s_q + 7 * s_kv + d)
    scale = 0.37
    counters = [n for n in vars(fa) if n.endswith("launches")]
    before = {n: getattr(fa, n) for n in counters}
    got = _run_kernels(kind, q, k, v, do, km, mask, mgmode or "bh", bias,
                       kbias, bgmode or "bh", causal, scale, lengths)
    torch.cuda.synchronize()
    moved = {n: getattr(fa, n) - before[n] for n in counters
             if getattr(fa, n) != before[n]}
    bf16 = dtype == torch.bfloat16
    assert len(moved) == 3 and all(
        n.endswith("_len_launches") and n.startswith("bf16_") == bf16
        and c == 1 for n, c in moved.items()), moved
    out, lse, dq, dk, dv, dbias, dkbias = got
    ref, lse_ref = fa.flash_fwd_plain(
        q, k, v, lengths, 3, scale, key_mask=km, causal=causal, mask=mask,
        gmode=mgmode or "bh", bias=bias, kbias=kbias, bgmode=bgmode or "bh")
    want = fa.flash_bwd_bias_plain(q, k, v, km, bias, kbias, bgmode or "bh",
                                   3, out, lse, do, scale, causal=causal,
                                   mask=mask, gmode=mgmode or "bh",
                                   lengths=lengths)
    tol = BF16_TOL if bf16 else dict(rtol=1e-4, atol=ATOL)
    assert float((lse - lse_ref).abs().max()) <= (1e-4 if bf16 else ATOL)
    if bf16:
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    else:
        assert float((out - ref).abs().max()) <= ATOL
    for g, w, name in zip((dq, dk, dv, dbias, dkbias), want,
                          ("dq", "dk", "dv", "dbias", "dkbias")):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype, name
            assert bool(torch.isfinite(g.float()).all()), name
            torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
    for b, n in enumerate(lens):          # the padded keys: exactly 0
        pad = slice(max(0, min(n, s_kv)), s_kv)
        rows = slice(3 * b, 3 * b + 3)
        for g in (dk, dv) + ((dkbias,) if dkbias is not None else ()):
            assert int(torch.count_nonzero(g[rows, ..., pad])
                       if g is dkbias else
                       torch.count_nonzero(g[rows, pad])) == 0
    valid = fa._valid(6, s_q, s_kv, cuda, lengths=lengths, key_mask=km,
                      causal=causal, mask=mask, gmode=mgmode or "bh",
                      heads=3).expand(6, s_q, s_kv)
    blind = ~valid.any(-1)
    if bool(blind.any()):
        assert float(out[blind].float().abs().max()) == 0.0
        assert float(dq[blind].float().abs().max()) == 0.0
        assert bool((lse[blind] == fa.NEG_INF).all())
    if dbias is not None:
        assert int(torch.count_nonzero(dbias[~valid])) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [0, 2, 9, 13])
def test_lengths_kernels_are_the_same_from_run_to_run(cuda, case, dtype):
    """dQ, dbias, dK, dV and dkbias with ``lengths``: each CTA owns its
    rows or keys (no atomics), so two runs are equal bit for bit."""
    kind, mgmode, bgmode, s_q, s_kv, d, causal, masked, lens = \
        LEN_CASES[case]
    q, k, v, do, km, lengths, mask, bias, kbias = _len_case(
        cuda, kind, mgmode, bgmode, s_q, s_kv, d, masked, lens, dtype,
        seed=case)
    runs = [_run_kernels(kind, q, k, v, do, km, mask, mgmode or "bh", bias,
                         kbias, bgmode or "bh", causal, 0.37, lengths)[2:]
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, name in zip(runs[0], runs[1],
                          ("dq", "dk", "dv", "dbias", "dkbias")):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,s_q,s_kv,causal,lens",
                         [("dense", 512, 512, False, (300, 64)),
                          ("dense", 300, 700, True, (129, 700)),
                          ("mask", 256, 520, False, (200, 448)),
                          ("bias", 200, 450, False, (0, 130))])
def test_lengths_walk_stops_at_the_length(cuda, kind, s_q, s_kv, causal,
                                          lens, dtype):
    """The key tiles past each row's length are never read: K and V are
    NaN in every 64-key tile that starts at or past the length (those
    ``walked_tiles`` leaves out), and the forward, dQ and dK/dV still
    match the plain version on the clean inputs, with dK = dV = 0 exactly
    on those tiles."""
    q, k, v, do, _, lengths, mask, bias, kbias = _len_case(
        cuda, "mask" if kind == "mask" else kind, "b" if kind == "mask"
        else None, "h" if kind == "bias" else None, s_q, s_kv, 64, False,
        lens, dtype, seed=s_kv)
    walk = fa.walked_tiles(6, 3, s_q, s_kv, lengths=lengths)[:, 0]
    assert 0 < int(walk.sum()) < walk.numel()
    dead = ~walk.repeat_interleave(fa.TILE, dim=1)[:, :s_kv]   # (BH, S_kv)
    kp, vp = k.clone(), v.clone()
    kp[dead], vp[dead] = float("nan"), float("nan")
    args = (kind, q, kp, vp, do, None, mask, "b", bias, kbias, "h", causal,
            0.37, lengths)
    out, lse, dq, dk, dv, _, _ = _run_kernels(*args)
    ref = _run_kernels(kind, q, k, v, do, None, mask, "b", bias, kbias, "h",
                       causal, 0.37, lengths)
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(dk[dead])) == 0
    assert int(torch.count_nonzero(dv[dead])) == 0
    for g, w in zip((out, lse, dq, dk, dv), ref[:5]):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_varlen_autograd_matches_the_cpu_route(cuda, causal, dtype):
    """``flash_attention(lengths=)`` with a gradient on the card (the
    forward, dQ and dK/dV with ``lengths``, once each) against the same
    call on the CPU (the plain versions): output and gradients within 1e-5
    (float32) or ``BF16_TOL``; the gradient of every padded key exactly
    0."""
    q, k, v, do, _ = _causal_inputs(cuda, 200, 200, 64, False, seed=4)
    if dtype == torch.bfloat16:
        q, k, v, do = _bf16(q, k, v, do)
    q4, k4, v4, do4 = (t.view(2, 3, 200, 64) for t in (q, k, v, do))
    lengths = torch.tensor([77, 200], dtype=torch.int32)
    names = [("bf16_" if dtype == torch.bfloat16 else "") + n
             + ("_causal" if causal else "") + "_len_launches"
             for n in ("fwd", "dq", "dkv")]
    before = [getattr(fa, n) for n in names]
    res = {}
    for dev in ("cuda", "cpu"):
        x = [t.to(dev).detach().requires_grad_(True) for t in (q4, k4, v4)]
        out = fa.flash_attention(*x, causal=causal,
                                 lengths=lengths.to(dev))
        res[dev] = (out,) + torch.autograd.grad(out, x, do4.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert [getattr(fa, n) for n in names] == [n + 1 for n in before]
    tol = BF16_TOL if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=ATOL)
    for g, w in zip(res["cuda"], res["cpu"]):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.detach().float().cpu(),
                                   w.detach().float(), **tol)
    for g in res["cuda"][2:]:
        assert int(torch.count_nonzero(g[0, :, 77:])) == 0


# -- the float32 backward walks only the tiles that hold a visible pair -------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mask", "mask_bias", "mask_kbias"])
def test_backward_skips_empty_tiles_and_matches_plain_version(cuda, kind):
    """A sparse mask whose query rows 64-127 and key columns 64-191 hold
    no visible pair, alone, with a dense bias and with a strip: with Q and
    dO NaN on those rows and K and V NaN on those keys, the forward, dQ,
    dK/dV, dbias and dkbias equal bit for bit the same call on finite
    values (the kernels never read a skipped tile), which matches the plain
    version; dbias is exactly 0 on every pair no row sees."""
    b, h, s_q, s_kv, d = 2, 3, 200, 300, 64
    q, k, v, do, _ = _causal_inputs(cuda, s_q, s_kv, d, False, seed=41)
    rng = np.random.RandomState(41)
    m = rng.rand(fa._group_rows("b", b * h, h), s_q, s_kv) < 0.3
    m[:, :, -1] = True                     # the ragged last key tile
    m[:, 64:128, :] = False                # a query tile that sees nothing
    m[:, :, 64:192] = False                # two key tiles no row sees
    mask = torch.from_numpy(m.astype(np.uint8)).to(cuda)
    bias = kbias = None
    if kind != "mask":
        bias, kbias = _bias_of(cuda, "kbias" if kind == "mask_kbias"
                               else "bias", "h", s_q, s_kv, seed=42)
    walk = fa.walked_tiles(b * h, h, s_q, s_kv, mask=mask, gmode="b")
    assert 0 < int(walk.sum()) < walk.numel()
    assert not walk[:, 1].any() and not walk[:, :, 1:3].any()
    qn, don, kn, vn = q.clone(), do.clone(), k.clone(), v.clone()
    qn[:, 64:128], don[:, 64:128] = float("nan"), float("nan")
    kn[:, 64:192], vn[:, 64:192] = float("nan"), float("nan")
    args = (mask, "b", bias, kbias, "h", False, 0.37)
    got = _run_kernels(kind, qn, kn, vn, don, None, *args)
    ref = _run_kernels(kind, q, k, v, do, None, *args)
    torch.cuda.synchronize()
    for g, w, name in zip(got, ref, ("out", "lse", "dq", "dk", "dv",
                                     "dbias", "dkbias")):
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g, w), name
    out, lse, dq, dk, dv, dbias, dkbias = ref
    want = fa.flash_bwd_bias_plain(q, k, v, None, bias, kbias, "h", h, out,
                                   lse, do, 0.37, mask=mask, gmode="b")
    for g, w, name in zip((dq, dk, dv, dbias, dkbias), want,
                          ("dq", "dk", "dv", "dbias", "dkbias")):
        if g is not None:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=ATOL, msg=name)
    assert int(torch.count_nonzero(dk[:, 64:192])) == 0
    assert int(torch.count_nonzero(dv[:, 64:192])) == 0
    if dbias is not None:
        valid = fa._valid(b * h, s_q, s_kv, cuda, mask=mask, gmode="b",
                          heads=h).expand(b * h, s_q, s_kv)
        assert int(torch.count_nonzero(dbias[~valid])) == 0
    if dkbias is not None:
        assert int(torch.count_nonzero(dkbias[:, 0, 64:192])) == 0


#: every float32 instantiation of dQ and dK/dV: (kind, causal, D)
F32_BWD_CASES = [(kind, causal, d)
                 for kind in ("dense", "bias", "kbias", "mask", "mask_bias",
                              "mask_kbias")
                 for causal in (False, True) for d in (64, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,causal,d", F32_BWD_CASES)
def test_f32_backward_is_the_same_from_run_to_run(cuda, kind, causal, d):
    """Every float32 dQ and dK/dV instantiation owns its rows or keys and
    sums in a fixed order (no atomics): two runs on the same inputs give
    dQ, dK, dV, dbias and dkbias equal bit for bit."""
    s_q, s_kv = 200, 330
    q, k, v, do, km = _causal_inputs(cuda, s_q, s_kv, d, True, s_q + d)
    mask = None
    if kind.startswith("mask"):
        rng = np.random.RandomState(d)
        mask = torch.from_numpy((rng.rand(fa._group_rows("b", 6, 3), s_q,
                                          s_kv) < 0.4).astype(np.uint8)
                                ).to(cuda)
    bias = kbias = None
    if kind.endswith("bias"):
        bias, kbias = _bias_of(cuda, "kbias" if kind.endswith("kbias")
                               else "bias", "h", s_q, s_kv, seed=d)
    runs = [_run_kernels(kind, q, k, v, do, km, mask, "b", bias, kbias, "h",
                         causal, 0.37)[2:] for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, name in zip(runs[0], runs[1],
                          ("dq", "dk", "dv", "dbias", "dkbias")):
        assert (a is None) == (b is None), name
        if a is not None:
            assert bool(torch.isfinite(a).all()), name
            assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "bias", "kbias", "mask"])
def test_masked_key_tiles_are_skipped_and_get_zero_grads(cuda, kind):
    """A key mask with whole 64-key tiles masked (tiles 1 and 3 of batch
    row 0, all but the first 40 keys of row 1): dK = dV (= dkbias) = 0
    exactly on every masked key, and with K and V NaN on the masked tiles
    every output equals the call on finite values bit for bit."""
    b, h, s_q, s_kv, d = 2, 3, 150, 300, 64
    q, k, v, do, _ = _causal_inputs(cuda, s_q, s_kv, d, False, seed=7)
    kmn = np.ones((b, s_kv), np.int32)
    kmn[0, 64:128] = kmn[0, 192:256] = 0
    kmn[1, 40:] = 0
    km = torch.from_numpy(kmn).to(cuda)
    mask = None
    if kind == "mask":
        rng = np.random.RandomState(8)
        mask = torch.from_numpy((rng.rand(fa._group_rows("bh", 6, 3), s_q,
                                          s_kv) < 0.5).astype(np.uint8)
                                ).to(cuda)
    bias = kbias = None
    if kind in ("bias", "kbias"):
        bias, kbias = _bias_of(cuda, kind, "b", s_q, s_kv, seed=9)
    dead = torch.zeros(b * h, s_kv, dtype=torch.bool, device=cuda)
    dead[:3, 64:128] = dead[:3, 192:256] = True
    dead[3:, 64:] = True                   # whole tiles past the first
    kn, vn = k.clone(), v.clone()
    kn[dead], vn[dead] = float("nan"), float("nan")
    args = (km, mask, "bh", bias, kbias, "b", False, 0.37)
    got = _run_kernels(kind, q, kn, vn, do, *args)
    ref = _run_kernels(kind, q, k, v, do, *args)
    torch.cuda.synchronize()
    for g, w, name in zip(got, ref, ("out", "lse", "dq", "dk", "dv",
                                     "dbias", "dkbias")):
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g, w), name
    _, _, _, dk, dv, _, dkbias = ref
    masked = (km == 0).repeat_interleave(h, dim=0)
    assert int(torch.count_nonzero(dk[masked])) == 0
    assert int(torch.count_nonzero(dv[masked])) == 0
    if dkbias is not None:
        assert int(torch.count_nonzero(dkbias[:, 0][masked])) == 0


# -- the CNN ops (cuDNN through torch.nn.functional; no hand kernel) ---------
#: (op, data_format) at ResNet-18's kinds of call, small shapes: a 3x3
#: stride-2 convolution, a 1x1 one, the bias op, both pools (the average
#: with padding above half the kernel, which the op pads itself), BatchNorm
#: in training and in inference
CNN_CASES = [("conv", "NCHW"), ("conv", "NHWC"), ("conv_1x1", "NCHW"),
             ("conv_bias", "NHWC"), ("max_pool", "NCHW"),
             ("max_pool", "NHWC"), ("avg_pool", "NCHW"),
             ("avg_pool_pad", "NHWC"), ("bn_train", "NCHW"),
             ("bn_train", "NHWC"), ("bn_eval", "NCHW")]
#: float32 card against CPU: the convolutions sum in another order (TF32
#: off).  bf16: each side rounds once from float32 sums in another order,
#: and BatchNorm's scale and bias gradients sum 256 bf16 products whose
#: terms cancel (0.25 apart on a largest value of 101 measured): held to
#: ``BF16_TOL``'s rtol and its atol times the output's largest magnitude
CNN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: BF16_TOL}


def _cnn_call(op, df):
    """(node, numpy inputs, how many of them are differentiated,
    training)."""
    from hetu_tpu_torch import ops
    rng = np.random.RandomState(len(op) + len(df))
    nhwc = df == "NHWC"

    def act(c, hw):
        shape = (4, hw, hw, c) if nhwc else (4, c, hw, hw)
        return rng.randn(*shape).astype(np.float32)

    from hetu_tpu_torch.graph.node import Variable, placeholder_op
    xs = [placeholder_op(f"x{i}") for i in range(3)]
    if op.startswith("conv"):
        k = 1 if op == "conv_1x1" else 3
        arrays = [act(16, 8), rng.randn(32, 16, k, k).astype(np.float32)
                  * 0.1]
        if op == "conv_bias":
            arrays.append(rng.randn(32).astype(np.float32))
            node = ops.conv2d_add_bias_op(*xs, stride=2, padding=1,
                                          data_format=df)
        else:
            node = ops.conv2d_op(xs[0], xs[1], stride=2,
                                 padding=0 if k == 1 else 1, data_format=df)
        return node, arrays, len(arrays), True
    if op.endswith("pool") or op.endswith("pool_pad"):
        kind = "max" if op.startswith("max") else "avg"
        k, s, p = (2, 2, 2) if op.endswith("_pad") else (4, 4, 0)
        node = getattr(ops, f"{kind}_pool2d_op")(xs[0], k, k, p, s,
                                                 data_format=df)
        return node, [act(16, 8)], 1, True
    scale = rng.rand(16).astype(np.float32) + 0.5
    bias = rng.randn(16).astype(np.float32)
    node = ops.batch_normalization_op(
        xs[0], Variable("s", value=scale), Variable("b", value=bias),
        momentum=0.9, data_format=df)
    arrays = [act(16, 8) * 2.0 + 1.0, scale, bias,
              rng.randn(16).astype(np.float32),
              rng.rand(16).astype(np.float32) + 0.5]
    return node, arrays, 3, op == "bn_train"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("op,df", CNN_CASES)
def test_cnn_op_on_the_card_matches_the_cpu(cuda, op, df, dtype):
    """The op's value, the gradients of its differentiated inputs and (in
    BatchNorm's training) both running statistics, on the card against the
    port's CPU run of the same lowering."""
    from hetu_tpu_torch.graph.node import LowerCtx
    node, arrays, n_diff, training = _cnn_call(op, df)
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            ts = [torch.from_numpy(a).to(dev, dtype).requires_grad_(
                i < n_diff) for i, a in enumerate(arrays)]
            ctx = LowerCtx(training)
            out = node.lower(ctx, *ts)
            if not results:
                g = torch.from_numpy(np.random.RandomState(5).randn(
                    *out.shape).astype(np.float32))
            grads = torch.autograd.grad(out, ts[:n_diff], g.to(dev, dtype))
            stats = [ctx.state_updates[n] for n in
                     (getattr(node, "running_mean", None),
                      getattr(node, "running_var", None))
                     if n in ctx.state_updates]
            results.append([t.detach().float().cpu().numpy()
                            for t in [out, *grads, *stats]])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert out.device.type == "cuda" and out.dtype == dtype
    assert len(results[1]) == 1 + n_diff + (2 if op == "bn_train" else 0)
    for want, got in zip(*results):
        assert np.all(np.isfinite(got))
        tol = dict(CNN_TOL[dtype])
        if dtype == torch.bfloat16:
            tol["atol"] *= max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, **tol)


# -- the executor's run surface on the card --------------------------------


def _mlp_steps(monkeypatch, mode, n=8):
    """A two-product MLP on the card under Adam, ``n`` steps of seeded
    feeds: the plain ``run()`` loop, or ``run_steps(sync=False)`` with
    every next step's feeds placed ahead on the side stream.  Returns the
    losses (bytes), the final weights and the run-plan counters."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import metrics
    monkeypatch.setenv("HETU_FEED_PIPELINE_MIN_US", "0")
    monkeypatch.setenv("HETU_ASYNC_WINDOW", "2")
    rng = np.random.RandomState(0)
    x = ht.placeholder_op("x", shape=(256, 512))
    w1 = ht.Variable("w1", value=rng.randn(512, 1024).astype(np.float32)
                     * 0.05)
    w2 = ht.Variable("w2", value=rng.randn(1024, 16).astype(np.float32)
                     * 0.05)
    h = ht.matmul_op(ht.relu_op(ht.matmul_op(x, w1)), w2)
    loss = ht.reduce_mean_op(h * h, [0, 1])
    ex = ht.Executor({"train": [loss,
                                ht.optim.AdamOptimizer(1e-3).minimize(loss)]},
                     seed=0, device="cuda", validate="error")
    feeds = [rng.randn(256, 512).astype(np.float32) for _ in range(n)]
    metrics.reset_run_plan_counts()
    if mode == "loop":
        outs = [ex.run("train", feed_dict={x: f}) for f in feeds]
    else:
        outs = ex.run_steps(lambda i: {x: feeds[i]}, n, name="train",
                            sync=False)
        assert len(ex._async_pending) == 2
    losses = [o[0].asnumpy().tobytes() for o in outs]
    ex.ps_flush()
    assert not ex._async_pending
    return losses, ex.return_tensor_values(), metrics.run_plan_counts()


@pytest.mark.gpu
def test_run_steps_on_the_card_is_bit_equal_to_the_loop(cuda, monkeypatch):
    """Feeds copied ahead from pinned memory on the side stream, the
    compute stream waiting on each copy's event, and a window of two CUDA
    events: the same bits as the plain loop."""
    want, w_want, _ = _mlp_steps(monkeypatch, "loop")
    got, w_got, counts = _mlp_steps(monkeypatch, "steps")
    assert got == want
    for k in w_want:
        np.testing.assert_array_equal(w_got[k], w_want[k])
    assert counts["feeds_pipelined"] == 7
    assert counts["plan_cache_miss"] == 1 and counts["plan_cache_hit"] == 7
    # six steps past the window of two, and the flush
    assert counts["async_sync_points"] == 7


# -- the transformer families' new shapes (Swin windows, head dim 41) -----------

def _entry_vs_plain(cuda, dtype, b, h, s_q, s_kv, d, causal=False, mask=None,
                    bias=None, seed=0):
    """Out and the gradients of q, k, v and the bias through the flash entry
    (``fa.flash_attention``, the autograd function) and through the plain
    attention (``sdpa_reference``) on the same inputs; returns both and
    the launch counters' increments."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(cuda, dtype).requires_grad_(True)
               for s in (s_q, s_kv, s_kv))
    if bias is not None:
        bias = bias.detach().requires_grad_(True)
    cot = torch.from_numpy(rng.randn(b, h, s_q, d).astype(np.float32)) \
        .to(cuda, dtype)
    wrt = (q, k, v) + ((bias,) if bias is not None else ())
    before = {n: c for n, c in vars(fa).items() if n.endswith("launches")}
    out = fa.flash_attention(q, k, v, causal=causal, mask=mask, bias=bias)
    got = (out,) + torch.autograd.grad(out, wrt, cot)
    torch.cuda.synchronize()
    counts = {n: c - before[n] for n, c in vars(fa).items()
              if n.endswith("launches") and c != before[n]}
    ref = sdpa_reference(q, k, v, causal=causal, mask=mask, bias=bias)
    want = (ref,) + torch.autograd.grad(ref, wrt, cot)
    return got, want, counts


def _close(got, want, dtype):
    tol = BF16_TOL if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [True, False])
def test_swin_window_attention_matches_plain_version(cuda, shifted, dtype):
    """Swin-T stage 2's windows (res 28, window 7, 6 heads of 32, batch
    2: 32 windows of 49 tokens, each one ragged 64-row tile): the bias of
    group ``h`` alone (unshifted blocks) or with the shift mask of group
    ``b`` tiled over the windows (shifted blocks), through the entry
    against the plain attention, forward and every gradient."""
    from hetu_tpu_torch.models.swin import _rel_bias_index, _shift_mask
    b, res, w, heads = 2, 28, 7, 6
    nwin = b * (res // w) ** 2
    rng = np.random.RandomState(3)
    table = rng.randn((2 * w - 1) ** 2, heads).astype(np.float32) * 0.5
    bias = torch.from_numpy(np.ascontiguousarray(
        table[_rel_bias_index(w)].reshape(w * w, w * w, heads)
        .transpose(2, 0, 1)[None])).to(cuda)
    mask = None
    if shifted:
        m = _shift_mask(res, res, w, w // 2)[:, None]      # (nW, 1, 49, 49)
        mask = torch.from_numpy(np.tile(m, (b, 1, 1, 1))).to(cuda)
    got, want, counts = _entry_vs_plain(cuda, dtype, nwin, heads, w * w,
                                        w * w, 32, mask=mask, bias=bias)
    _close(got, want, dtype)
    sfx = "_mask_bias_launches" if shifted else "_bias_launches"
    pre = "bf16_" if dtype == torch.bfloat16 else ""
    assert counts == {pre + k + sfx: 1 for k in ("fwd", "dq", "dkv")}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_41_launches_the_kernels_padded(cuda, dtype):
    """Transformer-XL wt103's attention (10 heads of 41, 128 queries over
    160 memory + 128 segment keys, causal from the bottom right, the
    relative bias of group ``h``): the entry pads D to 44 (float32) or 48
    (bf16), keeps the scale at 1/sqrt(41) and slices back; out and every
    gradient match the plain attention at D = 41, and each of the three
    launches counts also in ``dpad_launches``."""
    b, h, s_q, s_kv, d = 2, 10, 128, 288, 41
    bias = torch.randn(1, h, s_q, s_kv, device=cuda) * 0.5
    got, want, counts = _entry_vs_plain(cuda, dtype, b, h, s_q, s_kv, d,
                                        causal=True, bias=bias, seed=4)
    _close(got, want, dtype)
    pre = "bf16_" if dtype == torch.bfloat16 else ""
    assert counts == dict({pre + k + "_bias_causal_launches": 1
                           for k in ("fwd", "dq", "dkv")}, dpad_launches=3)
