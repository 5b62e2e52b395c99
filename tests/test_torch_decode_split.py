"""The decode kernel's split-KV scheme on the CPU: the split plan
(``decode_split_plan``, made from shapes alone) and the plain split-and-
merge version (``flash_fwd_split_plain``) against the JAX package's flash
attention with ``lengths`` in interpret mode (as
tests/test_torch_flash_attention.py runs it) and against ``flash_fwd_plain``.
The CUDA kernels themselves are held to both plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py phase 2).

Tolerance: atol 1e-5 (float32; the splits sum in another order than one
softmax), lse within 1e-5; NaN past the lengths must change no bit."""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

ATOL = 1e-5
B, H, D, S_KV = 4, 2, 32, 200
#: lengths 0 (every split empty), 1, a partial second tile, the whole cache
LENS = [0, 1, 70, S_KV]
#: plans of the 4 key tiles: one split, even splits, a tile a split, a short
#: last split, and splits wholly past the cache
PLANS = [(1, 4), (2, 2), (4, 1), (3, 2), (8, 1)]
#: (BH, S_q, S_kv, SMs): the kernels line, phase 3's largest and smallest
#: buckets, a long cache at one row, four query rows, an empty cache, a
#: batch wider than the card
PLAN_SHAPES = [(96, 1, 1024, 132), (96, 1, 384, 132), (12, 1, 1, 132),
               (12, 1, 1024, 132), (96, 4, 384, 132), (12, 1, 0, 132),
               (6144, 1, 1024, 132), (24, 1, 333, 78)]


def _inputs(s_q, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, s_q, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, H, S_KV, D) * 0.5).astype(np.float32)
    v = rng.randn(B, H, S_KV, D).astype(np.float32)
    return q, k, v, np.array(LENS, np.int32)


def _flat(x):
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(B * H, x.shape[2], x.shape[3])))


@functools.lru_cache(maxsize=None)
def _jax_reference(s_q):
    q, k, v, lens = _inputs(s_q)
    out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    lengths=jnp.asarray(lens), interpret=True)
    return np.asarray(out).reshape(B * H, s_q, D)


def _split(s_q, plan, nan_past=False):
    q, k, v, lens = _inputs(s_q)
    if nan_past:
        for b, n in enumerate(lens):
            k[b, :, n:] = np.nan
            v[b, :, n:] = np.nan
    return fa.flash_fwd_split_plain(_flat(q), _flat(k), _flat(v),
                                    torch.from_numpy(lens), H, D ** -0.5,
                                    plan)


@pytest.mark.parametrize("bh,s_q,s_kv,sms", PLAN_SHAPES)
def test_split_plan_covers_every_tile_once_in_order(bh, s_q, s_kv, sms):
    n_split, per = fa.decode_split_plan(bh, s_q, s_kv, sms)
    tiles = max(1, -(-s_kv // fa.DECODE_TILE))
    runs = [range(s * per, min((s + 1) * per, tiles)) for s in range(n_split)]
    assert [t for r in runs for t in r] == list(range(tiles))
    assert all(len(r) > 0 for r in runs)           # no split past the cache
    if n_split > 1:
        assert per >= fa.DECODE_MIN_SPLIT_TILES
        # the grid aims at no more than the card's CTA slots (a split fewer
        # would leave it short of them)
        assert bh * s_q * (n_split - 1) < fa.DECODE_CTAS_PER_SM * sms


@pytest.mark.parametrize("bh", [12, 96])
@pytest.mark.parametrize("s_kv", [1, 64, 128, 192])
def test_split_plan_keeps_a_short_cache_in_one_split(bh, s_kv):
    """A cache of at most three tiles: one split, so one launch."""
    assert fa.decode_split_plan(bh, 1, s_kv, 132)[0] == 1


def test_split_plan_fills_the_card_at_the_kernels_line():
    """B 8, H 12, L 1024 on a 132-SM card: at least two CTAs an SM, every
    split the same number of tiles."""
    n_split, per = fa.decode_split_plan(96, 1, 1024, 132)
    assert 96 * n_split >= 2 * 132
    assert n_split * per * fa.DECODE_TILE == 1024


@pytest.mark.parametrize("plan", PLANS)
def test_split_plain_matches_jax_pallas_interpret(plan):
    want = _jax_reference(1)
    out, lse = _split(1, plan)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)
    q, k, v, lens = _inputs(1)
    ref, lse_ref = fa.flash_fwd_plain(_flat(q), _flat(k), _flat(v),
                                      torch.from_numpy(lens), H, D ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert np.all(out.numpy()[:H] == 0.0)          # length 0: every split empty
    assert np.all(lse.numpy()[:H] == np.float32(fa.NEG_INF))


@pytest.mark.parametrize("plan", [(2, 2), (8, 1)])
def test_split_plain_at_several_query_rows(plan):
    out, _ = _split(3, plan)
    np.testing.assert_allclose(out.numpy(), _jax_reference(3), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("plan", [(1, 4), (3, 2), (8, 1)])
def test_split_plain_ignores_nan_past_lengths(plan):
    out, lse = _split(1, plan)
    out_n, lse_n = _split(1, plan, nan_past=True)
    assert torch.equal(out, out_n) and torch.equal(lse, lse_n)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    q, k, v, lens = _inputs(1)
    before = fa.launches, fa.merge_launches
    out, lse = fa.flash_fwd(_flat(q), _flat(k), _flat(v),
                            torch.from_numpy(lens), H, D ** -0.5, plan=(4, 1))
    ref, lse_ref = fa.flash_fwd_plain(_flat(q), _flat(k), _flat(v),
                                      torch.from_numpy(lens), H, D ** -0.5)
    assert torch.equal(out, ref) and torch.equal(lse, lse_ref)
    assert (fa.launches, fa.merge_launches) == before
