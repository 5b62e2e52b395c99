"""The MoE row gather's launch plan on the CPU.

``gather_plan`` (``hetu_tpu_torch/ops/kernels/moe_dispatch.py``) decides
the route, the grid and the blocks of rows of the CUDA row gather (B6,
float32 and bf16) from shapes, alignment and the SM count alone: TMA bulk
copies of whole rows in blocks of consecutive output rows for rows of
whole 16-byte units on aligned buffers, else one chunk a thread.  Here
each bulk plan is held to cover every output row exactly once, in order,
in blocks the kernel can take (at most 32 rows, one shared-memory stage),
spread evenly over a grid no wider than the card holds; and the plain
version, gathering the plan's blocks one by one, is held bit for bit to
the Pallas kernels in interpret mode and to ``row_gather_plain`` /
``gather_rows_plain`` (the slab gather, B4, has no plan: one chunk a
thread).  The CUDA kernels themselves are held to both plain versions on
the card (tests/test_torch_kernels_gpu.py, chip_smoke.py phases 8, 11 and
29)."""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu.ops.pallas import emb_cache as jemb  # noqa: E402
from hetu_tpu.ops.pallas.moe_dispatch import row_gather as jrow_gather  # noqa: E402
from hetu_tpu_torch.ops.kernels import emb_cache as temb  # noqa: E402
from hetu_tpu_torch.ops.kernels import moe_dispatch as tmd  # noqa: E402

#: an H100's SMs, and a card small enough that the MoE shapes take rounds
SMS = 132
#: n: none, one, a warp and either side of it, the MoE combine and
#: dispatch, the CTR plan's 53,248 ids
NS = [0, 1, 31, 32, 33, 8192, 20480, 53248]
WIDTHS = [13, 16, 512, 2048]
DTYPES = {"float32": 4, "bfloat16": 2}


def _check_plan(n, plan, cap):
    ctas, per = plan
    runs = tmd.gather_runs(n, plan)
    # every row once, in order, block after block
    starts = sorted(runs, key=lambda r: r[1])
    assert [i for _, a, z in starts for i in range(a, z)] == list(range(n))
    assert all(z > a for _, a, z in runs)
    assert 1 <= per <= 32                      # one lane an index
    assert 1 <= ctas <= cap
    # each CTA walks blocks cta, cta + ctas, ... in order, and every CTA
    # has one; no CTA takes more than one block beyond another
    blocks = {}
    for c, a, _ in runs:
        blocks.setdefault(c, []).append(a // per)
    assert sorted(blocks) == list(range(ctas))
    for c, bs in blocks.items():
        assert bs == sorted(bs) and {b % ctas for b in bs} == {c}
    counts = [len(bs) for bs in blocks.values()]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", NS)
def test_plan_covers_every_row_once_in_order(n, width, dtype):
    """The plans on aligned and 2-byte-offset sources: the bulk route for
    rows of whole 16-byte units on aligned buffers within a block's bytes,
    else (and for no rows) the chunk-a-thread route, ``(0, 0)``."""
    es = DTYPES[dtype]
    row_bytes = width * es
    for off in (0, 2):
        plan = tmd.gather_plan(n, width, es, off, 0, SMS)
        if n and off == 0 and row_bytes % 16 == 0 \
                and row_bytes <= tmd.BULK_BLOCK_BYTES:
            assert plan[1] * row_bytes <= tmd.BULK_BLOCK_BYTES
            _check_plan(n, plan, SMS * tmd.BULK_CTAS_PER_SM)
        else:
            assert plan == (0, 0) and tmd.gather_runs(n, plan) == []


def test_units_and_plans_at_the_main_paths_shapes():
    """The bulk route only for rows of whole 16-byte units on aligned
    buffers; the plans the MoE path launches on an H100."""
    assert tmd.gather_plan(4099, 512, 2, 2, 0, SMS) == (0, 0)   # src off
    assert tmd.gather_plan(4099, 512, 2, 0, 8, SMS) == (0, 0)   # out off
    assert tmd.gather_plan(4099, 13, 2, 0, 0, SMS) == (0, 0)    # 26 bytes
    # four CTAs an SM: bf16 (16 rows a block at most) the dispatch in three
    # rounds of 13-row blocks, the combine in one of 16; float32 (8 at
    # most) in five and two rounds of 8
    assert tmd.gather_plan(20480, 512, 2, 0, 0, SMS) == (528, 13)
    assert tmd.gather_plan(8192, 512, 2, 0, 0, SMS) == (512, 16)
    assert tmd.gather_plan(20480, 512, 4, 0, 0, SMS) == (528, 8)
    assert tmd.gather_plan(8192, 512, 4, 0, 0, SMS) == (528, 8)
    # a row of a whole block is a block alone; a longer one takes the
    # chunk-a-thread route; 64-byte rows take blocks of 32
    assert tmd.gather_plan(3001, 4096, 4, 0, 0, SMS) == (528, 1)
    assert tmd.gather_plan(3001, 8192, 4, 0, 0, SMS) == (0, 0)
    assert tmd.gather_plan(300000, 16, 4, 0, 0, SMS) == (528, 32)
    assert tmd.gather_plan(0, 512, 2, 0, 0, SMS) == (0, 0)


def _blocked(src, idx, plan):
    """The plain version gathering ``plan``'s blocks one by one (the whole
    of ``idx`` as one block on the chunk-a-thread route)."""
    n = idx.shape[0]
    out = src.new_empty((n, src.shape[1]))
    for _, start, stop in tmd.gather_runs(n, plan) or [(0, 0, n)]:
        out[start:stop] = tmd.row_gather_plain(src, idx[start:stop])
    return out


def _inputs(n, width):
    rng = np.random.RandomState(n + width)
    src = rng.randn(40, width).astype(np.float32)
    idx = rng.randint(-1, 40, size=n).astype(np.int32)
    idx[:min(n, 3)] = -1
    return src, idx


@functools.lru_cache(maxsize=None)
def _pallas(dtype, n, width):
    """The Pallas kernels in interpret mode on ``_inputs``: the MoE gather,
    and in float32 the slab gather at the indices' absolute values."""
    src, idx = _inputs(n, width)
    moe = np.asarray(jrow_gather(jnp.asarray(src, dtype), jnp.asarray(idx),
                                 interpret=True))
    emb = np.asarray(jemb.gather_rows(jnp.asarray(src),
                                      jnp.asarray(np.abs(idx)),
                                      interpret=True)) \
        if dtype == "float32" else None
    return moe, emb


@pytest.mark.parametrize("sms", [1, 2, SMS])
@pytest.mark.parametrize("n,width", [(1, 16), (37, 13), (100, 512),
                                     (300, 8)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blocked_twin_matches_pallas_kernels_and_plain(dtype, n, width, sms):
    """The plan's blocks for ``sms`` SMs (a grid of 4 or 8 CTAs takes
    several rounds), each gathered by the plain version: bit for bit the
    MoE Pallas kernel in interpret mode and ``row_gather_plain`` (-1 rows
    zero), and, in float32 with every index valid, the slab gather's
    Pallas kernel and ``gather_rows_plain``."""
    src, idx = _inputs(n, width)
    want, want_emb = _pallas(dtype, n, width)
    es = DTYPES[dtype]
    jsrc = jnp.asarray(src, dtype)
    tsrc = torch.from_numpy(np.array(jsrc.astype(jnp.float32))).to(
        getattr(torch, dtype))
    plan = tmd.gather_plan(n, width, es, 0, 0, sms)
    got = _blocked(tsrc, torch.from_numpy(idx), plan)
    bits, tbits = ((np.uint16, torch.int16) if dtype == "bfloat16"
                   else (np.uint32, torch.int32))
    assert got.dtype == tsrc.dtype and got.shape == (n, width)
    np.testing.assert_array_equal(got.view(tbits).numpy().view(bits),
                                  want.view(bits))
    assert torch.equal(got.view(tbits),
                       tmd.row_gather_plain(tsrc, torch.from_numpy(idx))
                       .view(tbits))
    if dtype == "float32":
        slots = torch.from_numpy(np.abs(idx))
        got = temb.gather_rows_plain(tsrc, slots)
        np.testing.assert_array_equal(got.numpy(), want_emb)
        assert torch.equal(got, _blocked(tsrc, slots, plan))


@pytest.mark.parametrize("n,width,rows,dtype", [
    (20480, 512, 8192, "bfloat16"), (8192, 512, 20480, "bfloat16"),
    (20480, 512, 8192, "float32"), (53248, 16, 63249, "float32")])
def test_blocked_twin_at_the_main_paths_shapes(n, width, rows, dtype):
    """At the MoE dispatch and combine and the CTR plan's shapes, the
    plan an H100 launches, its blocks gathered one by one: bit for bit
    ``row_gather_plain`` (at the CTR shape, every index valid, also
    ``gather_rows_plain``, the slab gather's plain version)."""
    rng = np.random.RandomState(n)
    src = torch.from_numpy(rng.randn(rows, width).astype(np.float32)).to(
        getattr(torch, dtype))
    idx = torch.from_numpy(rng.randint(-1, rows, n).astype(np.int32))
    plan = tmd.gather_plan(n, width, DTYPES[dtype], 0, 0, SMS)
    assert plan[0] > 0
    got = _blocked(src, idx, plan)
    assert torch.equal(got, tmd.row_gather_plain(src, idx))
    if width == 16:
        slots = idx.abs()
        assert torch.equal(_blocked(src, slots, plan),
                           temb.gather_rows_plain(src, slots))
