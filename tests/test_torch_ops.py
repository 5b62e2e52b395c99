"""Each op lowering of the port against the JAX package's lowering of the
same op on the same numpy inputs (atol 1e-6, float32)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu.ops as jops                                  # noqa: E402
from hetu_tpu.graph.node import LowerCtx as JaxCtx           # noqa: E402
from hetu_tpu.graph.node import placeholder_op as jax_ph     # noqa: E402
import hetu_tpu_torch.ops as tops                            # noqa: E402
from hetu_tpu_torch import metrics                           # noqa: E402
from hetu_tpu_torch.graph.node import LowerCtx as TorchCtx   # noqa: E402
from hetu_tpu_torch.graph.node import placeholder_op as torch_ph  # noqa: E402

ATOL = 1e-6


def _both(name, arrays, **attrs):
    """Lower op ``name`` in both packages on the same numpy inputs."""
    jnode = getattr(jops, name)(*[jax_ph(f"x{i}") for i in range(len(arrays))],
                                **attrs)
    tnode = getattr(tops, name)(*[torch_ph(f"x{i}")
                                  for i in range(len(arrays))], **attrs)
    want = jnode.lower(JaxCtx(False), *[jnp.asarray(a) for a in arrays])
    got = tnode.lower(TorchCtx(False), *[torch.from_numpy(np.array(a))
                                         for a in arrays])
    assert tnode.op_type == jnode.op_type
    return np.asarray(got), np.asarray(want)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


BINARY = ["add_op", "minus_op", "mul_op", "div_op"]
CONST = ["addbyconst_op", "minusbyconst_op", "mulbyconst_op",
         "div_const_op", "const_div_op"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_elementwise(name):
    a, b = _rand(4, 6), _rand(4, 6, seed=1) + 3.0
    got, want = _both(name, [a, b])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", CONST)
def test_const_elementwise(name):
    got, want = _both(name, [_rand(5, 3) + 4.0], const_attr=0.75)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,attrs", [("opposite_op", {}),
                                        ("pow_op", {"p": 3.0})])
def test_unary_elementwise(name, attrs):
    got, want = _both(name, [_rand(3, 7)], **attrs)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_operator_overloads_build_the_same_op_types():
    a, b = torch_ph("a"), torch_ph("b")
    ja, jb = jax_ph("a"), jax_ph("b")
    for t, j in ((a + b, ja + jb), (a - 2.0, ja - 2.0), (3.0 - a, 3.0 - ja),
                 (a * b, ja * jb), (a * 2.0, ja * 2.0), (a / b, ja / jb),
                 (a / 4.0, ja / 4.0), (2.0 / a, 2.0 / ja), (-a, -ja),
                 (a ** 2, ja ** 2), (a @ b, ja @ jb)):
        assert t.op_type == j.op_type


def test_gelu_tanh_approximation():
    got, want = _both("gelu_op", [_rand(8, 16) * 3.0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_layer_norm_biased_variance():
    x = _rand(6, 32) * 2.0 + 1.0
    scale, bias = _rand(32, seed=1), _rand(32, seed=2)
    got, want = _both("layer_normalization_op", [x, scale, bias], eps=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("trans_A,trans_B", [(False, False), (True, False),
                                             (False, True)])
def test_matmul(trans_A, trans_B):
    # weights at the decode path's scale (init std 0.02-0.2), so outputs
    # are O(1) and float32 rounding of the sum stays below atol
    a = _rand(*((12, 5) if trans_A else (5, 12)))
    b = _rand(*((7, 12) if trans_B else (12, 7)), seed=1) * 0.2
    got, want = _both("matmul_op", [a, b], trans_A=trans_A, trans_B=trans_B)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_linear():
    got, want = _both("linear_op", [_rand(4, 16), _rand(16, 8, seed=1) * 0.2,
                                    _rand(8, seed=2) * 0.2])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_dropout_is_identity_when_serving():
    x = _rand(4, 4)
    got, want = _both("dropout_op", [x], keep_prob=0.5)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)


@pytest.mark.parametrize("idx_shape", [(4, 1), (5,)])
def test_embedding_lookup(idx_shape):
    table = _rand(11, 6)
    idx = np.random.RandomState(3).randint(0, 11, size=idx_shape) \
        .astype(np.int32)
    got, want = _both("embedding_lookup_op", [table, idx])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_reshape_and_transpose():
    x = _rand(3, 8)
    got, want = _both("array_reshape_op", [x], output_shape=(-1, 1, 2, 4))
    np.testing.assert_array_equal(got, want)
    y = _rand(3, 1, 2, 4)
    got, want = _both("transpose_op", [y], perm=(0, 2, 1, 3))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got, want = _both("transpose_op", [x])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("positions", [[0, 3, 5], [7, 2, 11], [-2, 0, -20]])
def test_kv_cache_append_with_clamped_start(positions):
    """Row writes at ``positions``; starts follow ``dynamic_update_slice``:
    past the last row (11 in an 8-row cache) clamps to it, a negative
    start counts from the end (-2 → row 6) and then clamps (-20 → row 0).
    The port writes in place."""
    cache = _rand(3, 2, 8, 4)
    new = _rand(3, 2, 1, 4, seed=1)
    pos = np.asarray(positions, np.int32)
    got, want = _both("kv_cache_append_op", [cache, new, pos])
    np.testing.assert_array_equal(got, want)
    tnode = tops.kv_cache_append_op(torch_ph("c"), torch_ph("n"),
                                    torch_ph("p"))
    c = torch.from_numpy(cache.copy())
    out = tnode.lower(TorchCtx(False), c, torch.from_numpy(new),
                      torch.from_numpy(pos))
    assert out.data_ptr() == c.data_ptr()
    np.testing.assert_array_equal(c.numpy(), want)


def test_kv_cache_append_refuses_chunked_writes():
    """Chunked writes are ported; the one refused is a chunk wider than
    the cache (``dynamic_update_slice`` refuses it at trace time too)."""
    tnode = tops.kv_cache_append_op(torch_ph("c"), torch_ph("n"),
                                    torch_ph("p"))
    with pytest.raises(ValueError, match="chunked"):
        tnode.lower(TorchCtx(False), torch.zeros(1, 1, 2, 2),
                    torch.zeros(1, 1, 3, 2), torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("positions,valid", [
    ([0, 3, 5], None), ([0, 3, 5], [3, 1, 0]), ([6, 2, 11], [3, 3, 2]),
    ([-2, 0, -20], [2, 3, 1]), ([1, 1, 1], [0, 0, 0]), ([5, 5, 5], [9, 3, 3])])
def test_kv_cache_append_chunked_with_valid(positions, valid):
    """A (B, H, 3, D) chunk at ``positions``, rows ``>= valid[b]`` not
    written (the old cache bytes stay): equal to the JAX op exactly,
    starts clamped into [0, L - 3] as ``dynamic_update_slice`` clamps
    them, and written in place."""
    cache = _rand(3, 2, 8, 4)
    new = _rand(3, 2, 3, 4, seed=1)
    arrays = [cache, new, np.asarray(positions, np.int32)]
    if valid is not None:
        arrays.append(np.asarray(valid, np.int32))
    got, want = _both("kv_cache_append_op", arrays)
    np.testing.assert_array_equal(got, want)
    tnode = tops.kv_cache_append_op(*[torch_ph(f"x{i}")
                                      for i in range(len(arrays))])
    c = torch.from_numpy(cache.copy())
    out = tnode.lower(TorchCtx(False), c,
                      *[torch.from_numpy(a) for a in arrays[1:]])
    assert out.data_ptr() == c.data_ptr()
    np.testing.assert_array_equal(c.numpy(), want)


@pytest.mark.parametrize("valid", [[3, 1, 0], [2, 3, 3]])
def test_kv_cache_append_chunk_equals_one_token_appends(valid):
    """One masked 3-row write leaves the bytes of ``valid[b]`` one-token
    writes at consecutive positions; rows past ``valid`` are untouched."""
    cache = _rand(3, 2, 8, 4)
    new = _rand(3, 2, 3, 4, seed=1)
    pos = np.asarray([0, 4, 5], np.int32)
    got, _ = _both("kv_cache_append_op",
                   [cache, new, pos, np.asarray(valid, np.int32)])
    step = tops.kv_cache_append_op(torch_ph("c"), torch_ph("n"),
                                   torch_ph("p"))
    want = torch.from_numpy(cache.copy())
    for b in range(3):
        for j in range(valid[b]):
            step.lower(TorchCtx(False), want[b:b + 1],
                       torch.from_numpy(new[b:b + 1, :, j:j + 1]),
                       torch.tensor([pos[b] + j], dtype=torch.int32))
    np.testing.assert_array_equal(got, want.numpy())


def test_chunk_positions_clamp_to_the_limit():
    pos = np.asarray([0, 5, 9], np.int32)
    ids = np.zeros((3, 4), np.int32)
    for limit in (None, 10):
        got, want = _both("chunk_positions_op", [pos, ids], limit=limit)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert got[2].tolist() == [9, 9, 9, 9]


def test_split_and_merge_heads_chunk():
    t = _rand(3 * 4, 2 * 5)
    ids = np.zeros((3, 4), np.int32)
    got, want = _both("split_heads_chunk_op", [t, ids], n_head=2)
    assert got.shape == want.shape == (3, 2, 4, 5)
    np.testing.assert_array_equal(got, want)
    back, jback = _both("merge_heads_chunk_op", [got])
    np.testing.assert_array_equal(back, jback)
    np.testing.assert_array_equal(back, t)


@pytest.mark.parametrize("valid", [[4, 1, 2], [0, 9, 3]])
def test_chunk_emit_gather_picks_the_last_consumed_row(valid):
    hidden = _rand(3 * 4, 6)
    ids = np.zeros((3, 4), np.int32)
    got, want = _both("chunk_emit_gather_op",
                      [hidden, ids, np.asarray(valid, np.int32)])
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_sdpa_prefill_on_cpu_takes_the_plain_version_and_counts_it(chunk):
    """Chunk-local query j sees keys < positions + j + 1; a slot whose
    window runs past the cache end only has don't-care rows."""
    q = _rand(3, 2, chunk, 8)
    kc, vc = _rand(3, 2, 12, 8, seed=1), _rand(3, 2, 12, 8, seed=2)
    pos = np.asarray([0, 4, 2], np.int32)
    metrics.reset_flash_fallbacks()
    got, want = _both("sdpa_prefill_op", [q, kc, vc, pos])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}


@pytest.mark.parametrize("kind", ["mask", "causal", "bias", "plain"])
def test_sdpa_reference(kind):
    q, k, v = _rand(2, 3, 5, 8), _rand(2, 3, 5, 8, seed=1), \
        _rand(2, 3, 5, 8, seed=2)
    kw_j, kw_t = {}, {}
    if kind == "mask":
        m = np.random.RandomState(4).rand(2, 1, 5, 5) > 0.5
        m[0, 0, 1] = False                  # a row with no valid key
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
    elif kind == "causal":
        kw_j["causal"] = kw_t["causal"] = True
    elif kind == "bias":
        bias = _rand(1, 3, 5, 5, seed=5)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    from hetu_tpu.ops.attention import sdpa_reference as jref
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw_j))
    got = tops.sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if kind == "mask":
        assert np.all(got[0, :, 1] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_bias_on_cpu_takes_the_plain_version_and_counts_it(causal):
    q, k, v = _rand(2, 3, 5, 8), _rand(2, 3, 5, 8, seed=1), \
        _rand(2, 3, 5, 8, seed=2)
    bias = _rand(1, 3, 5, 5, seed=5)
    metrics.reset_flash_fallbacks()
    got, want = _both("sdpa_bias_op", [q, k, v, bias], causal=causal,
                      scale=1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_masked_bias_on_cpu_takes_the_plain_version_and_counts_it(
        causal):
    q, k, v = _rand(2, 3, 5, 8), _rand(2, 3, 5, 8, seed=1), \
        _rand(2, 3, 5, 8, seed=2)
    mask = np.asarray([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]],
                      np.int32).reshape(2, 1, 1, 5)   # one row fully masked
    bias = _rand(2, 1, 5, 5, seed=6)
    metrics.reset_flash_fallbacks()
    got, want = _both("sdpa_masked_bias_op", [q, k, v, mask, bias],
                      causal=causal)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0)
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}


def test_rsqrt():
    got, want = _both("rsqrt_op", [np.abs(_rand(4, 9)) + 1e-3])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sdpa_decode_on_cpu_takes_the_plain_version_and_counts_it():
    q = _rand(3, 2, 1, 8)
    kc, vc = _rand(3, 2, 6, 8, seed=1), _rand(3, 2, 6, 8, seed=2)
    pos = np.asarray([0, 5, 2], np.int32)
    metrics.reset_flash_fallbacks()
    got, want = _both("sdpa_decode_op", [q, kc, vc, pos])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}


# -- ops of the BERT training graph -------------------------------------------

def test_ne_returns_the_first_inputs_dtype():
    """The ``masked_lm_loss`` pattern: int32 labels against the float32
    ``labels * 0.0 + -1.0``; the result is int32 in both packages."""
    labels = np.array([3, -1, 0, -1, 7], np.int32)
    got, want = _both("ne_op", [labels, labels * 0.0 - 1.0])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["reduce_sum_op", "reduce_mean_op"])
@pytest.mark.parametrize("axes,keepdims", [([0], False), ([1], True),
                                           (None, False)])
def test_reductions(name, axes, keepdims):
    # rtol 1e-6: the two libraries sum in different orders (a few ulp)
    got, want = _both(name, [_rand(4, 5)], axes=axes, keepdims=keepdims)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("name", ["reduce_sum_op", "reduce_mean_op"])
def test_reductions_of_int32_keep_the_jax_dtype(name):
    x = np.random.RandomState(0).randint(0, 2, size=(7,)).astype(np.int32)
    got, want = _both(name, [x], axes=[0])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_softmaxcrossentropy_sparse_with_ignored_labels():
    logits = _rand(6, 9) * 3.0
    labels = np.array([2, -1, 8, 0, -1, 5], np.int32)
    got, want = _both("softmaxcrossentropy_sparse_op", [logits, labels])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got[1] == 0.0 and got[4] == 0.0


def test_softmaxcrossentropy_dense_labels():
    logits = _rand(5, 4) * 2.0
    labels = np.eye(4, dtype=np.float32)[[0, 3, 1, 1, 2]]
    got, want = _both("softmaxcrossentropy_op", [logits, labels])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [{"begin": (0, 0, 0), "size": (2, 1, 4)},
                                {"begin": (1, 2, 0), "size": (1, -1, 3)},
                                {"begin": (0, 1, 1), "end": (2, 3, 4)}])
def test_slice(kw):
    got, want = _both("slice_op", [_rand(2, 3, 4)], **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_tanh():
    got, want = _both("tanh_op", [_rand(4, 8) * 3.0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_embedding_lookup_with_float32_position_ids():
    """BERT's position ids are a float32 variable; both packages cast
    them to integers before the gather."""
    table = _rand(16, 6)
    pos = np.arange(12, dtype=np.float32)
    got, want = _both("embedding_lookup_op", [table, pos])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["dense", "key_mask"])
def test_sdpa_ops_on_cpu_take_the_plain_version_and_count_it(kind):
    q, k, v = (_rand(2, 3, 7, 8, seed=i) for i in range(3))
    arrays, name = [q, k, v], "sdpa_op"
    if kind == "key_mask":
        m = np.ones((2, 1, 1, 7), np.int32)
        m[0, ..., 4:] = 0
        m[1] = 0                              # every key masked
        arrays, name = arrays + [m], "sdpa_masked_op"
    metrics.reset_flash_fallbacks()
    got, want = _both(name, arrays)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}


@pytest.mark.parametrize("keep_prob", [0.9, 0.5])
def test_training_dropout_statistics(keep_prob):
    """Training dropout zeroes about 1 - keep_prob of the elements and
    scales the survivors by 1 / keep_prob; the mask comes from the
    context's generator, so a reseeded generator repeats it."""
    x = torch.from_numpy(_rand(200, 500) + 5.0)      # no zeros in x
    node = tops.dropout_op(torch_ph("x"), keep_prob=keep_prob)

    def run(seed):
        return node.lower(TorchCtx(True, torch.Generator().manual_seed(seed)),
                          x)

    y = run(0)
    dropped = float((y == 0).float().mean())
    n = x.numel()
    sigma = np.sqrt(keep_prob * (1 - keep_prob) / n)
    assert abs(dropped - (1 - keep_prob)) < 5 * sigma
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / keep_prob, rtol=0, atol=0)
    assert torch.equal(run(0), y) and not torch.equal(run(1), y)


def test_training_dropout_needs_a_generator():
    node = tops.dropout_op(torch_ph("x"), keep_prob=0.5)
    with pytest.raises(RuntimeError, match="seed="):
        node.lower(TorchCtx(True), torch.ones(3))
