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
    tnode = tops.kv_cache_append_op(torch_ph("c"), torch_ph("n"),
                                    torch_ph("p"))
    with pytest.raises(NotImplementedError, match="chunked"):
        tnode.lower(TorchCtx(False), torch.zeros(1, 1, 8, 2),
                    torch.zeros(1, 1, 2, 2), torch.zeros(1, dtype=torch.int32))


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


def test_sdpa_decode_on_cpu_takes_the_plain_version_and_counts_it():
    q = _rand(3, 2, 1, 8)
    kc, vc = _rand(3, 2, 6, 8, seed=1), _rand(3, 2, 6, 8, seed=2)
    pos = np.asarray([0, 5, 2], np.int32)
    metrics.reset_flash_fallbacks()
    got, want = _both("sdpa_decode_op", [q, kc, vc, pos])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}
