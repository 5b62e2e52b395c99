"""The port's flash attention (``lengths`` specialization) against the JAX
package: the plain PyTorch version the wrapper takes on CPU tensors is
held to ``flash_attention(..., lengths=..., interpret=True)`` (the Pallas
kernel run by its interpreter, as tests/test_pallas.py runs it) and to
``sdpa_reference`` with the length mask.  The CUDA kernel itself is held
to the same plain version on the card (tests/test_torch_kernels_gpu.py
and chip_smoke.py).

Tolerance: atol 1e-5 in float32 — the algorithms sum in different orders
(blockwise online softmax vs one softmax)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu.ops.attention import sdpa_reference as jax_sdpa_reference  # noqa: E402
from hetu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

ATOL = 1e-5
B, H, D = 3, 2, 32


def _inputs(s_q, s_kv, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, s_q, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, H, s_kv, D) * 0.5).astype(np.float32)
    v = rng.randn(B, H, s_kv, D).astype(np.float32)
    lengths = np.array([s_kv, 0, rng.randint(1, s_kv)], np.int32)
    return q, k, v, lengths


def _port(q, k, v, lengths):
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             lengths=torch.from_numpy(lengths))
    return out.numpy()


CASES = [(1, 16), (1, 40), (4, 16), (4, 40)]


@pytest.mark.parametrize("s_q,s_kv", CASES)
def test_plain_flash_matches_jax_pallas_interpret(s_q, s_kv):
    q, k, v, lengths = _inputs(s_q, s_kv)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), lengths=jnp.asarray(lengths),
                                interpret=True))
    got = _port(q, k, v, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0)       # the length-0 row outputs zero


@pytest.mark.parametrize("s_q,s_kv", CASES)
def test_plain_flash_matches_jax_sdpa_reference(s_q, s_kv):
    q, k, v, lengths = _inputs(s_q, s_kv, seed=1)
    mask = np.arange(s_kv)[None, None, None, :] \
        < lengths[:, None, None, None]
    want = np.asarray(jax_sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v),
                                         mask=jnp.asarray(mask)))
    got = _port(q, k, v, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s_q,s_kv", CASES)
def test_plain_flash_lse_matches_numpy(s_q, s_kv):
    q, k, v, lengths = _inputs(s_q, s_kv, seed=2)
    scale = 1.0 / np.sqrt(D)
    _, lse = fa.flash_fwd(
        torch.from_numpy(q.reshape(B * H, s_q, D)),
        torch.from_numpy(k.reshape(B * H, s_kv, D)),
        torch.from_numpy(v.reshape(B * H, s_kv, D)),
        torch.from_numpy(lengths), H, scale)
    lse = lse.numpy().reshape(B, H, s_q)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    for b in range(B):
        n = lengths[b]
        if n == 0:
            assert np.all(lse[b] == np.float32(fa.NEG_INF))
            continue
        sb = s[b, :, :, :n]
        m = sb.max(-1)
        want = m + np.log(np.exp(sb - m[..., None]).sum(-1))
        np.testing.assert_allclose(lse[b], want, rtol=0, atol=ATOL)


def test_lengths_past_the_cache_clamp_to_it():
    q, k, v, _ = _inputs(1, 16, seed=3)
    full = np.full(B, 16, np.int32)
    over = np.full(B, 99, np.int32)
    np.testing.assert_array_equal(_port(q, k, v, over), _port(q, k, v, full))


@pytest.mark.parametrize("bad", ["dtype", "shape", "heads", "lengths"])
def test_wrapper_checks_its_inputs(bad):
    q = torch.zeros(4, 1, 8)
    k = torch.zeros(4, 5, 8)
    lengths = torch.ones(2, dtype=torch.int32)
    heads = 2
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        k = torch.zeros(4, 5, 4)
    elif bad == "heads":
        heads = 3
    else:
        lengths = lengths.long()
    with pytest.raises((TypeError, ValueError)):
        fa.flash_fwd(q, k, k, lengths, heads, 1.0)
