"""The port's flash attention against the JAX package: the plain PyTorch
versions the wrappers take on CPU tensors are held to the Pallas kernels
run by their interpreter (``flash_attention(..., interpret=True)``, and
``jax.vjp`` of it for the backward's ``_dq_kernel`` / ``_dkv_kernel``, as
tests/test_pallas.py runs them) and to ``sdpa_reference``.  The CUDA
kernels themselves are held to the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).

Tolerances, float32: forward atol 1e-5 — the algorithms sum in different
orders (blockwise online softmax vs one softmax); gradients rtol 2e-4,
atol 2e-4, the JAX package's own flash-gradient tolerance
(tests/test_pallas.py)."""
import os
import sys

import jax
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


# -- dense and key_mask (training) --------------------------------------------

TB, TH, TD = 2, 2, 32
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _train_inputs(s, masked, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(TB, TH, s, TD).astype(np.float32)
                   for _ in range(4))
    km = None
    if masked:
        km = (rng.rand(TB, s) < 0.7).astype(np.int32)
        km[0, 0] = 1
        km[1] = 0                      # a batch row with every key masked
    return q, k, v, do, km


def _flat(x):
    return torch.from_numpy(x.reshape(TB * TH, x.shape[2], TD))


TRAIN_CASES = [(s, masked) for s in (128, 77) for masked in (False, True)]


@pytest.mark.parametrize("s,masked", TRAIN_CASES)
def test_plain_forward_and_backward_match_jax_pallas_interpret(s, masked):
    q, k, v, do, km = _train_inputs(s, masked, seed=s)
    scale = 1.0 / np.sqrt(TD)
    jkm = None if km is None else jnp.asarray(km)

    def jax_fn(q, k, v):
        return jax_flash(q, k, v, key_mask=jkm, interpret=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tkm = None if km is None else torch.from_numpy(km)
    out, lse = fa.flash_fwd_plain(_flat(q), _flat(k), _flat(v), None, TH,
                                  scale, key_mask=tkm)
    np.testing.assert_allclose(out.numpy().reshape(q.shape),
                               np.asarray(want), rtol=0, atol=ATOL)
    grads = fa.flash_bwd_plain(_flat(q), _flat(k), _flat(v), tkm, out, lse,
                               _flat(do), scale)
    for name, got, ref in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(got.numpy().reshape(q.shape),
                                   np.asarray(ref), err_msg=f"d{name}",
                                   **GRAD_TOL)
    if masked:
        assert np.all(out.numpy()[TH:] == 0.0)
        assert np.all(lse.numpy()[TH:] == np.float32(fa.NEG_INF))
        for g in grads:
            assert np.all(g.numpy()[TH:] == 0.0)


@pytest.mark.parametrize("s,masked", TRAIN_CASES)
def test_autograd_function_on_cpu_matches_autograd_of_sdpa_reference(
        s, masked):
    """``flash_attention`` → ``FlashAttention`` on CPU tensors runs the
    plain versions of all three kernels (forward, dQ, dK/dV)."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    q, k, v, do, km = _train_inputs(s, masked, seed=s + 1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    tkm = None if km is None else torch.from_numpy(km)
    out = fa.flash_attention(tq, tk, tv, key_mask=tkm)
    ref = sdpa_reference(tq, tk, tv, mask=None if tkm is None
                         else tkm[:, None, None, :])
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=ATOL)
    cot = torch.from_numpy(do)
    got = torch.autograd.grad(out, (tq, tk, tv), cot)
    want = torch.autograd.grad(ref, (tq, tk, tv), cot)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_training_wrappers_count_no_launch_on_cpu():
    q, k, v, do, km = _train_inputs(16, True, seed=9)
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    tq, tk, tv, tdo = (_flat(x) for x in (q, k, v, do))
    tkm = torch.from_numpy(km)
    out, lse = fa.flash_fwd_masked(tq, tk, tv, tkm, 0.25)
    delta = (tdo * out).sum(-1)
    dq = fa.flash_bwd_dq(tq, tk, tv, tkm, tdo, lse, delta, 0.25)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tkm, tdo, lse, delta, 0.25)
    want = fa.flash_bwd_plain(tq, tk, tv, tkm, out, lse, tdo, 0.25)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == before


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_rows", "lse_shape",
                                 "delta_dtype"])
def test_training_wrappers_check_their_inputs(bad):
    q = torch.zeros(4, 6, 8)
    km = torch.ones(2, 6, dtype=torch.int32)
    lse, delta = torch.zeros(4, 6), torch.zeros(4, 6)
    if bad == "mask_dtype":
        km = km.bool()
    elif bad == "mask_rows":
        km = torch.ones(3, 6, dtype=torch.int32)
    elif bad == "lse_shape":
        lse = torch.zeros(4, 5)
    else:
        delta = delta.double()
    with pytest.raises(ValueError):
        if bad.startswith("mask"):
            fa.flash_fwd_masked(q, q, q, km, 1.0)
        fa.flash_bwd_dq(q, q, q, km, q, lse, delta, 1.0)
