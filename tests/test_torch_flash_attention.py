"""The port's flash attention against the JAX package: the plain PyTorch
versions the wrappers take on CPU tensors are held to the Pallas kernels
run by their interpreter (``flash_attention(..., interpret=True)``, and
``jax.vjp`` of it for the backward's ``_dq_kernel`` / ``_dkv_kernel``, as
tests/test_pallas.py runs them) and to ``sdpa_reference``.  The CUDA
kernels themselves are held to the same plain versions on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py).  The additive-bias
specializations are held with their gradient, dbias / dkbias summed over
the bias's broadcast group, at a scale other than 1 (T5 attends at scale
1, which would hide a bias added before the scale).  So are the full-mask
backward (Longformer) and a full mask together with a bias (XLNet), each
through its own group mode.

Tolerances, float32: forward atol 1e-5 — the algorithms sum in different
orders (blockwise online softmax vs one softmax); gradients rtol 2e-4,
atol 2e-4, the JAX package's own flash-gradient tolerance
(tests/test_pallas.py).  bfloat16 (the mixed-precision path): the bf16
plain versions against the Pallas kernels' bf16 instantiation within one
bf16 ulp (``BF16_TOL``), and ``ScoresF32`` against ``_scores_f32``."""
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


# -- causal (training) and full mask (chunked prefill) ------------------------

#: gradients of the new specializations, held tighter than GRAD_TOL: the
#: plain version and the Pallas kernel compute the same formulas from the
#: same lse, only the summation order differs
CAUSAL_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)

#: (S_q, S_kv): the lengths the CUDA kernels are held at on the card
#: ((1024, 1024), (200, 200), (64, 200), (200, 64), (1, 130)), cut where
#: the Pallas interpreter would be slow, plus two unequal pairs the Pallas
#: entry takes (lengths equal mod 128).  The entry raises for causal
#: lengths that differ mod 128; those are held to sdpa_reference only.
CAUSAL_PAIRS = [(128, 128), (200, 200), (128, 256), (256, 128), (64, 200),
                (200, 64), (1, 130)]


def _causal_inputs(s_q, s_kv, seed, key_mask=False):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(TB, TH, s_q, TD).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(TB, TH, s_kv, TD).astype(np.float32) for _ in range(2))
    km = None
    if key_mask:
        km = (rng.rand(TB, s_kv) < 0.7).astype(np.int32)
        km[0, 0] = 1
        km[1] = 0                      # a batch row with every key masked
    return q, k, v, do, km


def _pallas_takes(s_q, s_kv):
    return (-s_q) % 128 == (-s_kv) % 128


def _flat3(x):
    return torch.from_numpy(x.reshape(TB * TH, x.shape[2], TD))


@pytest.mark.parametrize("key_mask", [False, True])
@pytest.mark.parametrize("s_q,s_kv", CAUSAL_PAIRS)
def test_plain_causal_forward_and_backward_match_jax(s_q, s_kv, key_mask):
    """Plain causal out / dQ / dK / dV against the Pallas kernels in
    interpret mode (``jax.vjp`` of the entry) where the entry takes the
    lengths, and against ``sdpa_reference`` (and ``jax.vjp`` of it)
    always; lse against float64 numpy."""
    q, k, v, do, km = _causal_inputs(s_q, s_kv, seed=s_q + s_kv,
                                     key_mask=key_mask)
    scale = 1.0 / np.sqrt(TD)
    jkm = None if km is None else jnp.asarray(km)
    jmask = None if km is None else jnp.asarray(km)[:, None, None, :]
    refs = [lambda q, k, v: jax_sdpa_reference(q, k, v, causal=True,
                                               mask=jmask)]
    if _pallas_takes(s_q, s_kv):
        refs.append(lambda q, k, v: jax_flash(q, k, v, causal=True,
                                              key_mask=jkm, interpret=True))
    tkm = None if km is None else torch.from_numpy(km)
    out, lse = fa.flash_fwd_plain(_flat3(q), _flat3(k), _flat3(v), None, TH,
                                  scale, key_mask=tkm, causal=True)
    grads = fa.flash_bwd_plain(_flat3(q), _flat3(k), _flat3(v), tkm, out,
                               lse, _flat3(do), scale, causal=True)
    for fn in refs:
        want, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
        np.testing.assert_allclose(out.numpy().reshape(q.shape),
                                   np.asarray(want), **FWD_TOL)
        for name, got, ref in zip("qkv", grads, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(
                got.numpy().reshape(ref.shape), np.asarray(ref),
                err_msg=f"d{name}", **CAUSAL_GRAD_TOL)
    # lse, and with it the probabilities exp(s - lse) the backward forms
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    valid = np.tril(np.ones((s_q, s_kv), bool), s_kv - s_q)[None, None]
    if km is not None:
        valid = valid & (km != 0)[:, None, None, :]
    valid = np.broadcast_to(valid, s.shape)
    lse = lse.numpy().reshape(TB, TH, s_q)
    seen = valid.any(-1)
    sm = np.where(valid, s, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = sm.max(-1)
        want_lse = m + np.log(np.exp(sm - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse[seen], want_lse[seen], **FWD_TOL)
    assert np.all(lse[~seen] == np.float32(fa.NEG_INF))
    flat_seen = seen.reshape(TB * TH, s_q)
    assert np.all(out.numpy()[~flat_seen] == 0.0)
    assert np.all(grads[0].numpy()[~flat_seen] == 0.0)
    for g in grads:
        assert np.all(np.isfinite(g.numpy()))


@pytest.mark.parametrize("key_mask", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(128, 128), (77, 77), (40, 100),
                                      (100, 40)])
def test_causal_autograd_function_on_cpu_matches_autograd_of_sdpa_reference(
        s_q, s_kv, key_mask):
    """``flash_attention(causal=True)`` → ``FlashAttention`` on CPU
    tensors runs the plain causal versions of all three kernels.  (The
    wrappers take float32 only, so this stands in for a float64
    ``gradcheck``.)"""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    q, k, v, do, km = _causal_inputs(s_q, s_kv, seed=s_q, key_mask=key_mask)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    tkm = None if km is None else torch.from_numpy(km)
    out = fa.flash_attention(tq, tk, tv, causal=True, key_mask=tkm)
    ref = sdpa_reference(tq, tk, tv, causal=True, mask=None if tkm is None
                         else tkm[:, None, None, :])
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    cot = torch.from_numpy(do)
    got = torch.autograd.grad(out, (tq, tk, tv), cot)
    want = torch.autograd.grad(ref, (tq, tk, tv), cot)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"d{name}",
                                   **CAUSAL_GRAD_TOL)


def _full_mask(gmode, s_q, s_kv, seed, rows=None):
    """A boolean (1|B, 1|H, rows, S_kv) mask of group mode ``gmode`` with
    one query row that masks every key."""
    rng = np.random.RandomState(seed)
    gb = TB if gmode in ("b", "bh") else 1
    gh = TH if gmode in ("h", "bh") else 1
    m = rng.rand(gb, gh, s_q if rows is None else rows, s_kv) < 0.6
    m[0, 0, 0] = False
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gmode", ["one", "h", "b", "bh"])
def test_plain_fullmask_forward_matches_jax_pallas_interpret(gmode, causal):
    s_q = s_kv = 128
    q, k, v, _, _ = _causal_inputs(s_q, s_kv, seed=11)
    mask = _full_mask(gmode, s_q, s_kv, seed=12)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask=jnp.asarray(mask),
                                causal=causal, interpret=True))
    ref = np.asarray(jax_sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        mask=jnp.asarray(mask)))
    tmask = torch.from_numpy(mask)
    assert fa.classify_group(tmask, TB, TH, s_q, s_kv, "mask") == gmode
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), mask=tmask,
                             causal=causal).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, ref, **FWD_TOL)
    # the row with every key masked outputs zero wherever its group reaches
    dead = got[slice(None) if gmode in ("one", "h") else slice(0, 1),
               slice(None) if gmode in ("one", "b") else slice(0, 1), 0]
    assert np.all(dead == 0.0)


@pytest.mark.parametrize("s_q,s_kv,rows", [(32, 96, None), (5, 40, 1),
                                           (1, 130, None)])
def test_plain_fullmask_ragged_and_row_broadcast_match_sdpa_reference(
        s_q, s_kv, rows):
    """Lengths no multiple of a tile, with ``key_mask`` on top, and a
    (B, 1, 1|S_q, S_kv) mask whose one row is expanded over the query
    rows (held to ``sdpa_reference``: the Pallas entry pads these)."""
    q, k, v, _, km = _causal_inputs(s_q, s_kv, seed=s_kv, key_mask=True)
    km[1, :3] = 1
    mask = _full_mask("b", s_q, s_kv, seed=s_q, rows=rows)
    both = mask & (km != 0)[:, None, None, :]
    want = np.asarray(jax_sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v),
                                         mask=jnp.asarray(both)))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), mask=torch.from_numpy(mask),
                             key_mask=torch.from_numpy(km)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_fullmask_lse_of_a_dead_row_and_storage():
    q, k, v, _, _ = _causal_inputs(16, 24, seed=3)
    mask = torch.from_numpy(_full_mask("h", 16, 24, seed=4))
    m3, gmode = fa.broadcast_group(mask, TB, TH, 16, 24, "mask")
    assert gmode == "h" and m3.dtype == torch.uint8
    assert tuple(m3.shape) == (TH, 16, 24)          # stored unbroadcast
    out, lse = fa.flash_fwd_fullmask(_flat3(q), _flat3(k), _flat3(v), m3,
                                     gmode, TH, 0.2)
    assert np.all(out.numpy()[::TH, 0] == 0.0)      # head 0 of every batch
    assert np.all(lse.numpy()[::TH, 0] == np.float32(fa.NEG_INF))


def test_new_wrappers_count_no_launch_on_cpu():
    q, k, v, do, km = _causal_inputs(16, 16, seed=9, key_mask=True)
    names = ("fwd_causal_launches", "dq_causal_launches",
             "dkv_causal_launches", "fwd_mask_launches")
    before = [getattr(fa, n) for n in names]
    tq, tk, tv, tdo = (_flat3(x) for x in (q, k, v, do))
    tkm = torch.from_numpy(km)
    out, lse = fa.flash_fwd_masked(tq, tk, tv, tkm, 0.25, causal=True)
    delta = (tdo * out).sum(-1)
    dq = fa.flash_bwd_dq(tq, tk, tv, tkm, tdo, lse, delta, 0.25, causal=True)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tkm, tdo, lse, delta, 0.25,
                              causal=True)
    want = fa.flash_bwd_plain(tq, tk, tv, tkm, out, lse, tdo, 0.25,
                              causal=True)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    fa.flash_fwd_fullmask(tq, tk, tv,
                          torch.ones(1, 16, 16, dtype=torch.uint8), "one", TH,
                          0.25)
    assert [getattr(fa, n) for n in names] == before


@pytest.mark.parametrize("bad", ["dtype", "rows", "gmode", "key_mask_rows"])
def test_fullmask_wrapper_checks_its_inputs(bad):
    q = torch.zeros(4, 6, 8)
    mask = torch.ones(2, 6, 6, dtype=torch.uint8)
    gmode, km = "h", None
    if bad == "dtype":
        mask = mask.bool()
    elif bad == "rows":
        mask = torch.ones(3, 6, 6, dtype=torch.uint8)
    elif bad == "gmode":
        gmode = "hb"
    else:
        km = torch.ones(4, 6, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.flash_fwd_fullmask(q, q, q, mask, gmode, 2, 1.0, key_mask=km)


# -- additive bias (T5) --------------------------------------------------------

#: the bias cases run at a scale other than 1: a bias added before the
#: scale would pass at T5's scale 1.0
BIAS_SCALE = 0.37
BS, BB, BHEADS, BD = 128, 2, 2, 16


def _bias_inputs(s_q, s_kv, bias_shape, seed, b=BB, h=BHEADS, key_mask=False):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, h, s_q, BD).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, s_kv, BD).astype(np.float32) for _ in range(2))
    bias = rng.randn(*bias_shape).astype(np.float32)
    km = None
    if key_mask:
        km = (rng.rand(b, s_kv) < 0.7).astype(np.int32)
        km[0, 0] = 1
        km[1] = 0                      # a batch row with every key masked
    return q, k, v, do, bias, km


def _port_bias_grads(q, k, v, do, bias, km, causal):
    """out and (dq, dk, dv, dbias) of the port's entry on CPU tensors:
    ``FlashAttention`` over the plain versions of the bias kernels, dbias
    summed over its group."""
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v, bias))
    out = fa.flash_attention(tq, tk, tv, causal=causal, scale=BIAS_SCALE,
                             key_mask=None if km is None
                             else torch.from_numpy(km), bias=tb)
    grads = torch.autograd.grad(out, (tq, tk, tv, tb), torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_bias_grads(q, k, v, do, bias, km, causal):
    jkm = None if km is None else jnp.asarray(km)

    def fn(q, k, v, b):
        return jax_flash(q, k, v, causal=causal, scale=BIAS_SCALE,
                         key_mask=jkm, bias=b, interpret=True)

    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, bias)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


BIAS_CASES = [("one", False, False), ("h", False, False), ("b", False, False),
              ("bh", False, False), ("h", True, False), ("h", False, True),
              ("bh", True, True)]


@pytest.mark.parametrize("gmode,key_mask,causal", BIAS_CASES)
def test_plain_bias_forward_and_backward_match_jax_pallas_interpret(
        gmode, key_mask, causal):
    """out, dq, dk, dv and the group-summed dbias of a dense bias in each
    group mode, alone, with a key mask (one batch row fully masked) and
    causal, against the Pallas kernels in interpret mode."""
    shape = (BB if gmode in ("b", "bh") else 1,
             BHEADS if gmode in ("h", "bh") else 1, BS, BS)
    q, k, v, do, bias, km = _bias_inputs(BS, BS, shape, seed=len(gmode) + 7
                                         * key_mask + 3 * causal,
                                         key_mask=key_mask)
    assert fa.classify_group(torch.from_numpy(bias), BB, BHEADS, BS, BS,
                             "bias") == gmode
    got, grads = _port_bias_grads(q, k, v, do, bias, km, causal)
    want, wgrads = _jax_bias_grads(q, k, v, do, bias, km, causal)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **CAUSAL_GRAD_TOL)
    if causal:      # no row sees a key above the diagonal: dbias is 0 there
        assert np.all(grads[3][..., np.triu_indices(BS, 1)[0],
                               np.triu_indices(BS, 1)[1]] == 0.0)
    if key_mask:
        assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("bias_shape,causal", [((1, 1, 1, 128), False),
                                               ((2, 1, 1, 128), False),
                                               ((2, 4, 1, 128), True)])
def test_plain_key_bias_strip_matches_jax_pallas_interpret(bias_shape,
                                                           causal):
    """A (., ., 1, S_kv) bias takes the key-bias strip (the shapes of
    tests/test_pallas.py's strip test, B=2, H=4): out, dq, dk, dv and the
    group-summed dkbias against the Pallas kernels in interpret mode."""
    q, k, v, do, bias, _ = _bias_inputs(BS, BS, bias_shape, seed=21, b=2, h=4)
    before = fa.dkv_kbias_launches
    got, grads = _port_bias_grads(q, k, v, do, bias, None, causal)
    want, wgrads = _jax_bias_grads(q, k, v, do, bias, None, causal)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dkbias"), grads, wgrads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **CAUSAL_GRAD_TOL)
    assert fa.dkv_kbias_launches == before       # the plain version ran


@pytest.mark.parametrize("s_q,s_kv,causal,key_mask", [(114, 114, True, False),
                                                      (114, 200, False, True)])
def test_bias_autograd_function_on_cpu_matches_autograd_of_sdpa_reference(
        s_q, s_kv, causal, key_mask):
    """Ragged lengths (T5's 114-token target, causal; a 114 x 200 cross
    shape with a key mask): ``flash_attention(bias=)`` → ``FlashAttention``
    against autograd of ``sdpa_reference`` with the broadcast bias."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    q, k, v, do, bias, km = _bias_inputs(s_q, s_kv, (1, BHEADS, s_q, s_kv),
                                         seed=s_kv, key_mask=key_mask)
    got, grads = _port_bias_grads(q, k, v, do, bias, km, causal)
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v, bias))
    ref = sdpa_reference(tq, tk, tv, causal=causal, scale=BIAS_SCALE,
                         bias=tb, mask=None if km is None else
                         torch.from_numpy(km)[:, None, None, :])
    wgrads = torch.autograd.grad(ref, (tq, tk, tv, tb), torch.from_numpy(do))
    np.testing.assert_allclose(got, ref.detach().numpy(), **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        np.testing.assert_allclose(g, w.numpy(), err_msg=name,
                                   **CAUSAL_GRAD_TOL)


def test_bias_wrappers_count_no_launch_on_cpu_and_give_storage_grads():
    q, k, v, do, bias, km = _bias_inputs(16, 24, (BHEADS, 16, 24), seed=5,
                                         key_mask=True)
    flat = [torch.from_numpy(x.reshape(BB * BHEADS, x.shape[2], BD))
            for x in (q, k, v, do)]
    tq, tk, tv, tdo = flat
    tb, tkm = torch.from_numpy(bias), torch.from_numpy(km)
    names = [n for n in vars(fa) if "bias" in n and n.endswith("launches")]
    # the mask-with-bias ones among them, each with its bfloat16 twin, and
    # each of those with its lengths twin
    assert len(names) == 60
    assert sum(n.startswith("bf16_") for n in names) == 30
    assert sum(n.endswith("_len_launches") for n in names) == 30
    before = [getattr(fa, n) for n in names]
    out, lse = fa.flash_fwd_bias(tq, tk, tv, tkm, tb, None, "h", BHEADS, 0.3)
    delta = (tdo * out).sum(-1)
    dq, dbias = fa.flash_bwd_dq_bias(tq, tk, tv, tkm, tb, None, "h", BHEADS,
                                     tdo, lse, delta, 0.3)
    dk, dv, dkbias = fa.flash_bwd_dkv_bias(tq, tk, tv, tkm, tb, None, "h",
                                           BHEADS, tdo, lse, delta, 0.3)
    want = fa.flash_bwd_bias_plain(tq, tk, tv, tkm, tb, None, "h", BHEADS,
                                   out, lse, tdo, 0.3)
    assert dkbias is None and want[4] is None
    assert tuple(dbias.shape) == (BB * BHEADS, 16, 24)
    for g, w in zip((dq, dk, dv, dbias), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [getattr(fa, n) for n in names] == before
    red = fa.group_reduce(dbias, "h", BHEADS, tb.shape)
    torch.testing.assert_close(red, dbias.view(BB, BHEADS, 16, 24).sum(0))


@pytest.mark.parametrize("bad", ["both", "neither", "dtype", "rows",
                                 "strip_rows", "gmode"])
def test_bias_wrapper_checks_its_inputs(bad):
    q = torch.zeros(4, 6, 8)
    bias, kbias, gmode = torch.zeros(2, 6, 6), None, "h"
    if bad == "both":
        kbias = torch.zeros(2, 1, 6)
    elif bad == "neither":
        bias = None
    elif bad == "dtype":
        bias = bias.double()
    elif bad == "rows":
        bias = torch.zeros(3, 6, 6)
    elif bad == "strip_rows":
        bias, kbias = None, torch.zeros(2, 2, 6)
    else:
        gmode = "hb"
    with pytest.raises(ValueError):
        fa.flash_fwd_bias(q, q, q, None, bias, kbias, gmode, 2, 1.0)


# -- full mask with its backward, alone or with a bias (Longformer, XLNet) ---

#: (mask gmode, bias shape (1|B, 1|H, 1|S, S) or None, key mask, causal):
#: the four mask groups alone, with and without a key mask and causal
#: (Longformer's is group one); with a dense bias of group h (XLNet: mask
#: b, bias h) or one; with a key-bias strip
MASK_BWD_CASES = [("one", None, False, False), ("h", None, True, False),
                  ("b", None, False, True), ("bh", None, True, True),
                  ("b", (1, BHEADS, BS, BS), False, False),
                  ("one", (1, BHEADS, BS, BS), True, True),
                  ("bh", (1, 1, BS, BS), False, True),
                  ("h", (1, 1, BS, BS), True, False),
                  ("b", (1, 1, 1, BS), False, False),
                  ("h", (BB, 1, 1, BS), True, True)]


def _mask_of(gmode, seed, s=BS):
    """A boolean (1|B, 1|H, S, S) mask of group mode ``gmode`` with one
    query row that sees no key."""
    rng = np.random.RandomState(seed)
    m = rng.rand(BB if gmode in ("b", "bh") else 1,
                 BHEADS if gmode in ("h", "bh") else 1, s, s) < 0.5
    m[0, 0, 0] = False
    return m


@pytest.mark.parametrize("gmode,bias_shape,key_mask,causal", MASK_BWD_CASES)
def test_plain_fullmask_backward_and_bias_match_jax_pallas_interpret(
        gmode, bias_shape, key_mask, causal):
    """out, dq, dk, dv and the group-summed dbias / dkbias of a full mask,
    alone or with a bias of its own group mode, against the Pallas kernels
    in interpret mode (``jax.vjp`` of the entry); the row with no visible
    key gives out = dQ = 0 and a dbias row of 0, and dbias is exactly 0 on
    every masked pair."""
    shape = bias_shape or (1, 1, 1, BS)
    q, k, v, do, bias, km = _bias_inputs(BS, BS, shape, seed=len(gmode)
                                         + 5 * key_mask + 3 * causal,
                                         key_mask=key_mask)
    mask = _mask_of(gmode, seed=len(gmode) + 11)
    tmask = torch.from_numpy(mask)
    assert fa.classify_group(tmask, BB, BHEADS, BS, BS, "mask") == gmode
    jkm = None if km is None else jnp.asarray(km)
    xs = (q, k, v) + ((bias,) if bias_shape else ())

    def fn(q, k, v, b=None):
        return jax_flash(q, k, v, causal=causal, scale=BIAS_SCALE,
                         key_mask=jkm, mask=jnp.asarray(mask), bias=b,
                         interpret=True)

    want, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in xs))
    wgrads = vjp(jnp.asarray(do))
    tx = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = fa.flash_attention(*tx[:3], causal=causal, scale=BIAS_SCALE,
                             key_mask=None if km is None
                             else torch.from_numpy(km), mask=tmask,
                             bias=tx[3] if bias_shape else None)
    grads = torch.autograd.grad(got, tx, torch.from_numpy(do))
    got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **CAUSAL_GRAD_TOL)
    assert np.all(got[0, 0, 0] == 0.0)          # the row that sees no key
    assert np.all(grads[0].numpy()[0, 0, 0] == 0.0)
    if bias_shape and bias_shape[2] == BS:
        # dbias before the group sum: 0 on the dead row and every pair no
        # row sees
        flat = [torch.from_numpy(x.reshape(BB * BHEADS, BS, BD))
                for x in (q, k, v, do)]
        m3, mg = fa.broadcast_group(tmask, BB, BHEADS, BS, BS, "mask")
        b3 = torch.from_numpy(bias.reshape(-1, BS, BS))
        bg = fa.classify_group(torch.from_numpy(bias), BB, BHEADS, BS, BS,
                               "bias")
        tkm = None if km is None else torch.from_numpy(km)
        out, lse = fa.flash_fwd_fullmask(*flat[:3], m3, mg, BHEADS,
                                         BIAS_SCALE, key_mask=tkm,
                                         causal=causal, bias=b3, bgmode=bg)
        delta = (flat[3] * out).sum(-1)
        _, dbias = fa.flash_bwd_dq_mask(*flat[:3], tkm, m3, mg, BHEADS,
                                        flat[3], lse, delta, BIAS_SCALE,
                                        causal=causal, bias=b3, bgmode=bg)
        valid = fa._valid(BB * BHEADS, BS, BS, "cpu", key_mask=tkm,
                          causal=causal, mask=m3, gmode=mg, heads=BHEADS)
        valid = valid.expand(BB * BHEADS, BS, BS)
        assert int(torch.count_nonzero(dbias[~valid])) == 0
        assert bool((dbias[0, 0] == 0).all())


@pytest.mark.parametrize("s_q,s_kv,gmode,bias_group", [(77, 77, "b", "h"),
                                                       (40, 100, "one", "bh")])
def test_mask_bias_autograd_function_on_cpu_matches_autograd_of_sdpa_reference(
        s_q, s_kv, gmode, bias_group):
    """Ragged lengths: ``flash_attention(mask=, bias=)`` →
    ``FlashAttention`` over the plain versions of the mask-with-bias
    kernels against autograd of ``sdpa_reference``, the bias's gradient
    summed over its group."""
    from hetu_tpu_torch.ops.attention import sdpa_reference
    bshape = (BB if bias_group in ("b", "bh") else 1,
              BHEADS if bias_group in ("h", "bh") else 1, s_q, s_kv)
    q, k, v, do, bias, _ = _bias_inputs(s_q, s_kv, bshape, seed=s_q)
    rng = np.random.RandomState(s_kv)
    mask = rng.rand(BB if gmode == "b" else 1, 1, s_q, s_kv) < 0.3
    mask[0, 0, 0] = False
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v, bias))
    tmask = torch.from_numpy(mask)
    got = fa.flash_attention(tq, tk, tv, scale=BIAS_SCALE, mask=tmask,
                             bias=tb)
    ref = sdpa_reference(tq, tk, tv, scale=BIAS_SCALE, mask=tmask, bias=tb)
    cot = torch.from_numpy(do)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"),
                          torch.autograd.grad(got, (tq, tk, tv, tb), cot),
                          torch.autograd.grad(ref, (tq, tk, tv, tb), cot)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **CAUSAL_GRAD_TOL)


def test_mask_wrappers_count_no_launch_on_cpu():
    q, k, v, do, bias, km = _bias_inputs(16, 24, (BB, 16, 24), seed=6,
                                         key_mask=True)
    tq, tk, tv, tdo = (torch.from_numpy(x.reshape(BB * BHEADS, x.shape[2],
                                                  BD))
                       for x in (q, k, v, do))
    tkm, tb = torch.from_numpy(km), torch.from_numpy(bias)
    mask = torch.from_numpy(_mask_of("h", seed=1, s=24)[0, :, :16]
                            .astype(np.uint8)).contiguous()
    names = [n for n in vars(fa) if "mask" in n and n.endswith("launches")]
    # each with its bfloat16 twin, and each of those with its lengths twin
    assert len(names) == 36
    assert sum(n.startswith("bf16_") for n in names) == 18
    assert sum(n.endswith("_len_launches") for n in names) == 18
    before = [getattr(fa, n) for n in names]
    for b, kb in ((None, None), (tb, None), (None, tb[:, :1].contiguous())):
        kw = dict(causal=True, bias=b, kbias=kb, bgmode="b")
        out, lse = fa.flash_fwd_fullmask(tq, tk, tv, mask, "h", BHEADS, 0.3,
                                         key_mask=tkm, **kw)
        delta = (tdo * out).sum(-1)
        args = (tq, tk, tv, tkm, mask, "h", BHEADS, tdo, lse, delta, 0.3)
        dq, dbias = fa.flash_bwd_dq_mask(*args, **kw)
        dk, dv, dkbias = fa.flash_bwd_dkv_mask(*args, **kw)
        want = fa.flash_bwd_bias_plain(tq, tk, tv, tkm, b, kb, "b", BHEADS,
                                       out, lse, tdo, 0.3, causal=True,
                                       mask=mask, gmode="h")
        assert (dbias is None) == (b is None)
        assert (dkbias is None) == (kb is None)
        for g, w in zip((dq, dk, dv, dbias, dkbias), want):
            assert (g is None) == (w is None)
            if g is not None:
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [getattr(fa, n) for n in names] == before


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_rows", "gmode",
                                 "bias_rows", "bgmode", "both",
                                 "key_mask_rows"])
def test_mask_wrappers_check_their_inputs(bad):
    q = torch.zeros(4, 6, 8)
    lse, delta = torch.zeros(4, 6), torch.zeros(4, 6)
    mask = torch.ones(2, 6, 6, dtype=torch.uint8)
    gmode, km = "b", None
    kw = dict(bias=torch.zeros(2, 6, 6), kbias=None, bgmode="h")
    if bad == "mask_dtype":
        mask = mask.bool()
    elif bad == "mask_rows":
        mask = torch.ones(4, 6, 6, dtype=torch.uint8)
    elif bad == "gmode":
        gmode = "hb"
    elif bad == "bias_rows":
        kw["bias"] = torch.zeros(4, 6, 6)
    elif bad == "bgmode":
        kw["bgmode"] = "x"
    elif bad == "both":
        kw["kbias"] = torch.zeros(2, 1, 6)
    else:
        km = torch.ones(4, 6, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.flash_fwd_fullmask(q, q, q, mask, gmode, 2, 1.0, key_mask=km,
                              **kw)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq_mask(q, q, q, km, mask, gmode, 2, q, lse, delta, 1.0,
                             **kw)
    with pytest.raises(ValueError):
        fa.flash_bwd_dkv_mask(q, q, q, km, mask, gmode, 2, q, lse, delta, 1.0,
                              **kw)


# -- bfloat16 (the mixed-precision training path) -----------------------------

#: (kind, S, key mask, causal): BERT's key mask and GPT-2's causal rule,
#: dense, a ragged causal case with a key mask, one dense bias (group h,
#: bf16 as a model under compute_dtype makes it) and one full mask (group b)
BF16_CASES = [("dense", 128, False, False), ("key_mask", 128, True, False),
              ("causal", 128, False, True), ("causal", 77, True, True),
              ("bias", 128, True, False), ("mask", 128, False, True)]


def _bf16_case(kind, s, key_mask, causal):
    """The inputs of one bf16 case as numpy float32 arrays (rounded to bf16
    by each package as it converts them) and the mask."""
    q, k, v, do, bias, km = _bias_inputs(s, s, (1, BHEADS, s, s),
                                         seed=s + 3 * key_mask + causal,
                                         key_mask=key_mask)
    mask = _mask_of("b", seed=s, s=s) if kind == "mask" else None
    return (q, k, v) + ((bias,) if kind == "bias" else ()), do, km, mask


#: bf16 plain versions vs the Pallas kernels' bf16 instantiation: one bf16
#: ulp.  The two round the same operands at the same points, from float32
#: sums taken in another order, so an element can land one ulp apart; the
#: measured spread over BF16_CASES is a few isolated flips (at most 1.95e-3
#: absolute, on values near 0.5; relative 2^-8 at most), and elements of
#: magnitude up to ~5.  test_pallas.py holds the TPU kernel to its
#: reference at the wider 2e-2.
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)


@pytest.mark.parametrize("kind,s,key_mask,causal", BF16_CASES)
def test_bf16_plain_versions_match_jax_pallas_interpret(kind, s, key_mask,
                                                       causal):
    """bf16 q, k, v (and bias) through ``flash_attention`` on CPU tensors
    (``FlashAttention`` over the bf16 plain versions of the forward, dQ
    and dK/dV) against the Pallas kernels' bf16 instantiation in interpret
    mode (``jax.vjp`` of the entry): out and every gradient bf16, within
    ``BF16_TOL``; dbias in the bias's dtype."""
    xs, do, km, mask = _bf16_case(kind, s, key_mask, causal)
    jkm = None if km is None else jnp.asarray(km)
    jmask = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v, b=None):
        return jax_flash(q, k, v, causal=causal, scale=BIAS_SCALE,
                         key_mask=jkm, mask=jmask, bias=b, interpret=True)

    want, vjp = jax.vjp(fn, *(jnp.asarray(x, jnp.bfloat16) for x in xs))
    wgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    tx = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in xs]
    got = fa.flash_attention(
        *tx[:3], causal=causal, scale=BIAS_SCALE,
        key_mask=None if km is None else torch.from_numpy(km),
        mask=None if mask is None else torch.from_numpy(mask),
        bias=tx[3] if len(tx) > 3 else None)
    grads = torch.autograd.grad(got, tx,
                                torch.from_numpy(do).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **BF16_TOL)


def test_bf16_plain_versions_keep_float32_outputs_where_the_kernels_do():
    """lse, delta and dbias stay float32 with bf16 inputs; out, dQ, dK and
    dV take the inputs' dtype; float32 inputs give exactly what they gave
    before bf16 existed (every rounding is the identity)."""
    q, k, v, do, bias, km = _bias_inputs(24, 40, (BB * BHEADS, 24, 40),
                                         seed=4, key_mask=True)
    flat = [torch.from_numpy(x.reshape(BB * BHEADS, x.shape[2], BD))
            for x in (q, k, v, do)]
    tkm, tb = torch.from_numpy(km), torch.from_numpy(bias)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv, tdo = (x.to(dtype) for x in flat)
        out, lse = fa.flash_fwd_plain(tq, tk, tv, None, BHEADS, 0.3,
                                      key_mask=tkm, bias=tb)
        dq, dk, dv, dbias, _ = fa.flash_bwd_bias_plain(
            tq, tk, tv, tkm, tb, None, "bh", BHEADS, out, lse, tdo, 0.3)
        assert lse.dtype == dbias.dtype == torch.float32
        assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    tq, tk, tv, tdo = flat
    out, lse = fa.flash_fwd_plain(tq, tk, tv, None, BHEADS, 0.3,
                                  key_mask=tkm, bias=tb)
    s = torch.matmul(tq, tk.transpose(1, 2)) * 0.3 + tb
    s = torch.where(tkm.repeat_interleave(BHEADS, 0)[:, None, :] != 0, s,
                    torch.full_like(s, fa.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * (tkm.repeat_interleave(BHEADS, 0)[:, None, :]
                            != 0)
    l_ = p.sum(-1, keepdim=True)
    l_ = torch.where(l_ == 0, torch.ones_like(l_), l_)
    torch.testing.assert_close(out, torch.matmul(p, tv) / l_, rtol=0,
                               atol=0)


def test_scores_f32_twin_matches_jax():
    """The port's ``ScoresF32`` against the JAX package's ``_scores_f32``
    on the same bf16 operands: the float32 scores (exact bf16 products,
    float32 sums in another order) and the bf16 dQ, dK from the cotangent
    rounded to bf16 first (each product rounds once from a float32 sum,
    so an element may land one bf16 ulp apart)."""
    from hetu_tpu.ops.attention import _scores_f32
    from hetu_tpu_torch.ops.attention import ScoresF32
    rng = np.random.RandomState(8)
    q, k = rng.randn(2, 3, 24, 16), rng.randn(2, 3, 40, 16)
    g = rng.randn(2, 3, 24, 40).astype(np.float32)
    jq, jk = (jnp.asarray(x, jnp.bfloat16) for x in (q, k))
    want, vjp = jax.vjp(_scores_f32, jq, jk)
    wdq, wdk = vjp(jnp.asarray(g))
    tq, tk = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k))
    got = ScoresF32.apply(tq, tk)
    dq, dk = torch.autograd.grad(got, (tq, tk), torch.from_numpy(g))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    for name, a, b in (("dq", dq, wdq), ("dk", dk, wdk)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=2 ** -8,
                                   atol=1e-6, err_msg=name)


# -- tile maps of the float32 forward (which key tiles it walks) ---------------

def _tiles_any(valid, tile=64):
    """numpy: any visible pair in each (tile x tile) block of the last two
    axes of a boolean (..., S_q, S_kv) array, ragged edges included."""
    s_q, s_kv = valid.shape[-2:]
    n_qt, n_kt = -(-s_q // tile), -(-s_kv // tile)
    out = np.zeros(valid.shape[:-2] + (n_qt, n_kt), bool)
    for i in range(n_qt):
        for j in range(n_kt):
            out[..., i, j] = valid[..., i * tile:(i + 1) * tile,
                                   j * tile:(j + 1) * tile].any(axis=(-2, -1))
    return out


def _sparse_mask(rng, g, s_q, s_kv):
    """A sparse uint8 (G, S_q, S_kv) mask with whole empty key tiles and
    one query tile whose rows see no key at all."""
    m = rng.rand(g, s_q, s_kv) < 0.02
    m[:, :, 64:128] = False                # an empty key-tile column
    m[:, 64:128, :] = False                # an all-invisible tile row
    return m.astype(np.uint8)


@pytest.mark.parametrize("gmode", fa.GMODES)
@pytest.mark.parametrize("s_q,s_kv", [(200, 260), (130, 70), (64, 64)])
def test_tile_maps_and_walked_tiles_match_numpy_reference(gmode, s_q, s_kv):
    rng = np.random.RandomState(s_q + s_kv + len(gmode))
    b, h = 2, 3
    g = fa._group_rows(gmode, b * h, h)
    m = _sparse_mask(rng, g, s_q, s_kv)
    km = (np.arange(s_kv)[None, :] < np.array([s_kv - 1, 40])[:, None])
    km = km.astype(np.int32)               # row 1: a padded key tail
    key_tiles, mask_tiles = fa.tile_maps(torch.from_numpy(km),
                                         torch.from_numpy(m))
    assert key_tiles.element_size() == mask_tiles.element_size() == 1
    np.testing.assert_array_equal(mask_tiles.numpy() != 0, _tiles_any(m != 0))
    np.testing.assert_array_equal(
        key_tiles.numpy() != 0,
        _tiles_any(np.broadcast_to(km[:, None, :] != 0, (b, 1, s_kv)))[:, 0])
    if s_q > 128:
        assert not mask_tiles.numpy()[:, 1].any()    # the invisible tile row
    # the kernel walks exactly the tiles with a visible pair when one map,
    # or causal, decides; with several it may walk more, never fewer
    tm, tkm = torch.from_numpy(m), torch.from_numpy(km)
    for kw, exact in ((dict(mask=tm), True), (dict(key_mask=tkm), True),
                      (dict(causal=True), True),
                      (dict(mask=tm, key_mask=tkm, causal=True), False)):
        walk = fa.walked_tiles(b * h, h, s_q, s_kv, gmode=gmode, **kw)
        valid = fa._valid(b * h, s_q, s_kv, "cpu", gmode=gmode, heads=h,
                          **kw).expand(b * h, s_q, s_kv).numpy()
        want = _tiles_any(valid)
        assert walk.shape == want.shape
        if exact:
            np.testing.assert_array_equal(walk.numpy(), want)
        else:
            assert (walk.numpy() | ~want).all()



# -- which tiles the float32 backward kernels walk ----------------------------

def test_float32_mask_backward_entries_take_the_tile_map():
    """The float32 full-mask dQ and dK/dV entries take the mask's tile map
    after the mask, as the float32 forward does: one pointer more than
    their ``_bf16`` twins, the same ints."""
    for name in ("hetu_flash_fwd_mask", "hetu_flash_bwd_dq_mask",
                 "hetu_flash_bwd_dkv_mask"):
        _, n_ptr, n_int = fa.ENTRIES[name]
        _, bf_ptr, bf_int = fa.ENTRIES[name + "_bf16"]
        assert (n_ptr, n_int) == (bf_ptr + 1, bf_int), name


def _c_signatures(source):
    """{entry: (pointer args, int args)} of the ``extern "C"`` functions
    in ``csrc/<source>.cu`` and the headers it includes, the stream and
    the float scale left out (an entry macro's ``##SFX`` dropped)."""
    import re
    csrc = os.path.join(ROOT, "hetu_tpu_torch", "csrc")
    with open(os.path.join(csrc, source + ".cu")) as f:
        text = f.read()
    for inc in re.findall(r'#include "([^"]+)"', text):
        with open(os.path.join(csrc, inc)) as f:
            text += f.read()
    text = text.replace("\\\n", " ")
    out = {}
    for name, params in re.findall(
            r'extern "C" int (\w+?)(?:##SFX)?\(([^)]*)\)', text):
        args = [a.strip() for a in params.split(",")][:-2]  # scale, stream
        out[name] = (sum("*" in a for a in args),
                     sum(a.startswith("int ") for a in args))
    return out


def test_float32_entries_take_the_arguments_the_map_gives():
    """Each float32 training entry's C signature has the pointer and int
    arguments ``fa.ENTRIES`` binds (a wrong count shows only on the card,
    as a crash or a wrong argument)."""
    sigs = {**_c_signatures("flash_attention"),
            **_c_signatures("flash_attention_bwd")}
    for name, (src, n_ptr, n_int) in fa.ENTRIES.items():
        if src in ("flash_attention", "flash_attention_bwd"):
            assert sigs[name] == (n_ptr, n_int), (name, sigs[name])


# (rule, exact): with one rule, lengths with a key mask, or lengths with
# causal, every walked tile holds a visible pair; with a mask or a key mask
# beside causal the kernels may walk a tile whose marks do not meet
WALK_RULES = [("mask", True), ("key_mask", True), ("causal", True),
              ("lengths", True), ("lengths+key_mask", True),
              ("lengths+causal", True), ("mask+key_mask", False),
              ("mask+causal+lengths", False), ("key_mask+causal", False)]


@pytest.mark.parametrize("rule,exact", WALK_RULES)
@pytest.mark.parametrize("gmode", fa.GMODES)
@pytest.mark.parametrize("s_q,s_kv", [(200, 260), (300, 130), (64, 64)])
def test_backward_walks_the_tiles_that_hold_a_visible_pair(s_q, s_kv, gmode,
                                                           rule, exact):
    """dQ walks each query tile's key tiles by the forward's rule
    (``walked_tiles``), dK/dV each key tile's query tiles by its own
    (``by="key"``): both give the same pairs, never miss a tile that holds
    a visible pair of ``_valid``, and walk no other where the rules say
    ``exact``."""
    rng = np.random.RandomState(s_q * 3 + s_kv + len(gmode) + len(rule))
    b, h = 2, 3
    kw = {}
    if "mask" in rule.split("+"):
        kw.update(mask=torch.from_numpy(_sparse_mask(
            rng, fa._group_rows(gmode, b * h, h), s_q, s_kv)), gmode=gmode)
    if "key_mask" in rule:
        km = (rng.rand(b, s_kv) < 0.5).astype(np.int32)
        km[0, 64:128] = 0                  # a dead key tile
        km[1, 40:] = 0                     # a padded tail
        kw["key_mask"] = torch.from_numpy(km)
    if "causal" in rule:
        kw["causal"] = True
    if "lengths" in rule:
        kw["lengths"] = torch.tensor([s_kv - 70, 65], dtype=torch.int32)
    by_q = fa.walked_tiles(b * h, h, s_q, s_kv, **kw)
    by_k = fa.walked_tiles(b * h, h, s_q, s_kv, by="key", **kw)
    valid = fa._valid(b * h, s_q, s_kv, "cpu", heads=h, **kw)
    want = _tiles_any(valid.expand(b * h, s_q, s_kv).numpy())
    assert by_q.shape == by_k.shape == want.shape
    np.testing.assert_array_equal(by_k.numpy(), by_q.numpy())
    if exact:
        np.testing.assert_array_equal(by_q.numpy(), want)
    else:
        assert (by_q.numpy() | ~want).all()
    if s_q > 128 and "mask" in kw:
        assert not by_q.numpy()[:, 1].any()     # the invisible tile row
