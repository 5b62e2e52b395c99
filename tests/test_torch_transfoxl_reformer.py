"""Transformer-XL and Reformer in the port against the JAX package, on the
CPU, and the flash wrappers' zero-padded head dim.

Tiny Transformer-XL (``TransfoXLConfig.tiny``: 128 wide, 2 heads, 2
layers, memory 16, 32 tokens a segment, vocabulary 512; batch 2, dropout
0) and tiny Reformer (``ReformerConfig.tiny``: 128 wide, 2 layers, 2
heads, 4 buckets, chunks of 16, S = 64; batch 2, dropout 0) from the JAX
package's weights on seeded ids, at the gates of
``tests/_torch_model_parity.py``: step-1 loss atol 1e-5, every gradient
``allclose(rtol=1e-4, atol=1e-6)``, 5 Adam losses rtol 1e-5.  Each step
feeds the same segment, so steps 2-5 read the memory the step before
wrote.

Reformer's bucket ``argmax`` can flip between the packages at a near tie
of two rotated projections; the feeds here are seed 0, at which the
closest top-two gap over every LSH call of the 5 steps is checked above
``LSH_TIE_GAP`` (1e-4, a hundred times the 1e-6 the packages' products
can differ by), so no bucket lies near a tie.

The JAX package's ``test_transfoxl_tiny_trains_and_carries_memory`` and
``test_reformer_lsh_close_to_full_when_one_bucket`` are held in the port,
each also against the JAX package.  Head dim 41 (Transformer-XL wt103's
410 / 10) goes through the flash entry zero-padded to 44 (float32) and 48
(bf16) with the scale of the true D, forward and every gradient against
the plain attention at D = 41."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_model_parity as P                          # noqa: E402
import hetu_tpu as jht                                   # noqa: E402
from hetu_tpu.models import reformer as jref             # noqa: E402
from hetu_tpu.models import transfoxl as jxl             # noqa: E402
import hetu_tpu_torch as tht                             # noqa: E402
from hetu_tpu_torch.models import reformer as tref       # noqa: E402
from hetu_tpu_torch.models import transfoxl as txl       # noqa: E402
from hetu_tpu_torch.ops.attention import sdpa_reference  # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

XL = dict(batch_size=2, dropout=0.0)
REF = dict(batch_size=2, hidden_dropout_prob=0.0)
LSH_TIE_GAP = 1e-4


@pytest.fixture(scope="module")
def transfoxl():
    cfg = jxl.TransfoXLConfig.tiny(**XL)
    return P.train_both("TransfoXLConfig", "transfoxl_lm_graph", XL,
                        P.lm_batch(cfg.vocab_size, cfg.batch_size,
                                   cfg.tgt_len))


@pytest.fixture(scope="module")
def reformer():
    cfg = jref.ReformerConfig.tiny(**REF)
    gaps = []
    real = tref.lsh_attention

    def probe(qk, v, rotations, chunk_length, causal=True):
        if qk.device.type != "meta":     # not the graph lint's shape pass
            rot = torch.einsum("bhsd,df->bhsf", qk.detach(), rotations)
            top2 = torch.topk(torch.cat([rot, -rot], -1), 2, dim=-1).values
            gaps.append(float((top2[..., 0] - top2[..., 1]).min()))
        return real(qk, v, rotations, chunk_length, causal)

    tref.lsh_attention = probe
    try:
        rec = P.train_both("ReformerConfig", "reformer_lm_graph", REF,
                           P.mlm_batch(cfg.vocab_size, cfg.batch_size,
                                       cfg.seq_len))
    finally:
        tref.lsh_attention = real
    rec["gaps"] = gaps
    return rec


def test_transfoxl_training_step_matches_jax(transfoxl):
    P.check_step(transfoxl, transfoxl["cfg"].n_layer)


def test_transfoxl_five_adam_steps_match_jax(transfoxl):
    P.check_trajectory(transfoxl)
    tex, jex = transfoxl["tex"], transfoxl["jex"]
    for node, name in tex.var_names.items():
        if name.endswith(".mems"):
            jnode = next(n for n, m in jex.var_names.items() if m == name)
            np.testing.assert_allclose(
                tex.var_values[node].numpy(),
                np.asarray(jex.var_values[jnode]), rtol=1e-4, atol=1e-5)


def test_reformer_training_step_matches_jax(reformer):
    cfg = reformer["cfg"]
    # LSH attention is plain PyTorch: no flash dispatch, no fallback
    P.check_step(reformer, 0)
    assert len(reformer["gaps"]) == P.STEPS * cfg.num_hidden_layers
    assert min(reformer["gaps"]) > LSH_TIE_GAP, min(reformer["gaps"])


def test_reformer_five_adam_steps_match_jax(reformer):
    P.check_trajectory(reformer)


@pytest.mark.parametrize("model", ["transfoxl", "reformer"])
def test_configs_and_names_equal_the_jax_package(model):
    config, graph, kw, tmod, jmod = {
        "transfoxl": ("TransfoXLConfig", "transfoxl_lm_graph", XL, txl, jxl),
        "reformer": ("ReformerConfig", "reformer_lm_graph", REF, tref,
                     jref)}[model]
    for make in ("base", "tiny"):
        assert vars(getattr(getattr(tmod, config), make)()) \
            == vars(getattr(getattr(jmod, config), make)())
    assert P.names_and_shapes(True, config, graph, kw) \
        == P.names_and_shapes(False, config, graph, kw)


def test_transfoxl_tiny_trains_and_carries_memory():
    """8 Adam steps train and rewrite every layer's memory; after two
    consecutive segments the memory equals the JAX package's."""
    cfg = txl.TransfoXLConfig.tiny(batch_size=2)
    feeds, loss, _ = txl.transfoxl_lm_graph(cfg)
    ex = tht.Executor({"train": [loss, tht.optim.AdamOptimizer(3e-3)
                                 .minimize(loss)]}, seed=0, device="cpu")
    mem_vars = [n for n in ex.var_values if n.name.endswith(".mems")]
    assert len(mem_vars) == cfg.n_layer
    before = [ex.var_values[m].numpy().copy() for m in mem_vars]
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, cfg.tgt_len + 1)).astype(np.int32)
    fd = {feeds["input_ids"]: ids[:, :-1], feeds["labels"]: ids[:, 1:]}
    losses = [float(ex.run("train", feed_dict=fd)[0].asnumpy())
              for _ in range(8)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    for b, m in zip(before, mem_vars):
        assert np.abs(ex.var_values[m].numpy() - b).max() > 0

    # two consecutive segments (dropout 0) in both packages
    cfg = txl.TransfoXLConfig.tiny(**XL)
    tfeeds, tloss, _ = txl.transfoxl_lm_graph(cfg)
    jfeeds, jloss, _ = jxl.transfoxl_lm_graph(cfg)
    tex = tht.Executor({"train": [tloss, tht.optim.AdamOptimizer(1e-3)
                                  .minimize(tloss)]}, seed=0, device="cpu")
    jex = jht.Executor({"train": [jloss, jht.optim.AdamOptimizer(1e-3)
                                  .minimize(jloss)]}, seed=0)
    tex.load_dict(jex.return_tensor_values())
    text = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (cfg.batch_size, 2 * cfg.tgt_len + 1))
    for seg in range(2):
        part = text[:, seg * cfg.tgt_len:(seg + 1) * cfg.tgt_len + 1]
        part = part.astype(np.int32)
        tl = tex.run("train", feed_dict={tfeeds["input_ids"]: part[:, :-1],
                                         tfeeds["labels"]: part[:, 1:]})
        jl = jex.run("train", feed_dict={jfeeds["input_ids"]: part[:, :-1],
                                         jfeeds["labels"]: part[:, 1:]})
        np.testing.assert_allclose(float(tl[0].asnumpy()),
                                   float(np.asarray(jl[0].asnumpy())),
                                   rtol=0, atol=P.LOSS_ATOL)
    tmem = {tex.var_names[n]: tex.var_values[n].numpy()
            for n in tex.var_values if n.name.endswith(".mems")}
    jmem = {jex.var_names[n]: np.asarray(jex.var_values[n])
            for n in jex.var_values if n.name.endswith(".mems")}
    assert sorted(tmem) == sorted(jmem) and len(tmem) == cfg.n_layer
    for name in tmem:
        assert np.abs(tmem[name]).max() > 0
        np.testing.assert_allclose(tmem[name], jmem[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_reformer_lsh_close_to_full_when_one_bucket():
    """With one hash bucket and chunk == seq, LSH attention is full
    causal attention with the -1e5 self-logit; the port's equals it and
    the JAX package's ``lsh_attention``."""
    import jax.numpy as jnp
    rng = np.random.RandomState(1)
    b, h, s, d = 1, 1, 8, 4
    qk = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    rot = rng.randn(d, 1).astype(np.float32)
    out = tref.lsh_attention(torch.from_numpy(qk), torch.from_numpy(v),
                             torch.from_numpy(rot), chunk_length=s,
                             causal=True).numpy()
    k = qk / np.maximum(np.linalg.norm(qk, axis=-1, keepdims=True), 1e-6)
    logits = np.einsum("bhqd,bhkd->bhqk", qk, k) / np.sqrt(d)
    i = np.arange(s)
    logits = np.where(i[None, :] > i[:, None], -1e30, logits)
    logits = np.where(np.eye(s, dtype=bool), -1e5, logits)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", e / e.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # several buckets and chunks, forward and gradient, against JAX
    import jax
    b, h, s, d, c = 2, 2, 32, 8, 8
    qk = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    rot = rng.randn(d, 2).astype(np.float32)
    cot = rng.randn(b, h, s, d).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b_: jref.lsh_attention(a, b_, rot, c),
                        jnp.asarray(qk), jnp.asarray(v))
    jg = vjp(jnp.asarray(cot))
    tq, tv = (torch.from_numpy(x).requires_grad_(True) for x in (qk, v))
    tout = tref.lsh_attention(tq, tv, torch.from_numpy(rot), c)
    tg = torch.autograd.grad(tout, (tq, tv), torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for a, w in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype,padded", [(torch.float32, 44),
                                          (torch.bfloat16, 48)])
def test_head_dim_41_is_padded_to_the_kernels_multiple(dtype, padded,
                                                       monkeypatch):
    """Transformer-XL's attention at D = 41 (causal, a bias of group
    ``h``, S_q 12 != S_kv 20) through the flash entry: the kernel
    wrappers see q, k, v, dO zero-padded to ``padded``; out and every
    gradient (q, k, v, the bias) equal the plain attention at D = 41 with
    scale 1/sqrt(41)."""
    assert fa.padded_head_dim(41, dtype) == padded
    assert fa.padded_head_dim(64, dtype) == 64
    rng = np.random.RandomState(0)
    b, h, s_q, s_kv, d = 2, 3, 12, 20, 41
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(dtype).requires_grad_(True)
               for s in (s_q, s_kv, s_kv))
    bias = torch.from_numpy(rng.randn(1, h, s_q, s_kv).astype(np.float32)
                            ).requires_grad_(True)
    seen = []
    for name in ("flash_fwd_bias", "flash_bwd_dq_bias", "flash_bwd_dkv_bias"):
        real = getattr(fa, name)

        def spy(q_, *a, _real=real, _name=name, **kw):
            # dO follows (k, v, key_mask, bias, kbias, gmode, heads)
            seen.append((_name, q_.shape[-1],
                         a[7].shape[-1] if "bwd" in _name else None))
            return _real(q_, *a, **kw)
        monkeypatch.setattr(fa, name, spy)
    before = fa.dpad_launches
    out = fa.flash_attention(q, k, v, causal=True, bias=bias)
    cot = torch.from_numpy(rng.randn(b, h, s_q, d).astype(np.float32)
                           ).to(dtype)
    grads = torch.autograd.grad(out, (q, k, v, bias), cot)
    assert [x[:2] for x in seen] == [("flash_fwd_bias", padded),
                                     ("flash_bwd_dq_bias", padded),
                                     ("flash_bwd_dkv_bias", padded)]
    assert [x[2] for x in seen[1:]] == [padded, padded]     # dO padded too
    assert fa.dpad_launches == before      # the CPU launches no kernel
    assert out.shape == (b, h, s_q, d)
    want_out = sdpa_reference(q, k, v, causal=True, bias=bias)
    want = torch.autograd.grad(want_out, (q, k, v, bias), cot)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)
