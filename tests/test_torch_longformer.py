"""Longformer MLM training in the port against the JAX package.

Both packages build ``longformer_mlm_graph`` on ``LongformerConfig.tiny``
(2 layers, 128 wide, 2 heads, intermediate 256, vocabulary 512, window 8,
one global token; batch 2, S = 64, dropout 0) and feed the ids and 15 %
labels ``examples/transformers/train_lm.py`` draws from
``RandomState(0)`` (``synthetic_mlm_ids``).  The static (1, 1, S, S)
sliding-window + global mask is one non-trainable Variable, group
``one`` for the kernels.  The JAX ``Executor(seed=0)`` weights go into
the port through ``load_dict``; then the same feeds go through both.
Both run the masked attention through their plain versions here on the
CPU (the JAX package's ``sdpa_reference``, the port's counted
``backend:cpu`` path); the port's full-mask kernels, forward and
backward, are held to the Pallas kernels in
tests/test_torch_flash_attention.py.

Tolerances (float32): step-1 loss atol 1e-5; every variable's gradient
``allclose(rtol=1e-4, atol=1e-6)``; a 5-step Adam loss trajectory rtol
1e-5."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo     # noqa: E402
from hetu_tpu.models import longformer as jlf             # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics                        # noqa: E402
from hetu_tpu_torch.models import longformer as tlf       # noqa: E402

CFG = dict(batch_size=2, hidden_dropout_prob=0.0)


def _build(ht, models, topo, device=None):
    cfg = models.LongformerConfig.tiny(**CFG)
    feeds, loss, _ = models.longformer_mlm_graph(cfg)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(loss)
    kw = {} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, train_op] + grads}, seed=0, **kw)
    return cfg, feeds, ex, [n.name for n in wrt]


def _train_lm_draw(cfg):
    """The ids and labels of ``examples/transformers/train_lm.py``'s
    Longformer branch, as written there."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      (cfg.batch_size, cfg.seq_len)).astype(np.int32)
    labels = np.where(rng.rand(cfg.batch_size, cfg.seq_len) < 0.15,
                      ids, -1).astype(np.int32)
    return ids, labels


@pytest.fixture(scope="module")
def trained():
    """Both executors over 5 Adam steps from the JAX package's weights."""
    jcfg, jfeeds, jex, jnames = _build(jht, jlf, jax_topo)
    tcfg, tfeeds, tex, tnames = _build(tht, tlf, tht.topo_sort, device="cpu")
    assert tnames == jnames
    assert sorted(tex.var_names.values()) == sorted(jex.var_names.values())
    tex.load_dict(jex.return_tensor_values())
    ids, labels = tlf.synthetic_mlm_ids(tcfg, seed=0)
    jfd = {jfeeds["input_ids"]: ids, jfeeds["labels"]: labels}
    tfd = {tfeeds["input_ids"]: ids, tfeeds["labels"]: labels}
    metrics.reset_flash_fallbacks()
    rec = {"names": jnames, "jl": [], "tl": [], "cfg": tcfg}
    for step in range(5):
        jout = jex.run("train", feed_dict=jfd)
        tout = tex.run("train", feed_dict=tfd)
        rec["jl"].append(float(np.asarray(jout[0].asnumpy())))
        rec["tl"].append(float(tout[0].asnumpy()))
        if step == 0:
            rec["jg"] = [np.asarray(g.asnumpy()) for g in jout[2:]]
            rec["tg"] = [g.asnumpy() for g in tout[2:]]
    rec["fallbacks"] = metrics.flash_fallback_counts()
    return rec


def test_longformer_training_step_matches_jax(trained):
    rec = trained
    cfg = rec["cfg"]
    np.testing.assert_allclose(rec["tl"][0], rec["jl"][0], rtol=0, atol=1e-5)
    # word, pos, emb_ln (scale, bias), mlm head (weight, bias), per layer
    # q / k / v / q_global / o (weight, bias), two norms, ffn1 / ffn2
    n = 2 + 2 + 2 + cfg.num_hidden_layers * (10 + 4 + 4)
    assert len(rec["names"]) == len(rec["tg"]) == n
    for name, jg, tg in zip(rec["names"], rec["jg"], rec["tg"]):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # the first layer's global query projection is trained through its
    # one position, which every later key sees (the last layer's reaches
    # the loss only through position 0's own label, -1 in this draw)
    assert all(np.abs(g).max() > 0 for name, g in zip(rec["names"],
                                                      rec["tg"])
               if name.startswith("longformer.layer0.attn.q_global."))
    assert rec["fallbacks"] == {"backend:cpu": 5 * cfg.num_hidden_layers}


def test_longformer_five_adam_steps_match_jax(trained):
    np.testing.assert_allclose(trained["tl"], trained["jl"], rtol=1e-5,
                               atol=0)
    assert trained["tl"][-1] < trained["tl"][0]


@pytest.mark.parametrize("seq_len,window,num_global",
                         [(64, 8, 1), (4096, 512, 1), (100, 7, 3)])
def test_longformer_mask_equals_the_jax_package(seq_len, window,
                                                num_global):
    got = tlf.longformer_attention_mask(seq_len, window, num_global)
    want = jlf.longformer_attention_mask(seq_len, window, num_global)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # every row sees its window (and the global columns); the global rows
    # see everything
    assert np.all(got[:num_global] == 1) and np.all(got[:, :num_global] == 1)
    assert np.all(got[np.arange(seq_len), np.arange(seq_len)] == 1)


def test_longformer_configs_draw_and_names_equal_the_jax_package():
    for make in ("base", "tiny"):
        assert vars(getattr(tlf.LongformerConfig, make)()) \
            == vars(getattr(jlf.LongformerConfig, make)())
    cfg = tlf.LongformerConfig.tiny(**CFG)
    for a, b in zip(tlf.synthetic_mlm_ids(cfg, seed=0), _train_lm_draw(cfg)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32

    def names(models, topo):
        _, loss, _ = models.longformer_mlm_graph(
            models.LongformerConfig.tiny(**CFG))
        return sorted((n.name, tuple(n.shape), bool(n.trainable))
                      for n in topo([loss])
                      if getattr(n, "is_variable", False))
    assert names(tlf, tht.topo_sort) == names(jlf, jax_topo)
