"""XLNet permutation-LM training in the port against the JAX package.

Both packages build ``xlnet_plm_graph`` on ``XLNetConfig.tiny`` (2
layers, 128 wide, 2 heads, d_inner 256, vocabulary 512, clamp 256;
batch 2, S = 32, dropout 0) and feed ``synthetic_plm_batch(seed=0)``:
per-sequence permutation masks (B, 1, S, S), group ``b`` for the
kernels, whose query stream has one row a sequence that sees no key.
The JAX ``Executor(seed=0)`` weights go into the port through
``load_dict``; then the same feeds go through both.  Both run the masked,
biased attention through their plain versions here on the CPU (the JAX
package's ``sdpa_reference``, the port's counted ``backend:cpu`` path);
the port's mask-with-bias kernels are held to the Pallas kernels in
tests/test_torch_flash_attention.py.

Tolerances (float32): step-1 loss atol 1e-5; every variable's gradient,
the relative-position tables and ``mask_emb`` included,
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
from hetu_tpu.models import xlnet as jxl                  # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics                        # noqa: E402
from hetu_tpu_torch.models import xlnet as txl            # noqa: E402

CFG = dict(batch_size=2, dropout=0.0)
FEEDS = ("input_ids", "content_mask", "query_mask", "labels")


def _build(ht, models, topo, device=None):
    cfg = models.XLNetConfig.tiny(**CFG)
    feeds, loss, _ = models.xlnet_plm_graph(cfg)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(loss)
    kw = {} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, train_op] + grads}, seed=0, **kw)
    return cfg, feeds, ex, [n.name for n in wrt]


@pytest.fixture(scope="module")
def trained():
    """Both executors over 5 Adam steps from the JAX package's weights."""
    jcfg, jfeeds, jex, jnames = _build(jht, jxl, jax_topo)
    tcfg, tfeeds, tex, tnames = _build(tht, txl, tht.topo_sort, device="cpu")
    assert tnames == jnames
    assert sorted(tex.var_names.values()) == sorted(jex.var_names.values())
    weights = jex.return_tensor_values()
    tex.load_dict(weights)
    batch = jxl.synthetic_plm_batch(jcfg, seed=0)
    jfd = {jfeeds[k]: v for k, v in zip(FEEDS, batch)}
    tfd = {tfeeds[k]: v for k, v in zip(FEEDS, batch)}
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


def test_xlnet_training_step_matches_jax(trained):
    rec = trained
    cfg = rec["cfg"]
    np.testing.assert_allclose(rec["tl"][0], rec["jl"][0], rtol=0, atol=1e-5)
    # word, mask_emb, lm head (weight, bias), per layer q/k/v, o (weight,
    # bias), two norms (scale, bias), ff1 / ff2 (weight, bias), rel_bias
    n = 2 + 2 + cfg.n_layer * (3 + 2 + 4 + 4 + 1)
    assert len(rec["names"]) == len(rec["tg"]) == n
    assert sum(name.endswith(".rel_bias") for name in rec["names"]) \
        == cfg.n_layer
    for name, jg, tg in zip(rec["names"], rec["jg"], rec["tg"]):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    by_name = dict(zip(rec["names"], rec["tg"]))
    assert np.abs(by_name["xlnet.mask_emb"]).max() > 0
    assert all(np.abs(g).max() > 0 for name, g in by_name.items()
               if name.endswith(".rel_bias"))
    # every attention call took the plain version only because the tensors
    # are on the CPU: two streams a layer, each step, less the last
    # layer's content stream, which the loss (from the query stream) does
    # not reach and the fetch subgraph leaves out
    assert rec["fallbacks"] == {"backend:cpu": 5 * (2 * cfg.n_layer - 1)}


def test_xlnet_five_adam_steps_match_jax(trained):
    np.testing.assert_allclose(trained["tl"], trained["jl"], rtol=1e-5,
                               atol=0)
    assert trained["tl"][-1] < trained["tl"][0]


def test_xlnet_masks_batch_and_names_equal_the_jax_package():
    for make in ("base", "tiny"):
        assert vars(getattr(txl.XLNetConfig, make)()) \
            == vars(getattr(jxl.XLNetConfig, make)())
    cfg = txl.XLNetConfig.tiny(**CFG)
    for a, b in zip(txl.synthetic_plm_batch(cfg, seed=3),
                    jxl.synthetic_plm_batch(cfg, seed=3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    _, cmask, qmask, _ = txl.synthetic_plm_batch(cfg, seed=0)
    # each sequence's first token in the permutation: a query row with
    # no visible key, and the content row of the same token sees itself
    dead = qmask.sum(-1) == 0
    assert dead.sum(-1).tolist() == [[1]] * cfg.batch_size
    assert np.all(cmask.sum(-1)[dead] == 1)

    def names(models, topo):
        _, loss, _ = models.xlnet_plm_graph(models.XLNetConfig.tiny(**CFG))
        return sorted((n.name, tuple(n.shape), bool(n.trainable))
                      for n in topo([loss])
                      if getattr(n, "is_variable", False))
    assert names(txl, tht.topo_sort) == names(jxl, jax_topo)
