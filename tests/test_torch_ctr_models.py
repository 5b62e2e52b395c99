"""The port's CTR models against the JAX package's, on the CPU at a tiny
size (vocab 520, dim 4, batch 8, 26 Zipf fields: the cache evicts from
the second step on):

* bf16 Wide & Deep with PS embeddings (``Executor(compute_dtype=
  "bfloat16")`` over the device cache, CPU slab): 5 SGD steps against
  ``hetu_tpu``'s bf16 run at ``tests/test_torch_bf16.py``'s gates — the
  step-1 loss at rtol 5e-3, every step-1 dense gradient at rtol 2e-2 /
  atol 1e-2, bf16 against the port's float32 run at rtol 5e-2 / atol
  5e-2 — and the 5 losses within one bf16 ulp of the JAX package's: the
  fetched loss is a bf16 number in both packages, and XLA's fused
  rounding and torch's per-op rounding put it one ulp apart on 2 of the
  5 steps even from equal weights (one ulp is 2^-8 = 3.9e-3 in [0.5, 1),
  6.3e-3 relative at 0.62, above rtol 5e-3); the store table after the
  flush within rtol 5e-2 / atol 5e-2, and the row gradient reaching
  B5's plain twin float32 in every step;
* DeepFM and DCN in ``dense`` and ``vlru_dev`` (CPU slab) modes through
  ``tests/_torch_model_parity.py``'s gates: the step-1 loss atol 1e-5,
  every dense gradient rtol 1e-4 / atol 1e-6, 5 Adam losses rtol 1e-5;
* ``validate_cache_parity`` at a few steps: the cache counters equal the
  JAX package's (they read ids only) and the curves stay together.

Both packages take one table (``set_data``) and one set of dense weights
(``load_dict``)."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu as jht                                  # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo   # noqa: E402
import hetu_tpu_torch as tht                            # noqa: E402
from hetu_tpu_torch.ops.kernels import segment_sum as tseg  # noqa: E402
import _torch_model_parity as parity                    # noqa: E402

VOCAB, DIM, BATCH = 520, 4, 8
BF16_LOSS_RTOL = 5e-3                     # tests/test_torch_bf16.py
BF16_GRAD_TOL = dict(rtol=2e-2, atol=1e-2)
BF16_PARITY = dict(rtol=5e-2, atol=5e-2)  # bf16 against float32


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def _jax_ctr():
    spec = importlib.util.spec_from_file_location(
        "jax_ctr_models_cm", os.path.join(ROOT, "examples", "ctr",
                                          "models.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCTR = _jax_ctr()


def _batches(steps, seed=0):
    d, s, y = tht.synthetic_criteo_skewed(steps * BATCH, vocab=VOCAB,
                                          seed=seed)
    return [(d[i * BATCH:(i + 1) * BATCH], s[i * BATCH:(i + 1) * BATCH],
             y[i * BATCH:(i + 1) * BATCH]) for i in range(steps)]


def _table():
    return np.random.RandomState(1).uniform(
        -0.01, 0.01, (VOCAB, DIM)).astype(np.float32)


def _build(port, model, mode, opt, grads=False, **ex_kw):
    """``model`` ('wdl', 'deepfm', 'dcn') in one package: (feeds,
    executor, dense trainable variables, the cache or None)."""
    ht = tht if port else jht
    ctr = tht.models.ctr if port else JCTR
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    kw = {"slab_device": "cpu"} if port and mode.endswith("_dev") else {}
    loss, _ = getattr(ctr, f"{model}_criteo")(
        dense, sparse, y_, BATCH, vocab=VOCAB, dim=DIM, embed_mode=mode,
        lr=0.01, **kw)
    topo = (tht.topo_sort if port else jax_topo)([loss])
    wrt = [n for n in topo if getattr(n, "is_variable", False)
           and n.trainable]
    fetch = [loss, opt(ht).minimize(loss)]
    if grads:
        fetch += ht.gradients(loss, wrt)
    if port:
        ex_kw["device"] = "cpu"
    ex = ht.Executor({"train": fetch}, seed=0, **ex_kw)
    ps = [n for n in topo if getattr(n, "is_ps", False)]
    cache = ps[0].cache if ps else None
    if cache is not None:
        cache.store.set_data(cache.table, _table())
    return (dense, sparse, y_), ex, wrt, cache


def _train(ex, feeds, batches, grads=False):
    losses, g1 = [], None
    for i, b in enumerate(batches):
        out = ex.run("train", feed_dict=dict(zip(feeds, b)))
        losses.append(float(np.asarray(out[0].asnumpy())))
        if grads and i == 0:
            g1 = [np.asarray(g.asnumpy()) for g in out[2:]]
    return losses, g1


def _sgd(ht):
    return ht.optim.SGDOptimizer(0.01)


def _adam(ht):
    return ht.optim.AdamOptimizer(1e-3)


# -- bf16 Wide & Deep with PS embeddings --------------------------------------

def test_bf16_wdl_with_ps_embeddings_matches_jax(monkeypatch):
    batches = _batches(5)
    dtypes = []
    plain = tseg.sorted_segment_sum_plain

    def recording(rows, seg_ids, num_segments):
        dtypes.append(rows.dtype)
        return plain(rows, seg_ids, num_segments)

    monkeypatch.setattr(tseg, "sorted_segment_sum_plain", recording)
    jfeeds, jex, jwrt, jc = _build(False, "wdl", "vlru_dev", _sgd,
                                   grads=True, compute_dtype="bfloat16")
    out = {}
    for cd in ("bfloat16", None):
        tfeeds, tex, twrt, tc = _build(True, "wdl", "vlru_dev", _sgd,
                                       grads=True, compute_dtype=cd)
        assert [n.name for n in twrt] == [n.name for n in jwrt]
        tex.load_dict(jex.return_tensor_values())
        dtypes.clear()
        losses, g1 = _train(tex, tfeeds, batches, grads=True)
        tc.flush()
        out[cd] = (losses, g1, tc.store.get_data(tc.table), list(dtypes),
                   dict(tc.stats))
        tex.close()
    jl, jg = _train(jex, jfeeds, batches, grads=True)
    jc.flush()
    tl, tg, ttab, seen, tstats = out["bfloat16"]
    # the row gradient reached B5's plain twin as float32, once a step
    assert seen == [torch.float32] * len(batches)
    np.testing.assert_allclose(tl[0], jl[0], rtol=BF16_LOSS_RTOL, atol=0)
    assert np.all(np.abs(np.subtract(tl, jl)) <= _bf16_ulp(jl)), (tl, jl)
    for w, a, b in zip(jwrt, tg, jg):
        np.testing.assert_allclose(a, b, err_msg=w.name, **BF16_GRAD_TOL)
    np.testing.assert_allclose(tl, out[None][0], **BF16_PARITY)
    np.testing.assert_allclose(ttab, jc.store.get_data(jc.table),
                               **BF16_PARITY)
    # the cache's decisions read ids only: equal to the JAX run's
    for k in ("lookups", "hits", "evictions", "pushes", "fetches",
              "updates"):
        assert tstats[k] == jc.stats[k], k
    # the slab stays float32
    assert tc._ensure_dev_slab().dtype == torch.float32


# -- DeepFM and DCN through the model-parity gates ----------------------------

@pytest.mark.parametrize("mode", ["dense", "vlru_dev"])
@pytest.mark.parametrize("model", ["deepfm", "dcn"])
def test_ctr_model_matches_jax(model, mode):
    batches = _batches(parity.STEPS, seed=3)
    jfeeds, jex, jwrt, jc = _build(False, model, mode, _adam, grads=True)
    tfeeds, tex, twrt, tc = _build(True, model, mode, _adam, grads=True)
    names = [n.name for n in jwrt]
    assert [n.name for n in twrt] == names
    tex.load_dict(jex.return_tensor_values())
    jl, jg = _train(jex, jfeeds, batches, grads=True)
    tl, tg = _train(tex, tfeeds, batches, grads=True)
    rec = {"names": names, "jl": jl, "tl": tl, "jg": jg, "tg": tg,
           "fallbacks": {}}
    parity.check_step(rec, 0)
    parity.check_trajectory(rec)
    if mode == "vlru_dev":
        for k in ("lookups", "hits", "evictions", "pushes", "fetches"):
            assert tc.stats[k] == jc.stats[k], k
        assert tc.stats["evictions"] > 0
    tex.close()


def test_validate_cache_parity_agrees_with_jax():
    kw = dict(steps=4, batch_size=32, vocab=VOCAB, dim=DIM, record_every=1)
    t = tht.validate_cache_parity(device="cpu", **kw)
    j = JCTR.validate_cache_parity(**kw)
    assert t["config"] == j["config"]
    assert t["cache_perf"] == j["cache_perf"]
    assert t["cache_hit_rate"] == j["cache_hit_rate"]
    assert len(t["loss_curve_cache_on"]) == len(j["loss_curve_cache_on"]) \
        == kw["steps"]
    assert np.all(np.isfinite(t["loss_curve_cache_on"]))
    assert t["max_curve_divergence"] < 0.05
    assert 0.0 <= t["auc_cache_on"] <= 1.0
