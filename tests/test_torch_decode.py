"""The port's GPT-2 decode slice against the JAX package, on the CPU at
tiny size: the JAX tiny decode engine's weights carried into the port
(``params_from_named_arrays``) give the same per-step logits for a
teacher-forced prompt (atol 1e-4, float32 through two layers) and the
same greedy streams through ``DecodeRouter``; and the continuous-batching
properties of tests/test_decode.py hold for the port's router."""
import os
import sys
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu.models as jmodels                          # noqa: E402
import hetu_tpu.serving as jserving                        # noqa: E402
import hetu_tpu_torch as ht                                # noqa: E402
from hetu_tpu_torch import metrics                         # noqa: E402
from hetu_tpu_torch.serving.decode import _DecodeRequest   # noqa: E402

_KW = dict(n_positions=64, batch_size=1, seq_len=16)
_MAX_LEN = 24
LOGITS_ATOL = 1e-4
PROMPTS = [([5, 9, 13], 8), ([7, 3, 11, 2, 8], 6), ([1], 10)]


@pytest.fixture(scope="module")
def jax_engine():
    cfg = jmodels.GPT2Config.tiny(**_KW)
    feeds, logits, caches, _ = jmodels.gpt2_decode_graph(cfg, max_len=_MAX_LEN)
    return jserving.DecodeEngine(feeds, logits, caches, seed=0, max_slots=4,
                                 max_len=_MAX_LEN)


@pytest.fixture(scope="module")
def jax_weights(jax_engine):
    iex = jax_engine.iex
    return {iex.var_names[n]: np.asarray(iex.params[iex._k(n)])
            for n in iex.var_nodes}


@pytest.fixture(scope="module")
def decode_graph():
    return ht.gpt2_decode_graph(ht.GPT2Config.tiny(**_KW), max_len=_MAX_LEN)


def _engine(decode_graph, weights=None, **kw):
    feeds, logits, caches, _ = decode_graph
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", _MAX_LEN)
    if weights is not None:
        weights = ht.params_from_named_arrays(weights, "cpu")
    return ht.DecodeEngine(feeds, logits, caches, weights=weights, seed=0,
                           device="cpu", **kw)


def _jax_teacher_forced(eng, tokens):
    iex, fk = eng.iex, eng._fk
    fn = iex.compiled(1)
    L = next(b for b in eng.len_ladder if b >= len(tokens))
    caches = [jnp.zeros((1, eng._heads, L, eng._head_dim), jnp.float32)
              for _ in eng.cache_names]
    out = []
    for t, tok in enumerate(tokens):
        feeds = {fk["input_ids"]: np.array([[tok]], np.int32),
                 fk["positions"]: np.array([t], np.int32)}
        feeds.update({fk[n]: c for n, c in zip(eng.cache_names, caches)})
        outs = fn(iex.params, feeds)
        out.append(np.asarray(outs[0])[0])
        caches = list(outs[1:])
    return np.stack(out)


def _torch_teacher_forced(eng, tokens):
    fn = eng.iex.compiled(1)
    L = next(b for b in eng.len_ladder if b >= len(tokens))
    caches = {n: eng._alloc(1, L) for n in eng.cache_names}
    out = []
    for t, tok in enumerate(tokens):
        feeds = {eng._fk["input_ids"]: torch.tensor([[tok]],
                                                    dtype=torch.int32),
                 eng._fk["positions"]: torch.tensor([t], dtype=torch.int32)}
        feeds.update({eng._fk[n]: caches[n] for n in eng.cache_names})
        out.append(fn(eng.iex.params, feeds)[0][0].numpy())
    return np.stack(out)


# ------------------------------------------------- parity with the JAX package

def test_weights_carry_over_by_name(decode_graph, jax_weights):
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # a missing name would warn
        eng = _engine(decode_graph, jax_weights)
    names = set(eng.iex.var_names.values())
    assert names == set(jax_weights)
    for n in eng.iex.var_nodes:
        np.testing.assert_array_equal(
            eng.iex.params[eng.iex._k(n)].numpy(),
            jax_weights[eng.iex.var_names[n]])


def test_teacher_forced_logits_match_jax(decode_graph, jax_engine,
                                         jax_weights):
    tokens = list(np.random.RandomState(0).randint(0, 512, size=14))
    want = _jax_teacher_forced(jax_engine, tokens)
    got = _torch_teacher_forced(_engine(decode_graph, jax_weights), tokens)
    assert got.shape == want.shape == (14, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)


def test_router_greedy_streams_match_jax(decode_graph, jax_engine,
                                         jax_weights):
    with jserving.DecodeRouter(jax_engine) as router:
        streams = [router.submit(p, max_new_tokens=n) for p, n in PROMPTS]
        want = [s.result(timeout=300) for s in streams]
    eng = _engine(decode_graph, jax_weights)
    with ht.DecodeRouter(eng) as router:
        streams = [router.submit(p, max_new_tokens=n) for p, n in PROMPTS]
        got = [s.result(timeout=300) for s in streams]
    assert got == want
    assert [len(g) for g in got] == [n for _, n in PROMPTS]


# ----------------------------------------- continuous batching in the port

def test_decode_stable_across_batch_mates(decode_graph):
    """The same prompt decodes to the same token stream whatever else
    shares the in-flight batch (each slot attends only to its own rows)."""
    eng = _engine(decode_graph)
    prompt = [7, 3, 11]
    with ht.DecodeRouter(eng) as router:
        solo = router.submit(prompt, max_new_tokens=6).result(timeout=120)
        streams = [router.submit(p, max_new_tokens=6)
                   for p in (prompt, [2], [9, 4, 1, 8], [1, 1])]
        crowded = [s.result(timeout=120) for s in streams]
    assert crowded[0] == solo
    assert len(solo) == 6


def test_continuous_join_leave_slot_recycle(decode_graph):
    metrics.reset_decode_counts()
    eng = _engine(decode_graph, max_slots=2)
    prompts = [([3], 2), ([5, 6], 4), ([7, 8, 9], 3), ([11], 5)]
    with ht.DecodeRouter(eng, queue_limit=8) as router:
        streams = [router.submit(p, max_new_tokens=n) for p, n in prompts]
        outs = [s.result(timeout=120) for s in streams]
    for (p, n), toks in zip(prompts, outs):
        assert len(toks) == n
    c = metrics.decode_counts()
    assert c["decode_joins"] == 4 and c["decode_leaves"] == 4
    assert c["decode_slot_recycles"] >= 2
    assert c["decode_tokens"] == sum(n for _, n in prompts)
    assert c["decode_prefill_rows"] == sum(len(p) - 1 for p, _ in prompts)
    assert c["decode_kv_bytes_hw"] > 0
    assert eng.idle and eng.capacity() == 2
    assert metrics.decode_latency_stats()["step"]["count"] \
        == c["decode_steps"]


def test_backpressure_and_too_long_rejection(decode_graph):
    eng = _engine(decode_graph, max_slots=2)
    router = ht.DecodeRouter(eng, queue_limit=1, start=False)
    try:
        router.submit([1], max_new_tokens=2)
        with pytest.raises(ht.ServeRejected) as ei:
            router.submit([2], max_new_tokens=2)
        assert ei.value.reason == "queue_full"
        with pytest.raises(ht.ServeRejected) as ei:
            router.submit(list(range(10)), max_new_tokens=_MAX_LEN)
        assert ei.value.reason == "over_max_len"
    finally:
        router.close()
    with pytest.raises(ht.ServeRejected) as ei:
        router.submit([1], max_new_tokens=2)
    assert ei.value.reason == "draining"


def test_stream_token_futures_and_iteration(decode_graph):
    eng = _engine(decode_graph, max_slots=2)
    with ht.DecodeRouter(eng) as router:
        s = router.submit([5, 2], max_new_tokens=3)
        first = s.token(0).result(timeout=120)
        rest = s.result(timeout=120)
        assert rest[0] == first and len(rest) == 3
        assert list(s) == rest
        with pytest.raises(IndexError):
            s.token(10).result(timeout=5)
        assert s.n_tokens == 3 and s.done


def test_router_close_fails_queued(decode_graph):
    eng = _engine(decode_graph, max_slots=1)
    router = ht.DecodeRouter(eng, queue_limit=8, start=False)
    queued = router.submit([1, 2], max_new_tokens=4)
    router.close()
    with pytest.raises(ht.ServeRejected) as ei:
        queued.result(timeout=5)
    assert ei.value.reason == "draining"


def test_deadline_expired_in_queue_fails_fast(decode_graph):
    metrics.reset_decode_counts()
    eng = _engine(decode_graph, max_slots=1)
    router = ht.DecodeRouter(eng, queue_limit=8, start=False)
    try:
        doomed = router.submit([1, 2], max_new_tokens=2, deadline_ms=0.01)
        live = router.submit([3, 2], max_new_tokens=2)
        time.sleep(0.05)
        router.start()
        with pytest.raises(ht.ServeRejected) as ei:
            doomed.result(timeout=30)
        assert ei.value.reason == "deadline"
        assert live.result(timeout=60)
        assert metrics.decode_counts()["decode_deadline_evictions"] == 1
    finally:
        router.close()


def test_deadline_mid_generation_evicts_and_frees_slot(decode_graph):
    eng = _engine(decode_graph, max_slots=1)
    req = _DecodeRequest(np.asarray([1, 2], np.int32), _MAX_LEN - 2, None,
                         deadline=time.monotonic() + 1000.0)
    eng.join(req)
    eng.step()
    eng.step()
    assert eng.evict_expired(now=req.deadline - 1.0) == 0
    assert eng.evict_expired(now=req.deadline + 1.0) == 1
    with pytest.raises(ht.ServeRejected) as ei:
        req.stream.result(timeout=5)
    assert ei.value.reason == "deadline"
    assert eng.idle and eng.capacity() == 1


def test_cache_grows_along_the_ladders(decode_graph):
    metrics.reset_decode_counts()
    eng = _engine(decode_graph, max_slots=4)
    with ht.DecodeRouter(eng) as router:
        streams = [router.submit(list(range(1, 10)), max_new_tokens=8)
                   for _ in range(3)]
        assert all(len(s.result(timeout=120)) == 8 for s in streams)
    # 9 prompt + 7 fed-back tokens write rows 0..15: length bucket 16
    assert eng.bb == 4 and eng.lb == 16
    assert eng.kv_bytes == 2 * 2 * 4 * 2 * 16 * 64 * 4
    c = metrics.decode_counts()
    assert c["decode_batch_grows"] == 2 and c["decode_len_grows"] == 4


# ------------------------------------------------------- InferenceExecutor

@pytest.mark.parametrize("max_batch", [1, 5, 64, 100, 128, 300, 513])
def test_default_buckets_match_jax(max_batch):
    assert ht.default_buckets(max_batch) \
        == jserving.default_buckets(max_batch)


def test_seeded_init_is_deterministic(decode_graph):
    _, logits, _, _ = decode_graph
    a = ht.InferenceExecutor([logits], seed=3, device="cpu")
    b = ht.InferenceExecutor([logits], seed=3, device="cpu")
    c = ht.InferenceExecutor([logits], seed=4, device="cpu")
    wte = next(n for n in a.var_nodes if n.name == "gpt2.wte")
    ka = a._k(wte)
    assert torch.equal(a.params[ka], b.params[ka])
    assert not torch.equal(a.params[ka], c.params[ka])
    w = a.params[ka]
    # truncated normal(0, 0.02) cut at two standard deviations
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.02


def test_missing_weights_warn_and_fall_back_to_init(decode_graph):
    _, logits, _, _ = decode_graph
    with pytest.warns(RuntimeWarning, match="no value"):
        iex = ht.InferenceExecutor(
            [logits], weights={"gpt2.wte": np.ones((512, 128), np.float32)},
            device="cpu")
    wte = next(n for n in iex.var_nodes if n.name == "gpt2.wte")
    assert float(iex.params[iex._k(wte)].min()) == 1.0


def test_compiled_is_built_once_per_bucket(decode_graph):
    _, logits, _, _ = decode_graph
    iex = ht.InferenceExecutor([logits], buckets=(1, 4), device="cpu")
    assert iex.compiled(4) is iex.compiled(4)
    with pytest.raises(ValueError):
        iex.compiled(2)


def test_step_failure_fails_inflight_streams_and_router_keeps_serving(
        decode_graph):
    """A step that raises fails every in-flight stream with that error;
    the loop survives and serves the next request."""
    eng = _engine(decode_graph, max_slots=2)
    real_step = eng.step
    boom = RuntimeError("device fault")

    def failing_step():
        eng.step = real_step
        raise boom

    eng.step = failing_step
    with ht.DecodeRouter(eng) as router:
        doomed = router.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="device fault"):
            doomed.result(timeout=60)
        assert len(router.submit([4, 5], max_new_tokens=3)
                   .result(timeout=60)) == 3
    assert eng.idle
