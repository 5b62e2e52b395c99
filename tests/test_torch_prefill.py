"""Chunked prefill in the port's decode engine, on the CPU at tiny size:
the properties tests/test_decode_prefill.py holds in the JAX package that
need no prefix store, and the port against the JAX package's chunked
engine on the same weights and the same schedule of joins (greedy
streams, ``_pick_chunk``'s choices and the prefill counters equal).

KV caches after chunked ingestion are held to the token-by-token path's
within atol 1e-5 and the greedy streams exactly: PyTorch's CPU matrix
product picks another summation order when the row count changes (B*C
rows in a chunked step, B in a one-token step), so the low bits of a
cache row may differ (by a few 1e-6 at most here), where XLA's are equal."""
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu.metrics as jmetrics                         # noqa: E402
import hetu_tpu.models as jmodels                           # noqa: E402
import hetu_tpu.serving as jserving                         # noqa: E402
from hetu_tpu.serving.decode import _DecodeRequest as JaxRequest  # noqa: E402
import hetu_tpu_torch as ht                                 # noqa: E402
from hetu_tpu_torch import metrics                          # noqa: E402
from hetu_tpu_torch.serving.decode import _DecodeRequest    # noqa: E402

_KW = dict(n_positions=64, batch_size=1, seq_len=16)
_MAX_LEN = 16
CACHE_ATOL = 1e-5
PREFILL_COUNTERS = ("decode_steps", "decode_prefill_steps",
                    "decode_prefill_steps_saved", "decode_prefill_rows",
                    "decode_logits_skipped", "decode_tokens",
                    "decode_generate_rows")


@pytest.fixture(scope="module")
def jax_graphs():
    cfg = jmodels.GPT2Config.tiny(**_KW)
    return (jmodels.gpt2_decode_graph(cfg, max_len=_MAX_LEN),
            jmodels.gpt2_decode_chunked_graph(cfg, max_len=_MAX_LEN))


def _jax_engine(jax_graphs, **kw):
    (feeds, logits, caches, _), cg = jax_graphs
    kw.setdefault("max_slots", 4)
    return jserving.DecodeEngine(feeds, logits, caches, seed=0,
                                 max_len=_MAX_LEN, chunked=cg[:3], **kw)


@pytest.fixture(scope="module")
def weights(jax_graphs):
    iex = _jax_engine(jax_graphs).iex
    return ht.params_from_named_arrays(
        {iex.var_names[n]: np.asarray(iex.params[iex._k(n)])
         for n in iex.var_nodes}, "cpu")


@pytest.fixture(scope="module")
def graphs():
    cfg = ht.GPT2Config.tiny(**_KW)
    return (ht.gpt2_decode_graph(cfg, max_len=_MAX_LEN),
            ht.gpt2_decode_chunked_graph(cfg, max_len=_MAX_LEN))


def _engine(graphs, weights, chunked=True, **kw):
    (feeds, logits, caches, _), cg = graphs
    kw.setdefault("max_slots", 4)
    if chunked:
        kw.setdefault("chunked", cg[:3])
    return ht.DecodeEngine(feeds, logits, caches, weights=weights, seed=0,
                           max_len=_MAX_LEN, device="cpu", **kw)


def _request(eng, prompt, max_new, eos_id=None):
    prompt = np.asarray(prompt, np.int32)
    if isinstance(eng, ht.DecodeEngine):
        return _DecodeRequest(prompt, max_new, eos_id)
    return JaxRequest(prompt, max_new, eos_id, None)


def _run(eng, prompt, max_new=6, eos_id=None):
    """One sequence straight on the engine: (tokens, engine steps)."""
    req = _request(eng, prompt, max_new, eos_id)
    eng.join(req)
    steps = 0
    while eng.active:
        eng.step()
        steps += 1
    return req.stream.result(timeout=60), steps


def _drive(eng, schedule):
    """Run ``schedule`` = [(join at step, prompt, max_new)] to the end.
    Returns (token streams, the chunk picked at every step)."""
    reqs, picks, step = [], [], 0
    todo = sorted(schedule, key=lambda x: x[0])
    while todo or eng.active:
        while todo and todo[0][0] <= step:
            _, prompt, max_new = todo.pop(0)
            reqs.append(_request(eng, prompt, max_new))
            eng.join(reqs[-1])
        active = [i for i, s in enumerate(eng.slots) if s is not None]
        picks.append(eng._pick_chunk(active) if active else 0)
        eng.step()
        step += 1
    return [r.stream.result(timeout=60) for r in reqs], picks


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, p).tolist() for p in lens]


# ------------------------------------------- chunked against token by token

@pytest.mark.parametrize("max_chunk", [2, 8])
def test_chunked_ingestion_equals_token_by_token(graphs, weights, max_chunk):
    """Ragged prompt lengths and chunk buckets: equal greedy streams,
    never more steps (fewer once the prompt spans several chunks), and
    the slot's KV rows within CACHE_ATOL of the one-token path's."""
    worst = 0.0
    for prompt in _prompts((1, 2, 3, 5, 8, 11), seed=7):
        ref = _engine(graphs, weights, chunked=False, max_slots=2)
        eng = _engine(graphs, weights, max_slots=2, max_chunk=max_chunk)
        itoks, isteps = _run(ref, prompt, 4)
        ctoks, csteps = _run(eng, prompt, 4)
        assert ctoks == itoks, (max_chunk, len(prompt))
        assert csteps <= isteps
        if len(prompt) > max_chunk:
            assert csteps < isteps
        rows = len(prompt) + 3               # the last token is not written
        for name in eng.cache_names:
            a = eng.caches[name][0, :, :rows].numpy()
            b = ref.caches[name][0, :, :rows].numpy()
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, rtol=0, atol=CACHE_ATOL)
            assert np.abs(b).max() > 0.01
    assert worst <= CACHE_ATOL


def test_mixed_batch_prefill_with_generating_rows(graphs, weights):
    """A long prompt that joins mid-generation rides chunked steps with
    the row that is already generating, and neither stream changes."""
    p_short, p_long = _prompts((2, 9), seed=3)
    eng = _engine(graphs, weights, max_slots=2, max_chunk=4)
    solo_short, _ = _run(eng, p_short, 6)
    solo_long, _ = _run(eng, p_long, 4)
    eng2 = _engine(graphs, weights, max_slots=2, max_chunk=4)
    got, picks = _drive(eng2, [(0, p_short, 6), (2, p_long, 4)])
    assert got == [solo_short, solo_long]
    assert max(picks) > 1 and 1 in picks


def test_ragged_valid_and_idle_slots_leave_other_rows_alone(graphs, weights):
    """One chunked step over a 4-slot batch with one 7-token prompt, one
    2-token prompt and two idle slots: the idle slots' cache rows stay
    zero, the short row's cache past its 2 tokens stays zero, and each
    stream equals its solo run."""
    p7, p2 = _prompts((7, 2), seed=5)
    solo = [_run(_engine(graphs, weights, max_chunk=8), p, 3)[0]
            for p in (p7, p2)]
    eng = _engine(graphs, weights, max_chunk=8)
    reqs = [_request(eng, p, 3) for p in (p7, p2)]
    eng._grow_batch()
    eng._grow_batch()                        # 4 slots: 2 stay idle
    for r in reqs:
        eng.join(r)
    metrics.reset_decode_counts()
    eng.step()
    assert metrics.decode_counts()["decode_prefill_steps"] == 1
    for name in eng.cache_names:
        c = eng.caches[name].numpy()
        assert not c[2:].any()               # idle slots
        assert not c[1, :, 2:].any()         # past the short row's tokens
        assert c[0, :, :7].any() and c[1, :, :2].any()
    while eng.active:
        eng.step()
    assert [r.stream.result(timeout=60) for r in reqs] == solo


def test_mid_chunk_eos(graphs, weights):
    """A prompt whose remainder ends mid-chunk emits its first token in
    that same chunked step; when that token is EOS the sequence leaves
    at once with exactly one token."""
    prompt, = _prompts((5,), seed=11)
    cold, _ = _run(_engine(graphs, weights, max_slots=2, max_chunk=8),
                   prompt, 6)
    eng = _engine(graphs, weights, max_slots=2, max_chunk=8)
    toks, steps = _run(eng, prompt, 6, eos_id=cold[0])
    assert toks == [cold[0]]
    assert steps == 1
    assert eng.active == 0


def test_pure_prefill_steps_skip_logits_fetch(graphs, weights):
    prompt = [3, 7, 11, 2, 5, 9]
    metrics.reset_decode_counts()
    _run(_engine(graphs, weights, chunked=False, max_slots=2), prompt, 2)
    assert metrics.decode_counts()["decode_logits_skipped"] == len(prompt) - 1
    metrics.reset_decode_counts()
    _run(_engine(graphs, weights, max_slots=2, max_chunk=8), prompt, 2)
    c = metrics.decode_counts()
    assert c["decode_prefill_steps"] == 1
    assert c["decode_prefill_steps_saved"] == len(prompt) - 1
    assert c.get("decode_logits_skipped", 0) == 0


def test_write_window_never_overruns_max_len(graphs, weights):
    """A prompt that ends at the cache's last rows: the chunk shrinks so
    that positions + chunk stays inside ``max_len`` and the stream still
    equals the one-token path's."""
    prompt, = _prompts((14,), seed=13)
    want, _ = _run(_engine(graphs, weights, chunked=False), prompt, 3)
    eng = _engine(graphs, weights, max_chunk=8)
    got, picks = _drive(eng, [(0, prompt, 3)])
    assert got == [want]
    assert picks[:3] == [8, 8, 1] or picks[:2] == [8, 4]
    assert eng.lb == _MAX_LEN


def test_ttft_is_recorded_once_per_stream(graphs, weights):
    metrics.reset_decode_counts()
    eng = _engine(graphs, weights, max_chunk=4)
    with ht.DecodeRouter(eng, queue_limit=16) as router:
        streams = [router.submit([3 + i, 5, 7], max_new_tokens=3)
                   for i in range(5)]
        for s in streams:
            s.result(timeout=120)
    lat = metrics.decode_latency_stats()
    assert lat["ttft"]["count"] == 5
    assert lat["token"]["count"] == 15


def test_pending_steps_folds_prompt_length(graphs, weights):
    """``pending_steps`` charges a queued prompt ceil(prompt_len /
    chunk_top) steps; ``pending`` still counts sequences."""
    eng = _engine(graphs, weights, max_slots=2, max_chunk=4)
    router = ht.DecodeRouter(eng, queue_limit=8, start=False)
    try:
        router.submit([1] * 10, max_new_tokens=2)   # ceil(10/4) = 3
        router.submit([2] * 3, max_new_tokens=2)    # ceil(3/4) = 1
        assert router.pending == 2
        assert router.pending_steps == 4
    finally:
        router.close()
    plain = ht.DecodeRouter(_engine(graphs, weights, chunked=False),
                            start=False)
    try:
        plain.submit([1] * 10, max_new_tokens=2)
        assert plain.pending_steps == 10            # chunk_top is 1
    finally:
        plain.close()


def test_pending_returns_to_zero_after_the_streams_finish(graphs, weights):
    eng = _engine(graphs, weights, max_chunk=4)
    with ht.DecodeRouter(eng) as router:
        router.submit([4, 5, 6, 7, 8], max_new_tokens=3).result(timeout=120)
        for _ in range(200):
            if router.pending == 0:
                break
            time.sleep(0.01)
        assert router.pending == 0 and router.pending_steps == 0


# --------------------------------------------------- against the JAX package

SCHEDULES = {
    "ragged_prompts": [(0, p, 4) for p in _prompts((1, 2, 3, 5), seed=7)],
    "late_long_prompt": [(0, _prompts((2,), 3)[0], 6),
                         (2, _prompts((9,), 4)[0], 4)],
    "stragglers_into_generators": [(0, _prompts((3,), 1)[0], 8),
                                   (0, _prompts((2,), 2)[0], 8),
                                   (0, _prompts((1,), 5)[0], 8),
                                   (3, _prompts((11,), 6)[0], 2)],
}


@pytest.mark.parametrize("max_chunk", [4, 8])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_streams_chunk_choices_and_counters_match_jax(
        jax_graphs, graphs, weights, name, max_chunk):
    """The same joins at the same steps through the JAX package's chunked
    engine and the port's, on the same weights: equal greedy streams,
    equal ``_pick_chunk`` choices at every step, equal prefill counters."""
    jmetrics.reset_decode_counts()
    want, jpicks = _drive(_jax_engine(jax_graphs, max_chunk=max_chunk),
                          SCHEDULES[name])
    jc = jmetrics.decode_counts()
    metrics.reset_decode_counts()
    got, picks = _drive(_engine(graphs, weights, max_chunk=max_chunk),
                        SCHEDULES[name])
    c = metrics.decode_counts()
    assert got == want
    assert picks == jpicks
    assert max(picks) > 1
    assert {k: c.get(k, 0) for k in PREFILL_COUNTERS} == \
        {k: jc.get(k, 0) for k in PREFILL_COUNTERS}


def test_router_greedy_streams_match_jax_chunked_engine(jax_graphs, graphs,
                                                        weights):
    prompts = _prompts((3, 9, 1, 12), seed=21)
    with jserving.DecodeRouter(_jax_engine(jax_graphs)) as router:
        streams = [router.submit(p, max_new_tokens=4) for p in prompts]
        want = [s.result(timeout=300) for s in streams]
    metrics.reset_decode_counts()
    with ht.DecodeRouter(_engine(graphs, weights)) as router:
        streams = [router.submit(p, max_new_tokens=4) for p in prompts]
        got = [s.result(timeout=300) for s in streams]
    assert got == want
    assert metrics.decode_counts()["decode_prefill_steps_saved"] > 0


def test_chunk_ladder_matches_jax(jax_graphs, graphs, weights):
    for mc in (None, 2, 5, 8):
        kw = {} if mc is None else {"max_chunk": mc}
        j = _jax_engine(jax_graphs, **kw)
        t = _engine(graphs, weights, **kw)
        assert t.chunk_ladder == tuple(j.chunk_ladder)
        assert t.chunk_top == j.chunk_top
    assert _engine(graphs, weights, chunked=False).chunk_ladder == (1,)
