"""The port's shared-prefix KV store (``serving/prefix_cache.py``) and
``DecodeEngine(prefix_store=)``, on the CPU at tiny size, held to the JAX
package.

* One seeded script of inserts and lookups runs on both stores (numpy
  rows in the JAX store, tensors in the port's): every ``(m, rows)``
  answer, ``len``, ``nbytes``, ``stats()``, the eviction order and the
  ``prefix_cache`` counters are equal, the rows exactly.
* A prefix-hit engine gives the greedy streams of a store-less engine
  and of the JAX engine with a store on the same weights, token for
  token, with the ``prefix_cache`` and prefill counters equal to the JAX
  run's.  A hit's seated rows equal the snapshot exactly; the rows it
  computes after them are held to the store-less engine's within
  ``CACHE_ATOL`` = 1e-5 (PyTorch's products change summation order with
  the row count, ROADMAP C6), and the smallest top-1 / top-2 logit gap
  over the streams is checked above ``GAP_MIN`` = 1e-4 (ROADMAP C7 (l))."""
import numpy as np
import pytest
import torch

import _torch_decode_harness as H


@pytest.fixture(scope="module")
def pair():
    return H.build_pair()


@pytest.fixture(autouse=True)
def _reset(pair):
    for p in pair:
        p.reset()
    yield


def _script(seed=0, n_ops=160):
    """(op, prompt, rows-or-None) over a 6-token vocabulary, so prompts
    share prefixes; rows are two cache names of (2, len, 4) float32."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        n = int(rng.randint(1, 9))
        prompt = rng.randint(0, 6, n).tolist()
        if rng.rand() < 0.5:
            rows = {name: rng.randn(2, n, 4).astype(np.float32)
                    for name in ("k0", "v0")}
            ops.append(("insert", prompt, rows))
        else:
            ops.append(("lookup", prompt, None))
    return ops


def _play(pkg, ops, capacity):
    store = pkg.store(capacity_bytes=capacity, min_tokens=2)
    trace = []
    for op, prompt, rows in ops:
        if op == "insert":
            if pkg.port:
                rows = {k: torch.from_numpy(v.copy()) for k, v in rows.items()}
            got = store.insert(prompt, rows)
        else:
            m, r = store.lookup(prompt)
            got = (m, None if r is None else
                   {k: np.asarray(v) for k, v in sorted(r.items())})
        keys = sorted(store._entries)
        trace.append((op, got, len(store), store.nbytes, store.stats(), keys))
    return trace


@pytest.mark.parametrize("capacity", [2048, 1 << 20])
def test_store_script_matches_jax(pair, capacity):
    """The same inserts and lookups on both stores: equal answers (rows
    exact), sizes, stats, entries after every op (so the eviction order),
    and counters.  2048 bytes holds a few entries (evictions and
    oversize skips); 1 MiB never evicts."""
    jax_side, port = pair
    ops = _script()
    want = _play(jax_side, ops, capacity)
    got = _play(port, ops, capacity)
    hits = 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[0] == g[0]
        if w[0] == "lookup":
            assert w[1][0] == g[1][0], i
            if w[1][1] is not None:
                hits += 1
                assert list(w[1][1]) == list(g[1][1])
                for k in w[1][1]:
                    np.testing.assert_array_equal(g[1][1][k], w[1][1][k])
        else:
            assert w[1] == g[1], i
        assert w[2:] == g[2:], i
    assert hits > 10
    counts = port.metrics.prefix_cache_counts()
    assert counts == jax_side.metrics.prefix_cache_counts()
    if capacity == 2048:
        assert counts["prefix_cache_evictions"] > 5
    else:
        assert "prefix_cache_evictions" not in counts


def test_lookup_rows_come_on_the_asking_device(pair):
    """``lookup(device=)`` hands the rows over on that device (a meta
    tensor stands in for the card); ``nbytes`` is numel x element size."""
    _, port = pair
    store = port.store()
    rows = {"k": torch.ones(2, 5, 4), "v": torch.zeros(2, 5, 4)}
    assert store.insert([1, 2, 3, 4, 5], rows)
    assert store.nbytes == 2 * 2 * 5 * 4 * 4
    m, got = store.lookup([1, 2, 3, 9], device="meta")
    assert m == 3
    assert all(t.device.type == "meta" and t.shape == (2, 3, 4)
               for t in got.values())
    m, got = store.lookup([1, 2, 3, 4, 5, 6])
    assert m == 5 and got["k"] is rows["k"]


def _schedule():
    base = [5, 3, 9, 2, 7, 1]
    return [(base + [4], 5), (base + [8, 6], 4), (base + [4], 3),
            (base + [4, 11, 12], 4), ([2, 4, 6], 4), ([2, 4, 6, 1], 3)]


def _serve(pkg, store, sched):
    eng = pkg.engine(store=store)
    out = []
    for prompt, max_new in sched:
        out.append(H.run(eng, pkg.request(prompt, max_new)))
    return eng, out


def test_prefix_hit_equals_the_cold_path_and_jax(pair):
    """Six prompts through one engine with a store (partial-overlap hits,
    an exact repeat, an extension of a stored prompt, a miss), against a
    store-less engine and the JAX engine with a store."""
    jax_side, port = pair
    sched = _schedule()
    _, want = _serve(jax_side, jax_side.store(), sched)
    jcounts = jax_side.counts()
    _, got = _serve(port, port.store(), sched)
    pcounts = port.counts()
    assert got == want
    for fam in ("prefix_cache", "decode"):
        assert pcounts[fam] == jcounts[fam], fam
    assert pcounts["prefix_cache"]["prefix_cache_hits"] == 4
    assert pcounts["prefix_cache"]["prefix_cache_hit_rows"] == 6 + 6 + 7 + 3
    port.reset()
    _, cold = _serve(port, None, sched)
    assert cold == got
    gaps = [H.greedy_with_gap(port, p, n) for p, n in sched]
    assert [t for t, _ in gaps] == got
    assert min(g for _, g in gaps) > H.GAP_MIN


def test_hit_seats_the_snapshot_rows_and_computes_the_rest_alike(pair):
    """A hit seats the stored rows exactly (a clone: the slot that made
    them has since been overwritten by another sequence) and computes its
    suffix rows within CACHE_ATOL of a cold engine's."""
    _, port = pair
    store = port.store()
    base = [5, 3, 9, 2, 7, 1]
    eng = port.engine(store=store, max_slots=1)
    H.run(eng, port.request(base + [4], 2))
    snap = store._entries[tuple(base + [4])].rows
    first = {k: v.clone() for k, v in snap.items()}
    H.run(eng, port.request([8, 8, 8, 8, 8, 8, 8, 8], 2))   # reuses slot 0
    for k in snap:
        assert torch.equal(snap[k], first[k])
        assert snap[k].data_ptr() != eng.caches[k].data_ptr()
    req = port.request(base + [10, 11], 3)
    eng.join(req)
    for k in eng.cache_names:
        assert torch.equal(eng.caches[k][0, :, :6], snap[k][:, :6])
    while eng.active:
        eng.step()
    cold = port.engine(max_slots=1)
    assert H.run(cold, port.request(base + [10, 11], 3)) == req.stream.result()
    rows = len(base) + 2 + 2
    for k in eng.cache_names:
        np.testing.assert_allclose(eng.caches[k][0, :, :rows].numpy(),
                                   cold.caches[k][0, :, :rows].numpy(),
                                   rtol=0, atol=H.CACHE_ATOL)


def test_min_tokens_and_capacity_skip_inserts(pair):
    """A prompt shorter than ``min_tokens`` and a snapshot larger than the
    whole capacity are not stored, in both packages alike."""
    jax_side, port = pair
    for pkg in pair:
        store = pkg.store(capacity_bytes=1000, min_tokens=4)
        eng = pkg.engine(store=store, max_slots=1)
        H.run(eng, pkg.request([3, 4, 5], 2))
        assert len(store) == 0
        big = pkg.store(capacity_bytes=100, min_tokens=2)
        eng = pkg.engine(store=big, max_slots=1)
        H.run(eng, pkg.request([3, 4, 5, 6], 2))
        assert len(big) == 0 and big.nbytes == 0
    assert port.metrics.prefix_cache_counts() \
        == jax_side.metrics.prefix_cache_counts()
