"""Shared harness of the serving-plane parity tests
(``test_torch_prefix_cache.py``, ``test_torch_decode_recovery.py``): tiny
GPT-2 decode graphs built in both packages, the JAX engine's seeded
weights carried into the port by name, engines and fleets built the same
way in each package, one pass of a router's loop driven on the test
thread (routers built with ``start=False``, so a schedule is the same in
both packages), and the greedy top-1 / top-2 logit gap.

The port's token streams are held to the JAX package's exactly.  Cache
rows may differ in the low bits (PyTorch's products change summation
order with the row count, ROADMAP C6), so each test also checks that the
smallest top-1 / top-2 logit gap over its streams stays above
``GAP_MIN``: a near tie can then neither pass nor fail by chance."""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu.metrics as jmetrics                              # noqa: E402
import hetu_tpu.models as jmodels                                # noqa: E402
import hetu_tpu.serving as jserving                              # noqa: E402
from hetu_tpu.serving import decode as jdecode                   # noqa: E402
import hetu_tpu_torch as tht                                     # noqa: E402
from hetu_tpu_torch import metrics as tmetrics                   # noqa: E402
from hetu_tpu_torch.serving import decode as tdecode             # noqa: E402

KW = dict(n_positions=64, batch_size=1, seq_len=16)
MAX_LEN = 16
CACHE_ATOL = 1e-5
GAP_MIN = 1e-4
FAMILIES = ("decode", "decode_recovery", "fleet", "prefix_cache",
            "serve_rejection", "run_plan")


class Pkg:
    """One package's side of a parity test: its modules, its graphs and
    the shared weights."""

    def __init__(self, port, graphs, weights):
        self.port = port
        self.serving = tht if port else jserving
        self.metrics = tmetrics if port else jmetrics
        self.decode = tdecode if port else jdecode
        self.graphs = graphs
        self.weights = weights

    def engine(self, chunked=True, store=None, **kw):
        (feeds, logits, caches, _), cg = self.graphs
        kw.setdefault("max_slots", 4)
        if chunked:
            kw["chunked"] = cg[:3]
        if store is not None:
            kw["prefix_store"] = store
        if self.port:
            kw["device"] = "cpu"
        return self.serving.DecodeEngine(feeds, logits, caches,
                                         weights=self.weights, seed=0,
                                         max_len=MAX_LEN, **kw)

    def request(self, prompt, max_new, eos_id=None, deadline=None):
        return self.decode._DecodeRequest(np.asarray(prompt, np.int32),
                                          max_new, eos_id, None, deadline)

    def store(self, **kw):
        return self.serving.PrefixKVStore(**kw)

    def fleet(self, n=2, *, chunked=True, store=None, slots=4, **door_kw):
        """A FrontDoor over ``n`` paused DecodeRouter replicas; returns
        (door, {index: router})."""
        routers = {}

        def mk(idx):
            eng = self.engine(chunked=chunked, store=store, max_slots=slots)
            routers[idx] = self.serving.DecodeRouter(
                eng, queue_limit=16, start=False, name=f"rec{idx}")
            return routers[idx]

        door_kw.setdefault("health_every_ms", 1e9)
        door_kw.setdefault("wedge_timeout_ms", 1e9)
        return self.serving.FrontDoor(mk, n, **door_kw), routers

    def reset(self):
        for fam in FAMILIES:
            getattr(self.metrics, f"reset_{fam}_counts")()

    def counts(self):
        return {fam: getattr(self.metrics, f"{fam}_counts")()
                for fam in FAMILIES}


def build_pair():
    """(JAX side, port side) over one set of weights: the JAX engine's
    seeded initial values, by name."""
    jg = (jmodels.gpt2_decode_graph(jmodels.GPT2Config.tiny(**KW),
                                    max_len=MAX_LEN),
          jmodels.gpt2_decode_chunked_graph(jmodels.GPT2Config.tiny(**KW),
                                            max_len=MAX_LEN))
    (feeds, logits, caches, _), _ = jg
    iex = jserving.DecodeEngine(feeds, logits, caches, seed=0,
                                max_len=MAX_LEN, max_slots=1).iex
    named = {iex.var_names[n]: np.asarray(iex.params[iex._k(n)])
             for n in iex.var_nodes}
    tg = (tht.gpt2_decode_graph(tht.GPT2Config.tiny(**KW), max_len=MAX_LEN),
          tht.gpt2_decode_chunked_graph(tht.GPT2Config.tiny(**KW),
                                        max_len=MAX_LEN))
    return (Pkg(False, jg, named),
            Pkg(True, tg, tht.params_from_named_arrays(named, "cpu")))


def run(eng, req):
    """One request straight on the engine, to its end."""
    eng.join(req)
    while eng.active:
        eng.step()
    return req.stream.result(timeout=60)


def tick(router):
    """One pass of a paused router's loop on this thread: seat what
    ``_take_joins`` hands over, one engine step, the seated mirror
    updated.  False when there was nothing to do (the loop would wait)."""
    with router._cv:
        if not router._q and router.engine.idle:
            return False
    joins = router._take_joins()
    if joins is None:
        return False
    for req in joins:
        router.engine.join(req)
    if not router.engine.idle:
        router.engine.evict_expired()
        router.engine.step()
    with router._cv:
        router._seated = [s.req for s in router.engine.slots
                          if s is not None]
        router._active_ct = len(router._seated)
    return True


def greedy_with_gap(port, prompt, max_new):
    """The port's greedy stream of ``prompt`` on a one-token engine at
    batch 1, and the smallest top-1 / top-2 logit gap over its tokens."""
    eng = port.engine(chunked=False, max_slots=1)
    fn = eng.iex.compiled(1)
    rows = []

    def recording(params, feeds):
        outs = fn(params, feeds)
        rows.append(np.sort(outs[0][0].numpy()))
        return outs

    eng.iex._compiled[1] = recording
    toks = run(eng, port.request(prompt, max_new))
    gaps = [r[-1] - r[-2] for r in rows[len(prompt) - 1:]]
    assert len(gaps) == len(toks)
    return toks, float(min(gaps))


def watch_fires(stream, n):
    """Count each of the first ``n`` token futures' completions."""
    fired = [0] * n
    for i in range(n):
        stream.token(i).add_done_callback(
            lambda f, i=i: fired.__setitem__(i, fired[i] + 1))
    return fired
