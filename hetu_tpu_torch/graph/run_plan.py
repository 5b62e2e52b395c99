"""Cached run plans (twin of ``hetu_tpu/graph/run_plan.py``): the
per-step host work of ``SubExecutor.run`` resolved once per (subgraph,
feed schema).

What a step's host work depends on is the feed schema: which
placeholders are fed, with what container, dtype and shape.  A
:class:`RunPlan` resolves it once and replays it:

* feed placement: one closure for each feed node, with its rows rule
  under data parallelism bound (``Executor._place_feed``), or the
  dataloader's fetch;
* validation: the ``validate='warn'|'error'`` check of fed shapes runs
  once per schema (an ``'error'`` verdict raises when the plan is built,
  and the failed plan is not cached, so every run with that schema
  fails);
* pipelined feeds: a dataloader-fed placeholder is double-buffered.
  After step N is enqueued, step N+1's batch is peeked (``get_next_arr``)
  and placed on the executor's one-worker feed thread; on the card the
  copy leaves pinned host memory on a side CUDA stream
  (``non_blocking=True``) and records an event.  The step that reads the
  batch makes the compute stream wait on that event and
  ``record_stream``s the tensor onto it.  The batch is consumed only if
  the loader hands out the very object that was peeked (identity), so a
  restored loader never gets a stale batch.

A new schema re-plans; ``plan_cache_hit`` / ``plan_cache_miss``
(``metrics.run_plan_counts``) show the reuse, and sustained misses from a
feed shape that keeps changing raise the ``feed-schema-churn`` warning,
which names the placeholder and its creation site.
``HETU_FEED_PIPELINE=0`` turns the double buffer off,
``HETU_FEED_PIPELINE_MIN_US`` (default 150) keeps batches whose inline
placement is cheaper than a thread handoff inline, and
``HETU_RUN_PLAN_CACHE`` bounds the plans a subgraph keeps (default 8,
LRU).
"""
from __future__ import annotations

import os
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ..metrics import record_run_plan
from ..ndarray import NDArray

#: marks a feed node absent from the feed dict (dataloader-fed) in the
#: identity memo; None would collide with a feed that disappeared
_DL_SENTINEL = object()


def feed_pipeline_enabled():
    return os.environ.get("HETU_FEED_PIPELINE", "1") != "0"


def pipeline_min_us():
    """Feed placements cheaper than this stay inline: a thread handoff
    costs tens of microseconds, so double-buffering a small copy would
    slow the step down."""
    try:
        return float(os.environ.get("HETU_FEED_PIPELINE_MIN_US", "150"))
    except ValueError:
        return 150.0


def _schema_of(sub, feed_dict):
    """Hashable fingerprint of how a run is fed: per feed node, the
    container kind, dtype and shape."""
    from ..data.dataloader import DataloaderOp
    items = []
    for node in sub.feed_nodes:
        if node in feed_dict:
            v = feed_dict[node]
            if isinstance(v, np.ndarray):
                items.append(("np", v.dtype, v.shape))
            elif isinstance(v, torch.Tensor):
                items.append(("torch", v.dtype, tuple(v.shape), v.device))
            elif isinstance(v, NDArray):
                t = v.torch()
                items.append(("ndarray", t.dtype, tuple(t.shape), t.device))
            else:   # a list, a scalar: the general placement
                items.append(("py", np.shape(v)))
        elif isinstance(node, DataloaderOp):
            items.append(("dl",))
        else:
            raise ValueError(f"missing feed for {node}")
    return tuple(items)


class RunPlan:
    """One feed schema's resolved placement (see the module docstring)."""

    def __init__(self, sub, schema, feed_dict):
        ex = sub.ex
        self.sub = sub
        self.ex = ex
        self.schema = schema
        # the validation verdict, once a schema ('error' raises here)
        if ex.validate != "off" and feed_dict:
            ex._check_feeds(sub, feed_dict)
        self._steps = []        # (node, fetch(feed_dict) -> device tensor)
        self._dl_entries = []   # dataloader nodes the double buffer feeds
        self._pre = {}          # node -> (host batch, Future[(t, event)])
        self._dl_cost = {}      # node -> last inline placement cost (us)
        self._pipelined = 0
        for node, item in zip(sub.feed_nodes, schema):
            rows = node not in sub._shard_loaders
            if item[0] == "dl":
                fetch = self._dataloader_fetch(node, rows)
            else:
                fetch = (lambda fd, n=node, r=rows:
                         ex._place_feed(n, fd[n], rows=r))
            self._steps.append((node, fetch))
            if item[0] == "dl" and feed_pipeline_enabled():
                self._dl_entries.append((node, rows))

    def _dataloader_fetch(self, node, rows):
        """A dataloader feed: the prefetched placement when the loader
        hands out the batch that was peeked (by identity), else an inline
        placement, timed for the double buffer's threshold."""
        ex, pre, name = self.ex, self._pre, self.sub.name

        def fetch(fd):
            val = node.get_arr(name)
            entry = pre.pop(node, None)
            if entry is not None and entry[0] is val:
                self._pipelined += 1
                t, event = entry[1].result()
                return ex._adopt(t, event)
            t0 = time.perf_counter()
            out = ex._place_feed(node, val, rows=rows)
            self._dl_cost[node] = (time.perf_counter() - t0) * 1e6
            return out
        return fetch

    def place_feeds(self, feed_dict):
        """``{feed node: device tensor}`` of one step."""
        feeds = {node: fetch(feed_dict) for node, fetch in self._steps}
        if self._pipelined:
            record_run_plan("feeds_pipelined", self._pipelined)
            self._pipelined = 0
        return feeds

    def start_feed_prefetch(self):
        """Place step N+1's dataloader batches on the feed thread, called
        once step N is enqueued, so the copy overlaps its device work.  A
        batch whose inline placement was cheaper than
        :func:`pipeline_min_us` stays inline (step 0 always places inline,
        so the cost is known from step 1 on)."""
        if not self._dl_entries:
            return
        pool = None
        min_us = pipeline_min_us()
        for node, rows in self._dl_entries:
            if node in self._pre:
                continue
            cost = self._dl_cost.get(node)
            if cost is None or cost < min_us:
                continue
            if pool is None:
                pool = self.sub._ensure_feed_pool()
            try:
                host = node.get_next_arr(self.sub.name)
            except KeyError:    # no dataloader for this subgraph
                continue
            self._pre[node] = (host, pool.submit(
                self.ex._place_ahead, node, host, rows))
        if self._pre:
            record_run_plan("feed_pipeline_depth_hw", len(self._pre))


class PlanCache:
    """A subgraph's schema -> :class:`RunPlan` map (LRU-bounded), with
    hit / miss accounting and feed-schema-churn detection."""

    #: misses before churn detection speaks up
    _CHURN_MISSES = 4
    #: distinct shapes one feed node must show to count as churning
    _CHURN_SHAPES = 3

    def __init__(self, sub):
        self.sub = sub
        self.plans = OrderedDict()
        try:
            self.max = max(1, int(os.environ.get("HETU_RUN_PLAN_CACHE",
                                                 "8")))
        except ValueError:
            self.max = 8
        self.misses = 0
        self._last = None           # (nodes, values, n fed, plan)
        self._shapes_seen = {}      # feed node -> shapes seen at misses
        self._schemas_seen = set()  # distinct schemas missed (capped)
        self._repeat_misses = 0     # misses on a schema seen before
        self._churn_warned = False

    def lookup(self, feed_dict):
        # the steady loop feeds the same objects step after step: the
        # same objects are the same schema
        last = self._last
        if last is not None and len(feed_dict) == last[2]:
            nodes, vals, _, plan = last
            for node, v in zip(nodes, vals):
                if feed_dict.get(node, _DL_SENTINEL) is not v:
                    break
            else:
                record_run_plan("plan_cache_hit")
                return plan
        schema = _schema_of(self.sub, feed_dict)
        plan = self.plans.get(schema)
        if plan is not None:
            self.plans.move_to_end(schema)
            record_run_plan("plan_cache_hit")
        else:
            record_run_plan("plan_cache_miss")
            self.misses += 1
            self._note_churn(schema)
            plan = RunPlan(self.sub, schema, feed_dict)
            self.plans[schema] = plan
            while len(self.plans) > self.max:
                self.plans.popitem(last=False)
        nodes = tuple(self.sub.feed_nodes)
        vals = tuple(feed_dict.get(n, _DL_SENTINEL) for n in nodes)
        nfed = sum(1 for v in vals if v is not _DL_SENTINEL)
        self._last = (nodes, vals, nfed, plan)
        return plan

    def _note_churn(self, schema):
        """feed-schema-churn: runs keep missing because a feed's shape
        keeps changing.  A fixed bucket set is not churn (each bucket
        misses once while warming), so the warning needs sustained misses:
        a schema missing again after it was planned, or more distinct
        schemas than the cache holds.  Warned once a subgraph."""
        if self._churn_warned:
            return
        if schema in self._schemas_seen:
            self._repeat_misses += 1
        elif len(self._schemas_seen) < 64:
            self._schemas_seen.add(schema)
        for node, item in zip(self.sub.feed_nodes, schema):
            if len(item) < 3:
                continue    # no shape to track (dl / py feeds)
            seen = self._shapes_seen.setdefault(node, set())
            if len(seen) < 8:
                seen.add(tuple(item[2]))
        if self.misses < self._CHURN_MISSES:
            return
        if self._repeat_misses < 2 and len(self._schemas_seen) <= self.max:
            return      # bucket warm-up, not sustained churn
        churners = [(node, shapes) for node, shapes in
                    self._shapes_seen.items()
                    if len(shapes) >= self._CHURN_SHAPES]
        if not churners:
            return
        self._churn_warned = True
        from ..analysis.lint import Diagnostic
        node, shapes = churners[0]
        shown = ", ".join(str(s) for s in sorted(shapes)[:4])
        if len(self._schemas_seen) > self.max and len(shapes) <= 16:
            fix = (f"this looks like a fixed bucket set larger than the "
                   f"plan cache (bound {self.max}) — raise "
                   f"HETU_RUN_PLAN_CACHE to cover every bucket")
        else:
            fix = ("each new shape also re-plans the step and, on the "
                   "card, re-tunes its kernels' launch shapes; bucket "
                   "ragged batches to a small fixed set of shapes (or fix "
                   "the dataloader batch size)")
        diag = Diagnostic(
            "feed-schema-churn", "warn",
            f"feed shapes for placeholder '{node.name}' keep missing "
            f"the run-plan cache across run() calls (saw {shown}"
            f"{', ...' if len(shapes) > 4 else ''}; {self.misses} misses "
            f"so far) — {fix}", node)
        warnings.warn(str(diag), UserWarning, stacklevel=5)


class KeyedPlanCache:
    """A keyed plan cache for planes that resolve their own step closures
    (the decode engine's per-bucket plans), with :class:`PlanCache`'s
    accounting: every lookup records ``plan_cache_hit`` or
    ``plan_cache_miss``."""

    def __init__(self, max_entries=32):
        self.plans = OrderedDict()
        self.max = max(1, int(max_entries))

    def lookup(self, key, build):
        """The plan of ``key``: built by ``build()`` on first sight,
        replayed (LRU-refreshed) after."""
        plan = self.plans.get(key)
        if plan is not None:
            self.plans.move_to_end(key)
            record_run_plan("plan_cache_hit")
            return plan
        record_run_plan("plan_cache_miss")
        plan = build()
        self.plans[key] = plan
        while len(self.plans) > self.max:
            self.plans.popitem(last=False)
        return plan


__all__ = ["RunPlan", "PlanCache", "KeyedPlanCache",
           "feed_pipeline_enabled", "pipeline_min_us"]
