"""InferenceExecutor: serving over frozen weights (twin of
``hetu_tpu/serving/executor.py``).

The executor owns a fetch subgraph, its read-only weights placed on one
device, and a fixed set of batch buckets.  ``compiled(bucket)`` returns
the cached serving step ``fn(params, feeds) -> [fetch tensors]`` for a
bucket: PyTorch runs eagerly, so the step is the graph's topo order
evaluated under ``torch.no_grad`` — built once per bucket and
reused, as the JAX package builds one jitted executable per bucket.

:meth:`InferenceExecutor.infer` runs one request batch: padded with zero
rows to the smallest legal bucket (:meth:`~InferenceExecutor.bucket_for`),
one call, per-row fetches sliced back.  :meth:`~InferenceExecutor.
infer_rows` also returns each fetch's scatter plan, found from the
fetches' abstract shapes at two batch sizes (``analysis.infer_graph``,
each op's lowering on meta tensors, no launch): ``k`` rows a sample, None
for a batch-invariant fetch, and a fetch that aggregates over the batch
is refused for a padded batch.  :meth:`~InferenceExecutor.warm` runs
every bucket once.

Weights come from a ``{checkpoint name: array or tensor}`` dict (see
:func:`hetu_tpu_torch.weights.params_from_named_arrays`), a live port
``Executor`` (its ``return_tensor_values()``) or a ``hetu_tpu.ckpt.v1``
directory written by ``Executor.save`` (its dense params); variables the
source does not cover take their seeded initializer values.  Feeds and
params are keyed by canonical topo-ordinal keys (``_k``), as in the JAX
package.  There is no process-wide serve cache: a rebuilt executor has
nothing to compile (ROADMAP C7 (k)).

PS embeddings serve through their node's cache — a read-only
``DistCacheTable`` over a (replicated) ``DistributedStore``, whose shard
router fails a killed primary over inside the pull.  ``infer`` pulls the
rows of the request's real ids before padding (padding ids would pull row
0 again and again) and pads the rows with zeros;
:meth:`InferenceExecutor.refresh_embeddings` re-pulls the cached rows a
trainer has since written (``serve_emb_refresh_rows``).  A checkpoint
directory's PS tables load into each node's store by node name.
"""
from __future__ import annotations

import glob
import json
import os
import warnings

import numpy as np
import torch

from ..context import resolve_device
from ..graph.executor import lower_forward
from ..graph.node import (LowerCtx, Op, PlaceholderOp, checkpoint_names,
                          topo_sort)
from ..initializers import variable_generator
from ..metrics import record_serve


def default_buckets(max_batch=128):
    """Serving buckets up to ``max_batch``: powers of two to 64, then
    multiples of 128, plus ``max_batch`` itself as the cap."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = {max_batch}
    b = 1
    while b < max_batch and b <= 64:
        out.add(b)
        b *= 2
    b = 128
    while b < max_batch:
        out.add(b)
        b += 128
    return tuple(sorted(out))


def _pad_rows(v, bucket):
    """Zero-pad ``v`` along the leading (batch) dim to ``bucket`` rows."""
    v = np.asarray(v)
    if v.ndim == 0 or v.shape[0] == bucket:
        return v
    if v.shape[0] > bucket:
        raise ValueError(f"batch {v.shape[0]} exceeds bucket {bucket}")
    pad = np.zeros((bucket - v.shape[0],) + v.shape[1:], v.dtype)
    return np.concatenate([v, pad], 0)


class InferenceExecutor:
    """Serving over a fetch subgraph (see module docstring).

    ``fetches``: the serving outputs.  ``weights``: ``None`` (seeded
    initializer values), a ``{name: array}`` dict, a live port
    ``Executor``, or a checkpoint directory (``Executor.save``; one
    without ``meta.json`` raises ``ValueError``).  ``buckets`` /
    ``max_batch``: the legal padded batch sizes.  ``device``: where
    weights live and the graph runs — CUDA by default; the CPU only when
    asked for.  ``strict``: a variable that a ``weights`` dict does not
    cover raises ``KeyError`` instead of taking its seeded initializer
    value with a warning.  ``validate``: ``'error'`` (the default: a
    gradient or an optimizer update in the fetch set is rejected at
    construction, with its creation site), ``'warn'`` or ``'off'``; the
    lint runs with ``serving=True, training=False`` and ``'error'``
    escalates only error-severity diagnostics (a dropout in a served
    forward is inert and only warned of).  ``decode=True``: the fetch set
    is a one-token decode step (the ``decode-incompatible-op`` rule).

    Not ported yet, and refused by name: ``plan=`` and ``mesh=``.
    """

    def __init__(self, fetches, weights=None, buckets=None, max_batch=128,
                 seed=0, device=None, plan=None, mesh=None, validate="error",
                 strict=False, decode=False):
        for opt, given in (("plan", plan), ("mesh", mesh)):
            if given is not None:
                raise NotImplementedError(
                    f"InferenceExecutor({opt}=) is not ported")
        if validate not in ("warn", "error", "off"):
            raise ValueError(f"validate={validate!r}: expected "
                             "'warn', 'error', or 'off'")
        self.validate = validate
        self.decode = bool(decode)
        if isinstance(fetches, Op):
            fetches = [fetches]
        self.fetches = list(fetches)
        self._validate_graph()
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.topo = topo_sort(self.fetches)
        # canonical topo-ordinal keys: a structurally identical rebuild
        # produces identical param/feed keys
        self._node_keys = {n: f"s{i}" for i, n in enumerate(self.topo)}
        self.ps_nodes = [n for n in self.topo if getattr(n, "is_ps", False)]
        self.feed_nodes = [n for n in self.topo
                           if isinstance(n, PlaceholderOp)
                           and not n.is_variable
                           and not getattr(n, "is_ps", False)]
        self.var_nodes = [n for n in self.topo
                          if isinstance(n, PlaceholderOp) and n.is_variable]
        bset = buckets if buckets is not None else default_buckets(max_batch)
        self.buckets = tuple(sorted({int(b) for b in bset}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket set {self.buckets}")
        self.max_batch = self.buckets[-1]
        # which fetches are batch-derived (transitively consume a fed
        # placeholder or PS rows)?  Those are padded and sliced per request
        deps = {}
        feed_set = set(self.feed_nodes) | set(self.ps_nodes)
        for node in self.topo:
            deps[node] = node in feed_set or any(
                deps.get(i, False) for i in node.inputs)
        self.fetch_batched = [deps.get(f, False) for f in self.fetches]
        self.params = {}
        self._load_weights(weights, bool(strict))
        self._compiled = {}
        self._fetch_rows = {}   # (bucket, feed schema) -> scatter plan

    # -- canonical keys ----------------------------------------------------

    def _k(self, node):
        k = self._node_keys.get(node)
        return k if k is not None else f"n{node.id}"

    # -- static validation -------------------------------------------------

    def _validate_graph(self):
        """``lint(fetches, serving=True, training=False)`` at construction
        (see the class docstring)."""
        if self.validate == "off":
            return
        from ..analysis import lint as lint_graph
        try:
            report = lint_graph(self.fetches, training=False, serving=True,
                                decode=self.decode)
        except Exception as e:
            warnings.warn(f"serving graph lint crashed: "
                          f"{type(e).__name__}: {e}", RuntimeWarning)
            return
        if report.diagnostics:
            if self.validate == "error":
                report.raise_errors()
            warnings.warn(
                f"serving lint found {len(report.diagnostics)} issue(s) "
                f"(InferenceExecutor(validate='off') silences):\n{report}",
                UserWarning)

    # -- weights -----------------------------------------------------------

    def _weights_dict(self, weights):
        """Normalize a weights source to ``{checkpoint name: array}``; a
        checkpoint directory's PS tables load into their nodes' stores
        (matched by node name: the file ordinals are the training graph's
        table order)."""
        if isinstance(weights, dict):
            return weights
        if hasattr(weights, "return_tensor_values"):   # live Executor
            return weights.return_tensor_values()
        path = os.fspath(weights)
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            raise ValueError(
                f"weights source {path!r} is not a checkpoint directory "
                f"(no meta.json) — pass an Executor, a name->array dict, "
                f"or a directory written by Executor.save")
        with open(meta_path) as f:
            meta = json.load(f)
        by_name = {e["node"]: e["file"] for e in meta.get("ps_tables", [])}
        for node in self.ps_nodes:
            fn = by_name.get(node.name)
            if fn is None:
                if by_name:
                    warnings.warn(
                        f"checkpoint has no PS table for serving node "
                        f"'{node.name}' (tables: {sorted(by_name)}) — "
                        f"serving the store's LIVE rows", RuntimeWarning)
                continue
            fp = os.path.join(path, fn)
            if hasattr(node.store, "load") and glob.glob(fp + "*"):
                node.store.load(node.table, fp)
        return {name: np.load(os.path.join(path, "params", fn))
                for name, fn in meta.get("params", {}).items()}

    def _load_weights(self, weights, strict=False):
        self.var_names = checkpoint_names(self.var_nodes)
        named = self._weights_dict(weights) if weights is not None else {}
        missing = []
        # initializers run only for variables the weights do not cover;
        # the generator is seeded from the node's topo position, so
        # partial inits are seed-stable either way
        for i, node in enumerate(self.var_nodes):
            v = named.get(self.var_names[node])
            if v is None:
                if weights is not None:
                    missing.append(self.var_names[node])
                v = node.get_init_value(variable_generator(self.seed, i))
                if v is None:
                    raise ValueError(
                        f"variable {node} has no value/initializer")
            self.params[self._k(node)] = self._place(v)
        if missing and strict:
            raise KeyError(
                f"weights provide no value for {len(missing)} variable(s): "
                f"{missing[:5]}")
        if missing:
            warnings.warn(
                f"weights source provides no value for {len(missing)} "
                f"variable(s) (e.g. {missing[0]!r}) — serving their seeded "
                f"INITIALIZER values", RuntimeWarning)

    def _place(self, val):
        """A tensor on the executor's device (float64 → float32)."""
        t = val if isinstance(val, torch.Tensor) \
            else torch.from_numpy(np.array(val))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

    def _place_feed(self, node, val):
        """A request feed on the device, in the placeholder's dtype."""
        val = np.asarray(val)
        if val.dtype == np.float64:
            val = val.astype(np.float32)
        want = getattr(node, "dtype", None)
        if want is not None and val.dtype != np.dtype(want):
            val = val.astype(np.dtype(want))
        return self._place(val)

    # -- one serving step per bucket ---------------------------------------

    def _infer_fn(self):
        """The serving step ``fn(params, feeds) -> [fetch values]``:
        forward evaluation only, ``training=False``.  The closure holds
        the graph structure, never ``self`` (and so never the weights)."""
        fetch_nodes = list(self.fetches)
        topo = self.topo
        key_of = dict(self._node_keys)

        def infer(params, feeds):
            ctx = LowerCtx(False)

            def resolve(node):
                k = key_of.get(node, f"n{node.id}")
                if k in params:
                    return params[k]
                return feeds[k]

            with torch.no_grad():
                env = lower_forward(topo, ctx, resolve)
            return [env[f] for f in fetch_nodes]

        return infer

    def bucket_for(self, n):
        """Smallest legal bucket >= ``n``, or None when ``n`` exceeds the
        largest bucket."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def compiled(self, bucket):
        """The serving step for one bucket, built at most once."""
        if bucket not in self.buckets:
            raise ValueError(f"{bucket} is not a legal bucket "
                             f"{self.buckets}")
        fn = self._compiled.get(bucket)
        if fn is None:
            fn = self._infer_fn()
            self._compiled[bucket] = fn
        return fn

    # -- inference ---------------------------------------------------------

    #: scatter-plan sentinel: batch-derived, but its leading dim does not
    #: scale with the batch — the fetch aggregated over it
    _AGGREGATE = -1

    def _eval_fetch_shapes(self, padded, b):
        """The fetches' shapes at batch size ``b``: each op's lowering on
        meta tensors (``analysis.infer_graph``), feeds synthesized from
        the real batch's trailing dims and the placeholders' dtypes (a PS
        embedding's rows from its ids feed and the table's width)."""
        from ..analysis import infer_graph
        from ..analysis.shapes import meta
        feeds = {}
        for node in self.feed_nodes + [n.ids_node for n in self.ps_nodes]:
            v = np.asarray(padded[node])
            dt = np.dtype(node.dtype) if node.dtype is not None \
                else (np.dtype(np.float32) if v.dtype == np.float64
                      else v.dtype)
            feeds[node] = meta((b,) + v.shape[1:], dt)
        gs = infer_graph(self.fetches, feeds=feeds, training=False)
        shapes = []
        for f in self.fetches:
            shape = gs.shape(f)
            if shape is None:
                why = gs.failed.get(f) or gs.pending.get(f)
                raise ValueError(f"fetch {f} has no abstract shape at "
                                 f"batch {b}: {why}")
            shapes.append(tuple(shape))
        return shapes

    def _fetch_row_scaling(self, padded, bucket):
        """Scatter plan per fetch: ``k`` (>= 1) when its leading dim is
        exactly ``k * batch`` rows in row-major sample order, None when the
        fetch never touches the batch, ``_AGGREGATE`` when it is
        batch-derived but does not row-scale.  A shape at one size is
        ambiguous (a reduce whose output dim equals the bucket looks
        per-row), so the plan compares two batch sizes; cached per
        (bucket, trailing-dims schema).  A graph that cannot be evaluated
        at twice the bucket is built at one batch size, and its plan reads
        the bucket's shapes alone (the JAX package refuses such a
        graph)."""
        key = (bucket,
               tuple((self._k(n), np.shape(v)[1:], str(np.asarray(v).dtype))
                     for n, v in sorted(padded.items(),
                                        key=lambda kv: kv[0].id)))
        plan = self._fetch_rows.get(key)
        if plan is not None:
            return plan
        s1 = self._eval_fetch_shapes(padded, bucket)
        try:
            s2 = self._eval_fetch_shapes(padded, 2 * bucket)
        except ValueError:
            # a graph built at one batch size (its reshapes name the
            # batch, as the model zoo's BERT does) is served at that size
            # only: its plan reads the one shape (ROADMAP C7 (n))
            s2 = [None] * len(s1)
        plan = []
        for a, b2, batched in zip(s1, s2, self.fetch_batched):
            if not batched:
                plan.append(None)
            elif (len(a) and a[0] and a[0] % bucket == 0
                  and (b2 is None
                       or b2[0] == (a[0] // bucket) * 2 * bucket)):
                plan.append(a[0] // bucket)
            else:
                plan.append(self._AGGREGATE)
        self._fetch_rows[key] = plan
        return plan

    def _batch_size(self, feed_dict):
        sizes = {int(np.shape(v)[0]) for v in feed_dict.values()
                 if np.ndim(v)}
        if len(sizes) != 1:
            raise ValueError(f"feeds disagree on batch size: {sizes}")
        return sizes.pop()

    def infer(self, feed_dict, convert=True):
        """Run ONE request batch: pad to the smallest legal bucket, one
        call, slice batch-derived fetches back to the true size.
        ``feed_dict``: ``{placeholder: array}`` with a shared leading batch
        dim.  Returns one value per fetch (numpy when ``convert``)."""
        return self.infer_rows(feed_dict, convert)[0]

    def infer_rows(self, feed_dict, convert=True):
        """:meth:`infer` plus the per-fetch scatter plan: ``(results,
        rows_per_sample)``, where ``rows_per_sample[i]`` is the number of
        leading rows each sample contributed to fetch ``i`` (request ``j``
        gets rows ``j*k:(j+1)*k``), or None for a batch-invariant or
        aggregating fetch whose whole value belongs to every request."""
        n = self._batch_size(feed_dict)
        bucket = self.bucket_for(n)
        if bucket is None:
            raise ValueError(
                f"request batch {n} exceeds the largest serving bucket "
                f"{self.max_batch} — split the request or raise max_batch")
        record_serve("serve_pad_rows", bucket - n)
        # PS rows of the REAL ids, before padding (pad ids would pull id
        # 0's row bucket - n times a field: store traffic, skewed hit
        # counts, an LFU boost); the rows pad with zeros instead
        ps_rows = {}
        for node in self.ps_nodes:
            ids = feed_dict.get(node.ids_node)
            if ids is None:
                raise ValueError(
                    f"missing ids feed for PS embedding {node} "
                    f"(feed its ids placeholder {node.ids_node})")
            rows = node.pull_rows(np.asarray(ids, np.int64))
            ps_rows[node] = _pad_rows(np.asarray(rows), bucket)
        padded = {node: _pad_rows(v, bucket)
                  for node, v in feed_dict.items()}
        for node in self.feed_nodes:
            if node not in padded:
                raise ValueError(f"missing feed for {node}")
        # the plan comes before any device work: a padded batch with an
        # aggregating fetch is refused without running it
        scaling = self._fetch_row_scaling(padded, bucket)
        if n != bucket:
            for i, k in enumerate(scaling):
                if k == self._AGGREGATE:
                    raise ValueError(
                        f"fetch {self.fetches[i]} aggregates over the "
                        f"batch dim (leading dim does not scale with "
                        f"batch size): its value would include the "
                        f"{bucket - n} zero-padding row(s) of bucket "
                        f"{bucket} — fetch the per-row form and "
                        f"aggregate client-side, or submit exact-bucket "
                        f"batches")
        outs = self._run_bucket(padded, bucket, ps_rows)
        results, rows_per_sample = [], []
        for o, k in zip(outs, scaling):
            if k is None or k == self._AGGREGATE:
                rows_per_sample.append(None)
            else:
                if n != bucket:
                    o = o[: n * k]
                rows_per_sample.append(k)
            results.append(o.cpu().numpy() if convert else o)
        return results, rows_per_sample

    def _run_bucket(self, padded, bucket, ps_rows=None, record=True):
        """One call at an exact bucket, with the PS rows ``infer`` pulled
        (or, absent, pulled here for the padded ids); ``record=False``
        (``warm``) leaves the batch counters alone."""
        feeds = {}
        for node in self.feed_nodes:
            if node not in padded:
                raise ValueError(f"missing feed for {node}")
            feeds[self._k(node)] = self._place_feed(node, padded[node])
        for node in self.ps_nodes:
            rows = (ps_rows or {}).get(node)
            if rows is None:
                ids = padded.get(node.ids_node)
                if ids is None:
                    raise ValueError(
                        f"missing ids feed for PS embedding {node} "
                        f"(feed its ids placeholder {node.ids_node})")
                rows = node.pull_rows(np.asarray(ids, np.int64))
            feeds[self._k(node)] = self._place_feed(node, rows)
        outs = self.compiled(bucket)(self.params, feeds)
        if record:
            record_serve("serve_batches")
            record_serve("serve_batch_rows", bucket)
        return outs

    def warm(self, example_feeds=None):
        """Run every bucket once: the example request (default: zeros of
        the declared feed shapes) tiled or cut to each bucket.  Returns the
        number of buckets."""
        if example_feeds is None:
            example_feeds = {}
            for node in self.feed_nodes + [n.ids_node
                                           for n in self.ps_nodes]:
                if getattr(node, "shape", None) is None:
                    raise ValueError(
                        f"warm() needs an example feed for {node} "
                        f"(no declared shape)")
                dt = getattr(node, "dtype", None) or np.float32
                example_feeds[node] = np.zeros(node.shape, dt)
        for bucket in self.buckets:
            fd = {}
            for node, v in example_feeds.items():
                v = np.asarray(v)
                reps = -(-bucket // max(1, v.shape[0]))  # ceil
                fd[node] = np.concatenate([v] * reps, 0)[:bucket]
            # zero rows for the PS embeddings: warming needs their shapes,
            # and pulling the example ids through the cache would be store
            # traffic and skewed hit counts
            ps_rows = {
                node: np.zeros(np.shape(fd[node.ids_node]) + (node.width,),
                               np.float32)
                for node in self.ps_nodes
                if node.ids_node in fd and node.width is not None}
            self._run_bucket(fd, bucket, ps_rows, record=False)
        return len(self.buckets)

    def refresh_embeddings(self):
        """The version-based staleness sweep of every read-only embedding
        cache this graph serves through (``DistCacheTable.refresh_stale``):
        the rows a trainer kept writing are re-pulled, one batched round
        trip a cache.  Returns the rows refreshed, also counted as
        ``serve_emb_refresh_rows``."""
        seen, total = set(), 0
        for node in self.ps_nodes:
            cache = getattr(node, "cache", None)
            if cache is None or id(cache) in seen \
                    or not hasattr(cache, "refresh_stale"):
                continue
            seen.add(id(cache))
            refreshed = cache.refresh_stale()
            total += refreshed
            record_serve("serve_emb_refresh_rows", refreshed)
        return total


__all__ = ["InferenceExecutor", "default_buckets"]
