"""InferenceExecutor: serving over frozen weights (twin of
``hetu_tpu/serving/executor.py``).

The executor owns a fetch subgraph, its read-only weights placed on one
device, and a fixed set of batch buckets.  ``compiled(bucket)`` returns
the cached serving step ``fn(params, feeds) -> [fetch tensors]`` for a
bucket: PyTorch runs eagerly, so the step is the graph's topo order
evaluated under ``torch.no_grad`` — built once per bucket and
reused, as the JAX package builds one jitted executable per bucket.

Weights come from a ``{checkpoint name: array or tensor}`` dict (see
:func:`hetu_tpu_torch.weights.params_from_named_arrays`) or, for
variables the dict does not cover, from seeded initializers.  Feeds and
params are keyed by canonical topo-ordinal keys (``_k``), as in the JAX
package.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..context import resolve_device
from ..graph.executor import lower_forward
from ..graph.node import (LowerCtx, Op, PlaceholderOp, checkpoint_names,
                          topo_sort)
from ..initializers import variable_generator


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


class InferenceExecutor:
    """Serving over a fetch subgraph (see module docstring).

    ``fetches``: the serving outputs.  ``weights``: ``None`` (seeded
    initializer values) or a ``{name: array}`` dict.  ``buckets`` /
    ``max_batch``: the legal padded batch sizes.  ``device``: where
    weights live and the graph runs — CUDA by default; the CPU only when
    asked for.

    Not ported yet, and refused by name: ``plan=``, ``mesh=``,
    ``validate=``, PS embedding nodes and checkpoint-directory weights.
    """

    def __init__(self, fetches, weights=None, buckets=None, max_batch=128,
                 seed=0, device=None, plan=None, mesh=None, validate=None):
        for opt, given in (("plan", plan), ("mesh", mesh),
                           ("validate", validate)):
            if given is not None:
                raise NotImplementedError(
                    f"InferenceExecutor({opt}=) is not ported")
        if isinstance(fetches, Op):
            fetches = [fetches]
        self.fetches = list(fetches)
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.topo = topo_sort(self.fetches)
        if any(getattr(n, "is_ps", False) for n in self.topo):
            raise NotImplementedError(
                "InferenceExecutor: PS embedding nodes are not ported")
        # canonical topo-ordinal keys: a structurally identical rebuild
        # produces identical param/feed keys
        self._node_keys = {n: f"s{i}" for i, n in enumerate(self.topo)}
        self.feed_nodes = [n for n in self.topo
                           if isinstance(n, PlaceholderOp)
                           and not n.is_variable]
        self.var_nodes = [n for n in self.topo
                          if isinstance(n, PlaceholderOp) and n.is_variable]
        bset = buckets if buckets is not None else default_buckets(max_batch)
        self.buckets = tuple(sorted({int(b) for b in bset}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket set {self.buckets}")
        self.params = {}
        self._load_weights(weights)
        self._compiled = {}

    # -- canonical keys ----------------------------------------------------

    def _k(self, node):
        k = self._node_keys.get(node)
        return k if k is not None else f"n{node.id}"

    # -- weights -----------------------------------------------------------

    def _load_weights(self, weights):
        if weights is not None and not isinstance(weights, dict):
            raise NotImplementedError(
                f"InferenceExecutor: weights from {type(weights).__name__} "
                f"(checkpoint directories, live executors) are not ported — "
                f"pass a {{name: array}} dict")
        self.var_names = checkpoint_names(self.var_nodes)
        named = weights or {}
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


__all__ = ["InferenceExecutor", "default_buckets"]
