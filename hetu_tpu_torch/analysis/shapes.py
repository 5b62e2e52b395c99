"""Abstract shape and dtype interpretation of fetch subgraphs (twin of
``hetu_tpu/analysis/shapes.py``): nothing runs on a device.

Every op carries the ground truth, its ``lower`` rule.  Evaluated on
meta tensors (``device="meta"``: a shape and a dtype, no storage), it
gives every node a static ``(shape, dtype)`` without computing anything,
as ``jax.eval_shape`` does over ``ShapeDtypeStruct``s in the JAX package;
hand-written shape rules are cross-checked against it by the
``shape-rule-mismatch`` lint.  The walk runs under
:func:`~hetu_tpu_torch.metrics.suppress_perf_counters` and
``torch.no_grad()``: the attention and row-gather dispatchers send a meta
tensor there to their plain versions, so no kernel launches and no
counter moves.

Two paths:

* :func:`infer_graph` — one walk over the runnable nodes of the whole
  subgraph, with a per-node fallback that isolates a failing node and
  marks everything downstream of it pending;
* :func:`abstract_infer_shape` — the ``Op.infer_shape`` fallback: one
  node's output shape from input shapes only (dtypes guessed, float32
  first).

The JAX package's rules hold: a float64 leaf is read as float32 (the
executor places it so), a ``GradientOp`` mirrors its ``wrt`` leaf, and a
PS embedding leaf takes ``ids.shape + (width,)`` from the table's
metadata, with no store round trip.  A struct here is a meta tensor (or a
tuple of them for a multi-output op).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.gradients import GradientOp
from ..graph.node import LowerCtx, PlaceholderOp, topo_sort

#: reasons of a node with no static shape: PENDING downstream of a feed
#: with no static shape (known at run time, not an error), FAILED where
#: abstract lowering raised
PENDING, FAILED = "pending", "failed"

_TORCH_OF_NP = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}
_NP_OF_TORCH = {t: n for n, t in _TORCH_OF_NP.items()}


def torch_dtype(dt):
    """A numpy dtype (or name, or torch dtype) as a torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str) and dt == "bfloat16":
        return torch.bfloat16
    return _TORCH_OF_NP[np.dtype(dt)]


def np_dtype(dt):
    """A torch dtype as a numpy dtype; bfloat16, which numpy lacks, stays
    ``torch.bfloat16``."""
    return _NP_OF_TORCH.get(dt, dt)


def meta(shape, dtype=np.float32):
    """The struct of a ``shape`` / ``dtype`` value: a meta tensor, float64
    read as float32."""
    dt = torch_dtype(dtype)
    if dt == torch.float64:
        dt = torch.float32
    return torch.empty(tuple(int(d) for d in shape), dtype=dt,
                       device="meta")


def _shape_of(struct):
    if struct is None:
        return None
    if isinstance(struct, (tuple, list)):
        return tuple(_shape_of(s) for s in struct)
    return tuple(struct.shape)


def _dtype_of(struct):
    if struct is None:
        return None
    if isinstance(struct, (tuple, list)):
        return tuple(_dtype_of(s) for s in struct)
    return np_dtype(struct.dtype)


def _as_struct(val, default_dtype=np.float32):
    """array | tensor | meta tensor | bare shape -> struct."""
    if val is None:
        return None
    if isinstance(val, torch.Tensor):
        return meta(val.shape, val.dtype)
    if hasattr(val, "shape") and hasattr(val, "dtype"):
        return meta(val.shape, np.dtype(val.dtype))
    if isinstance(val, (tuple, list)):
        if len(val) and isinstance(val[0], (tuple, list)):
            return tuple(_as_struct(v, default_dtype) for v in val)
        return meta(val, default_dtype)
    if np.isscalar(val):
        return meta((), np.asarray(val).dtype)
    raise TypeError(f"cannot derive a struct from {type(val)}")


class GraphShapes:
    """Static ``(shape, dtype)`` assignment of one fetch subgraph.

    ``structs``: node -> meta tensor (a tuple for a multi-output op).
    ``pending``: node -> reason, for nodes whose shape depends on a feed
    with no static shape (known at run time, not an error).  ``failed``:
    node -> reason, for nodes whose abstract lowering raised (a graph bug,
    the ``uninferable`` lint).  ``markers``: optimizer updates, which
    produce no tensor."""

    def __init__(self, topo):
        self.topo = topo
        self.structs = {}
        self.pending = {}
        self.failed = {}
        self.markers = []

    @property
    def complete(self):
        """Every value-producing node has a static (shape, dtype)."""
        return not self.pending and not self.failed

    def struct(self, node):
        return self.structs.get(node)

    def shape(self, node):
        return _shape_of(self.structs.get(node))

    def dtype(self, node):
        return _dtype_of(self.structs.get(node))


def _normalize_feeds(feeds, topo):
    """{node or name: array / shape / struct} -> {PlaceholderOp: struct}."""
    out = {}
    if not feeds:
        return out
    by_name = {}
    for n in topo:
        if isinstance(n, PlaceholderOp):
            by_name.setdefault(n.name, n)
    for k, v in feeds.items():
        node = by_name.get(k) if isinstance(k, str) else k
        if node is None:
            continue
        dt = getattr(node, "dtype", None) or np.float32
        out[node] = _as_struct(v, default_dtype=dt)
    return out


def _ps_struct(node, feeds, structs):
    """A PS embedding leaf: ``ids.shape + (width,)`` from the table's
    metadata."""
    idn = node.ids_node
    ids = structs.get(idn)
    if ids is None:
        ids = feeds.get(idn)
    if ids is None:
        ids = _leaf_struct(idn, feeds) \
            if isinstance(idn, PlaceholderOp) else None
    if ids is None:
        return None
    width = node.width
    if width is None and hasattr(node.store, "width"):
        width = int(node.store.width(node.table))
    if width is None:
        return None
    return meta(tuple(ids.shape) + (int(width),), np.float32)


def _leaf_struct(node, feeds):
    """The struct of a placeholder or variable leaf, or None."""
    if node in feeds:
        st = feeds[node]
        # a feed decides a FED placeholder's struct; a declared shape it
        # disagrees with is the feed-mismatch rule's business
        if not node.is_variable:
            return st
    shape = node.shape
    if shape is None:
        return None
    return meta(shape, node.dtype or np.float32)


def _ctx(training):
    return LowerCtx(training, torch.Generator().manual_seed(0))


def _node_eval(node, in_structs, training=True):
    """One node's lowering over input structs."""
    from ..metrics import suppress_perf_counters
    with suppress_perf_counters(), torch.no_grad():
        return node.lower(_ctx(training), *in_structs)


def _detached(out):
    if isinstance(out, (tuple, list)):
        return tuple(_detached(o) for o in out)
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"lowering returned {type(out).__name__}, not a "
                        f"tensor")
    return out if out.device.type == "meta" else meta(out.shape, out.dtype)


def infer_graph(fetches, feeds=None, training=True):
    """A static ``(shape, dtype)`` for every node of the fetch subgraph,
    computed on meta tensors.

    ``feeds``: optional {placeholder node or name: array | shape |
    struct} for placeholders declared without a shape.  ``training``: the
    lowering context's flag (dropout draws, BatchNorm's batch
    statistics)."""
    from ..metrics import suppress_perf_counters
    from ..optim.optimizer import OptimizerOp

    if isinstance(fetches, dict):
        fetches = [n for fl in fetches.values() for n in fl]
    elif not isinstance(fetches, (list, tuple)):
        fetches = [fetches]
    topo = topo_sort([f for f in fetches if f is not None])
    gs = GraphShapes(topo)
    feeds = _normalize_feeds(feeds, topo)

    compute = []
    for node in topo:
        if isinstance(node, OptimizerOp):
            gs.markers.append(node)
        elif isinstance(node, GradientOp):
            continue  # mirrors its wrt leaf, below
        elif isinstance(node, PlaceholderOp):
            try:
                st = _ps_struct(node, feeds, gs.structs) \
                    if getattr(node, "is_ps", False) \
                    else _leaf_struct(node, feeds)
            except Exception as e:  # corrupt store or feed metadata
                gs.failed[node] = f"{type(e).__name__}: {e}"
                continue
            if st is None:
                gs.pending[node] = (
                    "no static shape: declare shape= or pass a feed "
                    "example to lint(feeds=...)")
            else:
                gs.structs[node] = st
        else:
            compute.append(node)

    for node in topo:
        if isinstance(node, GradientOp):
            st = gs.structs.get(node.wrt)
            if st is not None:
                gs.structs[node] = st
            else:
                gs.pending[node] = f"wrt {node.wrt.name} has no static shape"

    # the runnable set in topo order; pending-ness propagates
    runnable = []
    have = set(gs.structs)
    for node in compute:
        bad = next((i for i in node.inputs if i not in have), None)
        if bad is None:
            runnable.append(node)
            have.add(node)
        elif bad in gs.failed:
            gs.pending[node] = f"input '{bad.name}' failed abstract eval"
        else:
            gs.pending[node] = f"input '{bad.name}' has no static shape"

    if not runnable:
        return gs
    try:
        # the fast path: one walk over the whole runnable set
        ctx = _ctx(training)
        env = {n: gs.structs[n] for n in topo if n in gs.structs}
        out = {}
        with suppress_perf_counters(), torch.no_grad():
            for node in runnable:
                env[node] = node.lower(ctx, *[env[i] for i in node.inputs])
                out[node] = _detached(env[node])
        gs.structs.update(out)
    except Exception:
        # isolate the failing node(s); their consumers turn pending
        for node in runnable:
            bad = next((i for i in node.inputs if i not in gs.structs),
                       None)
            if bad is not None:
                gs.pending[node] = f"input '{bad.name}' could not be inferred"
                continue
            try:
                gs.structs[node] = _detached(_node_eval(
                    node, [gs.structs[i] for i in node.inputs], training))
            except Exception as e:
                gs.failed[node] = f"{type(e).__name__}: {e}"
    return gs


def _nested(shape):
    return bool(shape) and isinstance(shape[0], (tuple, list))


def _structs_for(input_shapes, dtypes):
    out = []
    for s, dt in zip(input_shapes, dtypes):
        if _nested(s):
            out.append(tuple(meta(x, np.float32) for x in s))
        else:
            out.append(meta(s, dt))
    return out


def abstract_infer_shape(node, input_shapes):
    """Best-effort static output shape of ONE node from input shapes only
    (the ``Op.infer_shape`` fallback).  Input dtypes are unknown here, so
    a ladder of guesses is tried: all float32, then one int32 at a time
    (index operands), then all int32.  Returns a shape tuple (a tuple of
    them for a multi-output op), or None when the inputs are unknown or
    the rule needs run-time context."""
    if input_shapes is None:
        input_shapes = []
    input_shapes = list(input_shapes)
    if any(s is None for s in input_shapes):
        return None
    key = tuple(tuple(s) if not _nested(s) else tuple(map(tuple, s))
                for s in input_shapes)
    cache = node.__dict__.setdefault("_abs_shape_cache", {})
    if key in cache:
        return cache[key]
    n = len(input_shapes)
    combos = [[np.float32] * n]
    for i in range(n):
        flip = [np.float32] * n
        flip[i] = np.int32
        combos.append(flip)
    if n > 1:
        combos.append([np.int32] * n)
    result = None
    for dts in combos:
        try:
            out = _node_eval(node, _structs_for(input_shapes, dts),
                             training=False)
        except Exception:
            continue
        result = _shape_of(out)
        break
    cache[key] = result
    return result
