"""Rematerialization policies (twin of ``hetu_tpu/parallel/remat.py``).

``Executor(remat=...)`` trades recompute, or host traffic, for activation
memory, on non-reentrant ``torch.utils.checkpoint``:

* ``'off'``     — autograd saves what it saves (the default).
* ``'dots'``    — the whole forward runs under one checkpoint with a
  selective policy: the outputs of products with no batch dimension
  (``aten.mm`` / ``aten.addmm``) are saved, everything else is
  recomputed in the backward, as ``dots_with_no_batch_dims_saveable``
  does.  ``True`` maps here.
* ``'full'``    — segmented: the forward is cut into contiguous segments
  anchored at products and attention (:func:`build_segments`,
  ``HETU_REMAT_SEGMENT_ANCHORS`` anchors a segment, default 6, about one
  transformer block), each lowered inside its own checkpoint, so only
  segment boundaries survive to the backward.  State-writing ops
  (BatchNorm's running statistics) lower outside and close the segment.
* ``'offload'`` — on CUDA, every tensor autograd saves that is a product's
  output goes to pinned host memory when it is saved and comes back when
  the backward reads it (``torch.autograd.graph.saved_tensors_hooks``);
  the bytes moved are counted (``remat_offload_bytes``).  Unlike the JAX
  policy (``offload_dot_with_no_batch_dims``), nothing else is
  recomputed: the other activations stay on the device.  Elsewhere the
  JAX package's counted fallback to ``'dots'`` (``remat_offload_fallback``
  once an executor; ``HETU_REQUIRE_OFFLOAD=1`` raises instead).
* ``'auto'``    — the segments of ``'full'``, each priced from the
  shapes of ``analysis.infer_graph`` (:func:`_price_segments`: the bytes
  of the values it produces, the bytes that must survive as its
  boundaries, the products' FLOPs a replay re-pays, with
  ``autoparallel.cost_model``'s pricing); the cheapest recompute per
  byte freed is rematted first until the projected live bytes fit the
  budget (:func:`resolve_budget`: ``HETU_HBM_BUDGET_MB``, else the
  card's memory).  No budget, or a graph that does not price, remats
  every segment.  ``Executor.remat_plan()`` reports the plan.

Every policy gives the losses and gradients of ``'off'`` bit for bit: a
recompute replays the same ops on the same inputs.  Dropout draws from
the step's explicit ``torch.Generator`` (``ctx.rng()``), which
``checkpoint``'s ``preserve_rng_state`` does not restore, so each
checkpointed region snapshots the generator's state on entry and
restores it at the top of its recompute: the replay draws the masks the
forward drew.  A recompute also launches the forward's kernels again (the
flash forward: twice a layer a step under every policy but ``'off'``).
"""
from __future__ import annotations

import functools
import os
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..metrics import record_remat

POLICIES = ("off", "dots", "full", "offload", "auto")

#: product and attention op types: segment anchors
ANCHOR_OPS = {"MatrixMult", "Linear", "BatchMatrixMult", "Addmm",
              "Baddbmm", "Einsum", "Conv2d", "Conv2dAddBias"}
ANCHOR_PREFIXES = ("ScaledDotProductAttention", "RingAttention",
                   "UlyssesAttention")

#: ops that write ``ctx.state_updates`` while lowering: they lower
#: outside every segment and close the current one
STATE_WRITING_OPS = {"BatchNorm", "StateWrite"}

#: op types whose outputs ``'offload'`` moves to the host when saved
#: (products with no batch dimension)
OFFLOAD_OPS = {"MatrixMult", "Linear", "Addmm"}


def _is_anchor(node):
    t = node.op_type
    return t in ANCHOR_OPS or t.startswith(ANCHOR_PREFIXES)


def anchors_per_segment():
    """Anchors a segment (``HETU_REMAT_SEGMENT_ANCHORS``, default 6)."""
    try:
        return max(1, int(os.environ.get("HETU_REMAT_SEGMENT_ANCHORS",
                                         "6")))
    except ValueError:
        return 6


def resolve_policy(value):
    """A ``remat=`` setting as a policy name: ``True`` is ``'dots'``,
    ``False`` / ``None`` ``'off'``; an unknown string raises."""
    if value is None or value is False:
        return "off"
    if value is True:
        return "dots"
    pol = str(value).lower()
    if pol not in POLICIES:
        raise ValueError(
            f"remat={value!r}: expected one of {'|'.join(POLICIES)} "
            f"(True == 'dots', False == 'off')")
    return pol


def resolve_budget(device=None):
    """The device memory budget of ``'auto'`` in bytes: ``(bytes,
    source)``, or ``(None, None)``.  ``HETU_HBM_BUDGET_MB`` wins; then a
    CUDA ``device``'s (or, given none, the current card's) total memory;
    the CPU reports none."""
    env = os.environ.get("HETU_HBM_BUDGET_MB")
    if env:
        try:
            return int(float(env) * 2**20), "HETU_HBM_BUDGET_MB"
        except ValueError:
            pass
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        try:
            _free, total = torch.cuda.mem_get_info(dev)
            return int(total), "device"
        except Exception:
            pass
    return None, None


@dataclass
class RematSegment:
    """One contiguous run of forward nodes, anchored at products.

    ``act_bytes`` prices every value the segment produces (what saving
    them costs), ``out_bytes`` the ones that survive as its boundaries
    either way (consumed outside it, or fetched), ``recompute_flops`` the
    product FLOPs a replay re-pays; ``saved_bytes``, what remat frees, is
    the difference."""

    index: int
    nodes: list
    anchors: int = 0
    act_bytes: float = 0.0
    out_bytes: float = 0.0
    recompute_flops: float = 0.0
    remat: bool = False

    @property
    def saved_bytes(self):
        return max(0.0, self.act_bytes - self.out_bytes)

    @property
    def cost_per_byte(self):
        """The greedy key: recompute FLOPs per byte freed."""
        return self.recompute_flops / max(1.0, self.saved_bytes)


@dataclass
class RematPlan:
    """The per-segment decisions of one subgraph (``'full'``: every
    segment; ``'auto'``: the budget's)."""

    policy: str
    segments: list = field(default_factory=list)
    budget_bytes: object = None
    budget_source: object = None
    persistent_bytes: int = 0
    priced: bool = True
    note: str = ""

    @property
    def n_remat(self):
        return sum(1 for s in self.segments if s.remat)

    @property
    def bytes_saved(self):
        return int(sum(s.saved_bytes for s in self.segments if s.remat))

    @property
    def recompute_flops(self):
        return int(sum(s.recompute_flops for s in self.segments
                       if s.remat))

    @property
    def total_act_bytes(self):
        return int(sum(s.act_bytes for s in self.segments))

    def remat_node_lists(self):
        """Node lists of the segments the plan remats."""
        return [s.nodes for s in self.segments if s.remat]

    def report(self):
        """The JSON-able summary ``Executor.remat_plan()`` returns (the
        JAX package's keys)."""
        return {
            "policy": self.policy,
            "segments": len(self.segments),
            "segments_rematted": self.n_remat,
            "budget_bytes": self.budget_bytes,
            "budget_source": self.budget_source,
            "persistent_bytes": int(self.persistent_bytes),
            "activation_bytes_total": self.total_act_bytes,
            "activation_bytes_saved": self.bytes_saved,
            "recompute_flops": self.recompute_flops,
            "priced": bool(self.priced),
            "note": self.note,
            "per_segment": [
                {"index": s.index, "ops": len(s.nodes),
                 "anchors": s.anchors,
                 "act_bytes": int(s.act_bytes),
                 "saved_bytes": int(s.saved_bytes),
                 "recompute_flops": int(s.recompute_flops),
                 "remat": bool(s.remat)}
                for s in self.segments],
        }


def build_segments(topo, skip=()):
    """Partition the lowerable forward nodes of ``topo`` into contiguous
    anchored segments (the JAX package's rule): placeholders, gradient
    markers and ``skip`` never lower in a segment; a state-writing op
    closes the current one; a segment closes after
    ``anchors_per_segment()`` anchors.  Only segments with an anchor and
    more than one node are kept."""
    from ..graph.gradients import GradientOp
    from ..graph.node import PlaceholderOp

    per = anchors_per_segment()
    skip = set(skip)
    segments, cur, nanch = [], [], 0

    def close():
        nonlocal cur, nanch
        if cur:
            segments.append(cur)
        cur, nanch = [], 0

    for node in topo:
        if isinstance(node, (PlaceholderOp, GradientOp)) or node in skip:
            continue
        if node.op_type in STATE_WRITING_OPS:
            close()
            continue
        cur.append(node)
        if _is_anchor(node):
            nanch += 1
            if nanch >= per:
                close()
    close()
    return [s for s in segments
            if len(s) > 1 and any(_is_anchor(n) for n in s)]


def _price_segments(segments, fetches, topo, skip=()):
    """Per-segment (act_bytes, out_bytes, recompute_flops) from the shapes
    of ``analysis.infer_graph``.  True when every segment priced; a failed
    inference leaves the prices at 0."""
    from ..graph.gradients import GradientOp
    try:
        from ..analysis.shapes import infer_graph
        from ..autoparallel.cost_model import MATMUL_OPS, matmul_flops
        gs = infer_graph(fetches)
    except Exception:
        return False

    def nbytes(node):
        st = gs.struct(node)
        if st is None or isinstance(st, (tuple, list)):
            return None
        return float(st.numel() * st.element_size())

    # a segment's value consumed outside it survives as a boundary
    skip = set(skip)
    lowerable = [n for n in topo
                 if not (isinstance(n, GradientOp) or n in skip)]
    consumers = {}
    for n in lowerable:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)
    fetch_set = {f for f in fetches if f is not None}

    ok = True
    for seg in segments:
        segset = set(seg.nodes)
        act = out = flops = 0.0
        for node in seg.nodes:
            b = nbytes(node)
            if b is None:
                ok = False
                continue
            act += b
            cons = consumers.get(node, [])
            if node in fetch_set or not cons \
                    or any(c not in segset for c in cons):
                out += b
            if node.op_type in MATMUL_OPS or node.op_type == "Einsum":
                f = None
                try:
                    f = matmul_flops(node, gs, gs.shape(node))
                except Exception:
                    f = None
                if f:
                    flops += f
                else:
                    ok = False
            elif node.op_type.startswith("Conv"):
                # 2 * output elements * the contracted Cin * kH * kW
                out_shape = gs.shape(node)
                w_shape = gs.shape(node.inputs[1])
                if out_shape and w_shape:
                    flops += 2.0 * float(np.prod(out_shape)) \
                        * float(np.prod(w_shape)) / w_shape[0]
                else:
                    ok = False
            elif node.op_type.startswith(ANCHOR_PREFIXES):
                # attention: the scores and values products
                q = gs.shape(node.inputs[0])
                kv = gs.shape(node.inputs[1])
                if q and kv:
                    flops += 2.0 * 2.0 * float(np.prod(q[:-2])) \
                        * q[-2] * kv[-2] * q[-1]
                else:
                    ok = False
        seg.act_bytes, seg.out_bytes, seg.recompute_flops = act, out, flops
    return ok


def build_plan(topo, fetches, policy, skip=(), persistent_bytes=0,
               budget=None, budget_source=None):
    """The per-segment decisions of ``policy`` over one fetch subgraph: a
    :class:`RematPlan`, or None for the policies without segments.
    Records the ``remat_*`` counters once a build."""
    if policy not in ("full", "auto"):
        return None
    segs = [RematSegment(index=i, nodes=nodes)
            for i, nodes in enumerate(build_segments(topo, skip=skip))]
    for s in segs:
        s.anchors = sum(1 for n in s.nodes if _is_anchor(n))
    priced = _price_segments(segs, fetches, topo, skip=skip)
    note = ""
    if policy == "full":
        for s in segs:
            s.remat = True
    else:
        if budget is None:
            budget, budget_source = resolve_budget()
        if budget is None or not priced:
            # no budget, or a graph that does not price: remat everything
            # (the remat-policy lint says so at construction)
            for s in segs:
                s.remat = True
            note = "no HBM budget resolvable — rematting every segment" \
                if budget is None else \
                "graph not fully priceable — rematting every segment"
        else:
            live = persistent_bytes + sum(s.act_bytes for s in segs)
            for s in sorted(segs, key=lambda s: s.cost_per_byte):
                if live <= budget:
                    break
                s.remat = True
                live -= s.saved_bytes
            if live > budget:
                note = (f"budget {budget} B not reachable even with "
                        f"every segment rematted (projected {int(live)} "
                        f"B)")
    plan = RematPlan(policy=policy, segments=segs, budget_bytes=budget,
                     budget_source=budget_source,
                     persistent_bytes=int(persistent_bytes),
                     priced=priced, note=note)
    record_remat("remat_layers_total", len(segs))
    record_remat("remat_layers_rematted", plan.n_remat)
    record_remat("remat_bytes_saved", plan.bytes_saved)
    record_remat("remat_recompute_flops", plan.recompute_flops)
    return plan


def plan_for(sub):
    """The ``'full'`` or ``'auto'`` plan of one differentiating subgraph
    (None for the other policies and for forward-only subgraphs); the
    persistent bytes are the executor's parameters, optimizer state and
    gradients (``Executor.memory_accounting``), the budget the
    executor's device's."""
    ex = sub.ex
    if ex.remat not in ("full", "auto") or not sub.grad_ops:
        return None
    mem = ex.memory_accounting()
    persistent = (mem["param_bytes_per_device"]
                  + mem["zero_slab_bytes_per_device"]
                  + mem["opt_state_bytes_per_device"]
                  + mem["grad_bytes_per_device"])
    budget, source = resolve_budget(ex.device) if ex.remat == "auto" \
        else (None, None)
    return build_plan(sub.topo, sub.fetches, ex.remat, skip=sub.opt_ops,
                      persistent_bytes=persistent, budget=budget,
                      budget_source=source)


def offload_available(device):
    """Whether ``'offload'`` can move saved products to pinned host
    memory on ``device`` (CUDA only).  Otherwise the fallback to
    ``'dots'`` is counted, or raises under ``HETU_REQUIRE_OFFLOAD=1``."""
    if device.type == "cuda":
        return True
    record_remat("remat_offload_fallback")
    if os.environ.get("HETU_REQUIRE_OFFLOAD") == "1":
        raise RuntimeError(
            f"HETU_REQUIRE_OFFLOAD=1 but activation offload is "
            f"unavailable here (reason: backend_{device.type})")
    return False


# -- the checkpointed regions --------------------------------------------------

_DOT_OPS = None


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    global _DOT_OPS
    if _DOT_OPS is None:
        _DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, generator, *args, dots=False):
    """``fn(*args)`` under a non-reentrant checkpoint (with the ``'dots'``
    selective policy when ``dots``).  ``generator`` (the step's, or None)
    is snapshotted here and restored at the top of every evaluation of
    ``fn``, so a recompute draws the masks the forward drew."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    snap = None if generator is None else generator.get_state()

    def replay(*a):
        if snap is not None:
            generator.set_state(snap)
        return fn(*a)

    kw = {}
    if dots:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(replay, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class ProductOffload:
    """The ``'offload'`` hooks of one step: the executor tells it of each
    product's output (:meth:`note`); when autograd saves a tensor whose
    storage is a live product output's, it is copied to pinned host
    memory (once a distinct view) and copied back when the backward
    unpacks it.  ``bytes`` counts what went to the host."""

    def __init__(self):
        self.bytes = 0
        # storage address -> the product output (weak: a freed output's
        # address, reused by the allocator, must not match)
        self._products = weakref.WeakValueDictionary()
        self._host = {}

    def note(self, t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            self._products[t.untyped_storage().data_ptr()] = t

    def _pack(self, t):
        ptr = t.untyped_storage().data_ptr() if t.is_cuda else None
        prod = None if ptr is None else self._products.get(ptr)
        if prod is None:
            return t
        key = (ptr, t.storage_offset(), tuple(t.shape), t.stride(), t.dtype)
        ref, h = self._host.get(key, (None, None))
        if ref is None or ref() is not prod:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self.bytes += h.numel() * h.element_size()
            self._host[key] = (weakref.ref(prod), h)
        return (t.device, h)

    @staticmethod
    def _unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        device, h = packed
        return h.to(device, non_blocking=True)

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)


__all__ = ["POLICIES", "ANCHOR_OPS", "ANCHOR_PREFIXES", "STATE_WRITING_OPS",
           "OFFLOAD_OPS", "resolve_policy", "resolve_budget",
           "anchors_per_segment", "RematSegment", "RematPlan",
           "build_segments", "build_plan", "plan_for",
           "offload_available", "checkpointed", "ProductOffload"]
