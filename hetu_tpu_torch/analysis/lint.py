"""Graph lint: a rule registry and diagnostics that name their node and
the user line that created it (twin of ``hetu_tpu/analysis/lint.py``).

Every rule sees the whole fetch subgraph with its static shapes
(:mod:`hetu_tpu_torch.analysis.shapes`) and yields :class:`Diagnostic`s
that name the offending node and its ``Op.creation_site``, so
``Executor(validate='error')`` fails with "your feed disagrees with
placeholder 'x' created at train.py:42" before anything runs.

Rules, with the JAX package's names and severities:

* ``uninferable`` (error) — a node's abstract lowering raised
* ``shape-rule-mismatch`` (error) — a hand ``infer_shape`` disagrees with
  the abstract interpreter
* ``feed-mismatch`` (error) — a fed value's shape or dtype disagrees with
  the placeholder's declaration
* ``grad-nontrainable`` (error) — a gradient w.r.t. a non-trainable or
  non-variable node
* ``duplicate-var-name`` (warn) — two variables share a checkpoint name
* ``ps-embedding-width`` (error) — a declared embedding width that is not
  the PS table's
* ``flash-fallback`` (warn) — an attention call the port's kernels would
  refuse on the card: a head dim above ``MAX_HEAD_DIM`` once padded to
  their multiple (a head dim off the multiple, such as 41, is zero-padded
  and taken), a mask or bias outside
  their broadcast support (1|B, 1|H, 1|S_q, S_kv), a q dtype other than
  float32 or bfloat16.  The port launches at every length and masks
  ragged tiles, so, unlike the JAX rule, a causal call with lengths that
  differ mod 128 is not flagged (ROADMAP C7).
* ``zero-sharding`` (warn) — ``zero=`` with no data-parallel group of two
  ranks or more (the update runs replicated), an optimizer that keeps the
  replicated update, or a bucket that needs zero padding to shard
* ``remat-policy`` (error/warn) — an unknown policy, a policy with
  nothing to recompute, ``'auto'`` with no budget
* ``train-only-op-in-serving`` (error/warn) — only under
  ``lint(serving=True)``: an optimizer update or a gradient reachable from
  a serving fetch set is an error, a dropout a warning
* ``decode-incompatible-op`` (error) — only under ``lint(decode=True)``:
  full-sequence attention or batch statistics in a one-token decode step
* ``feed-schema-churn`` (warn, at run time) — emitted by the run-plan
  cache (``graph/run_plan.py``), not a static pass: a fed placeholder's
  shape keeps changing, so every run re-plans.

Not ported: ``mesh-axis``, ``pipeline-stage`` and ``plan-coverage``,
which check ``mesh=``, ``pipeline=`` and ``plan=``, arguments the port's
executor refuses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.gradients import GradientOp
from ..graph.node import Op, PlaceholderOp, format_site
from .shapes import GraphShapes, _normalize_feeds, infer_graph

#: rule name -> callable(GraphInfo) -> iterable[Diagnostic]
RULES = {}


def rule(name):
    def deco(fn):
        RULES[name] = fn
        fn.rule_name = name
        return fn
    return deco


@dataclass
class Diagnostic:
    rule: str
    severity: str          # 'error' | 'warn'
    message: str
    node: object = None    # the offending Op, when there is one
    #: a rule crashed: reported, never escalated to an exception (an
    #: analyzer bug must not reject a working graph)
    internal: bool = False

    def __str__(self):
        loc = ""
        if self.node is not None:
            loc = (f" [node '{self.node.name}' created at "
                   f"{format_site(getattr(self.node, 'creation_site', None))}]")
        return f"{self.severity}[{self.rule}]: {self.message}{loc}"


class GraphInfo:
    """What a rule sees: topo, static shapes and the executor's settings
    (``dp``: the data-parallel group's size, or None without one)."""

    def __init__(self, shapes: GraphShapes, feeds, feed_values=None, zero=0,
                 serving=False, remat="off", decode=False, dp=None):
        self.shapes = shapes
        self.topo = shapes.topo
        self.feeds = feeds
        #: {node: fed array} for feeds given as values, not bare shapes
        self.feed_values = feed_values or {}
        self.zero = int(zero or 0)
        self.serving = bool(serving)
        self.decode = bool(decode)
        #: the requested remat policy, raw: the rule diagnoses unknown names
        self.remat = remat
        self.dp = dp

    def shape(self, node):
        return self.shapes.shape(node)

    def struct(self, node):
        return self.shapes.struct(node)


class LintReport:
    """Diagnostics and the shape assignment they came from."""

    def __init__(self, shapes: GraphShapes, diagnostics):
        self.shapes = shapes
        order = {"error": 0, "warn": 1}
        self.diagnostics = sorted(diagnostics,
                                  key=lambda d: order.get(d.severity, 2))

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == "warn"]

    @property
    def ok(self):
        return not self.diagnostics

    @property
    def complete(self):
        """Every value-producing node got a static (shape, dtype)."""
        return self.shapes.complete

    def __bool__(self):
        return self.ok

    def __str__(self):
        if self.ok:
            return "lint: clean"
        return "\n".join(str(d) for d in self.diagnostics)

    def raise_errors(self, all_severities=False):
        bad = self.diagnostics if all_severities else self.errors
        bad = [d for d in bad if not d.internal]
        if bad:
            raise GraphValidationError(
                "graph validation failed:\n" +
                "\n".join(f"  {d}" for d in bad))


class GraphValidationError(ValueError):
    """Raised by ``Executor(validate='error')`` and
    ``LintReport.raise_errors``."""


# --------------------------------------------------------------------- rules

@rule("uninferable")
def _r_uninferable(gi):
    for node, why in gi.shapes.failed.items():
        yield Diagnostic(
            "uninferable", "error",
            f"abstract evaluation of {node.op_type} '{node.name}' failed: "
            f"{why}", node)


def _has_hand_rule(node):
    if getattr(node, "has_shape_rule", None) is not None:
        return bool(node.has_shape_rule)   # SimpleOp: an explicit shape_fn
    return type(node).infer_shape is not Op.infer_shape


def _norm_shape(s):
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_norm_shape(x) if isinstance(x, (tuple, list))
                     else int(x) for x in s)
    return s


@rule("shape-rule-mismatch")
def _r_shape_rule(gi):
    """Hand-written shape rules against the abstract interpreter."""
    for node in gi.topo:
        if node in gi.shapes.failed or node in gi.shapes.pending \
                or isinstance(node, (PlaceholderOp, GradientOp)):
            continue
        if not _has_hand_rule(node):
            continue
        in_shapes = [gi.shape(i) for i in node.inputs]
        if any(s is None for s in in_shapes):
            continue
        try:
            declared = node.infer_shape(in_shapes)
        except Exception as e:
            yield Diagnostic(
                "shape-rule-mismatch", "error",
                f"hand shape rule of {node.op_type} '{node.name}' raised "
                f"{type(e).__name__}: {e}", node)
            continue
        if declared is None:
            continue
        actual = gi.shape(node)
        if _norm_shape(declared) != _norm_shape(actual):
            yield Diagnostic(
                "shape-rule-mismatch", "error",
                f"hand shape rule of {node.op_type} '{node.name}' says "
                f"{_norm_shape(declared)} but its lowering produces "
                f"{_norm_shape(actual)}", node)


@rule("feed-mismatch")
def _r_feed(gi):
    for node, st in gi.feeds.items():
        if isinstance(st, (tuple, list)):
            continue  # a nested feed: no single shape to check
        if not isinstance(node, PlaceholderOp):
            yield Diagnostic(
                "feed-mismatch", "error",
                f"feed target '{getattr(node, 'name', node)}' is not a "
                f"placeholder (op type {getattr(node, 'op_type', '?')})",
                node if isinstance(node, Op) else None)
            continue
        if node.is_variable:
            yield Diagnostic(
                "feed-mismatch", "error",
                f"'{node.name}' is a variable, not a fed placeholder — "
                f"use executor.load_dict / set_value to change it", node)
            continue
        if node.shape is not None and tuple(st.shape) != tuple(node.shape):
            yield Diagnostic(
                "feed-mismatch", "error",
                f"feed for placeholder '{node.name}' has shape "
                f"{tuple(st.shape)} but the placeholder declares "
                f"{tuple(node.shape)}", node)
            continue
        # the executor casts a feed to the declared dtype: an error only
        # where the cast would destroy values (checkable for fed values)
        val = gi.feed_values.get(node)
        if node.dtype is not None and val is not None \
                and np.issubdtype(np.dtype(node.dtype), np.integer) \
                and np.issubdtype(np.asarray(val).dtype, np.floating) \
                and not np.all(np.mod(np.asarray(val), 1.0) == 0):
            yield Diagnostic(
                "feed-mismatch", "error",
                f"feed for placeholder '{node.name}' holds fractional "
                f"float values but the placeholder declares "
                f"{np.dtype(node.dtype)} — the executor's dtype adoption "
                f"would truncate them", node)


@rule("grad-nontrainable")
def _r_grad(gi):
    for node in gi.topo:
        if not isinstance(node, GradientOp):
            continue
        wrt = node.wrt
        if not (isinstance(wrt, PlaceholderOp) and wrt.is_variable):
            yield Diagnostic(
                "grad-nontrainable", "error",
                f"gradient requested w.r.t. '{wrt.name}' which is not a "
                f"variable ({wrt.op_type})", wrt)
        elif not wrt.trainable:
            yield Diagnostic(
                "grad-nontrainable", "error",
                f"gradient requested w.r.t. NON-TRAINABLE variable "
                f"'{wrt.name}' — the optimizer would silently train it "
                f"(mark trainable=True or drop it from the loss params)",
                wrt)


@rule("duplicate-var-name")
def _r_dup_names(gi):
    seen = {}
    for node in gi.topo:
        if isinstance(node, PlaceholderOp) and node.is_variable:
            first = seen.setdefault(node.name, node)
            if first is not node:
                yield Diagnostic(
                    "duplicate-var-name", "warn",
                    f"two variables share checkpoint name '{node.name}' "
                    f"(first created at "
                    f"{format_site(first.creation_site)}) — the executor "
                    f"renames the second to '{node.name}~1', making the "
                    f"checkpoint identity creation-order-dependent", node)


@rule("ps-embedding-width")
def _r_ps_width(gi):
    for node in gi.topo:
        if not getattr(node, "is_ps", False):
            continue
        store, table = node.store, node.table
        if not hasattr(store, "width"):
            continue
        try:
            actual = int(store.width(table))
        except Exception as e:
            yield Diagnostic(
                "ps-embedding-width", "error",
                f"PS embedding '{node.name}': table {table} is not "
                f"readable from its store ({type(e).__name__}: {e})", node)
            continue
        if node.width is not None and int(node.width) != actual:
            yield Diagnostic(
                "ps-embedding-width", "error",
                f"PS embedding '{node.name}' declares width {node.width} "
                f"but table {table} has width {actual} — every pulled row "
                f"would be mis-shaped", node)


#: attention op types -> (index of k, index of the mask or None, index of
#: the bias or None)
_ATTN_OPS = {
    "ScaledDotProductAttention": (1, None, None),
    "ScaledDotProductAttentionVarlen": (1, None, None),
    "ScaledDotProductAttentionMasked": (1, 3, None),
    "ScaledDotProductAttentionBias": (1, None, 3),
    "ScaledDotProductAttentionMaskedBias": (1, 3, 4),
}


def _broadcastable(q, k, extra):
    """(1|B, 1|H, 1|S_q, S_kv): what ``classify_group`` takes."""
    s = tuple(extra.shape)
    if len(s) != 4:
        return False
    b, h, s_q, _ = q.shape
    return s[3] == k.shape[-2] and s[2] in (1, s_q) and s[0] in (1, b) \
        and s[1] in (1, h)


@rule("flash-fallback")
def _r_flash(gi):
    """Attention calls the port's kernels would refuse on the card (the
    dispatchers never fall back to the plain attention there: the
    wrapper raises)."""
    import torch
    from ..ops.kernels.flash_attention import MAX_HEAD_DIM, padded_head_dim
    for node in gi.topo:
        spec = _ATTN_OPS.get(node.op_type)
        if spec is None:
            continue
        k_i, m_i, b_i = spec
        q = gi.struct(node.inputs[0])
        k = gi.struct(node.inputs[k_i]) if k_i < len(node.inputs) else None
        if q is None or k is None or isinstance(q, tuple) \
                or isinstance(k, tuple) or q.ndim != 4:
            continue
        d = q.shape[-1]
        if q.dtype not in (torch.float32, torch.bfloat16):
            yield Diagnostic(
                "flash-fallback", "warn",
                f"{node.op_type} '{node.name}': q is {q.dtype}; the flash "
                f"kernels take float32 or bfloat16, so on the card this "
                f"call raises", node)
            continue
        if padded_head_dim(d, q.dtype) > MAX_HEAD_DIM:
            yield Diagnostic(
                "flash-fallback", "warn",
                f"{node.op_type} '{node.name}': head dim {d} pads to "
                f"{padded_head_dim(d, q.dtype)} for {q.dtype}, above the "
                f"kernels' {MAX_HEAD_DIM}, so on the card the flash kernels "
                f"refuse this call (reason 'head_dim')", node)
        for what, idx in (("mask", m_i), ("bias", b_i)):
            if idx is None or idx >= len(node.inputs):
                continue
            extra = gi.struct(node.inputs[idx])
            if extra is not None and not isinstance(extra, tuple) \
                    and not _broadcastable(q, k, extra):
                yield Diagnostic(
                    "flash-fallback", "warn",
                    f"{node.op_type} '{node.name}': {what} shape "
                    f"{tuple(extra.shape)} is outside the flash kernel's "
                    f"broadcast support (1|B, 1|H, 1|S_q, S_kv) — on the "
                    f"card this call raises (reason '{what}_shape')", node)


@rule("zero-sharding")
def _r_zero(gi):
    """ZeRO's preconditions (``parallel/zero.py``): a data-parallel group
    of two ranks or more, optimizers whose every parameter is eligible,
    and buckets that shard without padding (the executor's own bucketing
    is reproduced, so a ragged parameter absorbed by its bucket is
    silent)."""
    if not gi.zero:
        return
    from ..optim.optimizer import OptimizerOp
    from ..parallel.zero import ZERO_AXIS, build_plan, ineligible_reason
    opt_ops = [n for n in gi.topo if isinstance(n, OptimizerOp)]
    if not opt_ops:
        return
    dp = gi.dp
    if not dp or dp < 2:
        yield Diagnostic(
            "zero-sharding", "warn",
            f"zero={gi.zero} requested but the executor has "
            f"{'a data-parallel group of ' + str(dp) if dp else 'no data-parallel group'}"
            f" — no '{ZERO_AXIS}' group of size >= 2 to shard the weight "
            f"update over, so the update runs fully REPLICATED (no memory "
            f"win)", opt_ops[0])
        return
    for op in opt_ops:
        ineligible = None
        for p in op.params:
            dt = getattr(p, "dtype", None) or gi.shapes.dtype(p)
            why = ineligible_reason(p, dt)
            if why is not None:
                ineligible = (p, why)
                break
        if ineligible:
            p, why = ineligible
            yield Diagnostic(
                "zero-sharding", "warn",
                f"zero={gi.zero}: optimizer '{op.name}' stays on the "
                f"fully REPLICATED update path because parameter "
                f"'{p.name}' {why} — no ZeRO memory win for its params "
                f"or moments", p)
            continue
        items, by_key = [], {}
        for i, p in enumerate(op.params):
            shape = p.shape if getattr(p, "shape", None) is not None \
                else gi.shape(p)
            if shape is None:
                continue
            dt = getattr(p, "dtype", None) or gi.shapes.dtype(p) \
                or np.float32
            key = f"p{i}"
            items.append((key, tuple(shape), np.dtype(dt).name))
            by_key[key] = p
        if not items:
            continue
        plan = build_plan(items, dp, gi.zero,
                          per_param=bool(getattr(op.optimizer, "lamb",
                                                 False)))
        for b in plan.buckets:
            if not b.pad:
                continue
            ragged = [k for k, shape in zip(b.param_keys, b.shapes)
                      if (int(np.prod(shape, dtype=np.int64))
                          if shape else 1) % dp]
            names = [by_key[k].name for k in ragged]
            pad_bytes = b.pad * np.dtype(b.dtype).itemsize
            yield Diagnostic(
                "zero-sharding", "warn",
                f"ZeRO bucket of {len(b.param_keys)} param(s) "
                f"({', '.join(repr(n) for n in names[:4])}"
                f"{', ...' if len(names) > 4 else ''} not divisible by "
                f"the '{ZERO_AXIS}' group) totals {b.numel} elements — "
                f"zero-padded to {b.padded} ({b.pad} wasted elements, "
                f"{pad_bytes} B per collective; see zero_pad_bytes)",
                by_key[ragged[0]])


@rule("remat-policy")
def _r_remat(gi):
    """Remat's preconditions (``parallel/remat.py``): an unknown policy is
    an error; a policy on a graph with nothing to recompute is a silent
    no-op worth a warning; ``'auto'`` with no budget remats every
    segment."""
    from ..parallel import remat as remat_mod
    pol = gi.remat
    if pol in (None, False, 0, "off"):
        return
    if pol is True:
        pol = "dots"
    anchor_node = next((n for n in gi.topo
                        if remat_mod._is_anchor(n)), None)
    site_node = anchor_node or next(
        (n for n in gi.topo
         if not isinstance(n, (PlaceholderOp, GradientOp))), None)
    if pol not in remat_mod.POLICIES:
        yield Diagnostic(
            "remat-policy", "error",
            f"unknown remat policy {pol!r} — expected one of "
            f"{'|'.join(remat_mod.POLICIES)} (True == 'dots')",
            site_node)
        return
    grads = [n for n in gi.topo if isinstance(n, GradientOp)]
    if not grads:
        yield Diagnostic(
            "remat-policy", "warn",
            f"remat={pol!r} on a forward-only graph — nothing "
            f"differentiates, so there is no backward pass to "
            f"rematerialize into (remat is a silent no-op here)",
            site_node)
    elif anchor_node is None:
        yield Diagnostic(
            "remat-policy", "warn",
            f"remat={pol!r} on a graph with NO recomputable segment — "
            f"no matmul-family/attention anchors to segment at, so the "
            f"policy frees (almost) nothing and 'full'/'auto' build an "
            f"empty plan", site_node)
    if pol == "auto":
        budget, _src = remat_mod.resolve_budget()
        if budget is None:
            yield Diagnostic(
                "remat-policy", "warn",
                "remat='auto' with no resolvable HBM budget — "
                "HETU_HBM_BUDGET_MB is unset and this device reports no "
                "memory limit, so auto remats EVERY segment (acts like "
                "'full'); set HETU_HBM_BUDGET_MB to get the budget-fitted "
                "plan", site_node)


#: a serving fetch set reaching these is wrong (an update) or suspect
#: (a dropout: inert under training=False, but a sign of a training head)
_TRAIN_ONLY_ERRORS = {"OptimizerUpdate"}
_TRAIN_ONLY_WARNS = {"Dropout", "Dropout2d"}


@rule("train-only-op-in-serving")
def _r_train_only_serving(gi):
    """Serving graphs never build gradient or optimizer nodes."""
    if not gi.serving:
        return
    for node in gi.topo:
        if isinstance(node, GradientOp):
            yield Diagnostic(
                "train-only-op-in-serving", "error",
                f"gradient node '{node.name}' (w.r.t. "
                f"'{getattr(node.wrt, 'name', node.wrt)}') is reachable "
                f"from a serving fetch set — serving must never build a "
                f"backward pass; fetch the model's inference output "
                f"instead", node)
        elif node.op_type in _TRAIN_ONLY_ERRORS:
            yield Diagnostic(
                "train-only-op-in-serving", "error",
                f"{node.op_type} '{node.name}' is reachable from a "
                f"serving fetch set — a weight update inside the request "
                f"path would train the serving replica; drop the "
                f"optimizer from the serving fetches", node)
        elif node.op_type in _TRAIN_ONLY_WARNS:
            yield Diagnostic(
                "train-only-op-in-serving", "warn",
                f"{node.op_type} '{node.name}' is reachable from a "
                f"serving fetch set — it lowers to identity under "
                f"training=False, but a dropout in an inference graph "
                f"usually means the fetch set came from a training head",
                node)


#: full-sequence attention: a one-token decode step would attend over the
#: one token it is handed
_DECODE_INCOMPATIBLE_SEQ = {
    "ScaledDotProductAttention",
    "ScaledDotProductAttentionMasked",
    "ScaledDotProductAttentionBias",
    "ScaledDotProductAttentionMaskedBias",
    "ScaledDotProductAttentionVarlen",
}
#: batch-coupled statistics: under continuous batching their output
#: depends on which sequences share the step
_DECODE_INCOMPATIBLE_STATE = {"BatchNorm"}


@rule("decode-incompatible-op")
def _r_decode_incompatible(gi):
    """A decode step graph must run one token at a time."""
    if not gi.decode:
        return
    for node in gi.topo:
        if node.op_type in _DECODE_INCOMPATIBLE_SEQ:
            yield Diagnostic(
                "decode-incompatible-op", "error",
                f"{node.op_type} '{node.name}' consumes the full "
                f"sequence axis in one shot — an incremental decode "
                f"step sees ONE token per call and would silently "
                f"attend over nothing; use sdpa_decode_op over a KV "
                f"cache maintained by kv_cache_append_op instead", node)
        elif node.op_type in _DECODE_INCOMPATIBLE_STATE:
            yield Diagnostic(
                "decode-incompatible-op", "error",
                f"{node.op_type} '{node.name}' computes batch-coupled "
                f"statistics — under continuous batching the batch "
                f"composition changes every token, so its output would "
                f"depend on which sequences share the step (the "
                f"bitwise-stability guarantee cannot hold); use "
                f"LayerNorm (per-row statistics) instead", node)


# ----------------------------------------------------------------- entry

def lint(fetches, feeds=None, training=True, rules=None, zero=0,
         serving=False, remat="off", decode=False, dp=None):
    """Statically verify a fetch subgraph; returns a :class:`LintReport`.

    ``feeds``: example values (or bare shapes) for placeholders declared
    without a shape, e.g. ``lint([loss], feeds={x: (32, 784)})``.
    ``zero`` / ``remat`` / ``dp`` (the data-parallel group's size): the
    executor's settings (the zero-sharding and remat-policy rules).
    ``serving=True``: a serving fetch set (the train-only-op-in-serving
    rule; pair with ``training=False``).  ``decode=True``: a one-token
    decode step (the decode-incompatible-op rule).  ``rules``: the rule
    names to run (default all)."""
    if isinstance(fetches, Op):
        fetches = [fetches]
    shapes = infer_graph(fetches, feeds=feeds, training=training)
    feed_values = {}
    if feeds:
        by_name = {n.name: n for n in shapes.topo
                   if isinstance(n, PlaceholderOp)}
        for k, v in feeds.items():
            node = by_name.get(k) if isinstance(k, str) else k
            if node is not None and hasattr(v, "dtype") \
                    and hasattr(v, "shape"):
                feed_values[node] = v
    gi = GraphInfo(shapes, _normalize_feeds(feeds, shapes.topo),
                   feed_values=feed_values, zero=zero, serving=serving,
                   remat=remat, decode=decode, dp=dp)
    diags = []
    selected = RULES if rules is None else {
        name: RULES[name] for name in rules}
    for name, fn in selected.items():
        try:
            diags.extend(fn(gi))
        except Exception as e:
            # a crashed rule must not take the report down
            diags.append(Diagnostic(
                name, "warn",
                f"lint rule crashed: {type(e).__name__}: {e} — "
                f"report it; the rule was skipped", internal=True))
    return LintReport(shapes, diags)
