"""Graph evaluation and the training executor (twin of
``hetu_tpu/graph/executor.py``, core only).

``lower_forward`` evaluates a topologically sorted subgraph eagerly:
each node's ``lower`` runs on its inputs' tensors as soon as they exist.

``Executor`` owns the variables of one or more fetch subgraphs
(``{name: fetches}``) and runs a subgraph per :meth:`Executor.run`:
feeds go to the device (a ``DataloaderOp`` leaf that the feed dict does
not hold takes its loader's next batch for the subgraph's name, so a
dataloader-fed graph trains with ``run(name)``), the forward runs through ``lower_forward``,
gradient markers (``GradientOp``) resolve through ``torch.autograd.grad``
of the loss with respect to the trainable variables, and each
``OptimizerOp`` applies its optimizer's pure update under
``torch.no_grad()``.  PyTorch runs eagerly: the step is this sequence of
kernel launches, with no whole-step capture.

PS embeddings (``ps_embedding_lookup_op``) take part as LEAVES: before
the forward, a host-mode table's rows are pulled on the host and placed
on the device; a device-resident cache (``DistCacheTable(device=True)``)
plans its lookup on the host, runs the store round trip (pending pushes
and the miss pull) on a one-worker feed thread while the dense feeds are
placed, commits and fills the slab, and gathers the batch's rows on the
card (kernel B4).  Each PS value is differentiated with the trainable
variables; after the step a host table's row gradient goes back through
``push`` and a device table's is first summed per unique key on the
card (sort + kernel B5) and committed with ``apply_update_summed``.
The ids come from the feed dict or from a ``DataloaderOp`` (its loader's
next batch for the subgraph).

The PS plane around the step (the JAX package's): ``bsp=0`` (BSP, the
default) pushes at the step's end; ``bsp=-1`` (ASP) pushes on a
one-worker pool with at most 32 pushes in flight, the ids captured when
queued, a failed push raised at the next step, and ``ps_flush`` drains
them; ``bsp=k > 0`` (SSP) ticks each store's clock after the push and
waits, under ``ssp_timeout_ms``, until this worker is within k clocks of
the slowest (a store without ``ssp_init`` is skipped).  ``prefetch``
(default True) pulls the next batch's rows of a host table whose ids
come from a ``DataloaderOp`` on a background thread, after the push
under BSP / SSP (not at all over a ``DistributedStore``, whose other
workers' pushes of the step it would miss) and before it under ASP; the
next step takes them when its ids match.  A device cache trains under
BSP only.

Mixed precision (``compute_dtype="bfloat16"``, the JAX package's
``_cast_tree`` discipline): inside the step every float32 variable,
trainable or not, and every float32 feed is cast to bfloat16; a
trainable variable is cast inside the differentiated function, so its
gradient reaches the float32 master as float32.  Feeds first take their
placeholder's declared dtype, so integer ids, labels and masks are never
rounded.  Fetched values and state updates leave the step as float32;
the optimizer's state and update stay float32, on the masters.  The MoE
sparse dispatch keeps the JAX package's dtypes (bf16 expert buffers,
float32 gate weights and combine output), so its row gather runs in both
dtypes within one step.  A PS embedding's rows stay float32 leaves and
are cast inside the differentiated function, as the JAX package casts
them: their gradient reaches the push and the device cache's segment sum
(B5) as float32, and the slab, its gather (B4) and the store stay
float32.

Data parallelism (``dist_strategy=DataParallel()``, over the
``torch.distributed`` group the caller initialised): the JAX package runs
the single-device program on the global batch under GSPMD, and so does
each rank here, on its rows.  Every rank is fed the global batch (or a
``Dataloader`` already cut to its shard) and keeps its contiguous block of
rows of every fed value with ndim > 0 (dim 0 must divide by dp); 0-d feeds
and variables are replicated, the variables from rank 0's values by one
broadcast at construction.  The forward lowers every node with a sharded
input by its op type's rule (``parallel/batch_axis.py``), so the loss, a
masked mean and BatchNorm's statistics are reductions over the global
batch; the gradients are averaged over the group in flattened buckets
after ``torch.autograd.grad``; a replicated fetch is returned as is, a
sharded one gathered to the global batch, so every rank returns what the
single-device run returns.  Rank r > 0 draws its dropout masks from
``(seed, step, r)``.

Mixed precision composes with the strategy: the casts into and out of
bf16 run inside each rank's step, the gradients reach the float32 masters
as float32 and are averaged (or reduce-scattered) in float32.

ZeRO (``zero=`` 1..3, else ``HETU_ZERO``, else ``DataParallel(zero=)``;
``parallel/zero.py``): with a strategy over two ranks or more, each
``OptimizerOp`` whose parameters are all float gets a plan of flat
buckets, and each rank keeps only its row of every bucket's optimizer
state (born in rows) and updates only that row.  Stage 1 slices the
averaged gradients, stages 2 and 3 reduce-scatter each bucket's gradient
slab; stages 1 and 2 all-gather the updated rows into full parameters
after the update, stage 3 keeps the rows as the masters between steps
(``var_values`` holds :class:`_ZeroView` stand-ins) and all-gathers them
at the top of the next step, before the forward.  A stand-in gathers its
bucket on demand (an eval subgraph, ``return_tensor_values``), and
``load_dict`` writes through to the rows a bucket at a time: collectives,
so every rank makes the same calls.  A fetched ``GradientOp`` is the full
averaged gradient at every stage.  At world size 1, or without a
strategy, ``zero=`` is the plain step.

Learning rates: each update reads its optimizer's ``step_lr(step)`` (a
number, or an ``LRScheduler``'s float32 value at the step counter), and
every optimizer's ``on_step`` runs after each training step.

The run surface (the JAX executor's): ``validate='warn'|'error'|'off'``
(default ``'warn'``) lints every subgraph at construction
(``analysis.lint`` on meta tensors: nothing launches) and checks fed
shapes once per run plan; each step replays its subgraph's cached
:class:`~hetu_tpu_torch.graph.run_plan.RunPlan` (placement closures, the
validation verdict, the dataloader double buffer); ``run(sync=False)``
keeps a window of ``HETU_ASYNC_WINDOW`` (default 4) steps in flight, a
CUDA event recorded after each, the oldest synchronized once the window
is full; ``run_steps(feeder, n)`` places step i+1's feeds on a
one-worker thread (on the card: pinned memory, a side stream, an event
the compute stream waits on) while step i runs; ``timing=True`` records
each run's wall time, blocking on its fetches (``timer_logs``,
``logOut``, ``clearTimer``); ``matmul_precision=`` sets
``torch.set_float32_matmul_precision`` (and cuDNN's TF32 switch) for the
step only.  The forced sync points of non-blocking stepping (a numpy
conversion, the PS push boundary, a save, a resume, ``ps_flush``, the
window) are counted in ``metrics.run_plan_counts()['async_sync_points']``.

Gradient accumulation (``num_microbatches=M``, the JAX package's
``_microbatched_grads``): the batch feeds split into M blocks, one
forward and backward a block, the gradients summed and divided by M, the
state updates threaded from block to block; M = 1 is the plain step.
Rematerialization (``remat=``): ``parallel/remat.py``.  Checkpoints in
the ``hetu_tpu.ckpt.v1`` format, auto-save, ``resume`` and the
preemption save: ``graph/checkpoint.py``.

``HETU_PS_REREPLICATE_EVERY`` steps (0, off, by default): each
replicated ``DistributedStore`` under the graphs' PS embeddings tries to
restore a failed-over shard's backup (``maybe_re_replicate``).

Not ported, refused by name: a strategy other than ``DataParallel``,
``mesh``, PS embeddings together with ``dist_strategy``, ``plan``,
``pipeline``, ``num_microbatches`` and ``remat`` under ``dist_strategy``,
``num_microbatches`` with PS embeddings, a ``compute_dtype`` other than
bfloat16, a device cache under ASP / SSP, PS ids from a computed node,
the other JAX-package options, and ``save_orbax`` / ``load_orbax``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import os
import time
import warnings

import numpy as np
import torch

from ..context import resolve_device
from ..ndarray import NDArray, wrap_device
from ..ops.kernels.emb_cache import emb_scatter_add
from ..metrics import record_remat, record_run_plan
from ..optim.optimizer import OptimizerOp
from ..parallel import remat as _remat
from ..parallel import zero as _zero
from ..parallel.batch_axis import BatchAxis
from ..parallel.collectives import (all_gather, all_reduce_mean_buckets,
                                    broadcast)
from ..parallel.strategies import DataParallel
from .checkpoint import CheckpointMixin
from .gradients import GradientOp
from .node import (LowerCtx, Op, PlaceholderOp, checkpoint_names,
                   format_site, topo_sort)
from .run_plan import PlanCache, feed_pipeline_enabled, pipeline_min_us


def lower_forward(topo, ctx, resolve_leaf, keep=None, remat_segments=None,
                  offload=None):
    """Evaluate every node of ``topo`` into an environment
    ``{node: tensor}``; placeholders resolve through ``resolve_leaf(node)``.
    Under data parallelism (``ctx.batch_axis``) a node with a
    batch-sharded input lowers by its op type's rule.

    ``keep`` (a training step): each value is dropped after its last
    consumer unless it is in ``keep``, so the returned environment holds
    only ``keep`` and no activation outlives the forward but what autograd
    saved.  ``remat_segments`` (``remat='full'``): node lists, contiguous
    in topo order, each lowered inside its own checkpoint
    (``parallel/remat.py``), only its boundary values (consumed outside
    it, or in ``keep``) entering the environment.  ``offload``
    (``remat='offload'``): a :class:`~hetu_tpu_torch.parallel.remat.
    ProductOffload` that is told of every product's output."""
    axis = ctx.batch_axis

    def lower(node, vals):
        out = node.lower(ctx, *vals) if axis is None \
            else axis.lower(node, ctx, vals)
        if offload is not None and node.op_type in _remat.OFFLOAD_OPS:
            offload.note(out)
        return out

    env = {}
    if keep is None:
        for node in topo:
            env[node] = resolve_leaf(node) \
                if isinstance(node, PlaceholderOp) \
                else lower(node, [env[i] for i in node.inputs])
        return env
    keep = set(keep)
    last, consumers = {}, {}
    for i, node in enumerate(topo):
        for x in node.inputs:
            last[x] = i
            consumers.setdefault(x, set()).add(node)
    segments = remat_segments or ()
    seg_of = {n: si for si, seg in enumerate(segments) for n in seg}
    done = set()
    for i, node in enumerate(topo):
        if node not in done:
            done.add(node)
            if isinstance(node, PlaceholderOp):
                env[node] = resolve_leaf(node)
            elif node in seg_of:
                seg = segments[seg_of[node]]
                env.update(_lower_segment(seg, env, done, consumers, keep,
                                          resolve_leaf, lower, ctx))
            else:
                env[node] = lower(node, [env[x] for x in node.inputs])
        for x in node.inputs:
            if last[x] == i and x not in keep:
                env.pop(x, None)
        if node not in last and node not in keep:
            env.pop(node, None)
    return env


def _lower_segment(seg, env, done, consumers, keep, resolve_leaf, lower,
                   ctx):
    """One ``remat='full'`` segment under its checkpoint: ``{node: value}``
    of its boundary values.  A placeholder that topo order puts inside
    the segment's span is resolved first."""
    segset = set(seg)
    ext = []
    for n in seg:
        for x in n.inputs:
            if x not in env and isinstance(x, PlaceholderOp):
                env[x] = resolve_leaf(x)
                done.add(x)
            if x not in segset and x not in ext:
                ext.append(x)
    outs = [n for n in seg if n in keep or not consumers.get(n)
            or any(c not in segset for c in consumers[n])]

    def seg_fn(*ins):
        e = dict(zip(ext, ins))
        for n in seg:
            e[n] = lower(n, [e[x] for x in n.inputs])
        return tuple(e[o] for o in outs)

    vals = _remat.checkpointed(seg_fn, ctx.generator,
                               *[env[x] for x in ext])
    done.update(seg)
    return dict(zip(outs, vals))


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype))).dtype


def _compute_dtype(cd):
    """``Executor(compute_dtype=)``: None, or bfloat16 by name or dtype."""
    if cd is None:
        return None
    if cd is torch.bfloat16 or (isinstance(cd, str) and cd == "bfloat16"):
        return torch.bfloat16
    raise NotImplementedError(
        f"Executor(compute_dtype={cd!r}) is not ported: the port trains in "
        f"float32 or, with compute_dtype='bfloat16', in bfloat16 mixed "
        f"precision")


def _step_generator(device, seed, step, rank=0, micro=None):
    """The ``torch.Generator`` of one step: seeded from ``(seed, step)``
    on the executor's device, so dropout masks depend on nothing else; a
    data-parallel rank r > 0 from ``(seed, step, r)``, so ranks do not
    repeat one mask (rank 0 draws the single-device masks); microbatch i
    of an accumulated step from ``(seed, step, rank, i)``."""
    entropy = [int(seed), int(step)] \
        + ([int(rank)] if rank or micro is not None else []) \
        + ([int(micro)] if micro is not None else [])
    state = np.random.SeedSequence(entropy).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


#: ``matmul_precision=`` names (the JAX package's) -> the
#: ``torch.set_float32_matmul_precision`` setting of the step
MATMUL_PRECISIONS = {"bfloat16": "medium", "fastest": "medium",
                     "default": "medium", "tensorfloat32": "high",
                     "high": "high", "float32": "highest",
                     "highest": "highest"}


@contextlib.contextmanager
def _precision(level):
    """The step's float32 product precision: ``level`` set on entry (cuDNN's
    TF32 switch on at ``'high'`` and below), the process's previous
    settings restored on exit."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision(level)
    torch.backends.cudnn.allow_tf32 = level != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


class _StepMark:
    """One in-flight step of ``run(sync=False)``: a CUDA event recorded on
    the compute stream after the step, or, on the CPU (where a step is
    done when ``run`` returns), nothing to wait for."""

    __slots__ = ("event",)

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def synchronize(self):
        if self.event is not None:
            self.event.synchronize()


def _sync_outs(outs):
    """Block until the fetched tensors are computed (the timer's rule)."""
    devs = {o.torch().device for o in outs or ()
            if isinstance(o, NDArray) and o.torch().is_cuda}
    for dev in devs:
        _StepMark(dev).synchronize()


class _ZeroView:
    """``Executor.var_values`` stand-in for a stage-3 ZeRO parameter: its
    master values live in the ranks' rows of a bucket
    (``Executor._zero_rows``), so no full copy exists between steps.
    ``materialize()`` gathers the bucket (a collective) and returns the
    full tensor."""

    __slots__ = ("ex", "node", "bucket")

    def __init__(self, ex, node, bucket):
        self.ex = ex
        self.node = node
        self.bucket = bucket

    @property
    def shape(self):
        b = self.bucket
        return b.shapes[b.param_keys.index(self.ex._k(self.node))]

    def materialize(self):
        return self.ex._zero_gather([self.node], count=False)[self.node]

    def __repr__(self):
        return (f"<ZeroView of '{self.node.name}' shape={self.shape} "
                f"in bucket {self.bucket.key}>")


class SubExecutor:
    """One fetch list → one step function."""

    def __init__(self, name, fetches, executor):
        self.name = name
        self.fetches = list(fetches)
        self.ex = executor
        self.topo = topo_sort([f for f in self.fetches if f is not None])
        self.opt_ops = [n for n in self.topo if isinstance(n, OptimizerOp)]
        self.grad_ops = [n for n in self.topo if isinstance(n, GradientOp)]
        # training iff the subgraph differentiates or is literally 'train'
        self.training = bool(self.opt_ops or self.grad_ops) \
            or name == "train"
        self.fwd_topo = [n for n in self.topo
                         if not isinstance(n, (GradientOp, OptimizerOp))]
        # PS embedding leaves: pulled (or gathered) before the step, their
        # row gradient pushed after it; the ids placeholder is no feed
        # node of the subgraph (the lookup has no inputs) and is read from
        # the feed dict
        self.ps_nodes = [n for n in self.topo if getattr(n, "is_ps", False)]
        for n in self.ps_nodes:
            idn = n.ids_node
            if not isinstance(idn, PlaceholderOp) or idn.is_variable:
                raise NotImplementedError(
                    f"PS embedding {n}: ids from {idn} (a computed node) "
                    f"are not ported; feed an ids placeholder or a "
                    f"DataloaderOp")
            if n.device_mode and n.cache.slab_device.type != \
                    executor.device.type:
                raise ValueError(
                    f"PS embedding {n}: the cache slab is on "
                    f"{n.cache.slab_device}, the executor on "
                    f"{executor.device}")
        self._ps_dev_items = [n for n in self.ps_nodes if n.device_mode]
        self._ps_host_items = [n for n in self.ps_nodes
                               if not n.device_mode]
        #: node -> the step's committed _DevLookup (read by _ps_post_step)
        self._dev_live = {}
        #: node -> (ids, Future[rows]): lookahead pulls in flight
        self._prefetched = {}
        self._prefetch_pool = None
        self._feed_pool = None
        #: feed schema -> RunPlan, built at the first run
        self._plan_cache = None
        self.feed_nodes = [n for n in self.topo
                           if isinstance(n, PlaceholderOp)
                           and not n.is_variable
                           and not getattr(n, "is_ps", False)]
        # fed from their loaders when the feed dict does not hold them
        from ..data.dataloader import DataloaderOp
        self.dataloader_nodes = [n for n in self.feed_nodes
                                 if isinstance(n, DataloaderOp)]
        self._feed_node_set = frozenset(self.feed_nodes)
        self.trainable_vars = sorted({g.wrt for g in self.grad_ops},
                                     key=lambda n: n.id)
        for v in self.trainable_vars:
            if not (isinstance(v, PlaceholderOp) and v.is_variable):
                raise ValueError(
                    f"gradient w.r.t. non-variable {v} unsupported")
        losses = {g.loss for g in self.grad_ops}
        if len(losses) > 1:
            raise ValueError("multiple distinct losses in one subgraph")
        self.loss_node = next(iter(losses)) if losses else None
        #: the variables the subgraph reads
        self.var_nodes = [n for n in self.topo
                          if isinstance(n, PlaceholderOp) and n.is_variable]
        #: parameters whose gradient slabs are reduce-scattered (ZeRO
        #: stages 2 and 3), not all-reduced
        self._scattered = {p for op in self.opt_ops
                           for p in op.params
                           if executor._zero_plans.get(op) is not None
                           and executor._zero_plans[op].stage >= 2}
        self._grad_fetched = {f.wrt for f in self.fetches
                              if isinstance(f, GradientOp)}
        #: dataloaders that already hold this rank's shard
        self._shard_loaders = set()
        if executor.dp is not None:
            self._check_dp(name)
        #: the values a training step keeps past the forward
        self._keep = [f for f in self.fetches
                      if f is not None
                      and not isinstance(f, (GradientOp, OptimizerOp))]
        if self.loss_node is not None:
            self._keep.append(self.loss_node)
        # which fetches consume a feed (transitively): how an accumulated
        # step merges its microbatches' values
        feed_set = set(self.feed_nodes)
        deps = {}
        for node in self.topo:
            deps[node] = node in feed_set or any(deps.get(i, False)
                                                 for i in node.inputs)
        self.fetch_depends_feed = [f is not None and deps.get(f, False)
                                   for f in self.fetches]
        if self.ps_nodes and self.grad_ops \
                and (executor.num_microbatches or 1) > 1:
            raise NotImplementedError(
                f"Executor(num_microbatches=) with PS embedding "
                f"{self.ps_nodes[0]} in subgraph {name!r}: the rows are "
                f"pulled for the whole batch")
        self._remat_plan = _remat.plan_for(self)

    def _check_dp(self, name):
        """Data parallelism: no PS embeddings; each dataloader either
        holds the whole dataset (``dp_nrank=1``: its batches are split
        like feeds) or exactly this rank's shard."""
        if self.ps_nodes:
            raise NotImplementedError(
                f"Executor(dist_strategy=...) with PS embedding "
                f"{self.ps_nodes[0]} in subgraph {name!r} is not ported")
        _, size, rank = self.ex.dp
        for node in self.dataloader_nodes:
            dl = node.dataloaders.get(name)
            if dl is None or dl.dp_nrank == 1:
                continue
            if (dl.dp_nrank, dl.dp_rank) != (size, rank):
                raise ValueError(
                    f"{node}: its dataloader {name!r} holds shard "
                    f"{dl.dp_rank} of {dl.dp_nrank}; rank {rank} of a "
                    f"data-parallel group of {size} takes dp_nrank=1 or "
                    f"its own shard")
            self._shard_loaders.add(node)

    def _low(self, t):
        """A float32 value in the compute dtype (the mixed-precision cast
        into the step); anything else unchanged."""
        cd = self.ex.compute_dtype
        if cd is not None and t is not None and t.dtype == torch.float32:
            return t.to(cd)
        return t

    def _high(self, t):
        """A compute-dtype value back in float32 (fetches and state
        updates leave the step as float32)."""
        cd = self.ex.compute_dtype
        if cd is not None and t.dtype == cd:
            return t.float()
        return t

    def run(self, feed_dict, convert_to_numpy_ret_vals=False, sync=True):
        ex = self.ex
        # a device cache's store round trip starts first, on the feed
        # thread, and overlaps the feed placement below
        dev_pending = self._begin_dev_lookups(feed_dict) \
            if self._ps_dev_items else None
        ps_vals, invs = {}, {}
        axis = None if ex.dp is None else BatchAxis(*ex.dp)
        try:
            # the feed schema's cached plan: placement closures, the
            # validation verdict, the dataloader double buffer
            if self._plan_cache is None:
                self._plan_cache = PlanCache(self)
            plan = self._plan_cache.lookup(feed_dict)
            feeds = {}
            for node, t in plan.place_feeds(feed_dict).items():
                feeds[node] = self._low(t)
                if axis is not None and t.ndim:
                    axis.sharded.add(node)
            for node in self._ps_host_items:
                ps_vals[node] = ex._place_feed(
                    node, self._host_rows(node, feed_dict, feeds))
            if dev_pending is not None:
                self._finish_dev_lookups(dev_pending, ps_vals, invs)
        except BaseException:
            if dev_pending is not None:
                self._settle_dev_pending(dev_pending)
            raise
        ctx = LowerCtx(self.training,
                       _step_generator(ex.device, ex.seed, ex.step_counter,
                                       0 if axis is None else axis.rank),
                       axis)
        grads, ps_grads = {}, {}
        # stage-3 ZeRO: the full parameters of this step, gathered from
        # the ranks' rows at its top, before the forward
        live = ex._zero_gather(self.var_nodes) if ex._zero_covered else {}

        def var(node):
            v = live.get(node)
            return ex.var_values[node] if v is None else v

        updates = ctx.state_updates
        if self.grad_ops:
            if (ex.num_microbatches or 1) > 1:
                env, grads, updates = self._accumulate(feeds, var)
            else:
                env, grads, ps_grads = self._value_and_grad(
                    feeds, ps_vals, var, ctx)
            with torch.no_grad():
                rest = [v for v in grads if v not in self._scattered]
                if axis is not None and rest:
                    grads.update(zip(rest, all_reduce_mean_buckets(
                        [grads[v] for v in rest], axis.group)))
                for node in self._ps_dev_items:
                    g = ps_grads[node]
                    ps_grads[node] = emb_scatter_add(
                        g.reshape(-1, g.shape[-1]), invs[node])
                for op in self.opt_ops:
                    keys = [ex._k(v) for v in op.params]
                    sub_g = {k: grads[v] for k, v in zip(keys, op.params)}
                    lr = op.optimizer.step_lr(ex.step_counter)
                    if op in ex._zero_plans:
                        ex._zero_update(op, sub_g, grads,
                                        self._grad_fetched, lr)
                        continue
                    sub_p = {k: ex.var_values[v]
                             for k, v in zip(keys, op.params)}
                    new_p, ex.opt_states[op] = op.optimizer.apply(
                        sub_p, sub_g, ex.opt_states[op], lr)
                    for k, v in zip(keys, op.params):
                        ex.var_values[v] = new_p[k]
        else:
            with torch.no_grad():
                env = lower_forward(
                    self.fwd_topo, ctx,
                    lambda n: feeds[n] if n in feeds
                    else self._low(ps_vals[n]) if n in ps_vals
                    else self._low(var(n)))
        for node, val in updates.items():
            ex.var_values[node] = self._high(val.detach())
        # the step is enqueued: step N+1's dataloader batches go to the
        # device now, overlapping its device work
        plan.start_feed_prefetch()
        if self.ps_nodes:
            self._ps_post_step(ps_grads)
            if not sync:
                # the push boundary reads the row gradient on the host
                record_run_plan("async_sync_points")
        if self.training:
            ex.step_counter += 1
            for op in self.opt_ops:
                op.optimizer.on_step(ex.step_counter)

        outs = []
        for f in self.fetches:
            if f is None or isinstance(f, OptimizerOp):
                outs.append(None)
            elif isinstance(f, GradientOp):
                outs.append(grads[f.wrt])
            elif axis is not None and f in axis.sharded:
                outs.append(all_gather(self._high(env[f].detach()),
                                       axis.group))
            else:
                outs.append(self._high(env[f].detach()))
        if convert_to_numpy_ret_vals:
            if not sync:
                # the conversion waits for the step: a sync point
                record_run_plan("async_sync_points")
            return [None if v is None else v.cpu().numpy() for v in outs]
        return [None if v is None else wrap_device(v) for v in outs]

    # -- the differentiated forward ---------------------------------------------

    def _forward(self, ctx, resolve):
        """The training forward under the executor's ``remat`` policy;
        returns the environment of ``self._keep``."""
        ex, keep = self.ex, self._keep
        if self._remat_plan is not None:
            return lower_forward(self.fwd_topo, ctx, resolve, keep=keep,
                                 remat_segments=self._remat_plan
                                 .remat_node_lists())
        if ex.remat == "offload" and ex._offload_ok:
            off = _remat.ProductOffload()
            with off.hooks():
                env = lower_forward(self.fwd_topo, ctx, resolve, keep=keep,
                                    offload=off)
            record_remat("remat_offload_bytes", off.bytes)
            return env
        if ex.remat in ("dots", "offload"):
            return _remat.checkpointed(
                lambda: lower_forward(self.fwd_topo, ctx, resolve,
                                      keep=keep),
                ctx.generator, dots=True)
        return lower_forward(self.fwd_topo, ctx, resolve, keep=keep)

    def _value_and_grad(self, feeds, ps_vals, var, ctx):
        """``(env, grads, ps_grads)`` of one forward and backward:
        ``torch.autograd.grad`` of the loss with respect to the trainable
        variables and the PS leaves."""
        leaves = {v: var(v).detach().requires_grad_(True)
                  for v in self.trainable_vars}
        leaves.update({n: v.detach().requires_grad_(True)
                       for n, v in ps_vals.items()})
        wrt = self.trainable_vars + self.ps_nodes

        def resolve(node):
            if node in feeds:
                return feeds[node]
            # the cast of a trainable variable, or of a PS embedding's
            # float32 rows, is differentiated through: the gradient
            # reaches the master, or the row push and B5, as float32
            return self._low(leaves[node] if node in leaves else var(node))

        with torch.enable_grad():
            env = self._forward(ctx, resolve)
            got = torch.autograd.grad(
                env[self.loss_node], [leaves[v] for v in wrt],
                allow_unused=True)
        got = {v: torch.zeros_like(leaves[v]) if g is None else g
               for v, g in zip(wrt, got)}
        return (env, {v: got[v] for v in self.trainable_vars},
                {n: got[n] for n in self.ps_nodes})

    def _accumulate(self, feeds, var):
        """``num_microbatches`` M > 1 (the JAX package's
        ``_microbatched_grads``): the batch feeds split into M blocks
        along dim 0, the other feeds whole to each; one forward and
        backward a block, its dropout from the (step, block) generator;
        state updates threaded from block to block; the gradients summed
        and divided by M once.  Returns ``(env, grads, state updates)``,
        the fetches merged as the JAX package merges them."""
        ex = self.ex
        M = ex.num_microbatches
        explicit = ex.microbatch_feeds
        names = {ex._k(n) if isinstance(n, Op) else n
                 for n in explicit or ()}
        cand = [v.shape[0] for n, v in feeds.items()
                if v.ndim and (not explicit or ex._k(n) in names)]
        counts = collections.Counter(cand)
        B = max(counts, key=lambda d: (counts[d], d)) if counts else 0
        if B % M:
            raise ValueError(
                f"batch {B} not divisible into {M} microbatches")
        split = {n for n, v in feeds.items()
                 if v.ndim and v.shape[0] == B
                 and (not explicit or ex._k(n) in names)}
        if not split:
            raise ValueError("num_microbatches needs at least one "
                             "batch-shaped feed")
        mb = B // M
        acc = {v: torch.zeros_like(var(v)) for v in self.trainable_vars}
        threaded, per_block = {}, []
        for i in range(M):
            fd = {n: v[i * mb:(i + 1) * mb] if n in split else v
                  for n, v in feeds.items()}
            ctx = LowerCtx(True, _step_generator(
                ex.device, ex.seed, ex.step_counter, micro=i))
            env, g, _ = self._value_and_grad(
                fd, {}, lambda n: threaded[n] if n in threaded else var(n),
                ctx)
            for v in acc:
                acc[v] = acc[v] + g[v]
            threaded.update((n, t.detach())
                            for n, t in ctx.state_updates.items())
            per_block.append([env[f].detach() if f in env else None
                              for f in self.fetches])
        grads = {v: a / M for v, a in acc.items()}
        merged = {}
        for j, (f, dep) in enumerate(zip(self.fetches,
                                         self.fetch_depends_feed)):
            if f is None or f not in self._keep:
                continue
            a = torch.stack([blk[j] for blk in per_block])
            if a.ndim <= 1:
                merged[f] = a.mean(0)
            elif dep:
                merged[f] = a.reshape((-1,) + a.shape[2:]) \
                    if mb and a.shape[1] % mb == 0 else a.mean(0)
            else:
                merged[f] = a[-1]
        return merged, grads, threaded

    # -- PS embeddings ----------------------------------------------------------

    def _ps_ids(self, node, feed_dict, feeds=None, peek=False):
        """The ids batch of a PS lookup: from the feed dict, else from its
        ``DataloaderOp`` — the value the run plan placed when the loader
        also feeds the graph (``feeds``), the loader's next batch peeked
        when the plan has yet to take it (``peek``), else taken here."""
        from ..data.dataloader import DataloaderOp
        idn = node.ids_node
        if idn in feed_dict:
            return np.asarray(feed_dict[idn], np.int64)
        if isinstance(idn, DataloaderOp):
            if feeds is not None and idn in feeds:
                return feeds[idn].cpu().numpy().astype(np.int64)
            if idn in self._feed_node_set:
                if peek:
                    return np.asarray(idn.get_next_arr(self.name), np.int64)
            else:
                return np.asarray(idn.get_arr(self.name), np.int64)
        raise ValueError(f"missing ids feed {idn} for PS embedding {node}")

    def _host_rows(self, node, feed_dict, feeds):
        """A host table's rows for this step: the lookahead pull issued at
        the end of the previous run when its ids match, else a pull."""
        ids = self._ps_ids(node, feed_dict, feeds)
        pre = self._prefetched.pop(node, None)
        # compare the ids before joining: a mismatched prefetch would cost
        # a whole pull wait only to be dropped
        if pre is not None and np.array_equal(pre[0], ids):
            rows = pre[1].result()
            node._last_ids = pre[0]
            return rows
        return node.pull(ids)

    def _ensure_feed_pool(self):
        """The subgraph's one feed worker, shared by the dataloader double
        buffer (``RunPlan.start_feed_prefetch``) and the device cache's
        store round trip."""
        if self._feed_pool is None:
            self._feed_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"feed-pipeline-{self.name}")
        return self._feed_pool

    def _begin_dev_lookups(self, feed_dict):
        """Phase 1 of a device-cache step: each table's plan
        (``begin_lookup``, which takes the cache lock), then its store
        round trip on the feed thread.  Returns the pending handles."""
        if self.ex.bsp != 0:
            raise NotImplementedError(
                "device-resident embedding caches support BSP training "
                "(bsp=0): ASP / SSP need the host-mode cache "
                "(DistCacheTable(device=False))")
        pool = self._ensure_feed_pool()
        pending = []
        try:
            for node in self._ps_dev_items:
                ids = self._ps_ids(node, feed_dict, peek=True)
                h = node.cache.begin_lookup(ids)
                pending.append((node, ids, h, pool.submit(h.roundtrip)))
        except BaseException:
            self._settle_dev_pending(pending)
            raise
        return pending

    def _finish_dev_lookups(self, pending, ps_vals, invs):
        """Phase 3: join the round trip, commit the plan (host bookkeeping
        and the in-place slab fill), gather the batch's rows on the card
        as the node's leaf value, and keep the unique-inverse map for the
        gradient's scatter-add."""
        for node, ids, h, fut in pending:
            try:
                rows = fut.result()
            except BaseException:
                node.cache.abort_lookup(h)
                raise
            cache = node.cache
            # RLock depth 2 across commit + gather (finish_lookup's release
            # drops to 1): no other lookup on this table may evict a slot
            # of this batch and fill another key's row into it in between
            cache._lock.acquire()
            try:
                cache.finish_lookup(h, rows)
                g = cache.gather(h)
            finally:
                cache._lock.release()
            ps_vals[node] = g.reshape(tuple(ids.shape) + (cache.width,))
            inv = h.inv if h.flat.size else np.zeros(0, np.int64)
            invs[node] = torch.from_numpy(inv.astype(np.int32)).to(
                self.ex.device)
            self._dev_live[node] = h

    def _settle_dev_pending(self, pending):
        """Failure path: every handle not yet committed releases its lock.
        A round trip that succeeded is committed (its pushes reached the
        store; dropping the plan would push them again later); a failed
        or unread one is aborted with the cache untouched."""
        for node, _ids, h, fut in pending:
            if h.done:
                continue
            try:
                rows = fut.result()
            except BaseException:
                node.cache.abort_lookup(h)
                continue
            try:
                node.cache.finish_lookup(h, rows)
            except BaseException:
                node.cache.abort_lookup(h)

    def _ps_post_step(self, ps_grads):
        """The PS plane after the step: the push (inline, or on the ASP
        worker), the SSP clock tick and wait, and the next batch's
        lookahead pull.  A device table commits its U summed rows (their
        copy to the host is the step's sync point); a host table pushes
        the whole row gradient through its cache or store."""
        ex = self.ex
        if ex.bsp == -1 and ex.prefetch:
            # ASP: the next pull may overlap the push (bounded staleness
            # allows it)
            self._start_ps_prefetch()
        for node in self.ps_nodes:
            g = ps_grads.get(node)
            if node.device_mode:
                h = self._dev_live.pop(node, None)
                if g is not None and h is not None and h.uk is not None:
                    node.cache.apply_update_summed(
                        h.uk, g[:h.uk.size].cpu().numpy(), h.cnt)
            elif g is not None:
                if ex.bsp == -1:
                    # the copy to the host runs on the worker, too
                    ex._ps_async_push(node, g)
                else:
                    node.push(g.cpu().numpy())
        if ex.bsp > 0 and self.training:
            self._ssp_wait()
        if ex.bsp != -1 and ex.prefetch:
            # BSP / SSP: the lookahead pull must see this step's push
            self._start_ps_prefetch()

    def _ssp_wait(self):
        """SSP (reference ``_compute_ssp_prefetch``): tick each store's
        clock after its push, then block while more than ``bsp`` clocks
        ahead of the slowest worker, under the ``ssp_timeout_ms``
        watchdog.  A store never ``ssp_init``-ed is skipped."""
        ex = self.ex
        seen = set()
        for node in self.ps_nodes:
            store = node.store
            if id(store) in seen or not hasattr(store, "ssp_sync") \
                    or not getattr(store, "ssp_ready", True):
                continue
            seen.add(id(store))
            rank = getattr(store, "rank", 0)
            try:
                store.clock(rank)
            except RuntimeError as e:
                if "not initialised" in str(e):
                    # a distributed store whose clocks were never
                    # ssp_init-ed: bounded staleness is vacuous
                    continue
                raise
            deadline = time.monotonic() + ex.ssp_timeout_ms / 1e3
            # a store whose ssp_sync blocks gets one wait for the budget
            # (never 0 ms, which reads as forever); another is polled
            blocking = getattr(store, "ssp_blocking", False)
            while True:
                left_ms = (deadline - time.monotonic()) * 1e3
                if blocking:
                    ok = left_ms > 0 and store.ssp_sync(
                        rank, ex.bsp, timeout_ms=max(1, int(left_ms)))
                else:
                    ok = store.ssp_sync(rank, ex.bsp, timeout_ms=200)
                if ok:
                    break
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"SSP bound {ex.bsp} not satisfied within "
                        f"{ex.ssp_timeout_ms}ms — a peer worker is stalled "
                        f"or dead")
                if not blocking:
                    time.sleep(0.005)

    def _start_ps_prefetch(self):
        """Issue the next batch's row pulls on a background thread for
        every host table whose ids come from a ``DataloaderOp`` (the one
        source whose next batch is known: ``get_next_arr``); the next run
        takes them when its ids match."""
        from ..data.dataloader import DataloaderOp
        from ..ps.dist_store import DistributedStore
        for node in self.ps_nodes:
            if node in self._prefetched or node.device_mode:
                continue
            if isinstance(node.store, DistributedStore) \
                    and self.ex.bsp != -1:
                # BSP / SSP over several workers: a lookahead issued after
                # only the local push would miss the other workers' pushes
                # of the step
                continue
            idn = node.ids_node
            if not isinstance(idn, DataloaderOp):
                continue
            try:
                next_ids = np.asarray(idn.get_next_arr(self.name), np.int64)
            except KeyError:       # no dataloader for this subgraph
                continue
            if self._prefetch_pool is None:
                self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"ps-prefetch-{self.name}")
            self._prefetched[node] = (
                next_ids, self._prefetch_pool.submit(node.pull_rows,
                                                     next_ids))

    def close(self):
        """Stop the feed and prefetch threads (idempotent)."""
        for attr in ("_feed_pool", "_prefetch_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=True)
                setattr(self, attr, None)


class Executor(CheckpointMixin):
    """Multi-subgraph training executor (see module docstring).

    ``eval_node_dict``: a list of fetches (one subgraph, "default") or
    ``{name: fetch list}``.  ``seed``: variable init and dropout.
    ``device``: where variables live and the step runs — CUDA by default
    (raises without it); the CPU only when asked for.  ``ctx`` (the JAX
    package's context argument) names the device when ``device`` is not
    given.  Float32 products run in full float32 (TF32 off).
    ``compute_dtype``: None (float32) or ``"bfloat16"`` (mixed precision,
    see the module docstring), with or without a strategy.
    ``dist_strategy``: None or a ``DataParallel`` over the initialised
    ``torch.distributed`` world: gloo on the CPU, NCCL on the card, or
    gloo carrying CUDA tensors for two ranks on one card (see the module
    docstring).  ``zero``: the ZeRO stage 0..3 of the weight update under
    the strategy (None: ``HETU_ZERO``, then the strategy's ``zero``).
    ``num_microbatches`` (with ``microbatch_feeds=``): gradient
    accumulation over that many blocks of the batch.  ``remat``: ``'off'``,
    ``'dots'`` (or True), ``'full'`` or ``'offload'``
    (``parallel/remat.py``).  ``auto_save_dir`` / ``auto_save_every`` /
    ``auto_save_keep`` / ``auto_resume`` / ``install_signal_handlers``:
    periodic checkpoints, resume at construction and the SIGTERM / SIGINT
    save (``graph/checkpoint.py``)."""

    def __init__(self, eval_node_dict, ctx=None, seed=None, device=None,
                 dist_strategy=None, mesh=None, pipeline=None,
                 num_microbatches=None, matmul_precision=None, zero=None,
                 **kwargs):
        for opt, given in (("mesh", mesh), ("pipeline", pipeline)):
            if given is not None:
                raise NotImplementedError(f"Executor({opt}=) is not ported")
        if matmul_precision is not None \
                and matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(
                f"matmul_precision={matmul_precision!r}: expected None or "
                f"one of {sorted(MATMUL_PRECISIONS)}")
        #: the JAX name given, and the step's torch setting (None: the
        #: executor's float32 default, TF32 off)
        self.matmul_precision = matmul_precision
        self._precision = None if matmul_precision is None \
            else MATMUL_PRECISIONS[matmul_precision]
        if dist_strategy is not None \
                and not isinstance(dist_strategy, DataParallel):
            raise NotImplementedError(
                f"Executor(dist_strategy={type(dist_strategy).__name__}) is "
                f"not ported; DataParallel is")
        self.compute_dtype = _compute_dtype(kwargs.pop("compute_dtype",
                                                       None))
        # the JAX package's precedence: the keyword, HETU_ZERO, the strategy
        if zero is None:
            zero = os.environ.get("HETU_ZERO") or None
        if zero is None:
            zero = getattr(dist_strategy, "zero", None) or None
        self.zero = _zero.resolve_stage(zero)
        self.remat = _remat.resolve_policy(kwargs.pop("remat", False))
        self.num_microbatches = None if num_microbatches is None \
            else int(num_microbatches)
        self.microbatch_feeds = kwargs.pop("microbatch_feeds", None)
        if dist_strategy is not None:
            for opt, on in (("num_microbatches",
                             (self.num_microbatches or 1) > 1),
                            ("remat", self.remat != "off")):
                if on:
                    raise NotImplementedError(
                        f"Executor({opt}=) with dist_strategy is not "
                        f"ported")
        # bsp: 0 BSP (push at the step's end), -1 ASP (push on a worker),
        # k > 0 SSP (staleness bound k through the stores' clocks)
        self.bsp = int(kwargs.pop("bsp", 0))
        # prefetch: the next batch's PS rows pulled during this step
        self.prefetch = bool(kwargs.pop("prefetch", True))
        # the SSP wait's watchdog
        self.ssp_timeout_ms = int(kwargs.pop("ssp_timeout_ms", 600000))
        #: ASP pushes in flight, oldest first, on a one-worker pool
        self._ps_futures = []
        self._ps_pool = None
        # validate: the lint at construction and the fed-shape check once
        # a run plan ('warn' reports, 'error' raises, 'off' skips)
        self.validate = kwargs.pop("validate", "warn")
        if self.validate not in ("warn", "error", "off"):
            raise ValueError(f"validate={self.validate!r}: expected "
                             "'warn', 'error', or 'off'")
        self._feed_warned = set()
        # timing: each run's wall time, blocking on its fetches
        self.timing = bool(kwargs.pop("timing", False))
        self.timer_logs = {}
        #: run(sync=False): the marks of the steps in flight, oldest first
        self._async_pending = collections.deque()
        try:
            self._async_window = max(
                1, int(os.environ.get("HETU_ASYNC_WINDOW", "4")))
        except ValueError:
            self._async_window = 4
        #: the side stream ahead-of-step feed copies run on (CUDA)
        self._feed_stream = None
        self._init_fault_tolerance(kwargs)
        if kwargs:
            raise NotImplementedError(
                f"Executor({next(iter(kwargs))}=) is not ported")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if isinstance(eval_node_dict, dict):
            self.eval_node_dict = dict(eval_node_dict)
        else:
            self.eval_node_dict = {"default": list(eval_node_dict)}
        self.device = resolve_device(device if device is not None else ctx)
        #: 'offload' moves saved products to pinned host memory (CUDA);
        #: elsewhere it is the counted fallback to 'dots'
        self._offload_ok = self.remat == "offload" \
            and _remat.offload_available(self.device)
        self.dist_strategy = dist_strategy
        #: (dp process group, its size, this rank's rank in it), or None
        self.dp = None
        if dist_strategy is not None:
            group = dist_strategy.make_mesh().get_group("dp")
            self.dp = (group, torch.distributed.get_world_size(group),
                       torch.distributed.get_rank(group))
        self.seed = 0 if seed is None else int(seed)
        self.step_counter = 0
        all_fetches = [n for fl in self.eval_node_dict.values() for n in fl
                       if n is not None]
        self.global_topo = topo_sort(all_fetches)
        self._node_keys = {n: f"t{i}" for i, n in enumerate(self.global_topo)}
        self.var_values = {}
        self._init_variables()

        #: OptimizerOp -> ZeroPlan (ZeRO on, a strategy over >= 2 ranks)
        self._zero_plans = {}
        #: stage 3: bucket key -> this rank's row of the parameters
        self._zero_rows = {}
        #: stage 3: parameter node -> its bucket, and key -> node
        self._zero_covered = {}
        self._zero_key_node = {}
        self._build_zero_plans()
        self.opt_states = {}
        for node in self.global_topo:
            if isinstance(node, OptimizerOp):
                plan = self._zero_plans.get(node)
                self.opt_states[node] = node.optimizer.init_state(
                    {self._k(v): self.var_values[v] for v in node.params}) \
                    if plan is None else self._init_zero_state(node, plan)
        self.subexecutors = {name: SubExecutor(name, fetches, self)
                             for name, fetches in self.eval_node_dict.items()}
        self._validate_graphs()
        if self._auto_resume and self.auto_save_dir:
            self.resume(self.auto_save_dir)

    def _k(self, node):
        """Canonical (topo-ordinal) key of a graph node."""
        k = self._node_keys.get(node)
        return k if k is not None else f"n{node.id}"

    # -- ZeRO weight-update sharding (parallel/zero.py) --------------------

    def _build_zero_plans(self):
        """One :class:`ZeroPlan` per OptimizerOp when ZeRO is on under a
        strategy of two ranks or more.  An optimizer with a parameter that
        is not a float tensor keeps its replicated update (a partial plan
        would skip the uncovered parameters' update); LAMB gets a bucket a
        parameter (its trust ratio is per parameter)."""
        if not self.zero or self.dp is None or self.dp[1] < 2:
            return
        for node in self.global_topo:
            if not isinstance(node, OptimizerOp) or not node.params:
                continue
            items = []
            for p in node.params:
                v = self.var_values[p]
                # (a bf16 master has no numpy dtype to pack by: replicated)
                dtype = None if v.dtype == torch.bfloat16 \
                    else str(v.dtype).replace("torch.", "")
                if dtype is None or _zero.ineligible_reason(p, dtype):
                    items = None
                    break
                items.append((self._k(p), tuple(v.shape), dtype))
            if items is None:
                continue
            self._zero_plans[node] = _zero.build_plan(
                items, self.dp[1], self.zero,
                per_param=bool(getattr(node.optimizer, "lamb", False)),
                prefix=self._k(node) + ".")

    def _init_zero_state(self, op, plan):
        """``op``'s optimizer state, born in this rank's rows; at stage 3
        the rows of the parameters become the masters (``var_values``
        takes :class:`_ZeroView` stand-ins)."""
        rank = self.dp[2]
        by_key = {self._k(p): p for p in op.params}
        rows = {}
        for b in plan.buckets:
            slab = _zero.pack_slab({k: self.var_values[by_key[k]]
                                    for k in b.param_keys}, b)
            rows[b.key] = _zero.row_of(slab, rank)
        state = op.optimizer.init_state(rows)
        if plan.stage >= 3:
            self._zero_rows.update(rows)
            self._zero_key_node.update(by_key)
            for b in plan.buckets:
                for k in b.param_keys:
                    p = by_key[k]
                    self._zero_covered[p] = b
                    self.var_values[p] = _ZeroView(self, p, b)
        return state

    def _zero_gather(self, nodes, count=True):
        """Stage 3: ``{node: full tensor}`` of every planned parameter in
        the buckets that hold one of ``nodes``, each bucket gathered once
        from the ranks' rows (a collective)."""
        buckets = {}
        for n in nodes:
            b = self._zero_covered.get(n)
            if b is not None:
                buckets[b.key] = b
        out = {}
        for b in buckets.values():
            full = _zero.gather_full(self._zero_rows[b.key], b,
                                     self.dp[0], count=count)
            out.update((self._zero_key_node[k], t) for k, t in full.items())
        return out

    def _zero_update(self, op, sub_g, grads, fetched, lr):
        """``op``'s sharded update: its gradient rows (sliced, or
        reduce-scattered at stages 2 and 3), the optimizer on this rank's
        rows, and the full parameters gathered back (stages 1 and 2) or
        the new rows kept (stage 3).  A fetched gradient in a
        reduce-scattered bucket is gathered to the full averaged one
        (``grads``, in place)."""
        plan = self._zero_plans[op]
        group, _, rank = self.dp
        keys = [self._k(v) for v in op.params]
        g_rows = _zero.grad_rows(plan, sub_g, rank, group)
        if plan.stage >= 3:
            params = {b.key: self._zero_rows[b.key] for b in plan.buckets}
        else:
            params = {k: self.var_values[v] for k, v in zip(keys, op.params)}
        new, self.opt_states[op] = _zero.apply_sharded(
            op.optimizer, plan, params, g_rows, self.opt_states[op],
            lr, rank, group)
        if plan.stage >= 3:
            self._zero_rows.update(new)
        else:
            for k, v in zip(keys, op.params):
                self.var_values[v] = new[k]
        if plan.stage >= 2 and fetched.intersection(op.params):
            node = dict(zip(keys, op.params))
            for b in plan.buckets:
                if any(node[k] in fetched for k in b.param_keys):
                    full = _zero.gather_full(g_rows[b.key], b, group,
                                             count=False)
                    grads.update((node[k], t) for k, t in full.items())

    def memory_accounting(self):
        """This rank's bytes of the persistent training state, the numbers
        the ZeRO memory claim is judged on (the JAX package's keys that
        need no compiled step): ``param_bytes_per_device`` (full
        parameters held; a stage-3 stand-in counts 0),
        ``zero_slab_bytes_per_device`` (stage-3 parameter rows),
        ``opt_state_bytes_per_device``, ``grad_bytes_per_device`` (the
        gradients' layout: full, or a row a bucket at stages 2 and 3) and
        ``zero_stage`` (0 without a plan)."""
        def nbytes(t):
            return t.numel() * t.element_size() \
                if isinstance(t, torch.Tensor) else 0

        def leaves(tree):
            if isinstance(tree, dict):
                return [x for v in tree.values() for x in leaves(v)]
            return [tree]

        grads = 0
        for node in self.global_topo:
            if not isinstance(node, OptimizerOp):
                continue
            plan = self._zero_plans.get(node)
            if plan is None:
                grads += sum(nbytes(self.var_values[p]) for p in node.params)
            else:
                grads += sum(b.nbytes // (plan.dp if plan.stage >= 2 else 1)
                             for b in plan.buckets)
        return {
            "zero_stage": self.zero if self._zero_plans else 0,
            "param_bytes_per_device": sum(nbytes(v) for v in
                                          self.var_values.values()),
            "zero_slab_bytes_per_device": sum(
                nbytes(v) for v in self._zero_rows.values()),
            "opt_state_bytes_per_device": sum(
                nbytes(x) for st in self.opt_states.values()
                for x in leaves(st)),
            "grad_bytes_per_device": int(grads)}

    # -- variables and feeds ----------------------------------------------

    def _init_variables(self):
        from ..initializers import variable_generator
        var_nodes = [n for n in self.global_topo
                     if isinstance(n, PlaceholderOp) and n.is_variable]
        self.var_names = checkpoint_names(var_nodes)
        for i, node in enumerate(var_nodes):
            val = node.get_init_value(variable_generator(self.seed, i))
            if val is None:
                raise ValueError(f"variable {node} has no value/initializer")
            self.var_values[node] = self._place(val)
        if self.dp is not None:
            self._broadcast_variables()

    def _broadcast_variables(self):
        """Every rank starts from rank 0's variables: one broadcast of
        them all, flattened (one per dtype)."""
        by_dtype = {}
        for node, val in self.var_values.items():
            by_dtype.setdefault(val.dtype, []).append(node)
        for nodes in by_dtype.values():
            flat = broadcast(torch.cat([self.var_values[n].reshape(-1)
                                        for n in nodes]), self.dp[0])
            parts = flat.split([self.var_values[n].numel() for n in nodes])
            for n, part in zip(nodes, parts):
                self.var_values[n] = part.view(
                    self.var_values[n].shape).clone()

    def _place(self, val):
        """A tensor on the executor's device (float64 → float32)."""
        if isinstance(val, NDArray):
            val = val.torch()
        t = val if isinstance(val, torch.Tensor) \
            else torch.from_numpy(np.array(val))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

    def _place_feed(self, node, val, rows=True):
        """A fed value on the device, in the placeholder's declared dtype
        (int placeholders stay integral); under data parallelism, with
        ``rows``, only this rank's rows of it."""
        if self.dp is not None and rows:
            val = self._rows(node, val)
        t = self._place(val)
        if node.dtype is not None:
            want = _torch_dtype(node.dtype)
            if t.dtype != want:
                t = t.to(want)
        return t

    def _rows(self, node, val):
        """This rank's contiguous block of the dim the strategy splits (0;
        a 0-d value whole); it must divide by the group size."""
        if isinstance(val, NDArray):
            val = val.torch()
        if not isinstance(val, torch.Tensor):
            val = np.asarray(val)
        if self.dist_strategy.feed_spec(node, val.ndim) is None:
            return val
        _, size, rank = self.dp
        if val.shape[0] % size:
            raise ValueError(
                f"feed {node}: dim 0 of {tuple(val.shape)} does not divide "
                f"by the data-parallel group's {size} ranks")
        per = val.shape[0] // size
        return val[rank * per:(rank + 1) * per]

    # -- public API ---------------------------------------------------------

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False, sync=True):
        """Run one step of subgraph ``name``; returns its fetches as
        :class:`NDArray` (numpy arrays with ``convert_to_numpy_ret_vals``):
        a ``GradientOp`` fetch is its gradient, an ``OptimizerOp`` fetch
        ``None``.

        ``sync=False``: non-blocking stepping.  The fetches are tensors
        whose kernels may still run; the executor keeps at most
        ``HETU_ASYNC_WINDOW`` (default 4) such steps in flight and waits
        for the oldest when the window is full.  The forced waits (a numpy
        conversion, the PS push boundary, a save, the window) count as
        ``async_sync_points``.  The same ops run in the same order on one
        stream either way, so the bits are the same."""
        if isinstance(name, dict):  # run(feed_dict) shorthand
            feed_dict, name = name, "default"
        if isinstance(eval_node_list, dict) and feed_dict is None:
            feed_dict, eval_node_list = eval_node_list, None
        if eval_node_list:
            warnings.warn("eval_node_list override is ignored; fetches are "
                          "fixed per subgraph at construction")
        sub = self.subexecutors[name]
        t0 = time.perf_counter() if self.timing else None
        # a SIGTERM / SIGINT during the step defers its save to the
        # boundary, where parameters, optimizer state and step agree
        self._in_step = True
        try:
            with contextlib.nullcontext() if self._precision is None \
                    else _precision(self._precision):
                out = sub.run(feed_dict or {}, convert_to_numpy_ret_vals,
                              sync)
        finally:
            self._in_step = False
        if not sync and not convert_to_numpy_ret_vals:
            self._note_async()
        if t0 is not None:
            # the timer blocks on the fetches: an unblocked bracket would
            # time the enqueue, not the step
            _sync_outs(out)
            self.timer_logs.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        self._post_step(sub.training)
        return out

    def run_steps(self, feeder, n, name="default", sync=False,
                  convert_to_numpy_ret_vals=False):
        """Drive ``n`` steps with pipelined feeds and, by default,
        non-blocking stepping.

        ``feeder``: ``callable(i) -> feed_dict``, a list of feed dicts, or
        None for a dataloader-fed graph (whose plan double-buffers on its
        own).  Step i+1's feeds are placed on a one-worker thread while
        step i runs (on the card: from pinned memory on a side stream,
        the compute stream waiting on the copy's event), when a step's
        placement costs more than a thread handoff (``pipeline_min_us``);
        step 0 is placed inline.  Returns each step's fetches."""
        if not isinstance(n, int) or n < 0:
            raise ValueError(f"run_steps needs a step count, got {n!r}")
        if feeder is None:
            get_fd = None
        elif callable(feeder):
            get_fd = feeder
        else:
            fds = list(feeder)
            if len(fds) < n:
                raise ValueError(
                    f"run_steps: {n} steps but only {len(fds)} feed dicts")
            get_fd = fds.__getitem__

        def place_all(fd):
            return {node: self._place_ahead(node, v)
                    for node, v in fd.items()}

        def adopt(placed):
            return {node: self._adopt(t, ev)
                    for node, (t, ev) in placed.items()}

        pool = None
        placed, overlap = {}, False
        if get_fd and n:
            t0 = time.perf_counter()
            placed = adopt(place_all(get_fd(0)))
            overlap = feed_pipeline_enabled() \
                and (time.perf_counter() - t0) * 1e6 >= pipeline_min_us()
        results = []
        try:
            for i in range(n):
                fut = None
                if overlap and i + 1 < n:
                    if pool is None:
                        pool = concurrent.futures.ThreadPoolExecutor(
                            max_workers=1,
                            thread_name_prefix="run-steps-feed")
                    fut = pool.submit(place_all, get_fd(i + 1))
                results.append(self.run(
                    name, feed_dict=placed, sync=sync,
                    convert_to_numpy_ret_vals=convert_to_numpy_ret_vals))
                if fut is not None:
                    placed = adopt(fut.result())
                    record_run_plan("feeds_pipelined", len(placed))
                elif get_fd and i + 1 < n:
                    placed = adopt(place_all(get_fd(i + 1)))
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return results

    def _place_ahead(self, node, val, rows=False):
        """A feed placed ahead of the step that reads it: ``(tensor,
        event)``.  On the card the copy leaves pinned host memory on the
        executor's side stream (``non_blocking=True``) and ``event`` marks
        its end; elsewhere the plain placement and no event.  ``rows``:
        this rank's rows only (a dataloader's batch; ``run_steps`` leaves
        the split to the step)."""
        if self.device.type != "cuda":
            return self._place_feed(node, val, rows=rows), None
        if self._feed_stream is None:
            self._feed_stream = torch.cuda.Stream(self.device)
        if self.dp is not None and rows:
            val = self._rows(node, val)
        if isinstance(val, NDArray):
            val = val.torch()
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.array(val))
        with torch.cuda.stream(self._feed_stream):
            if val.device.type == "cpu":
                val = val.pin_memory()
            t = self._place_feed(node, val.to(self.device, non_blocking=True),
                                 rows=False)
            event = torch.cuda.Event()
            event.record(self._feed_stream)
        return t, event

    def _adopt(self, t, event):
        """A tensor placed ahead, made safe to read on the compute stream:
        the stream waits on the copy's event, and the tensor's memory is
        recorded as used there."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            t.record_stream(stream)
        return t

    def _note_async(self):
        """Track one non-blocking step; wait for the oldest once more than
        the window are in flight."""
        self._async_pending.append(_StepMark(self.device))
        if len(self._async_pending) > self._async_window:
            record_run_plan("async_sync_points")
            self._async_pending.popleft().synchronize()

    def _drain_async(self):
        """Wait for every step in flight (one sync point when any was):
        before a save, a resume, ``ps_flush`` and a ZeRO transcoding."""
        if not self._async_pending:
            return
        record_run_plan("async_sync_points")
        while self._async_pending:
            self._async_pending.popleft().synchronize()

    def logOut(self, path, clear=True):
        """Append the recorded step times to ``path`` ("name<TAB>t ms")."""
        with open(path, "a") as f:
            for name, times in self.timer_logs.items():
                for t in times:
                    f.write(f"{name}\t{t:.3f} ms\n")
        if clear:
            self.clearTimer()

    def clearTimer(self):
        self.timer_logs = {}

    # -- static validation (analysis/) -------------------------------------

    def _validate_graphs(self):
        """The construction-time lint of every subgraph (``validate=
        'warn'|'error'``): graph bugs fail here with the node and its
        creation site, before a step runs.  Fed shapes are checked once a
        run plan (:meth:`_check_feeds`)."""
        if self.validate == "off":
            return
        from ..analysis import lint as lint_graph
        # remat is a training-graph concern: an eval subgraph beside it
        # does not warn of "no recomputable segment", unless no subgraph
        # differentiates, and then the first says so
        any_grads = any(s.grad_ops for s in self.subexecutors.values())
        first = next(iter(self.eval_node_dict), None)
        for name, fetches in self.eval_node_dict.items():
            lint_remat = self.remat if (
                self.subexecutors[name].grad_ops
                or (not any_grads and name == first)) else "off"
            try:
                report = lint_graph(fetches, zero=self.zero,
                                    remat=lint_remat,
                                    dp=None if self.dp is None
                                    else self.dp[1])
            except Exception as e:
                # the analyzer must never break a working graph
                warnings.warn(f"graph lint crashed on subgraph "
                              f"'{name}': {type(e).__name__}: {e}",
                              RuntimeWarning)
                continue
            if report.diagnostics:
                if self.validate == "error":
                    report.raise_errors(all_severities=True)
                warnings.warn(
                    f"graph lint found {len(report.diagnostics)} issue(s) "
                    f"in subgraph '{name}' "
                    f"(Executor(validate='off') silences):\n{report}",
                    UserWarning)

    def _check_feeds(self, sub, feed_dict):
        """Fed values against their placeholders' declared shapes (the
        run-time half of ``validate=``, once a feed schema)."""
        from ..analysis.lint import GraphValidationError
        for node in sub.feed_nodes:
            if node not in feed_dict or node.shape is None:
                continue
            val = feed_dict[node]
            shape = tuple(val.shape) if hasattr(val, "shape") \
                else tuple(np.shape(val))
            if shape == tuple(node.shape):
                continue
            msg = (f"feed for placeholder '{node.name}' has shape "
                   f"{shape} but the placeholder declares "
                   f"{tuple(node.shape)} [created at "
                   f"{format_site(node.creation_site)}]")
            if self.validate == "error":
                raise GraphValidationError(msg)
            if node.id not in self._feed_warned:
                self._feed_warned.add(node.id)
                warnings.warn(msg, UserWarning)

    def remat_plan(self, name=None):
        """``{"policy": ..., "plans": {subgraph: plan report}}`` (with
        ``name``, that subgraph's report or None); ``'full'`` and
        ``'auto'`` build per-segment plans."""
        plans = {n: sub._remat_plan.report()
                 for n, sub in self.subexecutors.items()
                 if sub._remat_plan is not None}
        if name is not None:
            return plans.get(name)
        return {"policy": self.remat, "plans": plans}

    def get_batch_num(self, name="default"):
        """Batches an epoch of subgraph ``name``'s dataloaders holds (the
        fewest, where it has several); None without a ``DataloaderOp``."""
        nums = [n.get_batch_num(name)
                for n in self.subexecutors[name].dataloader_nodes]
        return min(nums) if nums else None

    def _ps_async_push(self, node, grad):
        """Queue an ASP push of ``grad`` for ``node``'s current ids: at
        most 32 in flight (the oldest waited for); a finished push is
        read, so a failed one raises at the next step."""
        if self._ps_pool is None:
            self._ps_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ps-asp-push")
        pending = []
        for f in self._ps_futures:
            if f.done():
                f.result()
            else:
                pending.append(f)
        self._ps_futures = pending
        while len(self._ps_futures) >= 32:
            self._ps_futures.pop(0).result()
        # the ids now: by the time the worker runs, the next step may have
        # replaced node._last_ids
        ids = node._last_ids
        self._ps_futures.append(self._ps_pool.submit(
            lambda: node.push_to(ids, grad.cpu().numpy())))

    def ps_flush(self):
        """Barrier: every PS push of this executor has been applied (the
        ASP pushes in flight, and the steps of ``run(sync=False)``)."""
        self._drain_async()
        futures, self._ps_futures = self._ps_futures, []
        for f in futures:
            f.result()

    def close(self):
        """Drain the ASP pushes and stop the subgraphs' feed and prefetch
        threads and the push worker (idempotent)."""
        try:
            self.ps_flush()
        finally:
            for sub in self.subexecutors.values():
                sub.close()
            if self._ps_pool is not None:
                self._ps_pool.shutdown(wait=True)
                self._ps_pool = None

    def load_dict(self, state_dict):
        """Set variables by checkpoint name from ``{name: array}``;
        unknown names are skipped.  A stage-3 ZeRO parameter is written
        through to this rank's row, a bucket at a time (every rank loads
        the same values)."""
        by_name = {self.var_names[n]: n for n in self.var_values}
        touched = {}
        for name, val in state_dict.items():
            node = by_name.get(name)
            if node is None:
                continue
            b = self._zero_covered.get(node)
            if b is None:
                self.var_values[node] = self._place(val)
            else:
                touched.setdefault(b.key, (b, {}))[1][self._k(node)] = val
        rank = self.dp[2] if touched else 0
        for key, (b, vals) in touched.items():
            row = self._zero_rows[key]
            flat = torch.zeros(b.padded, dtype=row.dtype, device=row.device)
            flat[rank * b.width:(rank + 1) * b.width] = row
            for k, shape, off in zip(b.param_keys, b.shapes, b.offsets):
                if k in vals:
                    v = self._place(vals[k]).reshape(-1)
                    flat[off:off + v.numel()] = v
            self._zero_rows[key] = _zero.row_of(
                flat.view(b.dp, b.width), rank)

    def return_tensor_values(self):
        """``{checkpoint name: numpy array}`` of every variable; stage-3
        ZeRO parameters gathered from the ranks' rows (a collective)."""
        return {self.var_names[n]: hv for n, hv in self._vars_host()}
