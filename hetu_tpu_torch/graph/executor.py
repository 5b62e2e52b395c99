"""Graph evaluation and the training executor (twin of
``hetu_tpu/graph/executor.py``, core only).

``lower_forward`` evaluates a topologically sorted subgraph eagerly:
each node's ``lower`` runs on its inputs' tensors as soon as they exist.

``Executor`` owns the variables of one or more fetch subgraphs
(``{name: fetches}``) and runs a subgraph per :meth:`Executor.run`:
feeds go to the device, the forward runs through ``lower_forward``,
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

Mixed precision (``compute_dtype="bfloat16"``, the JAX package's
``_cast_tree`` discipline): inside the step every float32 variable,
trainable or not, and every float32 feed is cast to bfloat16; a
trainable variable is cast inside the differentiated function, so its
gradient reaches the float32 master as float32.  Feeds first take their
placeholder's declared dtype, so integer ids, labels and masks are never
rounded.  Fetched values and state updates leave the step as float32;
the optimizer's state and update stay float32, on the masters.  Not with
PS embeddings or the MoE sparse dispatch (their kernels take float32
only): refused by name.

Not ported, refused by name: distribution (``dist_strategy``, ``mesh``,
``zero``, ``plan``, ``pipeline``, ``num_microbatches``), ``remat``,
``matmul_precision``, a ``compute_dtype`` other than bfloat16, ASP/SSP
(``bsp`` other than 0), ``prefetch`` and ids from a ``DataloaderOp``, the
other JAX-package options, ``run(sync=False)``, ``run_steps``, ``save``
/ ``load``.
"""
from __future__ import annotations

import concurrent.futures
import warnings

import numpy as np
import torch

from ..context import resolve_device
from ..ndarray import NDArray, wrap_device
from ..ops.kernels.emb_cache import emb_scatter_add
from ..optim.optimizer import OptimizerOp
from .gradients import GradientOp
from .node import LowerCtx, PlaceholderOp, checkpoint_names, topo_sort


def lower_forward(topo, ctx, resolve_leaf):
    """Evaluate every node of ``topo`` into an environment
    ``{node: tensor}``; placeholders resolve through ``resolve_leaf(node)``."""
    env = {}
    for node in topo:
        if isinstance(node, PlaceholderOp):
            env[node] = resolve_leaf(node)
        else:
            env[node] = node.lower(ctx, *[env[i] for i in node.inputs])
    return env


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


#: op types whose kernels take float32 only (the MoE sparse dispatch)
_F32_ONLY_OPS = ("SparseDispatch", "SparseCombine")


def _step_generator(device, seed, step):
    """The ``torch.Generator`` of one step: seeded from ``(seed, step)``
    on the executor's device, so dropout masks depend on nothing else."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


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
                    f"PS embedding {n}: ids from {idn} (a DataloaderOp or a "
                    f"computed node) are not ported; feed an ids "
                    f"placeholder")
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
        self._feed_pool = None
        self.feed_nodes = [n for n in self.topo
                           if isinstance(n, PlaceholderOp)
                           and not n.is_variable
                           and not getattr(n, "is_ps", False)]
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
        if executor.compute_dtype is not None:
            f32_only = [n for n in self.topo if getattr(n, "is_ps", False)
                        or getattr(n, "op_type", None) in _F32_ONLY_OPS]
            if f32_only:
                raise NotImplementedError(
                    f"Executor(compute_dtype=...) with {f32_only[0]} in "
                    f"subgraph {name!r}: PS embeddings and the MoE sparse "
                    f"dispatch take float32 only")

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

    def run(self, feed_dict, convert_to_numpy_ret_vals=False):
        ex = self.ex
        # a device cache's store round trip starts first, on the feed
        # thread, and overlaps the feed placement below
        dev_pending = self._begin_dev_lookups(feed_dict) \
            if self._ps_dev_items else None
        ps_vals, invs = {}, {}
        try:
            feeds = {}
            for node in self.feed_nodes:
                if node not in feed_dict:
                    raise ValueError(f"missing feed for {node}")
                feeds[node] = self._low(
                    ex._place_feed(node, feed_dict[node]))
            for node in self._ps_host_items:
                ps_vals[node] = ex._place_feed(
                    node, node.pull(self._ps_ids(node, feed_dict)))
            if dev_pending is not None:
                self._finish_dev_lookups(dev_pending, ps_vals, invs)
        except BaseException:
            if dev_pending is not None:
                self._settle_dev_pending(dev_pending)
            raise
        ctx = LowerCtx(self.training,
                       _step_generator(ex.device, ex.seed, ex.step_counter))
        grads, ps_grads = {}, {}
        if self.grad_ops:
            leaves = {v: ex.var_values[v].detach().requires_grad_(True)
                      for v in self.trainable_vars}
            leaves.update({n: v.detach().requires_grad_(True)
                           for n, v in ps_vals.items()})
            wrt = self.trainable_vars + self.ps_nodes

            def resolve(node):
                if node in feeds:
                    return feeds[node]
                # the cast of a trainable variable is differentiated
                # through: its gradient reaches the master as float32
                return self._low(leaves.get(node, ex.var_values.get(node)))

            with torch.enable_grad():
                env = lower_forward(self.fwd_topo, ctx, resolve)
                got = torch.autograd.grad(
                    env[self.loss_node], [leaves[v] for v in wrt],
                    allow_unused=True)
            got = {v: torch.zeros_like(leaves[v]) if g is None else g
                   for v, g in zip(wrt, got)}
            grads = {v: got[v] for v in self.trainable_vars}
            ps_grads = {n: got[n] for n in self.ps_nodes}
            with torch.no_grad():
                for node in self._ps_dev_items:
                    g = ps_grads[node]
                    ps_grads[node] = emb_scatter_add(
                        g.reshape(-1, g.shape[-1]), invs[node])
                for op in self.opt_ops:
                    keys = [ex._k(v) for v in op.params]
                    sub_p = {k: ex.var_values[v]
                             for k, v in zip(keys, op.params)}
                    sub_g = {k: grads[v] for k, v in zip(keys, op.params)}
                    new_p, ex.opt_states[op] = op.optimizer.apply(
                        sub_p, sub_g, ex.opt_states[op], op.optimizer.lr)
                    for k, v in zip(keys, op.params):
                        ex.var_values[v] = new_p[k]
        else:
            with torch.no_grad():
                env = lower_forward(
                    self.fwd_topo, ctx,
                    lambda n: feeds[n] if n in feeds
                    else ps_vals[n] if n in ps_vals
                    else self._low(ex.var_values[n]))
        for node, val in ctx.state_updates.items():
            ex.var_values[node] = self._high(val.detach())
        if self.ps_nodes:
            self._ps_post_step(ps_grads)
        if self.training:
            ex.step_counter += 1

        outs = []
        for f in self.fetches:
            if f is None or isinstance(f, OptimizerOp):
                outs.append(None)
            elif isinstance(f, GradientOp):
                outs.append(grads[f.wrt])
            else:
                outs.append(self._high(env[f].detach()))
        if convert_to_numpy_ret_vals:
            return [None if v is None else v.cpu().numpy() for v in outs]
        return [None if v is None else wrap_device(v) for v in outs]

    # -- PS embeddings ----------------------------------------------------------

    def _ps_ids(self, node, feed_dict):
        """The ids batch of a PS lookup, read from the feed dict."""
        if node.ids_node not in feed_dict:
            raise ValueError(f"missing ids feed {node.ids_node} for PS "
                             f"embedding {node}")
        return np.asarray(feed_dict[node.ids_node], np.int64)

    def _begin_dev_lookups(self, feed_dict):
        """Phase 1 of a device-cache step: each table's plan
        (``begin_lookup``, which takes the cache lock), then its store
        round trip on the feed thread.  Returns the pending handles."""
        if self._feed_pool is None:
            self._feed_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"feed-pipeline-{self.name}")
        pending = []
        try:
            for node in self._ps_dev_items:
                ids = self._ps_ids(node, feed_dict)
                h = node.cache.begin_lookup(ids)
                pending.append((node, ids, h,
                                self._feed_pool.submit(h.roundtrip)))
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
        """The push boundary: a device table commits its U summed rows
        (their copy to the host is the step's sync point), a host table
        pushes the whole row gradient through its cache or store."""
        for node in self.ps_nodes:
            g = ps_grads.get(node)
            if node.device_mode:
                h = self._dev_live.pop(node, None)
                if g is not None and h is not None and h.uk is not None:
                    node.cache.apply_update_summed(
                        h.uk, g[:h.uk.size].cpu().numpy(), h.cnt)
            elif g is not None:
                node.push(g.cpu().numpy())

    def close(self):
        """Stop the feed thread (idempotent)."""
        if self._feed_pool is not None:
            self._feed_pool.shutdown(wait=True)
            self._feed_pool = None


class Executor:
    """Multi-subgraph training executor (see module docstring).

    ``eval_node_dict``: a list of fetches (one subgraph, "default") or
    ``{name: fetch list}``.  ``seed``: variable init and dropout.
    ``device``: where variables live and the step runs — CUDA by default
    (raises without it); the CPU only when asked for.  ``ctx`` (the JAX
    package's context argument) names the device when ``device`` is not
    given.  Float32 products run in full float32 (TF32 off).
    ``compute_dtype``: None (float32) or ``"bfloat16"`` (mixed precision,
    see the module docstring)."""

    def __init__(self, eval_node_dict, ctx=None, seed=None, device=None,
                 dist_strategy=None, mesh=None, pipeline=None,
                 num_microbatches=None, matmul_precision=None, **kwargs):
        for opt, given in (("dist_strategy", dist_strategy), ("mesh", mesh),
                           ("pipeline", pipeline),
                           ("num_microbatches", num_microbatches),
                           ("matmul_precision", matmul_precision)):
            if given is not None:
                raise NotImplementedError(f"Executor({opt}=) is not ported")
        self.compute_dtype = _compute_dtype(kwargs.pop("compute_dtype",
                                                       None))
        if kwargs.pop("remat", None) not in (None, False, "off"):
            raise NotImplementedError("Executor(remat=) is not ported")
        bsp = kwargs.pop("bsp", 0)
        if bsp != 0:
            raise NotImplementedError(
                f"Executor(bsp={bsp}): ASP / SSP parameter-server training "
                f"is not ported; PS embeddings train BSP (bsp=0)")
        if kwargs.pop("prefetch", False):
            raise NotImplementedError(
                "Executor(prefetch=True): the lookahead PS pull (for "
                "DataloaderOp ids) is not ported")
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
        self.seed = 0 if seed is None else int(seed)
        self.step_counter = 0
        all_fetches = [n for fl in self.eval_node_dict.values() for n in fl
                       if n is not None]
        self.global_topo = topo_sort(all_fetches)
        self._node_keys = {n: f"t{i}" for i, n in enumerate(self.global_topo)}
        self.var_values = {}
        self._init_variables()

        self.opt_states = {}
        for node in self.global_topo:
            if isinstance(node, OptimizerOp):
                self.opt_states[node] = node.optimizer.init_state(
                    {self._k(v): self.var_values[v] for v in node.params})
        self.subexecutors = {name: SubExecutor(name, fetches, self)
                             for name, fetches in self.eval_node_dict.items()}

    def _k(self, node):
        """Canonical (topo-ordinal) key of a graph node."""
        k = self._node_keys.get(node)
        return k if k is not None else f"n{node.id}"

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

    def _place(self, val):
        """A tensor on the executor's device (float64 → float32)."""
        if isinstance(val, NDArray):
            val = val.torch()
        t = val if isinstance(val, torch.Tensor) \
            else torch.from_numpy(np.array(val))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

    def _place_feed(self, node, val):
        """A fed value on the device, in the placeholder's declared dtype
        (int placeholders stay integral)."""
        t = self._place(val)
        if node.dtype is not None:
            want = _torch_dtype(node.dtype)
            if t.dtype != want:
                t = t.to(want)
        return t

    # -- public API ---------------------------------------------------------

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False, sync=True):
        """Run one step of subgraph ``name``; returns its fetches as
        :class:`NDArray` (numpy arrays with ``convert_to_numpy_ret_vals``):
        a ``GradientOp`` fetch is its gradient, an ``OptimizerOp`` fetch
        ``None``."""
        if not sync:
            raise NotImplementedError(
                "Executor.run(sync=False) is not ported")
        if isinstance(name, dict):  # run(feed_dict) shorthand
            feed_dict, name = name, "default"
        if isinstance(eval_node_list, dict) and feed_dict is None:
            feed_dict, eval_node_list = eval_node_list, None
        if eval_node_list:
            warnings.warn("eval_node_list override is ignored; fetches are "
                          "fixed per subgraph at construction")
        return self.subexecutors[name].run(feed_dict or {},
                                           convert_to_numpy_ret_vals)

    def ps_flush(self):
        """Barrier: every PS push of this executor has been applied.  The
        port trains BSP only, and pushes inline at each step's end, so
        none is ever in flight when ``run`` returns."""

    def close(self):
        """Stop the subgraphs' feed threads (idempotent)."""
        for sub in self.subexecutors.values():
            sub.close()

    def load_dict(self, state_dict):
        """Set variables by checkpoint name from ``{name: array}``;
        unknown names are skipped."""
        by_name = {self.var_names[n]: n for n in self.var_values}
        for name, val in state_dict.items():
            node = by_name.get(name)
            if node is not None:
                self.var_values[node] = self._place(val)

    def return_tensor_values(self):
        """``{checkpoint name: numpy array}`` of every variable."""
        return {self.var_names[n]: v.detach().cpu().numpy()
                for n, v in self.var_values.items()}
