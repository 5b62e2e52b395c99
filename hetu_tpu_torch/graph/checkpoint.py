"""Checkpoints of the training executor in the JAX package's
``hetu_tpu.ckpt.v1`` format (``hetu_tpu/graph/executor.py``: ``save``,
``load``, auto-save, ``resume``, the preemption save), mixed into
:class:`~hetu_tpu_torch.graph.executor.Executor`.

A checkpoint is a directory:

* ``params/p{i}.npy`` — variable i in the executor's variable order,
  named by its checkpoint name in ``meta.json``'s ``params``;
* ``opt/o{k}_{j}.npy`` — leaf j of optimizer k's state, in the order
  ``jax.tree_util.tree_flatten_with_path`` gives (dict keys sorted), its
  key the ``keystr`` of its path with parameter names for node keys, for
  example ``['m']['bert.layer0.attn.q.weight']``; Adam's ``t`` is a 0-d
  int32 leaf.  Under ZeRO the moments are keyed by bucket (``t57.zb0``)
  and stored as the full ``(dp, width)`` slabs, gathered from the ranks'
  rows.  :func:`flatten_with_path` and :func:`keystr` are the port's copy
  of those JAX functions' order and strings, so both packages name the
  same files and either loads the other's checkpoint;
* ``ps{i}.bin`` — PS table i in the store's streamed v3 format;
* ``meta.json``, written last with an atomic replace: the format, the
  step, the seed, the names above, the dataloaders' cursors and the size
  ``manifest`` that :meth:`CheckpointMixin._checkpoint_complete` checks.

The directory is assembled in ``<path>.saving`` and published by a rename
(an existing checkpoint goes through ``<path>.replaced``), so a save cut
at any point leaves the previous checkpoint or a remnant ``resume``
probes.  ``save(path, file=name)`` writes the JAX package's single pickle
blob instead.  Under a strategy every rank calls ``save`` (the ZeRO
gathers are collectives) and rank 0 writes; the ranks meet at
``torch.distributed.barrier`` between the phases.
"""
from __future__ import annotations

import glob
import json
import os
import pickle
import re
import shutil
import warnings

import numpy as np
import torch

from ..metrics import record_fault

FORMAT = "hetu_tpu.ckpt.v1"

#: ``chaos.active``, resolved at the first step that asks; the injector
#: itself may be installed or removed mid-run and is read every step
_chaos_active_fn = None


def _chaos_active():
    global _chaos_active_fn
    if _chaos_active_fn is None:
        from .. import chaos
        _chaos_active_fn = chaos.active
    return _chaos_active_fn()


# -- jax.tree_util's flattening order and key strings ---------------------------

def flatten_with_path(tree, path=()):
    """``[(path, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, lists and tuples in order, ``None`` an empty
    node.  A path element is ``("key", k)`` or ``("index", i)``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], path + (("key", k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, path + (("index", i),))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def keystr(path):
    """``jax.tree_util.keystr``: ``['m']['w']`` for dict keys (their
    ``repr``), ``[0]`` for sequence indices."""
    return "".join(f"[{k!r}]" if kind == "key" else f"[{k}]"
                   for kind, k in path)


def unflatten_like(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`flatten_with_path`
    order, by ``leaves``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            new = {k: walk(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        return next(it)

    return walk(tree)


def rename_dict_keys(tree, ren):
    """``tree`` with every dict key found in ``ren`` renamed."""
    if isinstance(tree, dict):
        return {ren.get(k, k): rename_dict_keys(v, ren)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rename_dict_keys(v, ren) for v in tree)
    return tree


def _to_host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class CheckpointMixin:
    """``save`` / ``load`` / ``resume`` and auto-save for the executor."""

    # -- fault-tolerance options (read in Executor.__init__) ---------------

    def _init_fault_tolerance(self, kwargs):
        """Pop the auto-save options from ``kwargs`` (then the
        ``HETU_AUTO_SAVE_{DIR,EVERY,KEEP}`` / ``HETU_AUTO_RESUME``
        variables) and install the signal handlers when auto-saving."""
        env = os.environ
        self.auto_save_dir = kwargs.pop(
            "auto_save_dir", env.get("HETU_AUTO_SAVE_DIR") or None)
        self.auto_save_every = int(kwargs.pop(
            "auto_save_every", env.get("HETU_AUTO_SAVE_EVERY", "0")))
        self.auto_save_keep = int(kwargs.pop(
            "auto_save_keep", env.get("HETU_AUTO_SAVE_KEEP", "3")))
        self._auto_resume = bool(kwargs.pop(
            "auto_resume", env.get("HETU_AUTO_RESUME", "") == "1"))
        self._in_step = False
        self._preempt_signum = None
        self._prev_handlers = {}
        self._installed_handlers = {}
        install = kwargs.pop("install_signal_handlers", None)
        if install is None:
            install = bool(self.auto_save_dir)
        if install and self.auto_save_dir:
            self._install_signal_handlers()

    @property
    def _rank0(self):
        return self.dp is None or self.dp[2] == 0

    # -- the checkpoint's naming -------------------------------------------

    def _opt_rename_maps(self, op):
        """(node key → parameter name, its inverse) of one optimizer: node
        keys are topo ordinals, parameter names the checkpoint's
        identity."""
        fwd = {self._k(p): self.var_names[p] for p in op.params}
        return fwd, {v: k for k, v in fwd.items()}

    def _named_opt_state(self, op, st):
        return rename_dict_keys(st, self._opt_rename_maps(op)[0])

    def _unname_opt_state(self, op, st):
        return rename_dict_keys(st, self._opt_rename_maps(op)[1])

    def _dataloader_sites(self):
        """Distinct ``DataloaderOp``s across subgraphs, in a stable graph
        order: their cursors are training state."""
        from ..data.dataloader import DataloaderOp
        seen, sites = set(), []
        for name in sorted(self.subexecutors):
            se = self.subexecutors[name]
            for node in list(se.feed_nodes) \
                    + [n.ids_node for n in se.ps_nodes]:
                if isinstance(node, DataloaderOp) and id(node) not in seen:
                    seen.add(id(node))
                    sites.append(node)
        return sites

    def _ps_table_sites(self):
        """Distinct (store, table) pairs across subgraphs, in a stable
        graph order: the ordinal is a table's checkpoint identity."""
        seen, sites = set(), []
        for name in sorted(self.subexecutors):
            for node in self.subexecutors[name].ps_nodes:
                key = (id(node.store), node.table)
                if key not in seen:
                    seen.add(key)
                    sites.append(node)
        return sites

    def _flush_ps_caches(self):
        """Push every HET cache's pending gradient rows to its store: the
        tables persist store-side, so a gradient still in a cache would be
        missing from the checkpoint."""
        flushed = set()
        for se in self.subexecutors.values():
            for node in se.ps_nodes:
                cache = node.cache
                if cache is not None and id(cache) not in flushed:
                    flushed.add(id(cache))
                    cache.flush()

    # -- host copies (collectives under a strategy) -----------------------

    def _vars_host(self):
        """``(node, host array)`` of every variable in order, one at a
        time; stage-3 parameters gathered from the ranks' rows first (a
        collective)."""
        full = self._zero_gather(list(self._zero_covered), count=False)
        for n, v in self.var_values.items():
            yield n, _to_host(full.get(n, v))

    def _zero_bucket_dicts(self, op, tree, fn):
        """``tree`` with ``fn(bucket, value)`` applied to every value of a
        dict keyed by exactly ``op``'s ZeRO buckets (its state rows or
        slabs); other subtrees unchanged."""
        plan = self._zero_plans.get(op)
        if plan is None:
            return tree
        buckets = {b.key: b for b in plan.buckets}

        def walk(t):
            if isinstance(t, dict):
                if set(t) == set(buckets):
                    return {k: fn(buckets[k], v) for k, v in t.items()}
                return {k: walk(v) for k, v in t.items()}
            return t

        return walk(tree)

    def _opt_state_host(self, op):
        """``op``'s state on the host in the JAX package's layout: a ZeRO
        row gathered with the other ranks' rows into its ``(dp, width)``
        slab (a collective: every rank calls this)."""
        from ..parallel.collectives import all_gather_flat

        def slab(b, row):
            return all_gather_flat(row, self.dp[0]).reshape(b.dp, b.width)

        st = self._zero_bucket_dicts(op, self.opt_states[op], slab)
        return _map_leaves(st, _to_host)

    def _place_opt_tree(self, op, tree, like):
        """A restored host state on the device, in ``like``'s layout: a
        ZeRO slab becomes this rank's row; a leaf keeps its live dtype."""
        from ..parallel import zero as _zero

        def row(b, v):
            v = np.asarray(v)
            return _zero.row_of(torch.from_numpy(
                np.ascontiguousarray(v.reshape(b.dp, b.width))),
                self.dp[2]) if v.ndim == 2 else v

        tree = self._zero_bucket_dicts(op, tree, row)
        flat = [leaf for _, leaf in flatten_with_path(tree)]
        live = [leaf for _, leaf in flatten_with_path(like)]
        placed = []
        for new, old in zip(flat, live):
            if isinstance(new, np.ndarray):
                new = torch.from_numpy(np.ascontiguousarray(new))
            if isinstance(old, torch.Tensor):
                new = new.to(device=old.device, dtype=old.dtype)
            placed.append(new)
        return unflatten_like(like, placed)

    def _maybe_transcode_loaded_opt(self, op, host_tree):
        """A checkpoint written at another data-parallel size carries
        ``op``'s ZeRO slabs in the writer's ``(dp, width)`` layout.  The
        bucket boundaries do not depend on dp, so the writer's plan is
        rebuilt from the slab's leading dim and the moments re-packed into
        this world's layout (pure data movement).  Anything else passes
        through."""
        self._drain_async()
        plan = self._zero_plans.get(op)
        if plan is None:
            return host_tree
        from ..parallel import zero as _zero
        new_shapes = {(b.dp, b.width) for b in plan.buckets}
        bucket_keys = frozenset(b.key for b in plan.buckets)
        slab_shape = []

        def scan(t):
            if not isinstance(t, dict) or slab_shape:
                return
            if frozenset(t) == bucket_keys:
                for bi, b in enumerate(plan.buckets):
                    v = t.get(b.key)
                    if getattr(v, "ndim", 0) == 2:
                        slab_shape.append((bi, tuple(v.shape)))
                        return
            for v in t.values():
                scan(v)

        scan(host_tree)
        if not slab_shape or slab_shape[0][1] in new_shapes:
            return host_tree
        bi, shape = slab_shape[0]
        dp_old = int(shape[0])
        items = [(k, s, b.dtype) for b in plan.buckets
                 for k, s in zip(b.param_keys, b.shapes)]
        old_plan = _zero.build_plan(
            items, dp_old, plan.stage,
            per_param=bool(getattr(op.optimizer, "lamb", False)),
            prefix=self._k(op) + ".")
        if frozenset(b.key for b in old_plan.buckets) != bucket_keys \
                or shape != (old_plan.buckets[bi].dp,
                             old_plan.buckets[bi].width):
            return host_tree
        warnings.warn(
            f"checkpoint optimizer state for '{op.name}' was written at "
            f"dp={dp_old}; transcoding its moment slabs to this world's "
            f"dp={plan.dp} layout")
        return _transcode_opt_state(host_tree, old_plan, plan)

    # -- save ----------------------------------------------------------------

    def _save_barrier(self):
        if self.dp is not None:
            torch.distributed.barrier(group=self.dp[0])

    def save(self, path, file=None):
        """Checkpoint the parameters, optimizer state, PS tables,
        dataloader cursors and step (see the module docstring);
        ``file=name`` writes the single pickle blob ``<path>/<name>``."""
        # steps of run(sync=False) and ASP pushes land first, then the
        # caches' pending rows
        self.ps_flush()
        self._flush_ps_caches()
        rank0 = self._rank0
        path = os.path.normpath(path)
        if file is not None:
            os.makedirs(path, exist_ok=True)
            blob = {"params": {self.var_names[n]: hv
                               for n, hv in self._vars_host()},
                    "opt_states": {op.name: self._opt_state_host(op)
                                   for op in self.opt_states},
                    "step": self.step_counter}
            if rank0:
                tmp = os.path.join(path, file + ".tmp")
                with open(tmp, "wb") as f:
                    pickle.dump(blob, f)
                os.replace(tmp, os.path.join(path, file))
            self._save_barrier()
            return
        work = path + ".saving"
        if rank0 and os.path.exists(work):   # a preempted save's remnant
            shutil.rmtree(work)
        self._save_barrier()
        if rank0:
            os.makedirs(os.path.join(work, "params"), exist_ok=True)
            os.makedirs(os.path.join(work, "opt"), exist_ok=True)
        # a DistributedStore's shards are written by their ranks, into the
        # directory rank 0 has just made
        self._save_barrier()
        meta = {"format": FORMAT, "step": self.step_counter,
                "seed": self.seed, "params": {}, "opt": [],
                "ps_tables": [], "manifest": {}}

        def persist(rel, host_val):
            fp = os.path.join(work, rel)
            np.save(fp, host_val)
            meta["manifest"][rel] = os.path.getsize(fp)

        for i, (n, hv) in enumerate(self._vars_host()):
            fn = f"p{i}.npy"
            if rank0:
                persist(os.path.join("params", fn), hv)
            meta["params"][self.var_names[n]] = fn
        for k, op in enumerate(self.opt_states):
            named = self._named_opt_state(op, self._opt_state_host(op))
            leaves = {}
            for j, (kpath, leaf) in enumerate(flatten_with_path(named)):
                fn = f"o{k}_{j}.npy"
                if rank0:
                    persist(os.path.join("opt", fn), leaf)
                leaves[keystr(kpath)] = fn
            meta["opt"].append({"name": op.name, "leaves": leaves})
        for i, node in enumerate(self._ps_table_sites()):
            fn = f"ps{i}.bin"
            # a DistributedStore suffixes its shard (.shard<rank>): every
            # rank writes its own; a plain store's one file, rank 0
            if rank0 or hasattr(node.store, "server"):
                node.store.save(node.table, os.path.join(work, fn))
            meta["ps_tables"].append({"file": fn, "node": node.name})
        meta["dataloaders"] = [
            {split: dl.state_dict() for split, dl in op.dataloaders.items()}
            for op in self._dataloader_sites()]
        # every rank's shard files are written before rank 0 publishes
        self._save_barrier()
        if rank0:
            tmp = os.path.join(work, "meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)
            os.replace(tmp, os.path.join(work, "meta.json"))
            if os.path.exists(path):
                # two renames (a directory cannot be os.replace'd): a cut
                # between them leaves the old copy at .replaced
                old = path + ".replaced"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.rename(path, old)
                os.rename(work, path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(work, path)
        self._save_barrier()

    # -- load ----------------------------------------------------------------

    def load(self, path, file=None, consider_splits=False,
             params_only=False):
        """Restore a checkpoint: a ``hetu_tpu.ckpt.v1`` directory (either
        package's), or the pickle blob ``file``.  ``params_only=True`` is
        the warm start: parameters and PS rows by name, and the step
        counter, optimizer state and dataloader cursors kept fresh."""
        meta_path = os.path.join(path, "meta.json") \
            if os.path.isdir(path) else None
        if file is None and meta_path and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self._load_dir(path, meta, params_only)
            return
        if os.path.isdir(path):
            path = os.path.join(path, file or "checkpoint.hetu")
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self.load_dict(blob["params"])
        if params_only:
            return
        ops = list(self.opt_states)
        by_name = {op.name: op for op in ops}
        blob_states = list(blob.get("opt_states", {}).items())
        matched = [by_name.get(name) for name, _ in blob_states]
        if not any(op is not None for op in matched) \
                and len(blob_states) == len(ops):
            # generated OptimizerOp names carry a process-global counter,
            # so a rebuilt graph never matches by name: graph order then
            matched = ops
        for op, (_, st) in zip(matched, blob_states):
            if op is not None:
                self.opt_states[op] = self._place_opt_tree(
                    op, self._maybe_transcode_loaded_opt(op, st),
                    self.opt_states[op])
        self.step_counter = blob.get("step", 0)

    def _load_ps_tables(self, path, meta):
        entries = {e["file"] for e in meta["ps_tables"]}
        for i, node in enumerate(self._ps_table_sites()):
            fn = f"ps{i}.bin"
            if fn in entries:
                node.store.load(node.table, os.path.join(path, fn))
        # each rank loads the shards it serves: no rank pulls before all
        # of them are back
        if meta["ps_tables"]:
            self._save_barrier()

    def _load_dir(self, path, meta, params_only):
        by_name = {self.var_names[n]: n for n in self.var_values}
        zero3 = {}
        for name, fn in meta["params"].items():
            node = by_name.get(name)
            if node is None:
                continue
            val = np.load(os.path.join(path, "params", fn))
            if node in self._zero_covered:   # one write a bucket
                zero3[name] = val
            else:
                self.var_values[node] = self._place(val)
        if zero3:
            self.load_dict(zero3)
        self._load_ps_tables(path, meta)
        if params_only:
            return
        # optimizers match by ordinal, leaves by their named key string
        for entry, op in zip(meta["opt"], list(self.opt_states)):
            named_live = self._named_opt_state(op, self.opt_states[op])
            host, missed = [], []
            for kpath, old in flatten_with_path(named_live):
                fn = entry["leaves"].get(keystr(kpath))
                if fn is None:
                    missed.append(keystr(kpath))
                    host.append(_to_host(old))
                else:
                    host.append(np.load(os.path.join(path, "opt", fn)))
            if missed and entry["leaves"]:
                warnings.warn(
                    f"checkpoint optimizer state for '{op.name}': "
                    f"{len(missed)}/{len(host)} live leaves absent from "
                    f"the checkpoint (e.g. {missed[0]}) — keeping existing "
                    f"values. A ZeRO stage or bucket-layout mismatch "
                    f"between save and load resumes with fresh moments.")
            tree = unflatten_like(named_live, host)
            if not missed:
                tree = self._maybe_transcode_loaded_opt(op, tree)
            self.opt_states[op] = self._place_opt_tree(
                op, self._unname_opt_state(op, tree), self.opt_states[op])
        for op, states in zip(self._dataloader_sites(),
                              meta.get("dataloaders", [])):
            for split, st in states.items():
                if split in op.dataloaders:
                    op.dataloaders[split].load_state(st)
        self.step_counter = meta.get("step", 0)

    # -- auto-save, resume, preemption ------------------------------------------

    def _post_step(self, training):
        """Step-boundary hooks: the periodic auto-save, the chaos
        schedule's step clock, the PS redundancy repair tick and a
        deferred preemption save."""
        if training:
            if self.auto_save_dir and self.auto_save_every > 0 \
                    and self.step_counter % self.auto_save_every == 0:
                self._auto_save()
            inj = _chaos_active()
            if inj is not None:
                # after the auto-save: ``kill:ps@rank<r>:step<s>`` is
                # "step s completed and was saved, then the server died"
                inj.on_step(self.step_counter)
            self._tick_re_replication()
        if self._preempt_signum is not None:
            self._handle_preemption()

    def _tick_re_replication(self):
        """Every ``HETU_PS_REREPLICATE_EVERY`` training steps (0, the
        default, is off): each replicated store the graphs' PS embeddings
        use tries to restore the backup of a shard that failed over onto
        its relaunched holder; a still-dead target defers
        (``ps_re_replicate_deferred``) to the next tick."""
        every = int(os.environ.get("HETU_PS_REREPLICATE_EVERY", "0"))
        if every <= 0 or self.step_counter % every != 0:
            return
        seen = set()
        for se in self.subexecutors.values():
            for node in getattr(se, "ps_nodes", []):
                store = getattr(node, "store", None)
                if store is None or id(store) in seen \
                        or not hasattr(store, "maybe_re_replicate"):
                    continue
                seen.add(id(store))
                store.maybe_re_replicate()

    def _auto_save(self):
        """One checkpoint of the current step under ``auto_save_dir``
        (idempotent a step), then keep-last-N retention."""
        d = self.auto_save_dir
        if not d:
            return None
        final = os.path.join(d, f"ckpt-{self.step_counter:08d}")
        if not os.path.exists(os.path.join(final, "meta.json")):
            os.makedirs(d, exist_ok=True)
            self.save(final)
            record_fault("auto_save")
            self._prune_auto_saves()
        return final

    def _prune_auto_saves(self):
        if not self._rank0:
            return                      # rank 0 owns retention
        cands = sorted(p for p in glob.glob(
            os.path.join(self.auto_save_dir, "ckpt-*"))
            if os.path.isdir(p) and not p.endswith((".saving",
                                                    ".replaced")))
        complete = [p for p in cands if self._checkpoint_complete(p)]
        for stale in complete[:-max(1, self.auto_save_keep)]:
            shutil.rmtree(stale, ignore_errors=True)

    @staticmethod
    def _checkpoint_complete(path):
        """Complete iff ``meta.json`` parses, declares the format, and
        every file it names exists at its manifest size."""
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if not str(meta.get("format", "")).startswith("hetu_tpu.ckpt"):
            return False
        manifest = meta.get("manifest", {})
        names = [os.path.join("params", fn)
                 for fn in meta.get("params", {}).values()]
        for entry in meta.get("opt", []):
            names += [os.path.join("opt", fn)
                      for fn in entry.get("leaves", {}).values()]
        for rel in names:
            fp = os.path.join(path, rel)
            if not os.path.exists(fp):
                return False
            want = manifest.get(rel)
            if want is not None and os.path.getsize(fp) != want:
                return False
        for entry in meta.get("ps_tables", []):
            if not glob.glob(os.path.join(path, entry["file"]) + "*"):
                return False
        return True

    def resume(self, path_or_dir):
        """Restore the newest complete checkpoint for an exact
        continuation.  ``path_or_dir``: one checkpoint directory, or an
        auto-save directory of ``ckpt-<step>`` entries (the newest
        complete one wins; incomplete ones are counted and skipped; the
        ``.saving`` / ``.replaced`` remnants of a cut save are probed at
        lower priority than a published checkpoint of the same step).
        Returns the restored step, or None when nothing loads."""
        self._drain_async()
        def attempt(cand, count_incomplete=False):
            if not os.path.isdir(cand):
                return False
            if not self._checkpoint_complete(cand):
                if count_incomplete:
                    record_fault("ckpt_incomplete_skipped")
                    warnings.warn(f"skipping incomplete checkpoint {cand}",
                                  RuntimeWarning)
                return False
            self.load(cand)
            record_fault("resume")
            return True

        for cand in (path_or_dir, str(path_or_dir) + ".saving",
                     str(path_or_dir) + ".replaced"):
            if os.path.exists(os.path.join(cand, "meta.json")) \
                    and attempt(cand):
                return self.step_counter
        if os.path.isdir(path_or_dir):
            def order(c):
                m = re.search(r"ckpt-(\d+)", os.path.basename(c))
                published = not c.endswith((".saving", ".replaced"))
                return (int(m.group(1)) if m else -1, published)

            for cand in sorted(glob.glob(os.path.join(path_or_dir,
                                                      "ckpt-*")),
                               key=order, reverse=True):
                # an incomplete .saving remnant is what a cut save leaves
                if attempt(cand, count_incomplete=not cand.endswith(
                        (".saving", ".replaced"))):
                    return self.step_counter
        return None

    def _install_signal_handlers(self):
        """SIGTERM / SIGINT → one emergency save, then the previous
        disposition (chained, not replaced).  Main thread only.  The
        handler holds only a weak reference to the executor."""
        import signal
        import threading
        import weakref
        if threading.current_thread() is not threading.main_thread():
            return
        ref = weakref.ref(self)
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.getsignal(sig)

                def handler(signum, frame, _ref=ref, _prev=prev):
                    ex = _ref()
                    if ex is not None:
                        return ex._on_preempt(signum, frame)
                    if callable(_prev):
                        return _prev(signum, frame)
                    if _prev == signal.SIG_IGN:
                        return
                    if signum == signal.SIGINT:
                        raise KeyboardInterrupt
                    raise SystemExit(128 + signum)

                signal.signal(sig, handler)
                self._prev_handlers[sig] = prev
                self._installed_handlers[sig] = handler
            except (ValueError, OSError):
                pass

    def uninstall_signal_handlers(self):
        """Restore the previous SIGTERM / SIGINT dispositions where this
        executor's handler is still the installed one."""
        import signal
        for sig, h in list(self._installed_handlers.items()):
            try:
                if signal.getsignal(sig) is h:
                    signal.signal(sig, self._prev_handlers[sig])
            except (ValueError, OSError):
                pass
            self._installed_handlers.pop(sig, None)

    def _on_preempt(self, signum, frame):
        self._preempt_signum = signum
        if not self._in_step:
            self._handle_preemption()
        # else: the running step finishes, and _post_step saves at the
        # boundary where parameters, state and step agree

    def _handle_preemption(self):
        import signal
        signum, self._preempt_signum = self._preempt_signum, None
        record_fault("emergency_save")
        try:
            # under a strategy save() is collective, and a signal that
            # reached one rank would hang it: the periodic saves cover that
            if self.auto_save_dir and self.dp is None:
                self._auto_save()
        finally:
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, None)
            elif prev == signal.SIG_IGN:
                pass
            elif signum == signal.SIGINT:
                raise KeyboardInterrupt
            else:
                raise SystemExit(128 + signum)

    def __del__(self):
        if getattr(self, "_installed_handlers", None):
            try:
                self.uninstall_signal_handlers()
            except Exception:
                pass


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def _transcode_opt_state(tree, old_plan, new_plan):
    """One optimizer's host state re-laid from ``old_plan``'s ZeRO slabs
    into ``new_plan``'s (unpack to parameters, re-pack): bitwise."""
    from ..parallel import zero as _zero
    old_keys = frozenset(b.key for b in old_plan.buckets)
    new_keys = frozenset(new_plan.param_keys)

    def walk(t):
        if not isinstance(t, dict):
            return t
        keys = frozenset(t)
        if keys == old_keys:
            flat = {}
            for b in old_plan.buckets:
                flat.update(_zero.host_unpack_slab(np.asarray(t[b.key]), b))
            t, keys = flat, frozenset(flat)
        if keys == new_keys:
            return {b.key: _zero.host_pack_slab(t, b)
                    for b in new_plan.buckets}
        return {k: walk(v) for k, v in t.items()}

    return walk(tree)
