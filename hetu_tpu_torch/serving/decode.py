"""Continuous-batching autoregressive decode over device-resident KV caches
(twin of ``hetu_tpu/serving/decode.py``).

* **Incremental KV cache.**  Each decode step feeds one token per
  sequence through the q_len=1 attention entry
  (:func:`~hetu_tpu_torch.ops.sdpa_decode_op`; on the GPU the
  hand-written flash kernel) against per-layer caches of shape
  ``(batch_bucket, heads, len_bucket, head_dim)`` that live on the device
  for the whole generation.  The step writes the new rows into the cache
  tensors in place (``kv_cache_append_op``), where the JAX package
  donates them to XLA.

* **Bucketed growth.**  The batch dim and the cache length walk the
  :func:`~hetu_tpu_torch.serving.default_buckets` ladder; a growth
  re-allocates the caches once (``decode_batch_grows`` /
  ``decode_len_grows``).

* **Continuous batching.**  Sequences join and leave the in-flight batch
  per token: a request takes a free KV slot at the next step boundary and
  a finished sequence frees its slot at once (``decode_slot_recycles``).
  Without a chunked entry, prompts are ingested one token per step
  (``decode_prefill_rows``).

* **Chunked prefill.**  With a ``chunked=`` graph entry
  (:func:`~hetu_tpu_torch.models.gpt2_decode_chunked_graph`) prompt
  ingestion consumes up to C tokens per sequence per step through the
  q_len=C attention entry (:func:`~hetu_tpu_torch.ops.sdpa_prefill_op`; on
  the GPU the full-mask flash kernel): a P-token prompt costs
  ``ceil(P/C)`` steps instead of P.  Chunk sizes walk their own ladder; a
  step's chunk is the smallest bucket covering the largest prompt
  remainder, generating rows ride along with their one token at column
  0, and a step where no row is past its prompt skips the logits copy to
  the host (``decode_logits_skipped``).  Single-token steps keep the
  q_len=1 entry.  Masked cache writes keep the KV rows equal to the
  token-by-token path's at every chunk boundary.

* **Greedy and batch-independent.**  Each slot attends only to its own
  cache rows ``0..position``, and selection is host ``np.argmax`` over the
  fetched logits row (first maximum wins, as in the JAX package).

* **Per-token streaming** through :class:`DecodeStream` futures, with
  explicit backpressure (:class:`~hetu_tpu_torch.serving.ServeRejected`).

* **Shared-prefix KV reuse.**  With a ``prefix_store=``
  (:class:`~hetu_tpu_torch.serving.PrefixKVStore`) the engine snapshots
  each prompt's KV rows (a clone: the caches are written in place) at its
  first generated token and seats a later request whose prompt extends a
  stored prefix with those rows copied into its slot: the shared part's
  prefill is skipped (``prefix_cache_hits`` / ``prefix_cache_hit_rows``).

* **Keyed dispatch.**  Every step resolves its closure through a
  :class:`~hetu_tpu_torch.graph.run_plan.KeyedPlanCache`, one key per
  (batch, len) bucket pair and one per (batch, chunk, len) triple, so
  ``plan_cache_hit`` shows the steady state as in the JAX package.

* **Exactly-once stream recovery.**  A stream's host-side token list is
  its replay journal: when a fleet replica dies mid-generation,
  :meth:`DecodeRouter.detach_inflight` turns each seated sequence into a
  continuation request (the original prompt plus the journal as the new
  prompt, the remaining ``max_new``, the same stream and deadline) that a
  survivor re-ingests, prefix store first.  The detach bumps the stream's
  replay epoch, which fences every late emission of the dead replica:
  resolved ``token(i)`` futures never fire again, and greedy selection
  over the replayed history continues the stream as an unkilled run would.

* **Fleet replica contract.**  :class:`DecodeRouter` has the surface
  :class:`~hetu_tpu_torch.serving.FrontDoor` drives (``pending``,
  ``pending_steps``, ``health()``, ``stop_admitting`` / ``drain``,
  ``detach_queue`` / ``detach_inflight`` / ``adopt``, ``kill``) and the
  request-level mode (``continuous=False``, ``max_wait_ms``).

Not ported: tensor-parallel plans (``plan=``), and the chaos, race,
protocol-trace and tracer hooks (``HETU_CHAOS`` set is refused by name).

Threading: the router's loop thread owns the engine (slots, caches); the
queue and the seated-request mirror hand off under ``DecodeRouter._cv``
and each stream has its own lock.  Neither lock is held across a device
call or while taking the other.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..graph.run_plan import KeyedPlanCache
from ..metrics import (record_decode, record_decode_latency,
                       record_decode_recovery)
from .executor import InferenceExecutor, default_buckets
from .router import ServeRejected, refuse_chaos


class DecodeStream:
    """Per-request handle: tokens stream out as the engine emits them.

    ``token(i)`` returns a Future for the i-th generated token (failed
    with ``IndexError`` if generation finishes before ``i`` tokens).
    Iterating yields tokens until the sequence finishes.
    ``result(timeout)`` blocks for the full token list.  A router or
    engine failure fails every outstanding future and ``result()`` with
    the same exception.

    The host-side token list is the replay journal of stream recovery:
    ``_detach`` bumps the replay epoch atomically with a snapshot of the
    journal, and every engine-side mutation carries the epoch its request
    was built under, so a stale replica cannot fire a resolved future
    again or deliver a token twice."""

    def __init__(self, prompt_len, max_new_tokens):
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self._lock = threading.Lock()
        self._futs = []
        self._tokens = []
        self._epoch = 0
        self._final = Future()

    # -- consumer side -----------------------------------------------------

    def token(self, i):
        """Future for the ``i``-th generated token."""
        i = int(i)
        with self._lock:
            done_short = self._final.done() and i >= len(self._tokens)
            while len(self._futs) <= i:
                self._futs.append(Future())
            fut = self._futs[i]
        if done_short and fut.set_running_or_notify_cancel():
            # the sequence already finished with fewer tokens: a future
            # created now would otherwise never resolve
            fut.set_exception(IndexError(
                f"generation finished after {len(self._tokens)} tokens"))
        return fut

    def result(self, timeout=None):
        """Block for the complete generated-token list."""
        return self._final.result(timeout)

    @property
    def done(self):
        return self._final.done()

    @property
    def n_tokens(self):
        with self._lock:
            return len(self._tokens)

    @property
    def epoch(self):
        """Current replay epoch (bumped once per detach)."""
        with self._lock:
            return self._epoch

    def partial(self):
        """The tokens generated so far (a copy of the journal); a
        ``recovery_exhausted`` failure carries it."""
        with self._lock:
            return list(self._tokens)

    def __iter__(self):
        i = 0
        while True:
            try:
                yield self.token(i).result()
            except Exception:
                # IndexError past the end, cancellation, or the engine's
                # failure — iteration stops; result() re-raises failures
                return
            i += 1

    # -- engine side (router loop thread only) -----------------------------

    def _detach(self):
        """Bump the replay epoch and snapshot the journal atomically.
        Returns ``(new_epoch, journal)``."""
        with self._lock:
            self._epoch += 1
            return self._epoch, list(self._tokens)

    def _emit(self, tok, epoch=None):
        """Deliver one token.  A stale ``epoch`` (the stream migrated
        away) is a no-op returning False; otherwise returns the journal
        length after the append (1: the stream's first token ever)."""
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return False
            while len(self._futs) <= len(self._tokens):
                self._futs.append(Future())
            fut = self._futs[len(self._tokens)]
            self._tokens.append(int(tok))
            count = len(self._tokens)
        # resolve outside the lock: a consumer's done-callback runs here
        if fut.set_running_or_notify_cancel():
            fut.set_result(int(tok))
        return count

    def _finish(self, epoch=None):
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return False
            tokens = list(self._tokens)
            extra = self._futs[len(tokens):]
        for f in extra:
            if f.set_running_or_notify_cancel():
                f.set_exception(IndexError(
                    f"generation finished after {len(tokens)} tokens"))
        if self._final.set_running_or_notify_cancel():
            self._final.set_result(tokens)
        return True

    def _fail(self, exc, epoch=None):
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return False
            pending = self._futs[len(self._tokens):]
        for f in pending:
            if f.set_running_or_notify_cancel():
                f.set_exception(exc)
        if self._final.set_running_or_notify_cancel():
            self._final.set_exception(exc)
        return True


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "stream", "t_arrival",
                 "fid", "deadline", "epoch", "retries", "detached_ts")

    def __init__(self, prompt, max_new, eos_id, fid=None, deadline=None):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.stream = DecodeStream(len(prompt), max_new)
        self.t_arrival = time.monotonic()
        self.fid = fid             # the JAX package's flow id; no tracer here
        self.deadline = deadline   # absolute monotonic, or None
        self.epoch = 0             # stream replay epoch this req emits under
        self.retries = 0           # continuation builds for this stream
        self.detached_ts = None    # set on continuations: detach time


def _continuation(req):
    """Continuation request for a detached in-flight stream: the original
    prompt plus the emitted-token journal is the new prompt, ``max_new``
    shrinks to the remaining budget, and the same stream travels along,
    resuming at the next token index.  The journal snapshot and the epoch
    bump are one atomic operation (``DecodeStream._detach``)."""
    stream = req.stream
    epoch, journal = stream._detach()
    base = np.asarray(req.prompt, np.int32)[:stream.prompt_len]
    cont = _DecodeRequest.__new__(_DecodeRequest)
    cont.prompt = np.concatenate(
        [base, np.asarray(journal, np.int32)]) if journal else base
    cont.max_new = stream.max_new_tokens - len(journal)
    cont.eos_id = req.eos_id
    cont.stream = stream
    cont.t_arrival = req.t_arrival      # deadlines stay submit-anchored
    cont.fid = None
    cont.deadline = req.deadline
    cont.epoch = epoch
    cont.retries = req.retries + 1
    cont.detached_ts = time.monotonic()
    record_decode_recovery("decode_recovery_detached")
    if cont.retries > 1:
        record_decode_recovery("decode_recovery_retries")
    return cont


class _Sequence:
    """One in-flight sequence's slot state (router loop thread only)."""

    __slots__ = ("req", "ptr", "emitted", "t_last")

    def __init__(self, req):
        self.req = req
        self.ptr = 0          # next prompt index to consume
        self.emitted = 0
        self.t_last = time.monotonic()


class DecodeEngine:
    """KV-cache decode executor: slots, bucket ladders, the decode step.

    Built from :func:`~hetu_tpu_torch.models.gpt2_decode_graph`'s return
    value: ``feeds`` maps ``input_ids`` (B, 1) / ``positions`` (B,) /
    per-layer cache placeholders to nodes, ``logits`` is the (B, vocab)
    fetch, ``cache_fetches`` the appended caches in feed order.

    ``max_slots`` caps the in-flight batch; ``max_len`` caps the cache
    length (prompt + generated).  ``device`` is CUDA by default; the CPU
    only when asked for.  ``weights``: ``None`` (seeded init) or a
    ``{name: array}`` dict (:func:`hetu_tpu_torch.params_from_named_arrays`).

    ``chunked=`` takes a second graph entry ``(feeds, logits,
    cache_fetches)`` from
    :func:`~hetu_tpu_torch.models.gpt2_decode_chunked_graph` (same weight
    names, an extra ``valid`` feed).  Its executor is loaded from the
    primary executor's parameters, never initialised on its own, so both
    entries serve the same weight tensors; a variable the primary lacks
    raises.  ``max_chunk`` caps the chunk ladder (default
    ``min(32, max_len)``).  ``validate`` (``'error'``, ``'warn'``,
    ``'off'``) is each entry's ``InferenceExecutor(validate=,
    decode=True)``.  ``prefix_store=`` takes a
    :class:`~hetu_tpu_torch.serving.PrefixKVStore` for shared-prefix KV
    reuse (one store may serve several engines).

    Not thread-safe by design: the owning :class:`DecodeRouter` loop
    thread (or a single test thread) makes every call after construction.
    """

    def __init__(self, feeds, logits, cache_fetches, weights=None, *,
                 max_slots=8, max_len=128, seed=0, device=None, plan=None,
                 validate="error", chunked=None, max_chunk=None,
                 prefix_store=None):
        if plan is not None:
            raise NotImplementedError("DecodeEngine(plan=) is not ported")
        # float32 products in full float32, as the JAX decode graph
        torch.backends.cuda.matmul.allow_tf32 = False
        self.iex = InferenceExecutor(
            [logits] + list(cache_fetches), weights=weights,
            buckets=default_buckets(max_slots), seed=seed, device=device,
            validate=validate, decode=True)
        self.device = self.iex.device
        self.max_len = int(max_len)
        self.batch_ladder = self.iex.buckets
        self.len_ladder = default_buckets(self.max_len)
        self.cache_names = [n for n in feeds
                            if n not in ("input_ids", "positions")]
        # feed name -> executor feed key
        self._fk = {name: self.iex._k(node) for name, node in feeds.items()}
        ck0 = feeds[self.cache_names[0]]
        self._heads, self._head_dim = ck0.shape[1], ck0.shape[3]
        self.ciex = None
        self.chunk_ladder = (1,)
        self.chunk_top = 1
        self.prefix = prefix_store
        if chunked is not None:
            cfeeds, clogits, ccaches = chunked
            # the chunked executor serves the primary's weight tensors:
            # built on its own it would draw every variable from a seed
            # folded over a different topo order
            w = {self.iex.var_names[n]: self.iex.params[self.iex._k(n)]
                 for n in self.iex.var_nodes}
            self.ciex = InferenceExecutor(
                [clogits] + list(ccaches), weights=w,
                buckets=default_buckets(max_slots), seed=seed,
                device=self.device, strict=True, validate=validate,
                decode=True)
            top = int(max_chunk) if max_chunk else min(32, self.max_len)
            self.chunk_ladder = tuple(default_buckets(max(2, top)))
            self.chunk_top = self.chunk_ladder[-1]
            self._cfk = {name: self.ciex._k(node)
                         for name, node in cfeeds.items()}
        # dispatch plans: one per (batch, len) pair for the one-token
        # entry and one per (batch, chunk, len) triple for the chunked one
        self._plans = KeyedPlanCache(
            max_entries=(len(self.batch_ladder) * len(self.len_ladder)
                         * (1 + len(self.chunk_ladder))))
        self.bb = self.batch_ladder[0]
        self.lb = self.len_ladder[0]
        self.slots = [None] * self.bb
        self._used = [False] * self.bb       # slot served a sequence before
        self.tokens = np.zeros(self.bb, np.int32)
        self.positions = np.zeros(self.bb, np.int32)
        self.caches = {name: self._alloc(self.bb, self.lb)
                       for name in self.cache_names}
        self._note_kv_bytes()

    # -- memory ------------------------------------------------------------

    def _alloc(self, bb, lb):
        return torch.zeros((bb, self._heads, lb, self._head_dim),
                           dtype=torch.float32, device=self.device)

    @property
    def kv_bytes(self):
        return sum(c.numel() * c.element_size() for c in self.caches.values())

    def _note_kv_bytes(self):
        record_decode("decode_kv_bytes_hw", self.kv_bytes)

    # -- capacity ----------------------------------------------------------

    @property
    def active(self):
        return sum(1 for s in self.slots if s is not None)

    @property
    def idle(self):
        return self.active == 0

    def capacity(self):
        """Free sequence slots, counting batch-ladder headroom."""
        return self.batch_ladder[-1] - self.active

    # -- bucket growth -----------------------------------------------------

    @staticmethod
    def _next_bucket(ladder, cur):
        for b in ladder:
            if b > cur:
                return b
        return None

    def _grow_batch(self):
        nb = self._next_bucket(self.batch_ladder, self.bb)
        if nb is None:
            raise RuntimeError(f"no free slot at max batch bucket {self.bb}")
        pad = nb - self.bb
        self.caches = {
            name: torch.cat([c, self._alloc(pad, self.lb)], dim=0)
            for name, c in self.caches.items()}
        self.slots += [None] * pad
        self._used += [False] * pad
        self.tokens = np.concatenate([self.tokens, np.zeros(pad, np.int32)])
        self.positions = np.concatenate([self.positions,
                                         np.zeros(pad, np.int32)])
        self.bb = nb
        record_decode("decode_batch_grows")
        self._note_kv_bytes()

    def _grow_len_if_needed(self, span=1):
        """Ensure the cache length bucket covers every active position
        plus the ``span`` rows about to be written (span > 1: a chunked
        step's write window; ``kv_cache_append_op`` clamps a start that
        would overrun the cache, which would shift the window onto wrong
        rows, so the bucket must cover it up front)."""
        need = max((int(self.positions[i]) for i, s in enumerate(self.slots)
                    if s is not None), default=-1) + int(span) - 1
        if need < self.lb:
            return
        lb = self.lb
        while lb <= need:
            lb = self._next_bucket(self.len_ladder, lb)
            if lb is None:
                raise RuntimeError(
                    f"cache position {need} exceeds max_len {self.max_len}")
            record_decode("decode_len_grows")
        pad = lb - self.lb
        self.caches = {
            name: torch.nn.functional.pad(c, (0, 0, 0, pad))
            for name, c in self.caches.items()}
        self.lb = lb
        self._note_kv_bytes()

    # -- join / leave ------------------------------------------------------

    def join(self, req):
        """Seat ``req`` in a free KV-cache slot (growing the batch bucket
        if every slot is taken); its first prompt token decodes at the
        next :meth:`step`.  With a prefix store, a prompt extending a
        stored prefix seats with its first ``m`` cache rows copied in
        (``ptr`` / ``positions`` start at ``m``): that prefill never
        runs.  A recycled slot's stale cache rows need no clearing: rows
        past the new sequence's position stay invisible and are
        overwritten before they become visible."""
        slot = next((i for i, s in enumerate(self.slots) if s is None),
                    None)
        if slot is None:
            self._grow_batch()
            slot = next(i for i, s in enumerate(self.slots) if s is None)
        m, rows = 0, None
        if self.prefix is not None:
            m, rows = self.prefix.lookup(req.prompt, device=self.device)
        seq = _Sequence(req)
        seq.ptr = m
        self.slots[slot] = seq
        self.tokens[slot] = req.prompt[m]
        self.positions[slot] = m
        if m:
            # the snapshot lands at rows 0..m-1: grow the length bucket
            # first
            self._grow_len_if_needed()
            for name in self.cache_names:
                self.caches[name][slot, :, :m, :].copy_(rows[name])
        if self._used[slot]:
            record_decode("decode_slot_recycles")
        self._used[slot] = True
        record_decode("decode_joins")
        if req.detached_ts is not None:
            # a migrated continuation: the journal replay is the prompt
            # suffix, less whatever the prefix store seated
            record_decode_recovery("decode_recovery_reseated")
            record_decode_recovery("decode_recovery_replayed_rows",
                                   max(0, len(req.prompt) - m))
            if m:
                record_decode_recovery("decode_recovery_prefix_assisted", m)
            record_decode_latency(
                "recovery", (time.monotonic() - req.detached_ts) * 1e6)
        else:
            record_decode_latency(
                "join_wait", (time.monotonic() - req.t_arrival) * 1e6)
        return slot

    def _clear(self, slot):
        self.slots[slot] = None
        self.tokens[slot] = 0
        self.positions[slot] = 0

    def _leave(self, slot):
        seq = self.slots[slot]
        self._clear(slot)
        record_decode("decode_leaves")
        seq.req.stream._finish(seq.req.epoch)

    def abort(self, exc):
        """Fail every in-flight stream and clear the batch (router close
        or a fatal step error).  Epoch-fenced: a stream the front door
        already migrated to a survivor ignores this replica's abort."""
        for i, seq in enumerate(self.slots):
            if seq is not None:
                self._clear(i)
                seq.req.stream._fail(exc, seq.req.epoch)

    def evict_expired(self, now=None):
        """Deadline eviction: a seated sequence whose deadline has passed
        leaves the batch now — its remaining futures fail with
        ``ServeRejected('deadline')`` and the slot frees for the next
        join.  Returns the number evicted."""
        now = time.monotonic() if now is None else now
        evicted = 0
        for i, seq in enumerate(self.slots):
            if seq is None or seq.req.deadline is None:
                continue
            if now >= seq.req.deadline:
                self._clear(i)
                record_decode("decode_leaves")
                record_decode("decode_deadline_evictions")
                seq.req.stream._fail(ServeRejected(
                    "deadline",
                    f"decode deadline passed after {seq.emitted} of "
                    f"{seq.req.max_new} tokens"), seq.req.epoch)
                evicted += 1
        return evicted

    # -- the decode step ---------------------------------------------------

    def _step_fn(self):
        """The step closure of the current (batch, len) bucket pair,
        through the keyed plan cache (a hit plans nothing)."""
        return self._plans.lookup((self.bb, self.lb),
                                  lambda: self.iex.compiled(self.bb))

    def _chunk_step_fn(self, chunk):
        """The chunked step closure of the current (batch, chunk, len)
        triple: a 3-tuple key in the same plan cache."""
        return self._plans.lookup((self.bb, chunk, self.lb),
                                  lambda: self.ciex.compiled(self.bb))

    def _pick_chunk(self, active):
        """Chunk bucket for this step: the smallest ladder bucket
        covering the largest per-row token demand (the prompt remainder
        of a mid-prompt row, 1 for a generating row), shrunk while the
        write window would overrun ``max_len``, then shrunk to the
        mixed-batch floor: every row of a chunked step computes q_len=C,
        so a generating row (1 useful token) wastes C-1 padded
        row-tokens, and the chunk shrinks while that waste exceeds the
        useful prefill volume (at least half the step's padded token
        volume must be prompt ingestion).  A lone prompt in an idle
        engine keeps the full chunk; a full batch of generators admitting
        one straggler prompt falls back toward the one-token entry.
        1 = run the one-token entry (no chunked graph, or nothing to
        chunk)."""
        if self.ciex is None:
            return 1
        want, gen = 1, 0
        for i in active:
            seq = self.slots[i]
            rem = len(seq.req.prompt) - seq.ptr
            if rem > want:
                want = rem
            if rem <= 1:
                gen += 1
        if want <= 1:
            return 1
        want = min(want, self.chunk_top)
        c = next(b for b in self.chunk_ladder if b >= want)
        maxp = max(int(self.positions[i]) for i in active)
        while c > 1 and maxp + c > self.max_len:
            c = max(b for b in self.chunk_ladder if b < c)
        pre = len(active) - gen
        while c > 1 and gen * (c - 1) > pre * c:
            c = max(b for b in self.chunk_ladder if b < c)
        return c

    def _emit_token(self, i, seq, tok, now):
        """Post-argmax bookkeeping shared by the one-token and chunked
        paths: counters, latency, the prefix snapshot, stream emission and
        the done check.  Returns 1 (one token emitted), or 0 when the
        stream's replay epoch fenced the emission: the stream migrated to
        a survivor while this replica was still stepping, so the stale
        seat is dropped without touching the stream."""
        count = seq.req.stream._emit(tok, seq.req.epoch)
        if count is False:
            self._clear(i)
            record_decode("decode_leaves")
            record_decode_recovery("decode_recovery_fenced")
            return 0
        seq.emitted += 1
        record_decode("decode_generate_rows")
        record_decode("decode_tokens")
        record_decode_latency("token", (now - seq.t_last) * 1e6)
        if count == 1:
            # the stream's first token ever, whichever replica delivers it
            record_decode_latency("ttft", (now - seq.req.t_arrival) * 1e6)
        if seq.emitted == 1 and self.prefix is not None:
            self._prefix_insert(i, seq)
        seq.t_last = now
        self.tokens[i] = tok
        done = (seq.emitted >= seq.req.max_new
                or (seq.req.eos_id is not None and tok == seq.req.eos_id))
        if not done and int(self.positions[i]) >= self.max_len:
            done = True     # cache exhausted: stop cleanly
        if done:
            self._leave(i)
        return 1

    def _prefix_insert(self, i, seq):
        """Snapshot slot ``i``'s prompt KV rows into the prefix store at
        the first generated token, when rows ``0..P-1`` hold exactly the
        prompt's KV.  Cloned: the slot's rows are written in place later
        and overwritten when the slot is reused."""
        p = len(seq.req.prompt)
        if p < self.prefix.min_tokens:
            return
        rows = {name: self.caches[name][i, :, :p, :].clone()
                for name in self.cache_names}
        self.prefix.insert(seq.req.prompt, rows)

    def step(self):
        """Decode ONE batch step: every active slot consumes its pending
        token(s), the caches take the new rows in place, rows past their
        prompt emit.  With a chunked entry, a step where some row still
        owes several prompt tokens runs the q_len=C chunked path
        (generating rows ride along); otherwise the one-token path runs.
        Returns the number of tokens emitted."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        chunk = self._pick_chunk(active)
        if chunk > 1:
            return self._step_chunked(active, chunk)
        self._grow_len_if_needed()
        fn = self._step_fn()
        t0 = time.perf_counter_ns()
        feeds = {
            self._fk["input_ids"]: torch.from_numpy(
                self.tokens.reshape(self.bb, 1).copy()).to(self.device),
            self._fk["positions"]: torch.from_numpy(
                self.positions.copy()).to(self.device),
        }
        for name in self.cache_names:
            feeds[self._fk[name]] = self.caches[name]
        outs = fn(self.iex.params, feeds)
        # the logits copy to the host is paid only when some row reads it
        if any(self.slots[i].ptr >= len(self.slots[i].req.prompt) - 1
               for i in active):
            logits = outs[0].cpu().numpy()
        else:
            logits = None
            record_decode("decode_logits_skipped")
        for name, new in zip(self.cache_names, outs[1:]):
            self.caches[name] = new
        record_decode("decode_steps")
        emitted = 0
        now = time.monotonic()
        for i in active:
            seq = self.slots[i]
            self.positions[i] += 1
            if seq.ptr < len(seq.req.prompt) - 1:
                # mid-prompt: next prompt token, nothing to emit yet
                seq.ptr += 1
                self.tokens[i] = seq.req.prompt[seq.ptr]
                record_decode("decode_prefill_rows")
                continue
            # greedy: the first maximum wins, as in the JAX package
            tok = int(np.argmax(logits[i]))
            seq.ptr = len(seq.req.prompt)
            emitted += self._emit_token(i, seq, tok, now)
        record_decode_latency("step", (time.perf_counter_ns() - t0) / 1e3)
        return emitted

    def _step_chunked(self, active, chunk):
        """One chunked-prefill step: each active row consumes up to
        ``chunk`` pending tokens (its prompt remainder, or its one
        generated token at column 0), the caches take a masked multi-row
        write, and only rows that finished their prompt read logits: a
        pure-prefill chunk skips the copy to the host."""
        self._grow_len_if_needed(span=chunk)
        fn = self._chunk_step_fn(chunk)
        t0 = time.perf_counter_ns()
        ids = np.zeros((self.bb, chunk), np.int32)
        valid = np.zeros(self.bb, np.int32)
        consume = {}
        emit_rows = []
        for i in active:
            seq = self.slots[i]
            rem = len(seq.req.prompt) - seq.ptr
            if rem > 0:
                n = min(rem, chunk)
                ids[i, :n] = seq.req.prompt[seq.ptr:seq.ptr + n]
            else:
                n = 1
                ids[i, 0] = self.tokens[i]
            valid[i] = n
            consume[i] = n
            if seq.ptr + n >= len(seq.req.prompt):
                emit_rows.append(i)
        feeds = {
            self._cfk["input_ids"]: torch.from_numpy(ids).to(self.device),
            self._cfk["positions"]: torch.from_numpy(
                self.positions.copy()).to(self.device),
            self._cfk["valid"]: torch.from_numpy(valid).to(self.device),
        }
        for name in self.cache_names:
            feeds[self._cfk[name]] = self.caches[name]
        outs = fn(self.ciex.params, feeds)
        if emit_rows:
            logits = outs[0].cpu().numpy()
        else:
            logits = None
            record_decode("decode_logits_skipped")
        for name, new in zip(self.cache_names, outs[1:]):
            self.caches[name] = new
        record_decode("decode_steps")
        record_decode("decode_prefill_steps")
        # steps saved against token-by-token ingestion: the widest row
        # would have needed max(consume) one-token steps; this is one
        record_decode("decode_prefill_steps_saved",
                      max(consume.values()) - 1)
        emitted = 0
        now = time.monotonic()
        for i in active:
            seq = self.slots[i]
            n = consume[i]
            self.positions[i] += n
            plen = len(seq.req.prompt)
            if seq.ptr + n < plen:
                # still mid-prompt after this chunk
                seq.ptr += n
                self.tokens[i] = seq.req.prompt[seq.ptr]
                record_decode("decode_prefill_rows", n)
                continue
            # the prompt finished this step (n-1 of the consumed tokens
            # were prefill rows, the last is the generate row) or the row
            # was already generating (n == 1, no prefill row)
            prefill_rows = (plen - seq.ptr - 1) if seq.ptr < plen else 0
            record_decode("decode_prefill_rows", prefill_rows)
            seq.ptr = plen
            tok = int(np.argmax(logits[i]))
            emitted += self._emit_token(i, seq, tok, now)
        record_decode_latency("step", (time.perf_counter_ns() - t0) / 1e3)
        return emitted


class DecodeRouter:
    """Bounded-queue continuous-batching front end for one
    :class:`DecodeEngine`.

    ``submit`` admits a prompt and returns a :class:`DecodeStream`; the
    loop thread seats waiting requests into free slots at every step
    boundary (``continuous=True``) and runs decode steps while any
    sequence is in flight.  ``continuous=False`` is the request-level
    mode: joins happen only into an EMPTY engine, after the
    arrival-anchored ``max_wait_ms`` fill window (the whole batch runs to
    completion first).  ``close()`` rejects the queue and fails in-flight
    streams with :class:`~hetu_tpu_torch.serving.ServeRejected`
    (``draining``).  ``name`` labels the replica behind a front door."""

    def __init__(self, engine, queue_limit=64, max_wait_ms=2.0,
                 continuous=True, start=True, name=""):
        refuse_chaos("DecodeRouter")
        self.engine = engine
        self.name = str(name)
        self.queue_limit = int(queue_limit)
        self.max_wait_ms = float(max_wait_ms)
        self.continuous = bool(continuous)
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._draining = False
        self._killed = False
        self._active_ct = 0     # loop's mirror of engine.active (under _cv)
        # the seated-request mirror (under _cv), updated at pop time in
        # _take_joins, before the step: a replica that wedges inside a
        # device call with an empty queue still reports its in-flight
        # batch, and detach_inflight rescues it without the loop thread
        self._seated = []
        now = time.monotonic()
        self.hb_ts = now          # loop heartbeat (under _cv)
        self.progress_ts = now    # last step that made progress (under _cv)
        self._thread = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._cv:
            if self._thread is not None or self._stop:
                return self
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hetu-decode-router")
            self._thread.start()
        return self

    def close(self, timeout=None):
        with self._cv:
            self._stop = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        for req in pending:
            req.stream._fail(
                ServeRejected("draining",
                              "router closed with the request queued"))
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"decode loop did not stop within {timeout} s")
        # the loop thread has exited: engine state is safe to touch here
        self.engine.abort(
            ServeRejected("draining", "router closed mid-generation"))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def queue_depth(self):
        with self._cv:
            return len(self._q)

    # -- fleet replica contract ----------------------------------------------

    @property
    def pending(self):
        """Queued + in-flight sequence count (``_active_ct`` is the loop's
        own mirror of ``engine.active``: no cross-thread engine read)."""
        with self._cv:
            return len(self._q) + self._active_ct

    def _queued_steps(self):
        # under _cv: a queued prompt costs ceil(prompt_len / chunk_top)
        # prefill steps; chunk_top does not change after construction
        ct = max(1, int(self.engine.chunk_top))
        return sum((len(r.prompt) + ct - 1) // ct for r in self._q)

    @property
    def pending_steps(self):
        """Estimated engine steps queued ahead of a new request: a queued
        prompt costs ``ceil(prompt_len / chunk_top)`` prefill steps
        (``prompt_len`` with no chunked entry), an in-flight sequence
        one."""
        with self._cv:
            return self._queued_steps() + self._active_ct

    def health(self):
        """Load, heartbeat and lifecycle flags in one lock hold, the shape
        of ``ServingRouter.health``."""
        with self._cv:
            q_steps = self._queued_steps()
            return {"pending": len(self._q) + self._active_ct,
                    "queued": len(self._q),
                    "inflight": self._active_ct,
                    "pending_steps": q_steps + self._active_ct,
                    "hb_ts": self.hb_ts,
                    "progress_ts": self.progress_ts,
                    "killed": self._killed,
                    "draining": self._draining,
                    "stopped": self._stop}

    def stop_admitting(self):
        """Graceful drain, step 1: new submits are rejected
        (``draining``) while the loop keeps decoding."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def drain(self, timeout=10.0):
        """Block until the queue is empty and every seated sequence
        finished.  Returns True when drained, False on timeout, a killed
        loop or one that never started."""
        deadline = time.monotonic() + float(timeout)
        with self._cv:
            while self._q or self._active_ct:
                if self._killed or self._thread is None:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            return True

    def detach_queue(self):
        """Remove and return every queued (not yet seated) request; the
        streams travel with them."""
        with self._cv:
            orphans = list(self._q)
            self._q.clear()
            self._cv.notify_all()
            return orphans

    def detach_inflight(self):
        """Remove and return every SEATED sequence as a continuation
        request (prompt + journal, the original arrival and deadline, the
        retry count bumped).  The journal snapshot bumps each stream's
        epoch, so this works on a wedged replica too: what its loop emits
        afterwards is fenced.  Streams already finished or migrated are
        skipped."""
        with self._cv:
            seated = list(self._seated)
            self._seated = []
            self._active_ct = 0
            self._cv.notify_all()
        return [_continuation(req) for req in seated
                if not req.stream.done and req.epoch == req.stream.epoch]

    def adopt(self, reqs):
        """Admit requests detached from another decode replica (queued
        orphans and continuations): arrival times and deadlines are kept,
        and ``queue_limit`` is bypassed (rescue must not reject admitted
        work).  Returns the count."""
        reqs = list(reqs)
        if not reqs:
            return 0
        with self._cv:
            if self._stop or self._killed:
                raise ServeRejected(
                    "draining", "cannot adopt into a stopped router")
            self._q.extend(reqs)
            self._cv.notify_all()
        return len(reqs)

    def kill(self):
        """Fail-stop: the loop exits at its next boundary without touching
        the queue or the seated streams; the front door rescues both
        (:meth:`detach_queue`, :meth:`detach_inflight`).  Streams nobody
        detaches are failed by :meth:`close`.  New submits are rejected
        (``draining``)."""
        with self._cv:
            self._killed = True
            self._cv.notify_all()

    # -- admission ---------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=16, eos_id=None,
               deadline_ms=None):
        """Admit one prompt (1-D int token ids); returns a
        :class:`DecodeStream`.  Raises ``ServeRejected`` when the queue
        is full (``queue_full``), the router is closed, draining or killed
        (``draining``), or the sequence cannot fit ``max_len``
        (``over_max_len``).

        ``deadline_ms``: completion budget from submit time.  A request
        still queued past it fails at seat time; a seated sequence that
        outlives it is evicted at the next step boundary."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new - 1 > self.engine.max_len:
            record_decode("decode_rejections")
            raise ServeRejected(
                "over_max_len",
                f"prompt {prompt.size} + {max_new} new tokens exceeds the "
                f"engine's max_len {self.engine.max_len}")
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        req = _DecodeRequest(prompt, max_new, eos_id, None, deadline)
        with self._cv:
            if self._stop or self._killed:
                record_decode("decode_rejections")
                raise ServeRejected("draining", "router is closed")
            if self._draining:
                record_decode("decode_rejections")
                raise ServeRejected("draining",
                                    "router is draining — not admitting")
            if len(self._q) >= self.queue_limit:
                record_decode("decode_rejections")
                raise ServeRejected(
                    "queue_full",
                    f"decode queue full ({self.queue_limit} waiting) — "
                    f"shed load upstream and retry")
            self._q.append(req)
            self._cv.notify()
        return req.stream

    # -- the loop ----------------------------------------------------------

    def _take_joins(self):
        """Requests to seat before the next step (empty: just step), or
        None at shutdown or kill.  Continuous mode joins at every step
        boundary; request-level mode only into an empty engine, after the
        arrival-anchored fill window."""
        with self._cv:
            while True:
                if self._stop or self._killed:
                    return None
                cap = self.engine.capacity()
                busy = not self.engine.idle
                if self._q and cap > 0 and (self.continuous or not busy):
                    if not self.continuous:
                        deadline = (self._q[0].t_arrival
                                    + self.max_wait_ms / 1e3)
                        while (len(self._q) < cap and not self._stop
                               and not self._killed):
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._cv.wait(left)
                        if self._stop or self._killed:
                            return None
                        cap = self.engine.capacity()
                    n = min(len(self._q), cap)
                    joins = [self._q.popleft() for _ in range(n)]
                    # mirrored at pop time, before the step: a loop that
                    # wedges inside the step still reports this work
                    self._seated.extend(joins)
                    self._active_ct = len(self._seated)
                    return joins
                if busy:
                    return []
                self.hb_ts = time.monotonic()   # an idle loop still beats
                self._cv.wait(0.05)

    def _loop(self):
        while True:
            joins = self._take_joins()
            if joins is None:
                # a kill leaves the seated streams and the mirror for the
                # front door's rescue; close() fails what nobody detached
                with self._cv:
                    self._cv.notify_all()
                return
            now = time.monotonic()
            for req in joins:
                if req.deadline is not None and now >= req.deadline:
                    # expired while queued: fail at seat time instead of
                    # burning a KV slot on a dead deadline
                    record_decode("decode_deadline_evictions")
                    req.stream._fail(ServeRejected(
                        "deadline",
                        "decode deadline passed waiting for a slot"),
                        req.epoch)
                    continue
                self.engine.join(req)
            emitted = 0
            if not self.engine.idle:
                try:
                    self.engine.evict_expired()
                    emitted = self.engine.step()
                except Exception as e:    # noqa: BLE001 — every in-flight
                    self.engine.abort(e)  # stream must learn its fate; the
                    #                       router keeps serving new work
            with self._cv:
                seated = [s.req for s in self.engine.slots if s is not None]
                active = len(seated)
                # a completed step with seated rows is progress; a wedged
                # step never gets here.  Seats of streams the door already
                # detached may re-enter the mirror: their emissions are
                # fenced and free the seat at the next emit
                progressed = bool(joins) or bool(emitted) \
                    or active != self._active_ct
                self._seated = seated
                self._active_ct = active
                now = time.monotonic()
                self.hb_ts = now
                if progressed or active:
                    self.progress_ts = now
                self._cv.notify_all()   # drain() waits on this


__all__ = ["DecodeEngine", "DecodeRouter", "DecodeStream"]
