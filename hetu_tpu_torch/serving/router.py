"""Request router: a bounded queue in front of an adaptive micro-batcher
(twin of ``hetu_tpu/serving/router.py``).

* **Bounded admission.**  ``submit`` enqueues one request and returns a
  ``concurrent.futures.Future``; a full queue raises
  :class:`ServeRejected` (``queue_full``) instead of growing.

* **Adaptive micro-batching.**  The batcher thread collects until
  ``max_batch`` requests wait or the OLDEST has waited ``max_wait_ms``
  since its arrival (a straggler ships alone after one window).  The batch
  is stacked, padded to the smallest legal bucket and run as one call of
  :meth:`~hetu_tpu_torch.serving.InferenceExecutor.infer_rows`, whose
  static scatter plan hands each request its own rows.

* **Failure semantics.**  A failed batch is retried once
  (``serve_batch_retries``); a second failure fails only that batch's
  futures, and the router keeps serving.  Futures are claimed with
  ``set_running_or_notify_cancel`` first, so a caller's cancel never
  kills the batcher.  ``close()`` rejects whatever is still queued.

* **Fleet replica contract.**  ``pending`` / ``health()``,
  ``stop_admitting()`` → ``drain()``, ``detach_queue()`` / ``adopt()``
  and ``kill()`` (fail-stop at the next batch boundary, the queue left
  for the front door's rescue), as :class:`~hetu_tpu_torch.serving.
  DecodeRouter` has them; a ``name`` suffixes the ``serve`` latency kinds
  (``batch@r0``) so the front door scores each replica.

* **PS embeddings.**  A graph served through a read-only
  ``DistCacheTable`` over a replicated store keeps answering through a
  killed shard primary (the failover is inside the batch's pull; the
  promotions a batch absorbed count as ``serve_failovers``), and
  ``refresh_every_batches=N`` runs the executor's staleness sweep
  (``refresh_embeddings``) after every N-th batch.

Not ported: the race and tracer hooks, and the chaos hooks of the serving
planes — the ``:req`` admission clock here and in ``FrontDoor``, the
``:tok`` token clock of ``DecodeRouter``, ``kill:replica`` — so a set
``HETU_CHAOS`` is refused by name by those three constructors.  The
injector itself (:mod:`hetu_tpu_torch.chaos`) is ported, and the PS path
(the store's transport, its servers, the executor's step clock, the
launcher) plays its schedules.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..metrics import (fault_counts, record_serve, record_serve_latency,
                       record_serve_rejection)


def refuse_chaos(who):
    """The serving planes' chaos hooks are not ported: a set
    ``HETU_CHAOS`` is refused by name rather than ignored."""
    if os.environ.get("HETU_CHAOS"):
        raise NotImplementedError(
            f"{who}: HETU_CHAOS is set, and the serving planes' chaos "
            f"hooks (the :req / :tok clocks, kill:replica) are not "
            f"ported — unset it")


class ServeRejected(RuntimeError):
    """Explicit backpressure: the request was NOT admitted — shed load
    upstream and retry later.

    Carries a structured ``reason`` from the closed taxonomy
    :attr:`REASONS` or the form ``shed:<class>``, the admission ``klass``
    when one applies, and ``partial``: the tokens already delivered when a
    decode stream could not be recovered (``recovery_exhausted``), else
    None.  Construction counts the reason into the
    ``serve_rejection_reason`` family."""

    REASONS = ("queue_full", "over_max_len", "deadline", "draining",
               "recovery_exhausted")

    def __init__(self, reason, detail="", klass=None, partial=None):
        reason = str(reason)
        if reason not in self.REASONS and not reason.startswith("shed:"):
            raise ValueError(
                f"unknown ServeRejected reason {reason!r} — taxonomy is "
                f"{list(self.REASONS)} or 'shed:<class>'")
        self.reason = reason
        self.klass = klass
        self.partial = partial
        record_serve_rejection(reason)
        super().__init__(f"{reason}: {detail}" if detail else reason)


class _Request:
    __slots__ = ("feeds", "future", "t_arrival")

    def __init__(self, feeds):
        self.feeds = feeds
        self.future = Future()
        self.t_arrival = time.monotonic()


class ServingRouter:
    """Bounded-queue micro-batching front end for one
    :class:`~hetu_tpu_torch.serving.InferenceExecutor` (see the module
    docstring).

    ``max_batch``: the largest batch packed (default and cap: the
    executor's largest bucket).  ``max_wait_ms``: how long the oldest
    waiting request may sit before its batch ships part-full.
    ``queue_limit``: the admission bound.  ``refresh_every_batches``: run
    the read-only embedding staleness sweep every N batches (0: never;
    call ``iex.refresh_embeddings()`` yourself).  ``start=False`` builds
    the router paused (call :meth:`start`).  ``name``: the replica label that
    suffixes the latency kinds."""

    def __init__(self, iex, max_batch=None, max_wait_ms=2.0,
                 queue_limit=256, refresh_every_batches=0, start=True,
                 name=""):
        refuse_chaos("ServingRouter")
        self.iex = iex
        self.refresh_every_batches = int(refresh_every_batches)
        self._batches = 0
        self.name = str(name)
        self.max_batch = min(int(max_batch or iex.max_batch), iex.max_batch)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait_ms = float(max_wait_ms)
        self.queue_limit = int(queue_limit)
        sfx = f"@{self.name}" if self.name else ""
        self._lat_queue_wait = "queue_wait" + sfx
        self._lat_batch = "batch" + sfx
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._draining = False
        self._killed = False
        self._inflight = 0
        now = time.monotonic()
        self.hb_ts = now          # batcher-loop heartbeat (under _cv)
        self.progress_ts = now    # last completed batch (under _cv)
        self._thread = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Start the batcher thread (idempotent)."""
        with self._cv:
            if self._thread is not None or self._stop:
                return self
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hetu-serve-router")
            self._thread.start()
        return self

    def close(self, timeout=None):
        """Stop the batcher; requests still queued are rejected
        (``draining``)."""
        with self._cv:
            self._stop = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        for req in pending:
            # claim first: a caller-cancelled future would raise
            # InvalidStateError and stop the rejection of the others
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    ServeRejected("draining",
                                  "router closed with the request queued"))
        if self._thread is not None:
            self._thread.join(timeout)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def queue_depth(self):
        with self._cv:
            return len(self._q)

    # -- fleet replica contract --------------------------------------------

    @property
    def pending(self):
        """Queued + in-flight requests: the front door's load signal."""
        with self._cv:
            return len(self._q) + self._inflight

    def health(self):
        """Load, heartbeat and lifecycle flags in one lock hold."""
        with self._cv:
            return {"pending": len(self._q) + self._inflight,
                    "queued": len(self._q),
                    "inflight": self._inflight,
                    "hb_ts": self.hb_ts,
                    "progress_ts": self.progress_ts,
                    "killed": self._killed,
                    "draining": self._draining,
                    "stopped": self._stop}

    def stop_admitting(self):
        """Graceful drain, step 1: new submits are rejected
        (``draining``) while the batcher keeps working the queue."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def drain(self, timeout=10.0):
        """Block until the queue is empty and no batch is in flight.
        Returns True when drained, False on timeout, a killed batcher or
        one that never started."""
        deadline = time.monotonic() + float(timeout)
        with self._cv:
            while self._q or self._inflight:
                if self._killed or self._thread is None:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            return True

    def detach_queue(self):
        """Remove and return every queued request, for :meth:`adopt` on a
        survivor."""
        with self._cv:
            orphans = list(self._q)
            self._q.clear()
            self._cv.notify_all()
            return orphans

    def adopt(self, reqs):
        """Admit requests detached from another replica: arrival times
        are kept (their deadlines anchor at the original arrival) and
        ``queue_limit`` is bypassed, since rescue must not reject
        admitted work.  Returns the count."""
        reqs = list(reqs)
        if not reqs:
            return 0
        with self._cv:
            if self._stop or self._killed:
                raise ServeRejected(
                    "draining", "cannot adopt into a stopped router")
            self._q.extend(reqs)
            record_serve("serve_queue_depth_hw", len(self._q))
            self._cv.notify_all()
        return len(reqs)

    def kill(self):
        """Fail-stop: the batcher exits at its next batch boundary without
        touching the queue (the front door rescues it); a batch already
        running completes.  New submits are rejected (``draining``)."""
        with self._cv:
            self._killed = True
            self._cv.notify_all()

    # -- admission ---------------------------------------------------------

    def submit(self, feed_dict):
        """Admit one single-sample request (``{placeholder: array}``
        without the batch dim).  Returns a Future resolving to one value
        per executor fetch: row ``i`` (or its ``k`` rows) of a per-row
        fetch, the whole value of a batch-invariant one."""
        req = _Request(feed_dict)
        with self._cv:
            if self._stop or self._killed:
                raise ServeRejected("draining", "router is closed")
            if self._draining:
                raise ServeRejected("draining",
                                    "router is draining — not admitting")
            if len(self._q) >= self.queue_limit:
                record_serve("serve_rejections")
                raise ServeRejected(
                    "queue_full",
                    f"request queue full ({self.queue_limit} waiting) — "
                    f"shed load upstream and retry")
            self._q.append(req)
            record_serve("serve_requests")
            record_serve("serve_queue_depth_hw", len(self._q))
            self._cv.notify()
        return req.future

    # -- batching ----------------------------------------------------------

    def _take_batch(self):
        """Block until work exists, then collect until ``max_batch``
        requests wait or the oldest has waited ``max_wait_ms`` since it
        ARRIVED (a request that already waited out a slow batch ships at
        once).  Returns the requests, or None at shutdown or kill."""
        with self._cv:
            while not self._q:
                if self._stop or self._killed:
                    return None
                self.hb_ts = time.monotonic()   # an idle loop still beats
                self._cv.wait(0.05)
            deadline = self._q[0].t_arrival + self.max_wait_ms / 1e3
            while len(self._q) < self.max_batch and not self._stop \
                    and not self._killed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            if self._killed:
                return None      # the queue stays for the rescue
            n = min(len(self._q), self.max_batch)
            reqs = [self._q.popleft() for _ in range(n)]
            self._inflight += n
            self.hb_ts = time.monotonic()
            return reqs

    def _loop(self):
        while True:
            reqs = self._take_batch()
            if reqs is None:
                return
            # requests grouped by feed schema: a malformed one fails only
            # its own group
            groups = {}
            for r in reqs:
                groups.setdefault(self._schema(r), []).append(r)
            for group in groups.values():
                self._run_batch(group)
            with self._cv:
                self._inflight -= len(reqs)
                now = time.monotonic()
                self.hb_ts = now
                self.progress_ts = now
                self._cv.notify_all()   # drain() waits on this

    @staticmethod
    def _schema(req):
        try:
            return tuple(sorted(
                (n.id, tuple(np.shape(v)), str(np.asarray(v).dtype))
                for n, v in req.feeds.items()))
        except Exception:
            return ("unstackable", id(req))

    def _run_batch(self, reqs):
        # claim each future so a later cancel() cannot race set_result;
        # cancelled requests drop out here
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        n = len(reqs)
        nodes = list(reqs[0].feeds)
        now = time.monotonic()
        for r in reqs:
            record_serve_latency(self._lat_queue_wait,
                                 (now - r.t_arrival) * 1e6)
        try:
            stacked = {node: np.stack(
                [np.asarray(r.feeds[node]) for r in reqs], 0)
                for node in nodes}
            before = fault_counts().get("ps_failover_promoted", 0)
            t_call = time.perf_counter_ns()
            try:
                outs, rows_per_req = self.iex.infer_rows(stacked)
            except Exception:     # noqa: BLE001 — one counted retry
                record_serve("serve_batch_retries")
                outs, rows_per_req = self.iex.infer_rows(stacked)
            record_serve_latency(self._lat_batch,
                                 (time.perf_counter_ns() - t_call) / 1e3)
            delta = fault_counts().get("ps_failover_promoted", 0) - before
            if delta:
                record_serve("serve_failovers", delta)
        except Exception as e:    # noqa: BLE001 — each request learns its
            for r in reqs:        # fate; the router keeps serving
                r.future.set_exception(e)
            return
        record_serve("serve_responses", n)
        for i, r in enumerate(reqs):
            row = []
            for o, k in zip(outs, rows_per_req):
                if k is None:
                    row.append(o)
                elif k == 1:
                    row.append(o[i])
                else:
                    row.append(o[i * k:(i + 1) * k])
            r.future.set_result(row)
        self._batches += 1
        if self.refresh_every_batches > 0 \
                and self._batches % self.refresh_every_batches == 0:
            try:
                self.iex.refresh_embeddings()
            except Exception:   # noqa: BLE001 — a refresh hiccup must
                pass            # not stop the router


__all__ = ["ServingRouter", "ServeRejected"]
