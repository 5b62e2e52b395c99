"""Fleet serving tier: replica sets behind one front door (twin of
``hetu_tpu/serving/fleet.py``).

* **Load-aware dispatch.**  Every admission picks the least-loaded live
  replica: its ``pending`` count (queued + in flight) first, then its
  recent per-batch cost (the ``batch@<name>`` serving latency kind,
  refreshed by the health sweep), then the lowest index.

* **Health ejection and re-admission.**  The sweep (time-gated, riding
  admissions and :meth:`FrontDoor.poll`; no thread of its own) ejects a
  replica that is killed, stopped or wedged (pending work, queued or
  seated, behind a stale heartbeat), rescues its queue onto a survivor
  (``detach_queue`` → ``adopt``) and re-admits a replica whose heartbeat
  returns.

* **Exactly-once stream recovery.**  Ejecting a decode replica also
  detaches its seated streams as continuation requests
  (``detach_inflight``: the journal replayed as the prompt suffix, the
  replay epoch bumped) and reseats them on the least-loaded survivor,
  prefix store first.  Resurrection is gated by a per-stream retry
  budget (``recovery_budget``), the door's deadline estimate of the
  re-prefill, and a survivor existing; a doomed stream fails fast with
  ``ServeRejected('recovery_exhausted')`` carrying
  ``DecodeStream.partial()``.

* **Admission control by class.**  Requests carry a class of
  :data:`CLASSES`; load (aggregate pending over the live replicas'
  bounded queues) sheds the lowest class first as
  ``ServeRejected('shed:<class>')``, and a deadline the estimated wait
  cannot meet is rejected at the door (``deadline``).

* **SLO autoscaling.**  :class:`SLOAutoscaler` grows the set when p99 or
  load runs hot and shrinks it when both run cold, through
  :class:`~hetu_tpu_torch.parallel.elastic.FlapDamper`'s consecutive-poll
  grace.

* **Graceful drain.**  ``scale_in`` / ``close`` stop admitting, hand the
  queue to a survivor, wait for in-flight work, then close.

Locking: the door owns one lock and never holds it across a replica's
``submit`` / ``drain`` / ``close``; replica reads under it nest door lock
→ router lock, and done-callbacks (router threads) take only the door
lock.

Not ported: the chaos ``kill:replica@…`` hooks (``HETU_CHAOS`` set is
refused by name) and the serve cache that makes a JAX scale-out a cache
hit.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..metrics import (record_decode_recovery, record_fleet,
                       record_serve_latency, serve_latency_stats)
from ..parallel.elastic import FlapDamper
from .router import ServeRejected, refuse_chaos

#: admission classes, highest priority first — overload sheds from the
#: BACK of this tuple (best_effort first, interactive never by default)
CLASSES = ("interactive", "batch", "best_effort")

#: default shed watermarks: fraction of aggregate healthy queue
#: capacity above which the class is shed (None = never shed, only the
#: hard queue_full bound applies)
DEFAULT_SHED_AT = {"interactive": None, "batch": 0.85, "best_effort": 0.5}


class _Replica:
    """One replica's record inside the front door: the router plus the
    door-side health state.  ``stop()`` fail-stops the router at its next
    batch boundary (queue and in-flight streams left for the rescue)."""

    __slots__ = ("idx", "router", "ejected", "draining", "cost_ms")

    def __init__(self, idx, router):
        self.idx = int(idx)
        self.router = router
        self.ejected = False
        self.draining = False
        #: recent per-batch device cost estimate (ms) — refreshed by the
        #: health sweep from the replica's serve_latency_us label
        self.cost_ms = 1.0

    def live(self):
        return not self.ejected and not self.draining

    def stop(self):
        self.router.kill()


class FrontDoor:
    """Replica-set front door: class-aware admission, least-loaded
    dispatch, health ejection/rescue, scale-out/in, graceful drain.

    ``make_replica(idx)`` builds one replica router (a
    :class:`~hetu_tpu_torch.serving.ServingRouter` or
    :class:`~hetu_tpu_torch.serving.DecodeRouter`, ideally with
    ``name=f"r{idx}"`` so per-replica latency kinds flow).

    ``shed_at``: {class: load-factor watermark} overriding
    :data:`DEFAULT_SHED_AT`.  ``class_deadline_ms``: {class: default
    deadline} applied when ``submit`` gets no explicit ``deadline_ms``.
    ``wedge_timeout_ms``: heartbeat staleness (with pending work) that
    ejects a replica.  ``health_every_ms``: sweep cadence (time-gated;
    sweeps ride admissions and ``poll``).  ``window``: end-to-end
    latency ring size behind :meth:`p99_ms`.  ``register_chaos`` is kept
    for the JAX package's signature; with no chaos injector in the port
    it does nothing (a set ``HETU_CHAOS`` is refused by name).
    ``forward_deadline_ms=True`` forwards the per-request deadline into
    ``replica.submit(..., deadline_ms=...)`` (decode replicas evict
    mid-generation); one-shot routers don't take the kwarg, so it
    defaults off.  ``recovery_budget``: how many times one in-flight
    decode stream may be resurrected across replica deaths before the
    door fails it with ``recovery_exhausted``.
    """

    def __init__(self, make_replica, n_replicas=1, *, shed_at=None,
                 class_deadline_ms=None, wedge_timeout_ms=1000.0,
                 health_every_ms=5.0, window=512, register_chaos=True,
                 forward_deadline_ms=False, recovery_budget=2):
        refuse_chaos("FrontDoor")
        self.make_replica = make_replica
        self.shed_at = dict(DEFAULT_SHED_AT)
        self.shed_at.update(shed_at or {})
        self.class_deadline_ms = {c: None for c in CLASSES}
        self.class_deadline_ms.update(class_deadline_ms or {})
        self.wedge_timeout_ms = float(wedge_timeout_ms)
        self.health_every_ms = float(health_every_ms)
        self.forward_deadline_ms = bool(forward_deadline_ms)
        self.recovery_budget = max(0, int(recovery_budget))
        self._lock = threading.Lock()
        self._replicas = []
        self._next_idx = 0
        self._admitted = 0
        self._closing = False
        self._last_sweep = 0.0
        self._lat_us = []               # end-to-end latency ring
        self._lat_cap = max(16, int(window))
        self._failures = 0
        for _ in range(max(1, int(n_replicas))):
            self.scale_out()

    # -- introspection -----------------------------------------------------

    @property
    def n_replicas(self):
        """Live (non-draining, non-ejected) replica count."""
        with self._lock:
            return sum(1 for r in self._replicas if r.live())

    @property
    def admitted(self):
        with self._lock:
            return self._admitted

    def p99_ms(self):
        """p99 of the end-to-end (submit → future done) latency ring —
        the number the SLO autoscaler steers on."""
        with self._lock:
            lat = list(self._lat_us)
        if not lat:
            return 0.0
        return float(np.percentile(np.asarray(lat, np.float64), 99)) / 1e3

    def reset_window(self):
        """Drop the latency ring — the autoscaler calls this after a
        resize so the next decision sees post-resize samples only."""
        with self._lock:
            self._lat_us = []

    def load_factor(self):
        """Aggregate pending work over aggregate queue capacity across
        healthy replicas (0.0 when none) — the shed watermarks and the
        autoscaler's load signal read this."""
        with self._lock:
            return self._load_factor_locked()

    def _load_factor_locked(self):
        cap = pend = 0
        for rep in self._replicas:
            if rep.live():
                cap += int(rep.router.queue_limit)
                pend += rep.router.pending
        return (pend / cap) if cap else 0.0

    def stats(self):
        """Snapshot for callers and tests: per-replica load + lifecycle, the
        door's latency window p99, load factor, admission count."""
        with self._lock:
            reps = [{"idx": r.idx, "pending": r.router.pending,
                     "cost_ms": round(r.cost_ms, 4),
                     "ejected": r.ejected, "draining": r.draining}
                    for r in self._replicas]
            admitted, failures = self._admitted, self._failures
        return {"replicas": reps, "p99_ms": self.p99_ms(),
                "load_factor": self.load_factor(),
                "admitted": admitted, "failures": failures}

    # -- health sweep ------------------------------------------------------

    def poll(self, now=None):
        """Force one health sweep (eject/rescue/re-admit).  The sweep
        also rides every admission (time-gated at ``health_every_ms``);
        this is the autoscaler's / a test's explicit handle."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._sweep_locked(now, force=True)

    def _sweep_locked(self, now, force=False):
        if not force and (now - self._last_sweep) * 1e3 < self.health_every_ms:
            return
        self._last_sweep = now
        lat_stats = None
        for rep in self._replicas:
            if rep.draining:
                continue
            snap = rep.router.health()
            if rep.ejected:
                # re-admission: a fresh heartbeat and no kill flag means
                # the loop recovered (a wedge that unwedged) — put the
                # replica back in dispatch
                if not snap["killed"] and not snap["stopped"] \
                        and (now - snap["hb_ts"]) * 1e3 \
                        < self.wedge_timeout_ms:
                    rep.ejected = False
                    record_fleet("fleet_replica_readmitted")
                continue
            hb_age_ms = (now - snap["hb_ts"]) * 1e3
            # pending covers queued + seated; pending_steps (decode)
            # additionally prices prompt backlogs — EITHER nonzero with
            # a stale heartbeat means live work behind a stuck loop (a
            # replica wedged mid-step with an empty queue still counts
            # its seated batch)
            stuck_work = snap["pending"] > 0 \
                or snap.get("pending_steps", 0) > 0
            wedged = stuck_work and hb_age_ms > self.wedge_timeout_ms
            if snap["killed"] or snap["stopped"] or wedged:
                rep.ejected = True
                record_fleet("fleet_replica_ejected")
                self._rescue_locked(rep)
                continue
            # refresh the dispatch cost estimate from the replica's own
            # latency kind
            name = getattr(rep.router, "name", "")
            if name:
                if lat_stats is None:
                    lat_stats = serve_latency_stats()
                st = lat_stats.get(f"batch@{name}")
                if st and st.get("count"):
                    rep.cost_ms = max(1e-3, float(st["p99"]) / 1e3)

    def _rescue_locked(self, dead):
        """Hand a dead/draining replica's QUEUED requests — and, for an
        EJECTED decode replica, its seated in-flight streams as
        continuation requests — to the least-loaded
        survivor; admitted work is rescued, not failed.  Continuations
        go through the recovery gate first (retry budget, deadline
        estimator, survivor existence): a doomed stream fails FAST with
        ``recovery_exhausted`` + partial tokens.  With no survivor the
        queued orphans' futures fail loudly (counted)."""
        orphans = dead.router.detach_queue()
        conts = []
        detach = getattr(dead.router, "detach_inflight", None)
        if detach is not None and dead.ejected:
            # draining replicas (scale_in) finish their own seated work;
            # only a DEAD replica's in-flight batch needs resurrection
            conts = detach()
        if not orphans and not conts:
            return 0
        now = time.monotonic()
        survivors = [r for r in self._replicas if r.live() and r is not dead]
        best = min(survivors,
                   key=lambda r: (r.router.pending, r.cost_ms, r.idx)) \
            if survivors else None
        ready = []
        for req in conts:
            why = self._recovery_gate_locked(req, best, now)
            if why is None:
                ready.append(req)
            else:
                self._fail_recovery_locked(req, why)
        if best is not None:
            try:
                # continuations ride AHEAD of the queued orphans: they
                # hold original arrival timestamps and already-delivered
                # tokens, so they reseat first
                n = best.router.adopt(ready + orphans)
                record_fleet("fleet_rescued", n)
                return n
            except ServeRejected:
                pass    # survivor raced into shutdown: fall through
        for req in ready:
            self._fail_recovery_locked(
                req, "no survivor to adopt the in-flight stream")
        if orphans:
            self._failures += len(orphans)
            record_fleet("fleet_request_failures", len(orphans))
            exc = ServeRejected("draining",
                                "replica died with no survivor to adopt "
                                "its queue")
            for req in orphans:
                fail = getattr(req, "future", None)
                if fail is not None:
                    if fail.set_running_or_notify_cancel():
                        fail.set_exception(exc)
                else:
                    req.stream._fail(exc)
        return 0

    def _recovery_gate_locked(self, req, best, now):
        """None = resurrect on ``best``; else the reason string the
        stream fails fast with.  The deadline leg reuses the door's
        admission estimator: steps already pending on the survivor,
        plus the continuation's own re-prefill (``ceil(P/chunk)``) and
        remaining tokens, at the survivor's recent per-batch cost."""
        if best is None:
            return "no survivor to adopt the in-flight stream"
        if req.retries > self.recovery_budget:
            return (f"retry budget exhausted "
                    f"({req.retries - 1} recoveries already spent, "
                    f"budget {self.recovery_budget})")
        if req.deadline is not None:
            steps = getattr(best.router, "pending_steps", None)
            ahead = int(steps) if steps is not None \
                else int(best.router.pending)
            ct = max(1, int(getattr(
                getattr(best.router, "engine", None), "chunk_top", 1)))
            replay = (len(req.prompt) + ct - 1) // ct
            eta_ms = (ahead + replay + int(req.max_new)) * best.cost_ms
            if now + eta_ms / 1e3 > req.deadline:
                return (f"re-prefill + {req.max_new} remaining tokens "
                        f"(~{eta_ms:.1f}ms) cannot meet the deadline")
        return None

    def _fail_recovery_locked(self, req, why):
        """Fail one unrecoverable stream loudly: ``recovery_exhausted``
        with the partial tokens attached (work already delivered is
        surfaced, never silently discarded)."""
        record_decode_recovery("decode_recovery_exhausted")
        self._failures += 1
        record_fleet("fleet_request_failures")
        partial = req.stream.partial()
        req.stream._fail(ServeRejected(
            "recovery_exhausted",
            f"in-flight stream not recoverable: {why} "
            f"({len(partial)} tokens already delivered ride exc.partial)",
            partial=partial))

    # -- admission + dispatch ----------------------------------------------

    def submit(self, *args, klass="interactive", deadline_ms=None,
               **kwargs):
        """Admit one request of ``klass`` and dispatch it to the least-
        loaded healthy replica; positional/keyword args go to the
        replica's own ``submit`` verbatim.  Returns whatever the replica
        returns (a Future for one-shot routers, a DecodeStream for
        decode).  Raises :class:`ServeRejected` with a structured reason:
        ``draining`` (door closing / whole fleet down), ``shed:<klass>``
        (over the class watermark), ``queue_full`` (aggregate capacity),
        ``deadline`` (estimated wait exceeds the request's deadline)."""
        if klass not in CLASSES:
            raise ValueError(f"unknown request class {klass!r} "
                             f"(classes: {list(CLASSES)})")
        t0 = time.monotonic()
        with self._lock:
            if self._closing:
                raise ServeRejected("draining", "front door is draining",
                                    klass=klass)
            self._sweep_locked(t0)
            order = [r for r in self._replicas if r.live()]
            order.sort(key=lambda r: (r.router.pending, r.cost_ms, r.idx))
            if not order:
                raise ServeRejected("draining",
                                    "no healthy replica in the fleet",
                                    klass=klass)
            lf = self._load_factor_locked()
            shed = self.shed_at.get(klass)
            if shed is not None and lf >= shed:
                record_fleet(f"fleet_shed_{klass}")
                raise ServeRejected(
                    f"shed:{klass}",
                    f"load factor {lf:.2f} >= {shed:.2f} watermark",
                    klass=klass)
            cap = sum(int(r.router.queue_limit) for r in order)
            pend = sum(r.router.pending for r in order)
            if pend >= cap:
                raise ServeRejected(
                    "queue_full",
                    f"fleet at aggregate capacity ({pend}/{cap})",
                    klass=klass)
            dl_ms = self.class_deadline_ms.get(klass) \
                if deadline_ms is None else float(deadline_ms)
            if dl_ms is not None:
                # estimated wait on the best replica: batches ahead of
                # us (its pending over its batch size) plus our own, at
                # its recent per-batch cost — unmeetable means reject at
                # the door, not a timeout inside a batch.  Decode
                # replicas expose pending_steps: a queued
                # PROMPT costs ceil(prompt_len/chunk) prefill steps, not
                # one, so the drain estimate folds prompt length in
                best = order[0]
                steps = getattr(best.router, "pending_steps", None)
                if steps is not None:
                    batches = int(steps) + 1
                else:
                    per_batch = max(
                        1, int(getattr(best.router, "max_batch", 1)))
                    batches = best.router.pending // per_batch + 1
                if batches * best.cost_ms > dl_ms:
                    raise ServeRejected(
                        "deadline",
                        f"estimated wait {batches * best.cost_ms:.1f}ms "
                        f"exceeds deadline {dl_ms:.1f}ms", klass=klass)
            self._admitted += 1
            record_fleet("fleet_admitted")
            targets = [r.idx for r in order]
        if self.forward_deadline_ms and dl_ms is not None \
                and "deadline_ms" not in kwargs:
            kwargs["deadline_ms"] = dl_ms
        # dispatch OUTSIDE the door lock: a replica that died/drained
        # between pick and submit just means we try the next one
        for idx in targets:
            rep = self._by_idx(idx)
            if rep is None or not rep.live():
                continue
            try:
                handle = rep.router.submit(*args, **kwargs)
            except ServeRejected:
                continue
            record_fleet("fleet_dispatch")
            add_cb = getattr(handle, "add_done_callback", None)
            if add_cb is not None:
                add_cb(lambda f, _t0=t0: self._note_done(f, _t0))
            return handle
        raise ServeRejected("queue_full",
                            "every healthy replica refused the request",
                            klass=klass)

    def _by_idx(self, idx):
        with self._lock:
            for rep in self._replicas:
                if rep.idx == idx:
                    return rep
        return None

    def _note_done(self, fut, t0):
        # runs on a replica loop thread with NO router lock held (the
        # routers resolve futures outside their cv) — taking only the
        # door lock here keeps the hierarchy one-directional
        us = (time.monotonic() - t0) * 1e6
        failed = (not fut.cancelled()) and fut.exception() is not None
        with self._lock:
            self._lat_us.append(us)
            if len(self._lat_us) > self._lat_cap:
                del self._lat_us[:len(self._lat_us) - self._lat_cap]
            if failed:
                self._failures += 1
        record_serve_latency("request", us)
        if failed:
            record_fleet("fleet_request_failures")

    # -- scaling + drain ---------------------------------------------------

    def scale_out(self):
        """Add one replica and return its index.  The port's executors
        compile nothing, so a new replica costs its construction alone
        (ROADMAP C7 (k): no serve cache, no ``step_cache_serve_hit``)."""
        with self._lock:
            if self._closing:
                raise ServeRejected("draining", "front door is draining")
            idx = self._next_idx
            self._next_idx += 1
        router = self.make_replica(idx)    # may build executors: no lock
        rep = _Replica(idx, router)
        with self._lock:
            self._replicas.append(rep)
            record_fleet("fleet_scale_out")
            record_fleet("fleet_replicas_hw",
                         sum(1 for r in self._replicas if r.live()))
        return idx

    def scale_in(self, timeout=10.0):
        """Gracefully retire the highest-index live replica: stop its
        admissions, hand its queue to a survivor, wait out its in-flight
        work, close it.  Returns the retired index, or None when only
        one live replica remains (the fleet never drains itself to
        zero)."""
        with self._lock:
            live = [r for r in self._replicas if r.live()]
            if len(live) <= 1:
                return None
            victim = max(live, key=lambda r: r.idx)   # deterministic
            victim.draining = True
        victim.router.stop_admitting()
        with self._lock:
            self._rescue_locked(victim)
        victim.router.drain(timeout=timeout)
        victim.router.close()
        with self._lock:
            self._replicas.remove(victim)
            record_fleet("fleet_scale_in")
        return victim.idx

    def drain(self, timeout=10.0):
        """Stop admitting fleet-wide and wait for every replica to
        finish its queued + in-flight work (the graceful half of
        :meth:`close`).  Returns True when everything drained."""
        with self._lock:
            self._closing = True
            reps = list(self._replicas)
        for rep in reps:
            rep.router.stop_admitting()
        # sweep first (a killed-but-unswept replica must be ejected),
        # then rescue dead replicas' queues BEFORE draining survivors so
        # the adopted work lands inside the survivors' drain window
        with self._lock:
            self._sweep_locked(time.monotonic(), force=True)
            for rep in reps:
                if rep.ejected:
                    self._rescue_locked(rep)
        ok = True
        deadline = time.monotonic() + float(timeout)
        for rep in reps:
            if rep.ejected:
                continue
            left = max(0.05, deadline - time.monotonic())
            ok = rep.router.drain(timeout=left) and ok
        return ok

    def close(self, timeout=10.0):
        """Graceful fleet shutdown: :meth:`drain`, then close every
        replica.  Queued work is finished (or rescued), never dropped —
        ``close()`` on an active fleet fails no admitted request."""
        self.drain(timeout=timeout)
        with self._lock:
            reps = list(self._replicas)
            self._replicas = []
        for rep in reps:
            rep.router.close()
        record_fleet("fleet_drained")
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SLOAutoscaler:
    """Grow/shrink a :class:`FrontDoor`'s replica set against a p99 SLO
    with the elastic plane's flap damping
    (:class:`~hetu_tpu_torch.parallel.elastic.FlapDamper`).

    Poll-driven, single caller (no thread, no lock): call :meth:`poll` on
    a cadence.  GROW when p99 exceeds ``p99_target_ms`` or load crosses
    ``grow_load``, after ``grow_grace`` CONSECUTIVE breaching polls;
    SHRINK when p99 sits under ``low_p99_frac * target`` AND load under
    ``shrink_load`` for ``shrink_grace`` consecutive polls.  After a
    resize the latency window and both dampers reset, so the next
    decision steers on post-resize evidence only — that reset plus the
    consecutive-poll grace IS the flap damping.  Bounds:
    ``min_replicas``/``max_replicas`` (a grow refused at the max counts
    ``fleet_scale_refused``).  Every resize appends an event (admission
    clock, dp transition, the p99/load that drove it) to :attr:`events`
    for a timeline."""

    def __init__(self, door, p99_target_ms, *, min_replicas=1,
                 max_replicas=8, grow_grace=2, shrink_grace=4,
                 grow_load=0.6, shrink_load=0.15, low_p99_frac=0.3):
        self.door = door
        self.p99_target_ms = float(p99_target_ms)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.grow_load = float(grow_load)
        self.shrink_load = float(shrink_load)
        self.low_p99_frac = float(low_p99_frac)
        self._grow = FlapDamper(grow_grace)
        self._shrink = FlapDamper(shrink_grace)
        #: resize timeline
        self.events = []

    def poll(self, now=None):
        """One control decision; returns the resize event dict when a
        resize happened, else None."""
        record_fleet("fleet_autoscaler_polls")
        self.door.poll(now)
        p99 = self.door.p99_ms()
        lf = self.door.load_factor()
        n = self.door.n_replicas
        hot = p99 > self.p99_target_ms or lf >= self.grow_load
        cold = (p99 < self.low_p99_frac * self.p99_target_ms
                and lf <= self.shrink_load)
        if hot and n >= self.max_replicas:
            record_fleet("fleet_scale_refused")
            self._grow.clear("grow")
            return None
        if self._grow.ready("grow", hot and n < self.max_replicas):
            idx = self.door.scale_out()
            return self._event("scale_out", n, n + 1, p99, lf, idx)
        if self._shrink.ready("shrink", cold and n > self.min_replicas):
            idx = self.door.scale_in()
            if idx is None:
                self._shrink.clear("shrink")
                return None
            return self._event("scale_in", n, n - 1, p99, lf, idx)
        return None

    def _event(self, kind, from_n, to_n, p99, lf, idx):
        # post-resize: steer on fresh evidence only (flap damping)
        self.door.reset_window()
        self._grow.clear()
        self._shrink.clear()
        ev = {"admitted": self.door.admitted, "kind": kind,
              "from_replicas": from_n, "to_replicas": to_n,
              "replica": idx, "p99_ms": round(p99, 3),
              "load_factor": round(lf, 4)}
        self.events.append(ev)
        return ev


__all__ = ["FrontDoor", "SLOAutoscaler", "CLASSES", "DEFAULT_SHED_AT"]
