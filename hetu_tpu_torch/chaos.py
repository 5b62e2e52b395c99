"""Chaos injection: seeded, reproducible fault schedules for the
fault-tolerance layer (twin of ``hetu_tpu/chaos.py``, standard library
only).

A :class:`ChaosInjector` parsed from ``HETU_CHAOS=<seed>:<spec>[,<spec>
...]`` drives

* **transport faults**: the dist-store client consults :func:`active`
  before every RPC frame, and the injector answers drop / delay /
  duplicate / wedge with decisions drawn from one seeded RNG (the same
  seed gives the same fault sequence for the same event order, and the
  same sequence as the JAX package's injector);
* **process kills**: ``kill:ps@rank<r>:step<s>`` stops a registered
  :class:`~hetu_tpu_torch.ps.dist_store.StoreServer` when the executor
  reports training step ``s``; ``kill:proc@rank<r>:after<ms>`` tells the
  supervising launcher (:mod:`hetu_tpu_torch.launcher`) to kill a child
  rank after a wall-clock delay; ``kill:proc@rank<r>:step<n>`` stops a
  handle registered with :meth:`ChaosInjector.register_proc` at step
  ``n``;
* **replica-role kills**: with PS shard replication,
  ``kill:primary@shard<s>:step<n>`` stops whichever registered server
  SERVES shard ``s`` at step ``n`` (resolved at fire time, so after a
  failover it targets the promoted ex-backup), and
  ``kill:backup@shard<s>:step<n>`` the one that HOLDS it without serving;
  the ``:req<n>`` form fires on a serving router's admission clock
  (:meth:`ChaosInjector.on_request`);
* **fleet replica kills**: ``kill:replica@<idx>:req<n>`` on a front
  door's admission clock and ``kill:replica@<idx>:tok<n>`` on a decode
  engine's emitted-token clock (:meth:`ChaosInjector.on_token`),
  against handles registered with :meth:`ChaosInjector.register_replica`;
* **network partitions**:
  ``partition:rank<a>[+rank<b>...]|rank<c>[+rank<d>...]@step<n>[:heal<m>]``
  drops every frame both ways between the two rank sets from step ``n``
  until step ``m`` (never, without ``:heal``); level-triggered on the
  step clock and drawing nothing from the RNG.  Senders name themselves
  with ``on_send(..., src=rank)``; a frame of unknown sender is never
  partition-dropped.

Spec grammar (after the first ``:``, a comma-separated fault list;
probabilities in [0, 1], durations in milliseconds)::

    HETU_CHAOS="1234:drop=0.1,delay=0.2:50,dup=0.05,wedge=0.01:2000"
    HETU_CHAOS="7:kill:ps@rank1:step3"
    HETU_CHAOS="7:kill:proc@rank0:after250"
    HETU_CHAOS="7:kill:proc@rank2:step5"
    HETU_CHAOS="7:kill:primary@shard1:step3"
    HETU_CHAOS="7:kill:backup@shard1:step3"
    HETU_CHAOS="7:kill:primary@shard1:req200"
    HETU_CHAOS="7:kill:replica@1:req40"
    HETU_CHAOS="7:kill:replica@0:tok16"
    HETU_CHAOS="7:partition:rank0|rank1@step3:heal7"
    HETU_CHAOS="7:partition:rank0+rank1|rank2+rank3@step3"

Every injected fault counts under the JAX package's name in
:func:`hetu_tpu_torch.metrics.fault_counts` (``chaos_drop``,
``chaos_kill_ps``, ``partition_frames_dropped``, ...).  The PS path calls
the hooks (the store server registers, ``DistributedStore._rpc`` asks
``on_send``, the executor's step boundary ``on_step``, the launcher's
monitor ``due_proc_kills``); the serving planes' routers do not yet, and
refuse a set ``HETU_CHAOS`` by name.
"""
from __future__ import annotations

import os
import random
import threading

from .metrics import record_fault

#: transport fault kinds a schedule may inject on an outgoing RPC frame
_TRANSPORT_KINDS = ("drop", "delay", "dup", "wedge")


class ChaosSpecError(ValueError):
    """Malformed ``HETU_CHAOS`` spec (loud: a typo'd schedule silently
    injecting nothing would make a chaos run indistinguishable from a
    clean one)."""


_PARTITION_GRAMMAR = ("partition:rank<a>[+rank<b>...]|rank<c>[+rank<d>"
                      "...]@step<n>[:heal<m>]")


def _parse_rank_set(side, part):
    """``rank0+rank2`` -> frozenset({0, 2}); loud on anything else."""
    ranks = set()
    for tok in side.split("+"):
        tok = tok.strip()
        if not tok.startswith("rank"):
            raise ChaosSpecError(
                f"bad partition side {side!r} in {part!r}: expected "
                f"{_PARTITION_GRAMMAR}")
        try:
            ranks.add(int(tok[len("rank"):]))
        except ValueError:
            raise ChaosSpecError(
                f"bad rank {tok!r} in partition fault {part!r}: expected "
                f"{_PARTITION_GRAMMAR}") from None
    return frozenset(ranks)


def _parse_partition(part):
    """``partition:<side>|<side>@step<n>[:heal<m>]`` -> fault dict.

    Validated loudly: two non-empty DISJOINT rank sets (an overlapping
    cut is ill-defined), an integer start step, and — when given — a
    heal step strictly after the start (a zero-length window would make
    the chaos run indistinguishable from a clean one)."""
    body = part[len("partition:"):]
    try:
        sides, when = body.split("@", 1)
        a_s, b_s = sides.split("|", 1)
    except ValueError:
        raise ChaosSpecError(
            f"bad partition fault {part!r}: expected "
            f"{_PARTITION_GRAMMAR}") from None
    a, b = _parse_rank_set(a_s, part), _parse_rank_set(b_s, part)
    if not a or not b:
        raise ChaosSpecError(
            f"empty partition side in {part!r}: expected "
            f"{_PARTITION_GRAMMAR}")
    if a & b:
        raise ChaosSpecError(
            f"partition sides overlap on rank(s) {sorted(a & b)} in "
            f"{part!r} — a rank cannot sit on both sides of the cut")
    heal = None
    if ":" in when:
        when, heal_s = when.split(":", 1)
        if not heal_s.startswith("heal"):
            raise ChaosSpecError(
                f"bad partition clause {heal_s!r} in {part!r}: expected "
                f"{_PARTITION_GRAMMAR}")
        try:
            heal = int(heal_s[len("heal"):])
        except ValueError:
            raise ChaosSpecError(
                f"bad heal step in {part!r}: expected "
                f"{_PARTITION_GRAMMAR}") from None
    if not when.startswith("step"):
        raise ChaosSpecError(
            f"bad partition trigger {when!r} in {part!r}: expected "
            f"{_PARTITION_GRAMMAR}")
    try:
        step = int(when[len("step"):])
    except ValueError:
        raise ChaosSpecError(
            f"bad partition step in {part!r}: expected "
            f"{_PARTITION_GRAMMAR}") from None
    if heal is not None and heal <= step:
        raise ChaosSpecError(
            f"partition heal step {heal} must be after its start step "
            f"{step} in {part!r}")
    return {"kind": "partition", "a": a, "b": b, "step": step,
            "heal": heal}


def _parse_fault(part):
    part = part.strip()
    if not part:
        raise ChaosSpecError("empty fault entry")
    if part.startswith("partition:"):
        return _parse_partition(part)
    if part.startswith("kill:"):
        # kill:ps@rank<r>:step<s> | kill:proc@rank<r>:after<ms>
        # | kill:{primary,backup}@shard<s>:{step<n>|req<n>}  (replica-
        #   role kills, resolved against the live serving/holding sets at
        #   fire time; req<n> fires on the serving router's admission
        #   clock instead of the training step clock)
        # | kill:replica@<idx>:req<n>  (fleet serving-replica
        #   kill on the FRONT DOOR's admission clock, resolved against
        #   register_replica'd handles)
        # | kill:replica@<idx>:tok<n>  (MID-GENERATION decode
        #   replica kill on the victim engine's own deterministic
        #   emitted-token clock — fires once replica <idx> has emitted
        #   n tokens, landing inside a generation regardless of how the
        #   door spread the request stream)
        try:
            _, rest = part.split(":", 1)
            what, where = rest.split("@", 1)
            target, when = where.split(":", 1)
            if what == "replica":
                if when.startswith("req"):
                    return {"kind": "kill_replica", "idx": int(target),
                            "req": int(when[len("req"):])}
                if when.startswith("tok"):
                    return {"kind": "kill_replica", "idx": int(target),
                            "tok": int(when[len("tok"):])}
                raise ValueError(part)
            if what in ("primary", "backup"):
                if not target.startswith("shard"):
                    raise ValueError(part)
                shard = int(target[len("shard"):])
                if when.startswith("step"):
                    return {"kind": f"kill_{what}", "shard": shard,
                            "step": int(when[len("step"):])}
                if when.startswith("req"):
                    return {"kind": f"kill_{what}", "shard": shard,
                            "req": int(when[len("req"):])}
                raise ValueError(part)
            if not target.startswith("rank"):
                raise ValueError(part)
            rank = int(target[len("rank"):])
            if what == "ps" and when.startswith("step"):
                return {"kind": "kill_ps", "rank": rank,
                        "step": int(when[len("step"):])}
            if what == "proc" and when.startswith("after"):
                return {"kind": "kill_proc", "rank": rank,
                        "after_ms": float(when[len("after"):])}
            if what == "proc" and when.startswith("step"):
                # deterministic form: fires on the executor's step clock
                # against a register_proc'd handle — elastic tests kill a
                # rank at an EXACT step boundary instead of a wall-clock
                # delay (the after<ms> form stays the launcher's)
                return {"kind": "kill_proc", "rank": rank,
                        "step": int(when[len("step"):])}
            raise ValueError(part)
        except (ValueError, IndexError):
            raise ChaosSpecError(
                f"bad kill fault {part!r}: expected kill:ps@rank<r>:step<s>,"
                f" kill:proc@rank<r>:{{after<ms>|step<n>}}, "
                f"kill:{{primary,backup}}@shard<s>:{{step<n>|req<n>}}, or "
                f"kill:replica@<idx>:{{req<n>|tok<n>}}"
                ) from None
    if "=" not in part:
        raise ChaosSpecError(f"bad fault {part!r}: expected <kind>=<prob>"
                             f"[:<ms>] or kill:...")
    kind, val = part.split("=", 1)
    kind = kind.strip()
    if kind not in _TRANSPORT_KINDS:
        raise ChaosSpecError(
            f"unknown fault kind {kind!r} (known: {_TRANSPORT_KINDS})")
    ms = 0.0
    if ":" in val:
        val, ms_s = val.split(":", 1)
        ms = float(ms_s)
    try:
        prob = float(val)
    except ValueError:
        raise ChaosSpecError(f"bad probability in {part!r}") from None
    if not 0.0 <= prob <= 1.0:
        raise ChaosSpecError(f"probability {prob} out of [0,1] in {part!r}")
    if kind in ("delay", "wedge") and ms <= 0:
        raise ChaosSpecError(f"{kind} needs a duration: {kind}=<p>:<ms>")
    return {"kind": kind, "prob": prob, "ms": ms}


def parse_spec(spec):
    """``"<seed>:<fault>[,<fault>...]"`` → ``(seed, [fault dicts])``."""
    if ":" not in spec:
        raise ChaosSpecError(
            f"chaos spec {spec!r} missing the '<seed>:' prefix")
    seed_s, rest = spec.split(":", 1)
    try:
        seed = int(seed_s)
    except ValueError:
        raise ChaosSpecError(f"bad chaos seed {seed_s!r}") from None
    faults = [_parse_fault(p) for p in rest.split(",") if p.strip()]
    if not faults:
        raise ChaosSpecError(f"chaos spec {spec!r} declares no faults")
    return seed, faults


class ChaosInjector:
    """One parsed schedule + its RNG stream + its kill registry.

    Determinism contract: probabilistic decisions are drawn from ONE
    ``random.Random(seed)`` stream in event order — the same seed and the
    same sequence of :meth:`on_send` calls produce the same action
    sequence (the determinism test's exact claim).  Multi-threaded
    transports still get a *reproducible distribution* (the lock
    serializes draws), single-threaded tests get bitwise repeatability.
    """

    def __init__(self, seed, faults):
        self.seed = seed
        self.faults = list(faults)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._servers = {}          # rank -> StoreServer
        self._procs = {}            # rank -> proc handle (step-clock kills)
        self._replicas = {}         # idx -> fleet replica handle
        self._fired = set()         # one-shot kill faults already fired
        #: the step clock partitions level-trigger on (fed by on_step);
        #: -1 = the executor never reported a step, so no partition is
        #: active yet.  Kills keep their own one-shot ``_fired`` set —
        #: the two clocks share on_step but nothing else (a heal must
        #: never consume or be consumed by a kill firing).
        self._now_step = -1
        #: per-event action log, kept for the determinism tests; bounded
        #: so a long chaos run doesn't grow it without limit
        self.decisions = []
        self.decisions_cap = 65536

    @classmethod
    def from_spec(cls, spec):
        seed, faults = parse_spec(spec)
        return cls(seed, faults)

    @classmethod
    def from_env(cls, env_var="HETU_CHAOS"):
        spec = os.environ.get(env_var, "").strip()
        return cls.from_spec(spec) if spec else None

    # -- transport faults --------------------------------------------------
    def _partitioned(self, src, peer):
        """True iff an ACTIVE partition separates ``src`` from ``peer``
        (caller holds the lock).  Level-triggered on the on_step clock:
        active from its start step until its heal step (or forever);
        symmetric (frames drop both directions); never consumes an RNG
        draw, so adding a partition to a schedule does not shift the
        probabilistic fault stream."""
        if src is None or peer is None:
            return False
        for f in self.faults:
            if f["kind"] != "partition" or self._now_step < f["step"]:
                continue
            if f["heal"] is not None and self._now_step >= f["heal"]:
                continue
            if (src in f["a"] and peer in f["b"]) \
                    or (src in f["b"] and peer in f["a"]):
                return True
        return False

    def on_send(self, peer=None, op=None, src=None):
        """Decide the fate of one outgoing RPC frame.

        Returns ``None`` (send normally) or ``(kind, ms)`` with kind in
        ``drop`` (never send; the client sees a timeout and retries),
        ``delay`` (sleep ``ms`` then send), ``dup`` (send the frame twice
        — the server's (client, seq) dedup must absorb it), ``wedge``
        (hold the socket ``ms``; the client's op deadline fires).

        ``src`` is the SENDING rank (transports pass their own rank so
        partition faults can tell which side of a cut the frame leaves
        from).  An active partition between ``src`` and ``peer`` drops
        the frame deterministically — it overrides any probabilistic
        fault, but the probabilistic draws still happen first so the
        RNG stream position stays a function of (schedule, event count)
        alone.
        """
        with self._lock:
            action = None
            for f in self.faults:
                if f["kind"] not in _TRANSPORT_KINDS:
                    continue
                # one draw per prob-fault per event: the stream position
                # depends only on (schedule, event count), never on which
                # earlier fault happened to trigger
                hit = self._rng.random() < f["prob"]
                if hit and action is None:
                    action = (f["kind"], f["ms"])
            if self._partitioned(src, peer):
                action = ("drop", 0.0)
                record_fault("partition_frames_dropped")
            elif action is not None:
                record_fault("chaos_" + action[0])
            if len(self.decisions) < self.decisions_cap:
                self.decisions.append(action)
            return action

    # -- step-scheduled PS-server kills ------------------------------------
    def register_server(self, rank, server):
        """A live PS server volunteers as a kill target for ``kill:ps``."""
        with self._lock:
            self._servers[rank] = server

    def register_proc(self, rank, handle):
        """A worker-rank handle volunteers as the kill target for the
        step-clock form ``kill:proc@rank<r>:step<n>``: anything with a
        ``stop()`` (the JAX package's elastic harness registers its
        ``LogicalRank``; a launcher-side wrapper could hold a Popen).
        The wall-clock ``after<ms>`` form stays on
        :meth:`due_proc_kills` (the launcher's monitor loop has no step
        clock)."""
        with self._lock:
            self._procs[rank] = handle

    def register_replica(self, idx, handle):
        """A fleet serving replica volunteers as the kill target for
        ``kill:replica@<idx>:req<n>``: anything with a ``stop()`` (the
        JAX package's front door registers its replica records, whose
        ``stop()`` fail-stops the replica's router at the next batch
        boundary; the port's does not yet).  The clock is the front
        door's admission count, so the kill lands at a deterministic
        point in the request stream regardless of how dispatch spread
        earlier requests."""
        with self._lock:
            self._replicas[int(idx)] = handle

    def _resolve_role_kill(self, fault):
        """The registered server currently filling the fault's replica
        role: ``kill_primary`` → the one SERVING the shard, ``kill_backup``
        → one HOLDING it without serving.  Resolved at fire time, so after
        an earlier failover ``kill:primary`` targets the promoted
        ex-backup — the double-failure schedules need exactly that."""
        shard = fault["shard"]
        for rank, srv in sorted(self._servers.items()):
            if getattr(srv, "_stop", False):
                continue
            serves = getattr(srv, "serves", None)
            holds = getattr(srv, "holds", None)
            if serves is None or holds is None:
                continue
            if fault["kind"] == "kill_primary" and serves(shard):
                return rank, srv
            if fault["kind"] == "kill_backup" and holds(shard) \
                    and not serves(shard):
                return rank, srv
        return None, None

    def on_step(self, step):
        """Executor hook: advances the step clock partitions level-
        trigger on (``partition:...@step<n>[:heal<m>]`` activates once
        the clock reaches ``n`` and heals once it reaches ``m``), then
        fires any step-scheduled server kill — ``kill:ps@rank<r>:
        step<s>`` and the replica-role forms ``kill:{primary,backup}@
        shard<s>:step<n>``.

        Returns the list of ranks whose server was stopped (empty almost
        always).  A fault whose target has no registered server is
        LOUD (warning + ``chaos_kill_target_missing`` counter) — a
        schedule that silently does nothing would make a chaos run
        indistinguishable from a clean one.  (Partitions are exempt from
        the one-shot ``_fired`` bookkeeping: they are windows, not
        events, so replaying a step can re-evaluate them without ever
        double-firing a kill.)"""
        killed, missing = [], []
        with self._lock:
            if step > self._now_step:
                self._now_step = step
            for i, f in enumerate(self.faults):
                if i in self._fired or f.get("step") != step \
                        or f["kind"] not in ("kill_ps", "kill_primary",
                                             "kill_backup", "kill_proc"):
                    continue
                self._fired.add(i)
                if f["kind"] == "kill_proc":
                    # step-clock worker-rank kill (elastic harness): the
                    # registered handle's stop() is the fail-stop death
                    handle = self._procs.get(f["rank"])
                    if handle is not None:
                        killed.append((f["rank"], handle,
                                       "chaos_kill_proc"))
                    elif not self._procs:
                        # same quiet/loud split as kill:ps — with OTHER
                        # handles registered the target presumably lives
                        # in a different process and fires there
                        missing.append(f"kill:proc@rank{f['rank']}"
                                       f":step{step}")
                elif f["kind"] == "kill_ps":
                    server = self._servers.get(f["rank"])
                    if server is not None:
                        killed.append((f["rank"], server, "chaos_kill_ps"))
                    elif not self._servers:
                        # no server registered in this process at all: the
                        # schedule cannot possibly fire here — loud.  When
                        # OTHER ranks' servers are registered, the target
                        # lives in a different process (each process hosts
                        # its own rank) and fires there: stay quiet.
                        missing.append(f"kill:ps@rank{f['rank']}"
                                       f":step{step}")
                else:
                    self._collect_role_kill(
                        f, f"kill:{f['kind'][len('kill_'):]}"
                           f"@shard{f['shard']}:step{step}",
                        killed, missing)
        return self._finish_kills(killed, missing)

    def _collect_role_kill(self, f, label, killed, missing):
        """Resolve one already-claimed replica-role fault (caller holds
        the lock): append its victim to ``killed``, or ``label`` to
        ``missing`` when NO server at all is registered in this process
        — the quiet/loud split: with OTHER servers registered the role
        is presumably filled in a different process and fires there."""
        rank, server = self._resolve_role_kill(f)
        if server is not None:
            killed.append((rank, server, "chaos_" + f["kind"]))
        elif not self._servers:
            missing.append(label)

    def _finish_kills(self, killed, missing):
        """Shared tail of every kill clock: loud counter + warning per
        unfillable kill (a chaos run that silently does nothing would be
        indistinguishable from a clean one), then stop each victim
        OUTSIDE the lock — ``stop()`` closes sockets and may block."""
        for what in missing:
            import warnings
            record_fault("chaos_kill_target_missing")
            warnings.warn(f"chaos {what} fired but no registered kill "
                          f"target fills that role (register_server for "
                          f"ps/primary/backup, register_proc for proc) — "
                          f"the kill did NOT happen", RuntimeWarning)
        for rank, server, counter in killed:
            record_fault(counter)
            server.stop()
        return [rank for rank, _, _ in killed]

    # -- request-count-scheduled kills (online serving) --------------------
    def on_request(self, admitted):
        """Serving-router hook: fires any replica-role kill scheduled on
        the ADMISSION clock (``kill:{primary,backup}@shard<s>:req<n>``)
        once ``admitted`` requests have entered the router — the serving
        analogue of :meth:`on_step` (a serving process has no training
        steps to schedule against) — and any fleet replica kill
        (``kill:replica@<idx>:req<n>``) once the FRONT DOOR's
        admission count reaches ``n``.  Each fault fires at most once;
        the same quiet/loud split as on_step applies when no registered
        target fills the role (for replica kills: against the
        ``register_replica`` registry).  Replica routers report their
        own smaller admission counts here too — harmless, since a
        replica's count can never exceed the door's, so a fleet-clock
        fault always fires first at the door."""
        killed, missing = [], []
        with self._lock:
            for i, f in enumerate(self.faults):
                if i in self._fired or f.get("req") is None \
                        or admitted < f["req"] \
                        or f["kind"] not in ("kill_primary", "kill_backup",
                                             "kill_replica"):
                    continue
                self._fired.add(i)
                if f["kind"] == "kill_replica":
                    handle = self._replicas.get(f["idx"])
                    if handle is not None:
                        killed.append((f["idx"], handle,
                                       "chaos_kill_replica"))
                    elif not self._replicas:
                        # same quiet/loud split as kill:ps — with OTHER
                        # replicas registered the target presumably
                        # lives behind a different front door
                        missing.append(f"kill:replica@{f['idx']}"
                                       f":req{f['req']}")
                    continue
                self._collect_role_kill(
                    f, f"kill:{f['kind'][len('kill_'):]}"
                       f"@shard{f['shard']}:req{f['req']}",
                    killed, missing)
        return self._finish_kills(killed, missing)

    # -- token-count-scheduled kills (decode serving) -----------------------
    def on_token(self, idx, total):
        """Decode-replica hook: fires ``kill:replica@<idx>:tok<n>`` once
        replica ``idx``'s OWN engine has emitted ``total`` >= n tokens —
        the engine's deterministic token clock, reported by the decode
        router loop after every step.  The door's admission clock cannot
        place a kill MID-GENERATION (dispatch spreads requests across
        replicas, and a request admits long before its tokens flow);
        this clock lands the kill inside a generation at an exact,
        replayable point.  Each fault fires at most once, with no RNG
        draw (transport fault decisions are unperturbed), and the same
        quiet/loud split as :meth:`on_request` applies against the
        ``register_replica`` registry."""
        killed, missing = [], []
        with self._lock:
            for i, f in enumerate(self.faults):
                if i in self._fired or f.get("tok") is None \
                        or f["kind"] != "kill_replica" \
                        or f["idx"] != idx or total < f["tok"]:
                    continue
                self._fired.add(i)
                handle = self._replicas.get(f["idx"])
                if handle is not None:
                    killed.append((f["idx"], handle, "chaos_kill_replica"))
                elif not self._replicas:
                    missing.append(
                        f"kill:replica@{f['idx']}:tok{f['tok']}")
        return self._finish_kills(killed, missing)

    # -- launcher-level child kills ----------------------------------------
    def due_proc_kills(self, elapsed_ms):
        """Ranks whose wall-clock ``kill:proc@rank<r>:after<ms>`` delay
        has elapsed; each fires once.  Step-clock ``:step<n>`` proc
        kills never fire here — they ride :meth:`on_step` against
        ``register_proc``'d handles."""
        due = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if f["kind"] == "kill_proc" and "after_ms" in f \
                        and i not in self._fired \
                        and elapsed_ms >= f["after_ms"]:
                    self._fired.add(i)
                    due.append(f["rank"])
        for _ in due:
            record_fault("chaos_kill_proc")
        return due


# ------------------------------------------------------------- active chaos
_active = None
_active_lock = threading.Lock()


def active():
    """The process-wide injector, or None (the hot-path check is one
    global read — a clean run pays nothing)."""
    return _active


def install(injector):
    """Make ``injector`` the process-wide schedule; returns the previous
    one so tests can restore it."""
    global _active
    with _active_lock:
        prev, _active = _active, injector
    return prev


def install_from_env(env_var="HETU_CHAOS"):
    """Install a schedule from the environment if one is set; returns the
    injector (or None).  Called by the dist-store and launcher entry
    points so ``HETU_CHAOS=...`` alone activates the harness."""
    inj = ChaosInjector.from_env(env_var)
    if inj is not None:
        install(inj)
    return inj


def uninstall():
    """Remove the process-wide schedule (test teardown)."""
    return install(None)


__all__ = ["ChaosInjector", "ChaosSpecError", "parse_spec", "active",
           "install", "install_from_env", "uninstall"]
