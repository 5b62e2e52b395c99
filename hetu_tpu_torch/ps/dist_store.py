"""The sharded, replicated parameter server and the HET bounded-staleness
embedding cache (twin of ``hetu_tpu/ps/dist_store.py``).

**The sharded store.**  Every process of a ``world`` owns the keys with
``key % world == rank``: a :class:`DistributedStore` keeps its shard in a
local :class:`~hetu_tpu_torch.ps.store.EmbeddingStore` (the native core),
answers for it over TCP through its :class:`StoreServer` thread, and
routes the keys it does not own to the rank serving them over persistent
sockets in length-prefixed binary frames (int64 keys, float32 rows; no
pickle).  The frame layout and the opcode numbers are the JAX package's
byte for byte — an 8-byte length, then the header ``<BiqdIqqqq`` (op,
table, nkeys, lr, payload width, client rank, client sequence number,
shard, fencing epoch), the keys and the payload — so either package's
client talks to either package's server, and a ring may mix them.
Transport discipline (ps-lite ``resender.h``): every socket op has a
timeout; a failed op drops the connection and retries on a fresh one
after a decorrelated-jitter backoff with the SAME (client, seq), and the
server's dedup window applies a retried push or clock tick once;
exhausted retries raise a RuntimeError naming the peer.  A frame length
outside ``[0, HETU_MAX_FRAME_MB]`` drops that connection only.

The client deduplicates keys with ``np.unique`` before the shard fanout
(duplicate grads pre-summed; a sorted unique batch, as the HET cache
hands over, skips it), fuses a push and a pull of one peer into one
``OP_PUSH_PULL`` frame, pushes asynchronously on a bounded queue
(``push_async`` / ``flush``, ASP), and keeps SSP clocks, in independent
channels, and heartbeats on shard 0 (the reference's scheduler role).

**Replication** (``replication=2``, ``HETU_PS_REPLICATION=2``): shard
``s`` keeps a bitwise-identical backup on rank ``(s + 1) % world``.  The
serving server mirrors every mutating frame (``OP_PUSH``, the push half
of ``OP_PUSH_PULL``, ``OP_SET_DATA``, and for shard 0 the heartbeats and
SSP clocks) to the backup as ``OP_REPLICATE`` before it acks, under one
lock, so the backup applies the op-log in the primary's order, Adam
moments included.  The forwarded frame keeps the original (client, seq),
so the backup's dedup window absorbs the retry of a push the primary
acked and then died on.  A client whose RPC to a shard's serving rank
exhausts its retries promotes the backup (``OP_PROMOTE``, idempotent),
re-routes and resends the same frame (``ps_failover``,
``ps_failover_promoted``).  :meth:`DistributedStore.re_replicate`
restores redundancy onto a relaunched holder (``standby=True``,
``HETU_PS_STANDBY=1``): ``OP_INIT`` replica tables, an ``OP_SYNC``
snapshot streamed as ``OP_SYNC_PUT`` chunks of the store's save file,
then the op-log buffered meanwhile.

**Fencing.**  Every shard carries a monotonic epoch, stamped on every
replication-relevant frame; promotion bumps it (``ps_epoch_bumps``).  A
frame of an older lineage is refused with :class:`EpochFenced`
(``ps_epoch_refused``) before it touches the table, and the refusal
teaches the sender the newer epoch; a healed stale ex-primary demotes
itself on first contact with the new lineage (``ps_demotions``) and must
be synced before it can be promoted again.  Reads stay unfenced.
``OP_CHECKSUM`` (``state_digest``) and ``OP_EPOCH`` are what
:mod:`hetu_tpu_torch.tools.ps_fsck` reads.  The chaos hooks are not
ported.

**The cache** (``_segment_sum``, ``_DevLookup``, :class:`DistCacheTable`)
works over either store, in training mode or as a read-only serving
cache (``read_only``, ``refresh_every``).
"""
from __future__ import annotations

import itertools
import os
import queue
import random
import re
import socket
import struct
import tempfile
import threading
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ..context import resolve_device
from ..metrics import record_cache, record_fault, record_rpc
from .opcodes import defop as _defop, frame_repr, op_name
from .store import _OPT_IDS, _V3_CHUNK, EmbeddingStore

_OPT_NAMES = {v: k for k, v in _OPT_IDS.items()}

OP_PULL = _defop("OP_PULL", 1)
OP_PUSH = _defop("OP_PUSH", 2)
OP_VERSIONS = _defop("OP_VERSIONS", 3)
OP_CLOCK = _defop("OP_CLOCK", 4)
OP_SSP_SYNC = _defop("OP_SSP_SYNC", 5)
OP_SSP_INIT = _defop("OP_SSP_INIT", 6)
OP_SHUTDOWN = _defop("OP_SHUTDOWN", 7)
OP_CLOCKS = _defop("OP_CLOCKS", 8)
OP_HEARTBEAT = _defop("OP_HEARTBEAT", 9)
OP_ALIVE = _defop("OP_ALIVE", 10)
#: fused push + pull (reference PsfType kSDPushPull): the keys carry
#: ``[npush, push_keys..., pull_keys...]``, the payload the grads
OP_PUSH_PULL = _defop("OP_PUSH_PULL", 11)
#: the replication plane: mirror a mutating frame to the backup; promote
#: a backup; create a replica table; set a shard's slab; the snapshot of
#: a re-replication; a copy's state digest; a copy's (epoch, serving)
OP_REPLICATE = _defop("OP_REPLICATE", 12)
OP_PROMOTE = _defop("OP_PROMOTE", 13)
OP_INIT = _defop("OP_INIT", 14)
OP_SET_DATA = _defop("OP_SET_DATA", 15)
OP_SYNC = _defop("OP_SYNC", 16)
OP_SYNC_PUT = _defop("OP_SYNC_PUT", 17)
OP_CHECKSUM = _defop("OP_CHECKSUM", 18)
OP_EPOCH = _defop("OP_EPOCH", 19)

# op, table, nkeys, lr, payload width, client rank, client sequence number,
# shard (-1: the receiving server's own), the sender's fencing epoch for
# that shard.  (client, seq) lets the server apply a retried push or
# clock tick once.
_HDR = struct.Struct("<BiqdIqqqq")
#: retried pushes are remembered per client this many ops back
_DEDUP_WINDOW = 4096

#: hard cap on a decoded frame length: a corrupt or hostile length prefix
#: raises a clean protocol error, not a negative or multi-GB allocation
MAX_FRAME_BYTES = int(float(os.environ.get("HETU_MAX_FRAME_MB",
                                           "1024")) * 1e6)


def _next_backoff(base, prev, cap, rng):
    """Decorrelated-jitter retry delay: ``min(cap, uniform(base,
    3*prev))``, so a fleet of clients retrying a killed primary spreads
    out instead of stampeding the promoted backup."""
    return min(cap, rng.uniform(base, 3.0 * max(base, prev)))


def _segment_sum(grads, inv, counts):
    """Per-unique-key float32 grad sums (the host cache's segment sum):
    a one-hot CSR product when scipy is present, which adds each key's
    occurrences in batch order, starting from zero; ``np.add.at``
    otherwise, counted as ``emb_grad_host_fallback`` in the cache family.
    With every key distinct it only reorders."""
    if counts.size == inv.size:
        return np.ascontiguousarray(grads[np.argsort(inv, kind="stable")])
    try:
        from scipy import sparse as _sp
        onehot = _sp.csr_matrix(
            (np.ones(inv.size, np.float32), inv,
             np.arange(inv.size + 1, dtype=np.int64)),
            shape=(inv.size, counts.size))
        return np.asarray(onehot.T @ grads, np.float32)
    except ImportError:
        record_cache("emb_grad_host_fallback", 1)
        out = np.zeros((counts.size, grads.shape[1]), np.float32)
        np.add.at(out, inv, grads)
        return out


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


def _send_frame(sock, *parts):
    body = b"".join(parts)
    sock.sendall(struct.pack("<q", len(body)) + body)


class FrameError(ConnectionError):
    """Corrupt frame header: framing on this stream is unrecoverable, so
    it is a ConnectionError — the server drops the connection and the
    client retries on a fresh one."""


class EpochFenced(RuntimeError):
    """A replication-relevant frame refused by the fencing epoch.
    ``current`` is the refusing side's epoch for the shard, ``serving``
    whether it still serves it: a serving refuser means "adopt my epoch
    and retry here", a non-serving one "adopt it and re-route to the
    shard's other holder".  The message carries both in the JAX
    package's parseable form, since the refusal usually crosses the wire
    as a server error string."""

    def __init__(self, shard, current, serving):
        self.shard, self.current, self.serving = \
            int(shard), int(current), bool(serving)
        super().__init__(
            f"shard {shard} epoch_fence cur={int(current)} "
            f"serving={int(bool(serving))} — frame from a different "
            f"lineage refused")


def _fence_info(err):
    """(current epoch, refuser still serving) from an epoch-fence refusal,
    local or in its wire string form; None for any other error."""
    if isinstance(err, EpochFenced):
        return err.current, err.serving
    m = re.search(r"epoch_fence cur=(\d+) serving=([01])", str(err))
    return (int(m.group(1)), bool(int(m.group(2)))) if m else None


def _recv_frame(sock):
    (n,) = struct.unpack("<q", _recv_exact(sock, 8))
    if n < 0 or n > MAX_FRAME_BYTES:
        record_fault("ps_bad_frame")
        raise FrameError(
            f"frame length {n} outside [0, {MAX_FRAME_BYTES}] "
            f"(HETU_MAX_FRAME_MB) — corrupt or hostile peer")
    return _recv_exact(sock, n)


class StoreServer:
    """Serves one process's shard over TCP (the reference server role):
    an accept loop, a handler thread a connection, the ``(client, seq)``
    dedup window for pushes and clock ticks, SSP clock vectors by
    channel and the heartbeat table.

    With ``replication=2`` it also holds, and does not serve, a replica
    of shard ``(rank - 1) % world``, kept bit-equal by the op-log its
    primary forwards, and mirrors its own shard's mutations to rank
    ``(rank + 1) % world`` before each ack.  A ``standby`` server (a
    relaunched replacement) serves nothing until re-replication and a
    promotion.  Forwards ride the owning :class:`DistributedStore`'s
    transport, :attr:`rpc_fn`."""

    def __init__(self, local: EmbeddingStore, world: int, rank: int,
                 host="127.0.0.1", port=0, replication=1, standby=False):
        self.local, self.world, self.rank = local, world, rank
        self.replication = int(replication)
        self.standby = bool(standby)
        self._ssp_lock = threading.Condition()
        self._clocks = {}          # channel -> per-worker clock vector
        self._hb = {}              # rank -> (monotonic last seen, step)
        self._hb_lock = threading.Lock()
        self._applied = {}         # client -> OrderedDict of recent seqs
        self._applied_lock = threading.Lock()
        self._live_conns = set()
        #: shard -> the store holding its rows here
        self._stores = {rank: local}
        self._ntables = {rank: 0}  # shard -> tables created
        standby = bool(standby and self.replicable)
        #: shards this server answers for; a standby starts with none
        self._serving = set() if standby else {rank}
        #: shards whose copy may be promoted: a standby's copy only once
        #: an OP_SYNC snapshot has landed (its own init_table would give
        #: the right table count with step-0 data)
        self._promotable = set() if standby \
            else {rank, (rank - 1) % world} if self.replicable else {rank}
        #: shard -> the fencing epoch of the lineage our copy belongs to
        self._epochs = {rank: 0}
        #: leaf lock of the epoch map, never held across an RPC: a
        #: primary holds _repl_lock across its forward, so the receive
        #: side of a forward must never wait on the receiver's _repl_lock
        self._epoch_lock = threading.Lock()
        self._fwd_ok = {}          # shard -> live forwarding enabled
        self._fence_probe = {}     # shard -> time of the last lineage probe
        self._oplog = {}           # shard -> frames buffered during OP_SYNC
        self._sync_parts = {}      # (shard, table) -> received chunks
        #: apply + forward is one critical section: the backup sees the
        #: op-log in the primary's apply order
        self._repl_lock = threading.RLock()
        #: set by the owning DistributedStore:
        #: rpc_fn(peer, op, table, keys, payload=..., epoch=...)
        self.rpc_fn = None
        if self.replicable:
            backup_of = (rank - 1) % world
            self._stores[backup_of] = EmbeddingStore()
            self._ntables[backup_of] = 0
            self._epochs[backup_of] = 0
            self._fwd_ok[rank] = True
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name=f"ps-accept-r{rank}")
        self._thread.start()

    # -- replication topology ----------------------------------------------
    @property
    def replicable(self):
        return self.replication >= 2 and self.world >= 2

    def serves(self, shard):
        """True iff this server answers for ``shard``."""
        return shard in self._serving

    def holds(self, shard):
        """True iff this server keeps a copy of ``shard``."""
        return shard in self._stores

    def epoch(self, shard):
        """This server's fencing epoch for ``shard`` (0 if unheld)."""
        return self._epochs.get(shard, 0)

    def _adopt_epoch(self, shard, epoch):
        """Advance ``shard``'s epoch to at least ``epoch``: a locked
        max-merge, so racing adoptions never let the lower epoch win."""
        with self._epoch_lock:
            if epoch > self._epochs.get(shard, 0):
                self._epochs[shard] = epoch

    def _fence_or_adopt(self, shard, epoch, refuse_equal_if_serving=False):
        """The replica plane's gate (OP_REPLICATE, OP_INIT, OP_SYNC_PUT):
        refuse a frame of an older lineage (and an op-log forward at our
        own epoch aimed at a copy we serve: one epoch has one primary);
        adopt a newer epoch, demoting first if we still served the
        shard."""
        with self._epoch_lock:
            cur = self._epochs.get(shard, 0)
            if epoch < cur or (refuse_equal_if_serving and epoch == cur
                               and shard in self._serving):
                record_fault("ps_epoch_refused")
                raise EpochFenced(shard, cur,
                                  serving=shard in self._serving)
        if epoch > cur:
            if shard in self._serving:
                self._demote(shard, epoch)
            else:
                self._adopt_epoch(shard, epoch)

    def _demote(self, shard, new_epoch):
        """Stop serving ``shard``: a newer lineage exists.  The copy stays
        but is no longer promotable (it may hold writes the surviving
        lineage never saw), and forwarding stops.  Idempotent."""
        self._adopt_epoch(shard, new_epoch)
        with self._repl_lock:
            if shard not in self._serving:
                return
            self._serving.discard(shard)
            self._promotable.discard(shard)
            self._fwd_ok[shard] = False
            record_fault("ps_demotions")

    def _fence(self, shard, frame_epoch):
        """The serving side's gate of a replication-relevant frame: equal
        epochs pass; a newer frame epoch means we missed a promotion
        (demote, refuse); an older one is a stale sender (refuse, and
        teach it ours).  Runs before the (client, seq) registration, so a
        refused frame retried at the right epoch still applies."""
        with self._epoch_lock:
            cur = self._epochs.get(shard, 0)
        if frame_epoch == cur:
            return
        record_fault("ps_epoch_refused")
        if frame_epoch > cur:
            self._demote(shard, frame_epoch)
            raise EpochFenced(shard, frame_epoch, serving=False)
        raise EpochFenced(shard, cur, serving=shard in self._serving)

    def register_table(self, shard):
        """Bookkeeping of a table created directly on ``local``."""
        with self._repl_lock:
            self._ntables[shard] = self._ntables.get(shard, 0) + 1

    def _fwd_target(self, shard):
        """The other holder of ``shard``: its backup rank when we are its
        home primary, its home rank when we are the promoted backup."""
        return (shard + 1) % self.world if self.rank == shard else shard

    def _store_serving(self, shard):
        """(store, shard) serving ``shard`` (-1: our own), or an error the
        client sees and fails over on: a stale route never reads a
        possibly stale replica."""
        if shard < 0:
            shard = self.rank
        if shard not in self._serving:
            raise RuntimeError(
                f"shard {shard} not served by rank {self.rank} "
                f"(serving {sorted(self._serving)})")
        return self._stores[shard], shard

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop:      # raced a concurrent stop(): refuse service
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._live_conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name=f"ps-serve-r{self.rank}").start()

    def _serve(self, conn):
        try:
            while True:
                body = _recv_frame(conn)
                if self._stop:
                    # a stopped server refuses ALL service, even on a
                    # connection that slipped past stop()
                    break
                try:
                    stop = self._handle(conn, body)
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # the handler's error, to the client
                    _send_frame(conn, b"\x01",
                                f"{type(e).__name__}: {e}".encode())
                    continue
                if stop:
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            self._live_conns.discard(conn)
            conn.close()

    def _seen(self, client, seq):
        """True iff this (client, seq) non-idempotent op (push, clock) was
        already applied: a retry resent a frame whose ack was lost.
        Clients base seq on time_ns, so a restarted client's sequences
        are fresh."""
        with self._applied_lock:
            seen = self._applied.setdefault(client, OrderedDict())
            if seq in seen:
                return True
            seen[seq] = True
            while len(seen) > _DEDUP_WINDOW:
                seen.popitem(last=False)
            return False

    def _clock_vec(self, channel):
        v = self._clocks.get(channel)
        if v is None:
            raise RuntimeError(
                f"SSP channel {channel} not initialised: call "
                f"ssp_init(n_workers, channel={channel}) first")
        return v

    # -- op-log forwarding ---------------------------------------------------
    def _forward(self, shard, body):
        """Mirror one applied mutating frame to ``shard``'s other holder,
        under ``_repl_lock`` (the apply's critical section), before the
        ack.  During an OP_SYNC transfer the frame is buffered for the
        catch-up instead.  A transport failure degrades to unreplicated
        serving until ``re_replicate``; an epoch-fence refusal means the
        peer is a newer lineage: demote and refuse the client."""
        log = self._oplog.get(shard)
        if log is not None:
            log.append(bytes(body))
            return
        if not self._fwd_ok.get(shard):
            return
        try:
            if self.rpc_fn is None:
                raise RuntimeError("replication transport not attached")
            self.rpc_fn(self._fwd_target(shard), OP_REPLICATE, 0,
                        np.asarray([shard], np.int64), payload=bytes(body),
                        epoch=self._epochs.get(shard, 0))
        except Exception as e:
            fence = _fence_info(e)
            if fence is not None:
                self._demote(shard, fence[0])
                raise EpochFenced(shard, fence[0], serving=False) from e
            self._fwd_ok[shard] = False
            record_fault("repl_forward_failed")
            warnings.warn(
                f"rank {self.rank}: op-log forward for shard {shard} to "
                f"rank {self._fwd_target(shard)} failed "
                f"({type(e).__name__}: {e}) — shard now serves "
                f"UNREPLICATED until re_replicate()", RuntimeWarning)

    def _probe_lineage(self, shard):
        """While forwarding of ``shard`` is broken, probe its other
        holder's epoch (at most every ``HETU_PS_FENCE_PROBE_S`` s, 5 by
        default): a newer one means we were deposed while cut off —
        demote and refuse the write in flight.  An unreachable peer keeps
        the degraded but available serving."""
        interval = float(os.environ.get("HETU_PS_FENCE_PROBE_S", "5"))
        now = time.monotonic()
        if now - self._fence_probe.get(shard, -1e9) < interval:
            return
        self._fence_probe[shard] = now
        try:
            raw = self.rpc_fn(self._fwd_target(shard), OP_EPOCH, 0,
                              np.asarray([shard], np.int64),
                              op_timeout=2.0, record=False, retries=1)
            peer_epoch = struct.unpack("<qq", raw)[0]
        except Exception:
            return      # still unreachable: availability wins
        if peer_epoch > self._epochs.get(shard, 0):
            self._demote(shard, peer_epoch)
            raise EpochFenced(shard, peer_epoch, serving=False)

    def _maybe_probe_degraded(self, shard):
        """The deposed-check of a shard served with broken forwarding, run
        before the apply and outside ``_repl_lock``."""
        if not self._fwd_ok.get(shard) and self._oplog.get(shard) is None:
            self._probe_lineage(shard)

    def _apply_push(self, shard, store, table, keys, grads, lr, body):
        """Serving-side push: apply and mirror in one critical section."""
        if not self.replicable:
            store.push(table, keys // self.world, grads, lr)
            return
        self._maybe_probe_degraded(shard)
        with self._repl_lock:
            store.push(table, keys // self.world, grads, lr)
            self._forward(shard, body)

    def _apply_set_data(self, shard, store, table, arr, body):
        if not self.replicable:
            store.set_data(table, arr)
            return
        self._maybe_probe_degraded(shard)
        with self._repl_lock:
            store.set_data(table, arr)
            self._forward(shard, body)

    def _apply_replicated(self, shard, inner):
        """Replay one forwarded frame on the held (non-serving) replica of
        ``shard``, in the order the sender forwarded it (one connection,
        forwards serialized under its _repl_lock).  Dedup registers the
        original (client, seq), so the promotion-window retry of a push
        acked before the primary died is recognised.  The inner frame's
        epoch is not read: the outer OP_REPLICATE was fenced."""
        iop, itable, inkeys, ilr, iwidth, iclient, iseq, _, _ = \
            _HDR.unpack_from(inner)
        ioff = _HDR.size
        ikeys = np.frombuffer(inner, np.int64, inkeys, ioff)
        ioff += inkeys * 8
        if iop == OP_HEARTBEAT:
            # shard 0's mirrored liveness table, stamped with our clock
            with self._hb_lock:
                self._hb[int(ikeys[0])] = (time.monotonic(), int(ikeys[1]))
            return
        if iop == OP_SSP_INIT:
            n, channel = int(ikeys[0]), int(ikeys[1])
            with self._ssp_lock:
                cur = self._clocks.get(channel)
                if cur is None or cur.size != n:
                    self._clocks[channel] = np.zeros(n, np.int64)
            return
        if iop == OP_CLOCK:
            channel = int(ikeys[1]) if inkeys > 1 else 0
            worker = int(ikeys[0])
            if not self._seen(iclient, iseq):
                with self._ssp_lock:
                    v = self._clocks.get(channel)
                    if v is None or v.size <= worker:
                        # a re-attached standby may see ticks before any
                        # ssp_init: grow rather than break the stream
                        nv = np.zeros(max(self.world, worker + 1), np.int64)
                        if v is not None:
                            nv[:v.size] = v
                        v = self._clocks[channel] = nv
                    v[worker] += 1
                    self._ssp_lock.notify_all()
            return
        store = self._stores.get(shard)
        if store is None:
            raise RuntimeError(
                f"rank {self.rank} holds no replica of shard {shard}")
        if iop == OP_PUSH:
            if not self._seen(iclient, iseq):
                grads = np.frombuffer(inner, np.float32, inkeys * iwidth,
                                      ioff).reshape(inkeys, iwidth)
                store.push(itable, ikeys // self.world, grads, ilr)
        elif iop == OP_PUSH_PULL:
            npush = int(ikeys[0])
            if npush and not self._seen(iclient, iseq):
                grads = np.frombuffer(inner, np.float32, npush * iwidth,
                                      ioff).reshape(npush, iwidth)
                store.push(itable, ikeys[1:1 + npush] // self.world,
                           grads, ilr)
        elif iop == OP_SET_DATA:
            n = (len(inner) - ioff) // 4
            store.set_data(itable, np.frombuffer(
                inner, np.float32, n, ioff).reshape(-1, iwidth))
        else:
            raise RuntimeError(
                f"{frame_repr(iop, itable, inkeys, client=iclient, seq=iseq)}"
                f" is not replicable")

    def _init_replica_table(self, shard, table, local_rows, width, opt_id,
                            seed, lr, beta1, beta2, eps, init_scale,
                            epoch=0):
        """Create table ``table`` in our copy of ``shard`` with the
        primary's init parameters (seeded init: the copies start
        bit-equal).  Idempotent per table id.  A newer ``epoch`` on a
        shard we still serve demotes us; an older one is refused."""
        store = self._stores.get(shard)
        if store is None:
            raise RuntimeError(
                f"rank {self.rank} is not a replica holder for shard "
                f"{shard} (replication={self.replication})")
        self._fence_or_adopt(shard, epoch)
        with self._repl_lock:
            have = self._ntables.get(shard, 0)
            if table < have:
                return               # idempotent re-init
            if table > have:
                raise RuntimeError(
                    f"out-of-order replica init: table {table} before "
                    f"{have} on shard {shard}")
            tid = store.init_table(
                local_rows, width, opt=_OPT_NAMES[opt_id], lr=lr,
                beta1=beta1, beta2=beta2, eps=eps, seed=seed,
                init_scale=init_scale)
            assert tid == table, (tid, table)
            self._ntables[shard] = table + 1

    def _promote(self, shard, want_tables, want_epoch=0):
        """Serve ``shard`` from our replica (idempotent); returns its
        resulting epoch.  Refused when we hold no copy, fewer tables than
        the client has, or a copy never synced.  A real promotion bumps
        the epoch past ours and the promoter's (``want_epoch``), so the
        new lineage dominates the old; concurrent promoters converge on
        one epoch."""
        with self._repl_lock:
            cur = self._epochs.get(shard, 0)
            if shard in self._serving:
                if want_epoch > cur:
                    cur = want_epoch
                    self._adopt_epoch(shard, cur)
                return cur
            if not self.replicable:
                raise RuntimeError(
                    f"rank {self.rank} runs unreplicated "
                    f"(replication={self.replication}) — cannot promote "
                    f"shard {shard}")
            store = self._stores.get(shard)
            if store is None or self._ntables.get(shard, 0) < want_tables:
                raise RuntimeError(
                    f"rank {self.rank} replica of shard {shard} has "
                    f"{self._ntables.get(shard, 0)}/{want_tables} tables "
                    f"— not promotable")
            if shard not in self._promotable and want_tables > 0:
                raise RuntimeError(
                    f"rank {self.rank} copy of shard {shard} was never "
                    f"synced from the serving replica — not promotable")
            new_epoch = max(cur + 1, want_epoch)
            self._adopt_epoch(shard, new_epoch)
            self._serving.add(shard)
            # the old primary is presumed dead: no forwarding until
            # re_replicate() attaches a fresh backup
            self._fwd_ok[shard] = False
            record_fault("ps_promoted")
            record_fault("ps_epoch_bumps")
            return new_epoch

    def _sync_to(self, shard, target):
        """Re-replication, source half: save every table of ``shard`` to
        temporary files (the store's own format), stream them to
        ``target`` in bounded OP_SYNC_PUT chunks, then drain the op-log
        buffered meanwhile and resume live forwarding.  Mutations wait
        only for the save and the drain, not the transfer."""
        if shard not in self._serving:
            raise RuntimeError(
                f"rank {self.rank} does not serve shard {shard} — "
                f"only the serving replica can source a sync")
        if not self.replicable:
            raise RuntimeError("replication disabled on this server")
        if target != self._fwd_target(shard):
            raise RuntimeError(
                f"shard {shard}: rank {target} is not its replica slot "
                f"(expected {self._fwd_target(shard)})")
        store = self._stores[shard]
        ntabs = self._ntables.get(shard, 0)
        paths = []
        with self._repl_lock:
            if self._fwd_ok.get(shard):
                return               # redundancy already live
            if self._oplog.get(shard) is not None:
                raise RuntimeError(
                    f"shard {shard}: sync already in progress")
            self._fwd_ok[shard] = False
            self._oplog[shard] = []
            for tid in range(ntabs):
                fd, path = tempfile.mkstemp(prefix="hetu_ps_sync_")
                os.close(fd)
                paths.append(path)
                store.save(tid, path)
        try:
            chunk = min(_V3_CHUNK, max(1 << 20, MAX_FRAME_BYTES // 2))
            epoch = self._epochs.get(shard, 0)
            for tid, path in enumerate(paths):
                size = os.path.getsize(path)
                nch = max(1, -(-size // chunk))
                with open(path, "rb") as f:
                    for ci in range(nch):
                        self.rpc_fn(
                            target, OP_SYNC_PUT, tid,
                            np.asarray([shard, ci, nch, size, ntabs],
                                       np.int64),
                            payload=f.read(chunk), epoch=epoch)
            with self._repl_lock:
                # the drain and the switch to live forwarding are atomic
                # against concurrent applies
                for frame in self._oplog.pop(shard, []):
                    self.rpc_fn(target, OP_REPLICATE, 0,
                                np.asarray([shard], np.int64),
                                payload=frame, epoch=epoch)
                self._fwd_ok[shard] = True
            record_fault("ps_re_replicated")
        except Exception as e:
            with self._repl_lock:
                self._oplog.pop(shard, None)
                self._fwd_ok[shard] = False
            fence = _fence_info(e)
            if fence is not None:
                # the target is a newer lineage: we are the stale
                # ex-primary, so demote instead of retrying every tick
                self._demote(shard, fence[0])
                raise EpochFenced(shard, fence[0], serving=False) from e
            record_fault("ps_re_replicate_failed")
            raise
        finally:
            for path in paths:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _sync_put(self, shard, table, ci, nch, total, ntabs, payload,
                  epoch=0):
        """Re-replication, sink half: append the chunks to a temporary
        file and load the completed table through the store's own load;
        once all ``ntabs`` tables have landed the copy is promotable.  A
        retried chunk is absorbed; an older epoch is refused, a newer one
        adopted (demoting us if we still served the shard)."""
        store = self._stores.get(shard)
        if store is None:
            raise RuntimeError(
                f"rank {self.rank} holds no replica of shard {shard}")
        self._fence_or_adopt(shard, epoch)
        if shard in self._serving and shard != self.rank:
            raise RuntimeError(
                f"rank {self.rank} already SERVES shard {shard} — "
                f"refusing a snapshot that would overwrite live state")
        part = self._sync_parts.get((shard, table))
        if part is None:
            fd, path = tempfile.mkstemp(prefix="hetu_ps_sync_")
            os.close(fd)
            part = self._sync_parts[(shard, table)] = {
                "path": path, "next": 0}
        if ci < part["next"]:
            return                   # a retried chunk
        if ci != part["next"]:
            raise RuntimeError(
                f"sync chunk gap: got {ci}, expected {part['next']}")
        with open(part["path"], "ab") as f:
            f.write(payload)
        part["next"] = ci + 1
        if part["next"] < nch:
            return
        del self._sync_parts[(shard, table)]
        try:
            if os.path.getsize(part["path"]) != total:
                raise RuntimeError(
                    f"sync snapshot truncated: "
                    f"{os.path.getsize(part['path'])}/{total} bytes")
            store.load(table, part["path"])
        finally:
            try:
                os.unlink(part["path"])
            except OSError:
                pass
        with self._repl_lock:
            done = self._sync_parts.setdefault(("loaded", shard), set())
            done.add(table)
            if len(done) >= ntabs:
                del self._sync_parts[("loaded", shard)]
                self._promotable.add(shard)

    def _mirror_shard0(self, body):
        """Scheduler state (heartbeats, SSP clocks) rides shard 0's
        replication, so the liveness table and the SSP barrier survive
        rank 0's death."""
        if self.replicable and 0 in self._serving:
            with self._repl_lock:
                self._forward(0, body)

    def _handle(self, conn, body):
        op, table, nkeys, lr, width, client, seq, shard, epoch = \
            _HDR.unpack_from(body)
        off = _HDR.size
        keys = np.frombuffer(body, np.int64, nkeys, off)
        off += nkeys * 8
        if op == OP_PULL:
            # reads are unfenced: a cut-off cell keeps serving bounded-
            # staleness reads; fencing guards the writes
            store, _ = self._store_serving(shard)
            out = store.pull(table, keys // self.world)
            _send_frame(conn, b"\x00",
                        np.ascontiguousarray(out, np.float32).tobytes())
        elif op == OP_PUSH:
            store, shard = self._store_serving(shard)
            self._fence(shard, epoch)
            if not self._seen(client, seq):
                grads = np.frombuffer(body, np.float32, nkeys * width,
                                      off).reshape(nkeys, width)
                self._apply_push(shard, store, table, keys, grads, lr, body)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_PUSH_PULL:
            # the push half is as non-idempotent as OP_PUSH: a retried
            # frame skips it but still answers the (idempotent) pull
            store, shard = self._store_serving(shard)
            self._fence(shard, epoch)
            npush = int(keys[0])
            push_keys = keys[1:1 + npush]
            pull_keys = keys[1 + npush:]
            if npush and not self._seen(client, seq):
                grads = np.frombuffer(body, np.float32, npush * width,
                                      off).reshape(npush, width)
                self._apply_push(shard, store, table, push_keys, grads, lr,
                                 body)
            out = store.pull(table, pull_keys // self.world)
            _send_frame(conn, b"\x00",
                        np.ascontiguousarray(out, np.float32).tobytes())
        elif op == OP_VERSIONS:
            store, _ = self._store_serving(shard)
            v = store.versions(table, keys // self.world)
            _send_frame(conn, b"\x00",
                        np.ascontiguousarray(v, np.int64).tobytes())
        elif op == OP_SET_DATA:
            store, shard = self._store_serving(shard)
            self._fence(shard, epoch)
            n = (len(body) - off) // 4
            arr = np.frombuffer(body, np.float32, n, off).reshape(-1, width)
            self._apply_set_data(shard, store, table, arr, body)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_REPLICATE:
            s = int(keys[0])
            self._fence_or_adopt(s, epoch, refuse_equal_if_serving=True)
            self._apply_replicated(s, body[off:])
            _send_frame(conn, b"\x00\x01")
        elif op == OP_PROMOTE:
            ep = self._promote(int(keys[0]), int(keys[1]),
                               int(keys[2]) if nkeys > 2 else 0)
            _send_frame(conn, b"\x00", struct.pack("<q", ep))
        elif op == OP_INIT:
            # keys [local_rows, width, opt_id, seed]; the payload packs the
            # float init parameters (a NaN init_scale: the store default)
            p = struct.unpack_from("<5d", body, off)
            self._init_replica_table(
                shard, table, int(keys[0]), int(keys[1]), int(keys[2]),
                int(keys[3]), p[0], p[1], p[2], p[3],
                None if p[4] != p[4] else p[4], epoch=epoch)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_SYNC:
            self._fence(int(keys[0]), epoch)
            self._sync_to(int(keys[0]), int(keys[1]))
            _send_frame(conn, b"\x00\x01")
        elif op == OP_SYNC_PUT:
            self._sync_put(int(keys[0]), table, int(keys[1]), int(keys[2]),
                           int(keys[3]), int(keys[4]), body[off:],
                           epoch=epoch)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_EPOCH:
            # (epoch, serving) of any shard's copy here (0 if unheld): the
            # probe works against a standby or a demoted holder too
            s = self.rank if not nkeys else int(keys[0])
            _send_frame(conn, b"\x00",
                        struct.pack("<qq", self._epochs.get(s, 0),
                                    int(s in self._serving)))
        elif op == OP_CHECKSUM:
            # the state digest of any held copy, serving or not
            s = self.rank if shard < 0 else shard
            store = self._stores.get(s)
            if store is None:
                raise RuntimeError(
                    f"rank {self.rank} holds no copy of shard {s}")
            _send_frame(conn, b"\x00", store.state_digest(table).encode())
        elif op == OP_SSP_INIT:
            n, channel = int(keys[0]), int(keys[1])
            with self._ssp_lock:
                # idempotent: every rank calls init; a different size is an
                # explicit reset
                cur = self._clocks.get(channel)
                if cur is None or cur.size != n:
                    self._clocks[channel] = np.zeros(n, np.int64)
            self._mirror_shard0(body)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_CLOCK:
            # a retried tick whose ack was lost must not count twice
            channel = int(keys[1]) if nkeys > 1 else 0
            if not self._seen(client, seq):
                with self._ssp_lock:
                    self._clock_vec(channel)[int(keys[0])] += 1
                    self._ssp_lock.notify_all()
                self._mirror_shard0(body)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_SSP_SYNC:
            worker, staleness = int(keys[0]), int(keys[1])
            channel = int(keys[2]) if nkeys > 2 else 0
            # always bounded, by a total deadline (570 s without one, under
            # the client's 600 s socket deadline)
            deadline = time.monotonic() + (lr if lr > 0 else 570.0)
            ok = True
            with self._ssp_lock:
                v = self._clock_vec(channel)
                while v[worker] - v.min() > staleness:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._ssp_lock.wait(left):
                        ok = False
                        break
                    v = self._clock_vec(channel)
            _send_frame(conn, b"\x00", b"\x01" if ok else b"\x00")
        elif op == OP_CLOCKS:
            channel = int(keys[0]) if nkeys else 0
            with self._ssp_lock:
                v = self._clock_vec(channel).copy()
            _send_frame(conn, b"\x00", v.tobytes())
        elif op == OP_HEARTBEAT:
            with self._hb_lock:
                self._hb[int(keys[0])] = (time.monotonic(), int(keys[1]))
            self._mirror_shard0(body)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_ALIVE:
            # keys=[n] (or [n, 1]: strict, a never-pinged rank is dead), lr
            # the deadline in ms: 1 iff the rank pinged within it; a rank
            # never seen counts alive (startup stagger is not death)
            n = int(keys[0])
            strict = nkeys > 1 and bool(keys[1])
            deadline_s = (lr if lr > 0 else 10_000.0) / 1e3
            now = time.monotonic()
            mask = np.zeros(n, np.int64)
            with self._hb_lock:
                for r in range(n):
                    rec = self._hb.get(r)
                    mask[r] = (0 if strict else 1) if rec is None else \
                        int(now - rec[0] <= deadline_s)
            _send_frame(conn, b"\x00", mask.tobytes())
        elif op == OP_SHUTDOWN:
            _send_frame(conn, b"\x00\x01")
            return True
        else:
            raise ValueError(
                f"unknown opcode in frame "
                f"{frame_repr(op, table, nkeys, shard, client, seq)}")
        return False

    def stop(self):
        """Stop serving: the listening socket and every live connection
        close, so peers see a dead server at once."""
        self._stop = True
        try:    # shutdown wakes a blocked accept() where close() does not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._live_conns):
            try:
                conn.close()
            except OSError:
                pass


class DistributedStore:
    """A worker + server pair with ``key % world`` routing and the
    :class:`~hetu_tpu_torch.ps.store.EmbeddingStore` API.

    ``endpoints``: ``(host, port)`` of every rank, index = rank; this
    process's entry may be None (its own server's bound port is used).
    ``replication``: 1 (one copy) or 2 (a ring backup of every shard;
    default ``HETU_PS_REPLICATION``; a world of one degrades to 1).
    ``standby``: this process replaces a dead rank and serves nothing
    until re-replication (default ``HETU_PS_STANDBY=1``).  A shard
    process is one of these that serves until ``close``.
    """

    def __init__(self, rank, world, endpoints=None, host="127.0.0.1",
                 port=0, async_queue=64, rpc_timeout=60.0, rpc_retries=3,
                 connect_timeout=10.0, replication=None, standby=None):
        self.rank, self.world = rank, world
        if standby is None:
            standby = os.environ.get("HETU_PS_STANDBY", "") == "1"
        if replication is None:
            replication = int(os.environ.get("HETU_PS_REPLICATION", "1"))
        replication = int(replication)
        if not 1 <= replication <= 2:
            raise ValueError(
                f"replication={replication} unsupported: 1 (off) or 2 "
                f"(primary + one ring backup)")
        self.replication = replication if world >= 2 else 1
        self.local = EmbeddingStore()
        self.server = StoreServer(self.local, world, rank, host, port,
                                  replication=self.replication,
                                  standby=standby)
        self.endpoints = list(endpoints) if endpoints else [None] * world
        self.endpoints[rank] = (host, self.server.port)
        self.rpc_timeout = rpc_timeout
        self.rpc_retries = max(1, rpc_retries)
        self.connect_timeout = connect_timeout
        self._backoff_base = float(
            os.environ.get("HETU_RPC_BACKOFF_MS", "50")) / 1e3
        self._backoff_cap = 1.0
        self._backoff_rng = random.Random()
        # seq base = time_ns: increasing across process restarts, so a
        # relaunched worker never collides with its predecessor's entries
        # in a server's dedup window
        self._seq = itertools.count(time.time_ns())
        self._conns = {}
        self._conn_locks = {}
        self._connect_lock = threading.Lock()   # guards the conn dicts
        self._pool = None                       # lazy RPC fan-out pool
        self._tables = {}
        self._table_init_kw = {}   # tid -> init kwargs (replica init)
        #: shard -> the rank serving it; a failover flips an entry to the
        #: shard's other holder
        self._route = list(range(world))
        #: shard -> the fencing epoch this client believes current
        self._epoch = [0] * world
        #: leaf lock of _epoch / _route / _flip_epoch: fence refusals land
        #: on whichever thread sent the frame; never held across an RPC
        self._fence_lock = threading.Lock()
        self._flip_epoch = {}      # shard -> epoch at which the route flipped
        self._failed_over = set()  # shards running without redundancy
        self._queue = queue.Queue(maxsize=async_queue)
        self._async_thread = None
        self._hb_thread = None
        self._hb_stop = threading.Event()
        # the server's forwards and sync transfers ride this transport
        self.server.rpc_fn = self._rpc

    # -- connections -------------------------------------------------------
    def _conn(self, peer):
        # a lock a peer: a slow or dead peer does not stall the others
        with self._connect_lock:
            lock = self._conn_locks.setdefault(peer, threading.Lock())
        with lock:
            if peer not in self._conns:
                s = socket.create_connection(self.endpoints[peer],
                                             timeout=self.connect_timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._conns[peer] = s
            return self._conns[peer], lock

    def _drop_conn(self, peer):
        with self._connect_lock:
            lock = self._conn_locks.setdefault(peer, threading.Lock())
        with lock:
            s = self._conns.pop(peer, None)
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def _rpc(self, peer, op, table, keys, payload=b"", lr=-1.0, width=0,
             op_timeout=None, shard=-1, seq=None, record=True,
             retries=None, epoch=0):
        """One request / response against ``peer``: a timeout on every
        socket op, a failed op retried on a fresh connection after a
        backoff with the same (client, seq), exhausted retries raised as a
        RuntimeError naming the peer.  ``seq`` may be pinned by the
        caller (a failover resends the same frame); ``record=False``
        keeps a probe out of the counters."""
        keys = np.ascontiguousarray(keys, np.int64)
        hdr = _HDR.pack(op, table, keys.size, lr, width, self.rank,
                        next(self._seq) if seq is None else seq, shard,
                        epoch)
        t_rpc = time.perf_counter_ns()
        nbytes = keys.nbytes + len(payload)
        last_err = None
        delay = 0.0
        for attempt in range(self.rpc_retries if retries is None
                             else max(1, retries)):
            if attempt:
                if record:
                    record_fault("ps_rpc_retry")
                delay = _next_backoff(self._backoff_base, delay,
                                      self._backoff_cap, self._backoff_rng)
                time.sleep(delay)
            try:
                sock, lock = self._conn(peer)
                with lock:
                    sock.settimeout(op_timeout if op_timeout is not None
                                    else self.rpc_timeout)
                    _send_frame(sock, hdr, keys.tobytes(), payload)
                    resp = _recv_frame(sock)
                break
            except (TimeoutError, ConnectionError, OSError) as e:
                last_err = e
                self._drop_conn(peer)
        else:
            if record:
                record_fault("ps_peer_unreachable")
            host_, port_ = self.endpoints[peer] or ("?", "?")
            raise RuntimeError(
                f"PS peer {peer} at {host_}:{port_} unreachable after "
                f"{self.rpc_retries} attempts sending "
                f"{frame_repr(op, table, keys.size, shard)} "
                f"({type(last_err).__name__}: {last_err}) — server process "
                f"dead or wedged")
        if not resp or resp[:1] == b"\x01":
            raise RuntimeError(
                f"PS rank {peer} error on {op_name(op)}: "
                f"{resp[1:].decode(errors='replace')}")
        if record:
            record_rpc(op_name(op), (time.perf_counter_ns() - t_rpc) / 1e3,
                       nbytes)
        return resp[1:]

    # -- shard routing and client-side failover ------------------------------
    @staticmethod
    def _failover_worthy(err):
        """An exhausted transport (peer dead or wedged), or a stale route
        hitting a non-serving holder; an application error raises."""
        msg = str(err)
        return "unreachable" in msg or "not served" in msg

    def _note_fence(self, shard, err):
        """Adopt the lineage an epoch-fence refusal names: advance our
        epoch for ``shard`` (a locked max-merge) and, when the refuser no
        longer serves, flip the route to the shard's other holder — once
        an epoch, so two racing refusals of one event do not flip it back
        — and mark the shard for re-replication."""
        cur, serving = _fence_info(err)
        with self._fence_lock:
            known = self._epoch[shard]
            if cur > known:
                self._epoch[shard] = known = cur
            if not serving and cur == known \
                    and self._flip_epoch.get(shard) != cur:
                self._flip_epoch[shard] = cur
                dead = self._route[shard]
                self._route[shard] = (shard + 1) % self.world \
                    if dead == shard else shard
                self._failed_over.add(shard)

    def _rpc_shard(self, shard, op, table, keys, payload=b"", lr=-1.0,
                   width=0, op_timeout=None):
        """An RPC to the rank serving ``shard``.  With ``replication=2``
        an unreachable primary is a transparent failover (promote the
        backup, flip the route, resend THE SAME frame: its pinned seq
        keeps an acked push exactly-once on the backup), and an epoch
        refusal one retry at the learnt epoch and route."""
        seq = next(self._seq)
        peer = self._route[shard]
        try:
            return self._rpc(peer, op, table, keys, payload, lr, width,
                             op_timeout, shard=shard, seq=seq,
                             epoch=self._epoch[shard])
        except RuntimeError as e:
            if _fence_info(e) is not None:
                # learn the lineage, then take the same send-with-failover
                # path below (the corrected target can die too)
                self._note_fence(shard, e)
            elif self.replication < 2 or not self._failover_worthy(e):
                raise
            else:
                self._failover(shard, err=e, dead=peer)
        peer = self._route[shard]
        try:
            return self._rpc(peer, op, table, keys, payload, lr, width,
                             op_timeout, shard=shard, seq=seq,
                             epoch=self._epoch[shard])
        except RuntimeError as e:
            if self.replication < 2 or not self._failover_worthy(e):
                raise
            alt = self._failover(shard, err=e, dead=peer)
            return self._rpc(alt, op, table, keys, payload, lr, width,
                             op_timeout, shard=shard, seq=seq,
                             epoch=self._epoch[shard])

    def _failover(self, shard, err=None, dead=None):
        """Promote ``shard``'s other holder and re-route to it.  Raises,
        chaining the transport error, when that holder is unreachable or
        not promotable: both copies gone is a real outage.  ``dead``: the
        rank the failing RPC went to; when another thread has already
        moved the route off it, that failover stands and its rank is
        returned (promoting the dead rank's partner instead would try
        the dead rank itself; ROADMAP C16)."""
        with self._fence_lock:
            if dead is not None and self._route[shard] != dead:
                return self._route[shard]
            dead = self._route[shard]
        alt = (shard + 1) % self.world if dead == shard else shard
        record_fault("ps_failover")
        # telemetry only: a heartbeat table that still believes the
        # primary alive flags a possible partition; one short,
        # counter-silent attempt
        if shard != 0:
            try:
                hb_ms = float(os.environ.get("HETU_HEARTBEAT_MS", "500"))
                raw = self._rpc(self._route[0], OP_ALIVE, 0,
                                np.asarray([self.world, 1], np.int64),
                                lr=3.0 * hb_ms,
                                op_timeout=min(2.0, self.rpc_timeout),
                                record=False, retries=1)
                if np.frombuffer(raw, np.int64)[dead]:
                    record_fault("ps_failover_primary_reported_alive")
            except (RuntimeError, OSError, ConnectionError):
                pass
        try:
            # want_epoch = ours + 1: the promotion strictly dominates the
            # lineage we abandon
            raw = self._rpc(alt, OP_PROMOTE, 0,
                            np.asarray([shard, len(self._tables),
                                        self._epoch[shard] + 1], np.int64))
        except (RuntimeError, OSError, ConnectionError) as e2:
            record_fault("ps_failover_failed")
            raise RuntimeError(
                f"shard {shard}: serving rank {dead} unreachable AND "
                f"backup rank {alt} not promotable ({e2})") from err
        with self._fence_lock:
            if len(raw) >= 8:    # the ack names the resulting epoch
                self._epoch[shard] = max(self._epoch[shard],
                                         int(np.frombuffer(raw, np.int64,
                                                           1)[0]))
            self._route[shard] = alt
            # the promotion is this epoch's route change: a refusal
            # racing in from the deposed primary must not flip it back
            self._flip_epoch[shard] = self._epoch[shard]
            self._failed_over.add(shard)
        record_fault("ps_failover_promoted")
        return alt

    def _fanout(self, jobs):
        """Run per-peer jobs concurrently (one RPC in flight a peer)."""
        if len(jobs) <= 1:
            for fn in jobs:
                fn()
            return
        from concurrent.futures import ThreadPoolExecutor
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=max(2, self.world))
        futs = [self._pool.submit(fn) for fn in jobs]
        for f in futs:
            f.result()

    def _local(self, shard):
        """True iff ``shard`` is answered by this process's own server."""
        return self._route[shard] == self.rank and self.server.serves(shard)

    # -- tables ------------------------------------------------------------
    def _shard_rows(self, rows, shard):
        return (rows - shard + self.world - 1) // self.world

    def init_table(self, rows, width, **kw):
        """This rank's shard of a ``rows x width`` table (every rank calls
        it with the same arguments); returns its id.  Replicated, the
        shard's backup is created with the same arguments (seeded init:
        the copies start bit-equal)."""
        tid = self.local.init_table(self._shard_rows(rows, self.rank), width,
                                    **kw)
        self.server.register_table(self.rank)
        self._tables[tid] = (rows, width)
        self._table_init_kw[tid] = dict(kw)
        if self.replication >= 2:
            self._replica_init(tid, self.rank, (self.rank + 1) % self.world,
                               patient=True)
        return tid

    def _replica_init(self, tid, shard, target, patient=False):
        """OP_INIT ``shard``'s table ``tid`` on ``target`` (idempotent).
        ``patient``: at bring-up the backup's server may not be bound yet,
        so the init keeps knocking for a bounded grace; re-replication is
        impatient, so a dead standby defers fast."""
        rows, width = self._tables[tid]
        kw = self._table_init_kw.get(tid, {})
        scale = kw.get("init_scale")
        keys = np.asarray([self._shard_rows(rows, shard), width,
                           _OPT_IDS[kw.get("opt", "sgd")],
                           int(kw.get("seed", 0))], np.int64)
        payload = struct.pack(
            "<5d", float(kw.get("lr", 0.01)), float(kw.get("beta1", 0.9)),
            float(kw.get("beta2", 0.999)), float(kw.get("eps", 1e-7)),
            float("nan") if scale is None else float(scale))
        deadline = time.monotonic() + max(3 * self.connect_timeout, 15.0)
        while True:
            try:
                return self._rpc(target, OP_INIT, tid, keys, payload,
                                 shard=shard, record=not patient,
                                 epoch=self._epoch[shard])
            except RuntimeError as e:
                fence = _fence_info(e)
                if fence is not None:
                    # the target already belongs to a newer lineage: the
                    # replica table exists there
                    with self._fence_lock:
                        if fence[0] > self._epoch[shard]:
                            self._epoch[shard] = fence[0]
                    return None
                if not patient or time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    def width(self, table):
        return self._tables[table][1]

    def set_data(self, table, arr):
        """Scatter a full ``(rows, width)`` array across every shard,
        through each shard's replication path (the copies stay
        bit-equal)."""
        rows, width = self._tables[table]
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.shape != (rows, width):
            raise ValueError(f"set_data shape {arr.shape} != "
                             f"({rows}, {width})")
        jobs = []
        for s in range(self.world):
            part = np.ascontiguousarray(arr[s::self.world])
            if self._local(s):
                jobs.append(lambda s=s, part=part:
                            self._local_set_data(s, table, part))
            else:
                jobs.append(lambda s=s, part=part: self._rpc_shard(
                    s, OP_SET_DATA, table, np.zeros(0, np.int64),
                    part.tobytes(), width=width))
        self._fanout(jobs)

    # -- applies to a shard we serve ----------------------------------------
    # They skip the wire but ride the op-log: the server's apply + forward
    # critical section orders a shard's mutations whether they came over
    # TCP or from this process's own client.
    def _local_store(self, shard):
        return self.server._stores[shard]

    def _local_push(self, shard, table, keys, grads, lr):
        keys = np.ascontiguousarray(keys, np.int64)
        grads = np.ascontiguousarray(grads, np.float32)
        body = None
        if self.server.replicable:
            body = _HDR.pack(OP_PUSH, table, keys.size, lr, grads.shape[1],
                             self.rank, next(self._seq), shard,
                             self._epoch[shard]) \
                + keys.tobytes() + grads.tobytes()
        try:
            self.server._apply_push(shard, self._local_store(shard), table,
                                    keys, grads, lr, body)
        except EpochFenced as e:
            # our server just learnt it is a deposed lineage and demoted
            # itself; the apply landed only on the demoted copy, so the op
            # goes to the surviving lineage, which never saw it
            self._note_fence(shard, e)
            self._rpc_shard(shard, OP_PUSH, table, keys,
                            np.ascontiguousarray(grads).tobytes(), lr,
                            grads.shape[1])

    def _local_set_data(self, shard, table, part):
        body = None
        if self.server.replicable:
            body = _HDR.pack(OP_SET_DATA, table, 0, -1.0, part.shape[1],
                             self.rank, next(self._seq), shard,
                             self._epoch[shard]) + part.tobytes()
        try:
            self.server._apply_set_data(shard, self._local_store(shard),
                                        table, part, body)
        except EpochFenced as e:
            self._note_fence(shard, e)       # see _local_push
            self._rpc_shard(shard, OP_SET_DATA, table,
                            np.zeros(0, np.int64), part.tobytes(),
                            width=part.shape[1])

    # -- sparse ops (EmbeddingStore API) -----------------------------------
    # Wire-level dedup: a Zipf-skewed CTR batch is mostly duplicate keys,
    # so pull / push collapse to unique keys before the fanout and scatter
    # back through the inverse; the server accumulates duplicates within a
    # push anyway, so pre-summing them gives the same optimizer step and
    # version bump.  The rows saved are counted (ps_dedup_*).

    @staticmethod
    def _sorted_unique(flat):
        """True iff strictly ascending: the HET cache hands over sorted
        unique keys, which skip a second dedup."""
        return flat.size <= 1 or bool(np.all(np.diff(flat) > 0))

    def _dedup_grads(self, keys, grads, width):
        """(unique keys, per-unique summed grads); counts saved rows."""
        if self._sorted_unique(keys):
            return keys, grads
        uk, inv, counts = np.unique(keys, return_inverse=True,
                                    return_counts=True)
        if uk.size < keys.size:
            record_cache("ps_dedup_push_rows_saved", keys.size - uk.size)
            record_cache("ps_dedup_push_bytes_saved",
                         (keys.size - uk.size) * (width * 4 + 8))
        return uk, _segment_sum(grads, inv, counts)

    def pull(self, table, keys):
        keys = np.ascontiguousarray(keys, np.int64)
        flat = keys.reshape(-1)
        _, width = self._tables[table]
        if self._sorted_unique(flat):
            uk, inv = flat, None
        else:
            uk, inv = np.unique(flat, return_inverse=True)
            if uk.size < flat.size:
                record_cache("ps_dedup_pull_rows_saved",
                             flat.size - uk.size)
                record_cache("ps_dedup_pull_bytes_saved",
                             (flat.size - uk.size) * (width * 4 + 8))
        out = np.empty((uk.size, width), np.float32)
        owners = uk % self.world
        jobs = []
        for s in range(self.world):
            sel = np.nonzero(owners == s)[0]
            if not sel.size:
                continue
            if self._local(s):
                jobs.append(lambda s=s, sel=sel: out.__setitem__(
                    sel, self._local_store(s).pull(
                        table, uk[sel] // self.world)))
            else:
                def job(s=s, sel=sel):
                    raw = self._rpc_shard(s, OP_PULL, table, uk[sel])
                    out[sel] = np.frombuffer(raw, np.float32).reshape(
                        sel.size, width)
                jobs.append(job)
        self._fanout(jobs)
        if inv is not None:
            out = out[inv]
        return out.reshape(keys.shape + (width,))

    def push(self, table, keys, grads, lr=-1.0):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        _, width = self._tables[table]
        if not keys.size:
            return
        grads = np.ascontiguousarray(grads, np.float32).reshape(keys.size, -1)
        uk, acc = self._dedup_grads(keys, grads, width)
        owners = uk % self.world
        jobs = []
        for s in range(self.world):
            sel = np.nonzero(owners == s)[0]
            if not sel.size:
                continue
            if self._local(s):
                jobs.append(lambda s=s, sel=sel: self._local_push(
                    s, table, uk[sel], acc[sel], lr))
            else:
                jobs.append(lambda s=s, sel=sel: self._rpc_shard(
                    s, OP_PUSH, table, uk[sel],
                    np.ascontiguousarray(acc[sel]).tobytes(), lr, width))
        self._fanout(jobs)

    def push_pull(self, table, push_keys, grads, pull_keys, lr=-1.0):
        """Fused SDPushPull: each peer gets ONE ``OP_PUSH_PULL`` round trip
        carrying its push and pull shards (the server applies the push
        before it answers the pull); rows are owner-partitioned, so a
        pull depends only on the pushes of its own frame."""
        push_keys = np.ascontiguousarray(push_keys, np.int64).reshape(-1)
        pull_arr = np.ascontiguousarray(pull_keys, np.int64)
        pflat = pull_arr.reshape(-1)
        _, width = self._tables[table]
        if not push_keys.size:
            return self.pull(table, pull_arr)
        grads = np.ascontiguousarray(grads, np.float32).reshape(
            push_keys.size, -1)
        upk, acc = self._dedup_grads(push_keys, grads, width)
        if self._sorted_unique(pflat):
            ulk, linv = pflat, None
        else:
            ulk, linv = np.unique(pflat, return_inverse=True)
            record_cache("ps_dedup_pull_rows_saved", pflat.size - ulk.size)
            record_cache("ps_dedup_pull_bytes_saved",
                         (pflat.size - ulk.size) * (width * 4 + 8))
        out = np.empty((ulk.size, width), np.float32)
        powners = upk % self.world
        lowners = ulk % self.world
        jobs = []
        for s in range(self.world):
            psel = np.nonzero(powners == s)[0]
            lsel = np.nonzero(lowners == s)[0]
            if not psel.size and not lsel.size:
                continue
            if self._local(s):
                def local_job(s=s, psel=psel, lsel=lsel):
                    if psel.size:
                        self._local_push(s, table, upk[psel], acc[psel], lr)
                    if not lsel.size:
                        return
                    if self.server.serves(s):
                        out[lsel] = self._local_store(s).pull(
                            table, ulk[lsel] // self.world)
                    else:
                        # the push's fence just demoted our own server:
                        # the pull follows the re-route
                        raw = self._rpc_shard(s, OP_PULL, table, ulk[lsel])
                        out[lsel] = np.frombuffer(raw, np.float32).reshape(
                            lsel.size, width)
                jobs.append(local_job)
            elif psel.size:
                def fused_job(s=s, psel=psel, lsel=lsel):
                    frame_keys = np.concatenate(
                        (np.asarray([psel.size], np.int64),
                         upk[psel], ulk[lsel]))
                    raw = self._rpc_shard(
                        s, OP_PUSH_PULL, table, frame_keys,
                        np.ascontiguousarray(acc[psel]).tobytes(), lr,
                        width)
                    if lsel.size:
                        out[lsel] = np.frombuffer(raw, np.float32).reshape(
                            lsel.size, width)
                        # only a frame that carried BOTH halves saved a
                        # round trip
                        record_cache("ps_push_pull_fused_rpcs", 1)
                jobs.append(fused_job)
            else:       # nothing to push at this peer: a plain pull
                def pull_job(s=s, lsel=lsel):
                    raw = self._rpc_shard(s, OP_PULL, table, ulk[lsel])
                    out[lsel] = np.frombuffer(raw, np.float32).reshape(
                        lsel.size, width)
                jobs.append(pull_job)
        self._fanout(jobs)
        if linv is not None:
            out = out[linv]
        return out.reshape(pull_arr.shape + (width,))

    def versions(self, table, keys):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        uk, inv = np.unique(keys, return_inverse=True)
        out = np.empty(uk.size, np.int64)
        owners = uk % self.world
        jobs = []
        for s in range(self.world):
            sel = np.nonzero(owners == s)[0]
            if not sel.size:
                continue
            if self._local(s):
                jobs.append(lambda s=s, sel=sel: out.__setitem__(
                    sel, self._local_store(s).versions(
                        table, uk[sel] // self.world)))
            else:
                def vjob(s=s, sel=sel):
                    raw = self._rpc_shard(s, OP_VERSIONS, table, uk[sel])
                    out[sel] = np.frombuffer(raw, np.int64)
                jobs.append(vjob)
        self._fanout(jobs)
        return out[inv]

    # -- ASP: bounded async push --------------------------------------------
    def _async_worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            table, keys, grads, lr = item
            try:
                self.push(table, keys, grads, lr)
            finally:
                self._queue.task_done()

    def push_async(self, table, keys, grads, lr=-1.0):
        """Enqueue a push; blocks only when ``async_queue`` is full
        (bounded eventual consistency, ASP)."""
        if self._async_thread is None:
            self._async_thread = threading.Thread(
                target=self._async_worker, daemon=True,
                name=f"ps-async-r{self.rank}")
            self._async_thread.start()
        self._queue.put((table, np.array(keys, np.int64, copy=True),
                         np.array(grads, np.float32, copy=True), lr))

    def flush(self):
        """Barrier: every queued async push has been applied."""
        if self._async_thread is not None:
            self._queue.join()

    # -- SSP via shard 0 (the reference scheduler role) ----------------------
    # ``channel`` separates independent clock consumers: the executor's SSP
    # loop ticks channel 0, partial-reduce arrivals channel 1.  Replicated,
    # every tick and init is mirrored to shard 0's backup, so the barrier
    # fails over with the shard.
    def ssp_init(self, n_workers, channel=0):
        """Idempotent per (channel, size): every rank may call it."""
        self._rpc_shard(0, OP_SSP_INIT, 0,
                        np.asarray([n_workers, channel], np.int64))

    def clock(self, worker=None, channel=0):
        w = self.rank if worker is None else worker
        self._rpc_shard(0, OP_CLOCK, 0, np.asarray([w, channel], np.int64))

    def clocks(self, channel=0):
        """Every worker's clock (shard 0's copy): the arrival feed of
        partial-reduce group formation."""
        raw = self._rpc_shard(0, OP_CLOCKS, 0,
                              np.asarray([channel], np.int64))
        return np.frombuffer(raw, np.int64).copy()

    #: the server blocks on a condition (OP_SSP_SYNC): one RPC waits out
    #: the whole bound
    ssp_blocking = True

    def ssp_sync(self, worker=None, staleness=0, timeout_ms=0, channel=0):
        w = self.rank if worker is None else worker
        # the socket deadline outlives the requested wait; timeout_ms=0
        # waits for stragglers, bounded at 600 s
        raw = self._rpc_shard(0, OP_SSP_SYNC, 0,
                              np.asarray([w, staleness, channel], np.int64),
                              lr=timeout_ms / 1e3 if timeout_ms else -1.0,
                              op_timeout=(timeout_ms / 1e3 + 30.0)
                              if timeout_ms else 600.0)
        return raw == b"\x01"

    # -- liveness: heartbeats on shard 0 -------------------------------------
    # Replicated, shard 0's server mirrors every heartbeat to the shard's
    # backup: alive_mask survives rank 0's death.
    def heartbeat(self, rank=None, step=0):
        """Ping shard 0's liveness table."""
        w = self.rank if rank is None else rank
        self._rpc_shard(0, OP_HEARTBEAT, 0, np.asarray([w, step], np.int64))

    def alive_mask(self, deadline_ms, n_workers=None):
        """int64 mask over workers: 1 iff the rank pinged within
        ``deadline_ms``, or never pinged at all (liveness declares death
        only for ranks it has seen alive)."""
        n = self.world if n_workers is None else n_workers
        raw = self._rpc_shard(0, OP_ALIVE, 0, np.asarray([n], np.int64),
                              lr=float(deadline_ms))
        return np.frombuffer(raw, np.int64).copy()

    def start_heartbeat(self, interval_ms=None, step_fn=None):
        """Background pings every ``interval_ms`` (default
        ``HETU_HEARTBEAT_MS``, 500) until ``close``; ``step_fn`` gives the
        step reported.  A failed ping is counted
        (``heartbeat_send_failed``) and retried next interval."""
        if self._hb_thread is not None:
            return
        iv = (float(os.environ.get("HETU_HEARTBEAT_MS", "500"))
              if interval_ms is None else float(interval_ms)) / 1e3

        def beat():
            while not self._hb_stop.wait(iv):
                try:
                    self.heartbeat(step=int(step_fn()) if step_fn else 0)
                except (RuntimeError, OSError, ConnectionError):
                    record_fault("heartbeat_send_failed")

        self._hb_thread = threading.Thread(
            target=beat, daemon=True, name=f"hetu-hb-{self.rank}")
        self._hb_thread.start()

    def liveness_report(self, deadline_ms, n_workers=None):
        """Ranks the heartbeat table calls dead, split into ``dead`` (no
        answer to one direct ``OP_EPOCH`` probe either) and
        ``unreachable`` (the rank answers this client: it only fails to
        reach shard 0, counted as ``ps_unreachable``), beside ``alive``."""
        n = self.world if n_workers is None else int(n_workers)
        mask = self.alive_mask(deadline_ms, n)
        report = {"alive": [], "dead": [], "unreachable": []}
        for r in range(min(n, self.world)):
            if mask[r]:
                report["alive"].append(r)
                continue
            try:
                self._rpc(r, OP_EPOCH, 0, np.asarray([r], np.int64),
                          op_timeout=min(2.0, self.rpc_timeout),
                          record=False, retries=1)
            except (RuntimeError, OSError, ConnectionError):
                report["dead"].append(r)
            else:
                report["unreachable"].append(r)
                record_fault("ps_unreachable")
        return report

    # -- re-replication and lineage introspection ----------------------------
    def re_replicate(self, shard=None):
        """Restore redundancy for ``shard`` (default: every shard this
        client failed over): replica tables on the shard's vacant holder
        (``OP_INIT``), then the serving replica's snapshot and op-log
        catch-up (``OP_SYNC``).  A second failure of the shard is then
        survivable."""
        if self.replication < 2:
            raise RuntimeError("re_replicate needs replication >= 2")
        shards = sorted(self._failed_over) if shard is None else [shard]
        for s in shards:
            serving = self._route[s]
            target = s if serving != s else (s + 1) % self.world
            for tid in sorted(self._tables):
                self._replica_init(tid, s, target)
            if serving == self.rank:
                self.server._sync_to(s, target)
            else:
                self._rpc(serving, OP_SYNC, 0,
                          np.asarray([s, target], np.int64),
                          op_timeout=max(self.rpc_timeout, 600.0),
                          epoch=self._epoch[s])
            self._failed_over.discard(s)

    def re_replicate_async(self, shard=None):
        """:meth:`re_replicate` on a background thread; a failure is a
        warning (and ``ps_re_replicate_failed``), not a crash."""
        def run():
            try:
                self.re_replicate(shard)
            except (RuntimeError, OSError, ConnectionError) as e:
                warnings.warn(f"background re-replication failed: {e}",
                              RuntimeWarning)
        t = threading.Thread(target=run, daemon=True,
                             name=f"hetu-resync-{self.rank}")
        t.start()
        return t

    def maybe_re_replicate(self):
        """Opportunistic repair (the executor's ``HETU_PS_REREPLICATE_EVERY``
        tick): one re-replication try for each shard running without a
        backup — one this client failed over, or one our server serves
        with broken forwarding; a still-dead target defers
        (``ps_re_replicate_deferred``).  True iff a shard was repaired."""
        if self.replication < 2:
            return False
        pending = set(self._failed_over)
        srv = self.server
        if srv.replicable:
            for s in list(srv._serving):
                if not srv._fwd_ok.get(s) and srv._oplog.get(s) is None:
                    pending.add(s)
        if not pending:
            return False
        repaired = False
        for s in sorted(pending):
            try:
                self.re_replicate(s)
                repaired = True
            except (RuntimeError, OSError, ConnectionError):
                record_fault("ps_re_replicate_deferred")
        return repaired

    def table_checksum(self, table, shard, rank=None):
        """The state digest of ``shard``'s copy of ``table`` on ``rank``
        (default: the serving rank): the divergence check behind
        ``ps_fsck --verify``."""
        peer = self._route[shard] if rank is None else rank
        if peer == self.rank:
            return self.server._stores[shard].state_digest(table)
        raw = self._rpc(peer, OP_CHECKSUM, table, np.zeros(0, np.int64),
                        shard=shard)
        return raw.decode()

    def shard_epoch(self, shard, rank=None):
        """``(epoch, serving)`` of ``shard``'s copy on ``rank`` (default:
        the rank this client routes the shard to)."""
        peer = self._route[shard] if rank is None else rank
        if peer == self.rank:
            return (self.server.epoch(shard), self.server.serves(shard))
        raw = self._rpc(peer, OP_EPOCH, 0, np.asarray([shard], np.int64))
        ep, serving = struct.unpack("<qq", raw)
        return int(ep), bool(serving)

    # -- shard persistence (reference per-server SaveParam) -----------------
    # Shard files are named by shard, ``<path>.shard<s>``, for every shard
    # this server serves: after a failover the promoted server saves the
    # shard it adopted, and an unsynced standby saves nothing.
    def save(self, table, path):
        for shard in sorted(self.server._serving):
            self.server._stores[shard].save(table, f"{path}.shard{shard}")

    def load(self, table, path):
        for shard in sorted(self.server._serving):
            self.server._stores[shard].load(table, f"{path}.shard{shard}")

    def close(self):
        """Drain the async pushes, say goodbye to every peer, stop the
        heartbeat, the pool and the server."""
        self._hb_stop.set()
        self.flush()
        if self._async_thread is not None:
            self._queue.put(None)
        for peer in list(self._conns):
            try:
                # best effort: a peer already gone is no fault
                self._rpc(peer, OP_SHUTDOWN, 0, np.zeros(0, np.int64),
                          op_timeout=min(5.0, self.rpc_timeout),
                          record=False, retries=1)
            except (OSError, RuntimeError, ConnectionError):
                pass
            self._drop_conn(peer)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self.server.stop()


class _DevLookup:
    """Pending device-mode lookup (:meth:`DistCacheTable.begin_lookup`):
    the host-side plan frozen before the one fallible store round trip.
    :meth:`roundtrip` touches ONLY the store (no cache state, no lock), so
    it is safe on any thread: the executor runs it on its feed thread."""

    __slots__ = ("cache", "flat", "uk", "inv", "cnt", "slots",
                 "hit", "refresh", "rkeys", "rslots", "dirty", "plan",
                 "absent", "pk", "pg", "positions", "fill_targets", "done")

    def __init__(self, cache, flat):
        self.cache, self.flat = cache, flat
        self.uk = self.inv = self.cnt = self.slots = None
        self.hit = self.refresh = None
        self.rkeys = self.rslots = None
        self.dirty = self.plan = self.absent = None
        self.pk = self.pg = None
        self.positions = self.fill_targets = None
        self.done = False

    def roundtrip(self):
        """Pending pushes + the batched MISS pull, fused into one
        ``push_pull`` when both are due.  Returns the pulled rows aligned
        to ``rkeys`` (None when the batch had no misses)."""
        c = self.cache
        rows = None
        if self.pk is not None:
            if self.rkeys is not None:
                rows = c.store.push_pull(c.table, self.pk, self.pg,
                                         self.rkeys, c.lr)
            else:
                c.store.push(c.table, self.pk, self.pg, c.lr)
        if rows is None and self.rkeys is not None:
            rows = c.store.pull(c.table, self.rkeys)
        return rows


class DistCacheTable:
    """HET bounded-staleness embedding cache, vectorized and batch-granular
    (reference ``src/hetu_cache/cache.h`` pull_bound / push_bound
    semantics; HET, VLDB'22), over an :class:`EmbeddingStore` table.

    Storage is a ``(limit, width)`` float32 slab plus an open-addressed
    int64 key→slot hash table in numpy.  The contract (the JAX package's
    per-key oracle ``refcache.py`` implements the same rules):

    - Decisions are batch-granular over the call's sorted unique keys: a
      key is a HIT iff cached with ``uses < pull_bound``; its occurrences
      serve the same row and ``uses`` grows by the occurrence count.  A
      refresh (stale or absent) re-pulls the row and restarts ``uses`` at
      the occurrence count.
    - ``update`` accumulates per-key grads client-side (``gcnt`` grows by
      the occurrence count); reaching ``push_bound`` pushes the
      accumulated grad and invalidates the row (``uses = pull_bound``), as
      does ``flush``.  Updating an uncached key allocates a grad-only slot
      that never serves.
    - Eviction at ``limit``: victims are the smallest ``(tick, key)``
      [LRU] or ``(freq, tick, key)`` [LFU] among slots the batch does not
      touch; dirty victims join the batched push.  Unique keys beyond
      capacity are served (and their grads pushed) uncached.

    **Device-resident mode** (``device=True``): the slot table, hash
    table, clocks and commit protocol stay on the host, unchanged, and the
    row slab lives on ``slab_device`` (CUDA by default; the CPU only when
    asked for) as ``(limit + device_scratch + 1, width)`` float32: the
    ``limit`` cache slots, ``device_scratch`` rows at ``[limit, limit +
    scratch)`` for a batch's uncacheable keys, and the JAX layout's one
    spare row.  A lookup is :meth:`begin_lookup` (plan, under the lock) →
    :meth:`_DevLookup.roundtrip` (pushes + MISS pull, lock-free) →
    :meth:`finish_lookup` (commit, and the miss rows land in the slab in
    place).  Hit rows are gathered on the card by slot index (kernel B4),
    and the training grads arrive summed per unique key (kernel B5)
    through :meth:`apply_update_summed`.  The lock is held from
    ``begin_lookup`` to ``finish_lookup`` / :meth:`abort_lookup`.  The
    host ``_data`` slab is not kept in device mode.

    **Read-only serving mode** (``read_only=True``, what
    :class:`~hetu_tpu_torch.serving.InferenceExecutor` serves through): a
    cached row serves without spending ``pull_bound`` or touching the
    grad slab, since a serving replica never writes; ``update`` is
    refused.  Staleness is by server version instead: each miss fill
    records the rows' versions (one ``versions`` fanout before the pull,
    so a write between the two leaves a version older than the data),
    and :meth:`refresh_stale` — called, or every ``refresh_every``
    lookups on a background thread (:meth:`refresh_join` waits for it) —
    re-pulls exactly the cached rows whose version advanced.  Eviction
    recency still advances.  A device slab with ``read_only`` is refused.
    """

    _EMPTY, _TOMB = -1, -2

    def __init__(self, store, table, limit=1 << 16, pull_bound=100,
                 push_bound=10, lr=-1.0, policy="lru", read_only=False,
                 refresh_every=0, device=False, device_scratch=None,
                 device_interpret=None, slab_device=None):
        if device_interpret is not None:
            raise NotImplementedError(
                "DistCacheTable(device_interpret=): the port's kernels are "
                "CUDA, with no interpret mode; a CPU slab "
                "(slab_device='cpu') takes their plain versions")
        self.store, self.table = store, table
        self.width = int(store.width(table))
        self.limit = int(limit)
        self.pull_bound, self.push_bound = int(pull_bound), int(push_bound)
        self.lr = lr
        self.device = bool(device)
        self.read_only = bool(read_only)
        if self.device and self.read_only:
            raise NotImplementedError(
                "DistCacheTable(device=True, read_only=True): the "
                "serving path keeps its host slab (version-refresh "
                "rides it) — device-resident serving is future work")
        #: read-only mode: a refresh sweep every N lookups (0: only when
        #: refresh_stale() is called)
        self.refresh_every = int(refresh_every)
        self._lookups_since_refresh = 0
        self._refresh_thread = None   # the sweep in flight (at most one)
        #: where the device slab lives (device mode only)
        self.slab_device = resolve_device(slab_device) if self.device \
            else None
        self._dev_scratch = int(device_scratch) if device_scratch \
            is not None else max(256, self.limit // 4)
        self._dev_slab = None
        policy = policy.lower()
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown cache policy {policy!r}")
        self.policy = policy
        L, w = self.limit, self.width
        self._data = np.zeros((0 if self.device else L, w), np.float32)
        self._grad = np.zeros((L, w), np.float32)   # pending grad slab
        self._slotkey = np.full(L, self._EMPTY, np.int64)
        self._uses = np.zeros(L, np.int64)     # lookups since refresh
        self._gcnt = np.zeros(L, np.int64)     # pending update events
        self._ticks = np.zeros(L, np.int64)    # last-touch clock (LRU)
        self._freq = np.zeros(L, np.int64)     # touch count (LFU)
        #: server version at fill time (read-only mode only)
        self._vers = np.zeros(L, np.int64)
        cap = 1 << max(6, (4 * L - 1).bit_length())   # load factor <= 1/4
        self._hcap, self._hmask = cap, cap - 1
        self._hkey = np.full(cap, self._EMPTY, np.int64)
        self._hslot = np.zeros(cap, np.int64)
        self._htomb = 0
        # popping from the end hands out ascending slot ids
        self._freelist = np.arange(L - 1, -1, -1, dtype=np.int64)
        self._nfree = L
        self._tick = 0
        self._lock = threading.RLock()
        #: (flat, uk, inv, cnt, slots) of the latest host lookup, reused
        #: by an update of the same ids
        self._batch_memo = None
        self.stats = {"lookups": 0, "hits": 0, "evictions": 0, "pushes": 0,
                      "fetches": 0, "updates": 0, "push_rpcs": 0}

    # -- open-addressed int64 hash table (vectorized linear probing) -------
    def _hash(self, keys):
        h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(29)
        return (h & np.uint64(self._hmask)).astype(np.int64)

    def _find(self, ukeys):
        """Slot of each (unique) key, -1 if absent; every probe round
        advances all unresolved keys one step."""
        out = np.full(ukeys.size, -1, np.int64)
        if not ukeys.size:
            return out
        pend = np.arange(ukeys.size)
        h = self._hash(ukeys)
        while pend.size:
            hk = self._hkey[h]
            found = hk == ukeys[pend]
            if found.any():
                out[pend[found]] = self._hslot[h[found]]
            keep = ~(found | (hk == self._EMPTY))   # TOMB keeps probing
            if not keep.any():
                break
            pend = pend[keep]
            h = (h[keep] + 1) & self._hmask
        return out

    def _hinsert(self, ukeys, slots):
        """Insert absent unique keys; rival claims on one free cell are
        resolved per round (first claimant wins, the rest re-probe)."""
        if not ukeys.size:
            return
        pend = np.arange(ukeys.size)
        h = self._hash(ukeys)
        while pend.size:
            hk = self._hkey[h]
            usable = (hk == self._EMPTY) | (hk == self._TOMB)
            if usable.any():
                _, first = np.unique(h[usable], return_index=True)
                winners = np.flatnonzero(usable)[first]
                wcells = h[winners]
                self._htomb -= int((self._hkey[wcells] == self._TOMB).sum())
                self._hkey[wcells] = ukeys[pend[winners]]
                self._hslot[wcells] = slots[pend[winners]]
                keep = np.ones(pend.size, bool)
                keep[winners] = False
                pend, h = pend[keep], h[keep]
            h = (h + 1) & self._hmask

    def _hdelete(self, ukeys):
        """Tombstone present unique keys (chains through them survive)."""
        if not ukeys.size:
            return
        pend = np.arange(ukeys.size)
        h = self._hash(ukeys)
        while pend.size:
            hk = self._hkey[h]
            found = hk == ukeys[pend]
            if found.any():
                self._hkey[h[found]] = self._TOMB
                self._htomb += int(found.sum())
            keep = ~(found | (hk == self._EMPTY))
            if not keep.any():
                break
            pend, h = pend[keep], h[keep]
            h = (h + 1) & self._hmask

    def _maybe_rehash(self):
        if self._htomb <= self._hcap // 4:
            return
        self._hkey.fill(self._EMPTY)
        self._htomb = 0
        occ = np.flatnonzero(self._slotkey >= 0)
        self._hinsert(self._slotkey[occ], occ)

    # -- slot allocation + vectorized victim selection ---------------------
    def _pick_victims(self, occ, n_ev):
        """The ``n_ev`` worst occupied slots under the policy's order —
        LRU ``(tick, key)``, LFU ``(freq, tick, key)`` — by argpartition
        on the primary clock and a lexsort of the boundary ties."""
        if n_ev >= occ.size:
            return occ
        prim = self._ticks[occ] if self.policy == "lru" \
            else self._freq[occ]
        part = np.argpartition(prim, n_ev - 1)[:n_ev]
        thresh = prim[part].max()
        sure = part[prim[part] < thresh]
        ties = np.flatnonzero(prim == thresh)
        if self.policy == "lru":
            order = np.argsort(self._slotkey[occ[ties]], kind="stable")
        else:
            order = np.lexsort((self._slotkey[occ[ties]],
                                self._ticks[occ[ties]]))
        chosen = ties[order[:n_ev - sure.size]]
        return occ[np.concatenate((sure, chosen))]

    def _plan_slots(self, newkeys, protect_slots):
        """PLAN slots for absent sorted unique ``newkeys``: free slots
        first, then victims among slots not in ``protect_slots``; overflow
        stays -1 (uncacheable).  A pure read: nothing is committed until
        :meth:`_commit_slots`."""
        slots = np.full(newkeys.size, -1, np.int64)
        take = min(newkeys.size, self._nfree)
        if take:
            slots[:take] = self._freelist[self._nfree - take:
                                          self._nfree][::-1]
        need = newkeys.size - take
        evslots = evkeys = np.empty(0, np.int64)
        if need > 0:
            protect = np.zeros(self.limit, bool)
            protect[protect_slots] = True
            occ = np.flatnonzero((self._slotkey >= 0) & ~protect)
            n_ev = min(need, occ.size)
            if n_ev > 0:
                evslots = self._pick_victims(occ, n_ev)
                evkeys = self._slotkey[evslots].copy()
                slots[take:take + n_ev] = evslots
        return slots, take, evslots, evkeys

    def _plan_dirty(self, slot_sel):
        """(dirty slots, their keys, grad copies) among ``slot_sel``."""
        dirty = slot_sel[self._gcnt[slot_sel] > 0]
        if not dirty.size:
            return dirty, None, None
        return dirty, self._slotkey[dirty].copy(), self._grad[dirty].copy()

    def _commit_slots(self, newkeys, plan):
        """Apply a :meth:`_plan_slots` plan: pop the freelist, tombstone
        and reset victims, register the new keys.  Returns the registered
        (keys, slots)."""
        slots, take, evslots, evkeys = plan
        self._nfree -= take
        if evslots.size:
            self._hdelete(evkeys)
            self._grad[evslots] = 0.0
            self._gcnt[evslots] = 0
            self.stats["evictions"] += int(evslots.size)
            record_cache("emb_cache_evict_rows", int(evslots.size))
        reg = slots >= 0
        regk, regs = newkeys[reg], slots[reg]
        self._slotkey[regs] = regk
        self._hinsert(regk, regs)
        self._freq[regs] = 0
        return regk, regs

    def _flush_to_store(self, push_keys, push_grads, pull_keys=None):
        """ONE store round trip for everything pending: the push list and,
        when ``pull_keys`` is given, the refresh pull.  Counters record
        only after it succeeds."""
        rows = None
        if push_keys:
            pk = np.concatenate(push_keys)
            pg = np.concatenate(push_grads)
            order = np.argsort(pk, kind="stable")   # deterministic wire
            pk, pg = pk[order], pg[order]
            if pull_keys is not None:
                rows = self.store.push_pull(self.table, pk, pg, pull_keys,
                                            self.lr)
            else:
                self.store.push(self.table, pk, pg, self.lr)
            self.stats["pushes"] += int(pk.size)
            self.stats["push_rpcs"] += 1
            record_cache("emb_cache_push_rows", int(pk.size))
            record_cache("emb_cache_push_rpcs", 1)
        if rows is None and pull_keys is not None:
            rows = self.store.pull(self.table, pull_keys)
        return rows

    # -- core ops ----------------------------------------------------------
    def lookup(self, keys):
        """Rows for ``keys`` (any shape) → keys.shape + (width,), numpy."""
        keys = np.ascontiguousarray(keys, np.int64)
        if self.device:
            return self._lookup_device(keys)
        sweep = False
        with self._lock:
            if self.read_only:
                out = self._lookup_readonly_locked(keys.reshape(-1))
                if self.refresh_every > 0:
                    self._lookups_since_refresh += 1
                    if self._lookups_since_refresh >= self.refresh_every:
                        self._lookups_since_refresh = 0
                        sweep = True
            else:
                out = self._lookup_locked(keys.reshape(-1))
        if sweep:
            self._refresh_async()
        return out.reshape(keys.shape + (self.width,))

    # -- read-only serving mode -----------------------------------------------
    def _lookup_readonly_locked(self, flat):
        """A read-only lookup: a cached row is a hit whatever its
        ``uses``, nothing dirty is planned, and each fill records the
        rows' server versions for :meth:`refresh_stale`."""
        self._tick += 1
        self.stats["lookups"] += int(flat.size)
        if not flat.size:
            return np.empty((0, self.width), np.float32)
        uk, inv, cnt = np.unique(flat, return_inverse=True,
                                 return_counts=True)
        slots = self._find(uk)
        present = slots >= 0
        rows_out = np.empty((uk.size, self.width), np.float32)
        miss = ~present
        if miss.any():
            mkeys = uk[miss]
            plan = self._plan_slots(mkeys, slots[present])
            # the one fallible step (a failover inside the store's pull
            # is invisible here); versions before rows, so a write landing
            # between the two leaves a version older than the data, which
            # the next sweep re-pulls once
            vers = self.store.versions(self.table, mkeys) \
                if hasattr(self.store, "versions") else None
            rows = self.store.pull(self.table, mkeys)
            self.stats["fetches"] += int(mkeys.size)
            self._commit_slots(mkeys, plan)
            mslots = plan[0]
            cached = mslots >= 0
            cs = mslots[cached]
            self._data[cs] = rows[cached]
            self._uses[cs] = 0
            self._ticks[cs] = self._tick
            self._freq[cs] += cnt[miss][cached]
            self._vers[cs] = 0 if vers is None else vers[cached]
            rows_out[miss] = rows
            self._maybe_rehash()
            slots = slots.copy()
            slots[miss] = mslots
        n_hit_rows = int(cnt[present].sum())
        self.stats["hits"] += n_hit_rows
        record_cache("emb_cache_hit_rows", n_hit_rows)
        record_cache("emb_cache_miss_rows", int(flat.size) - n_hit_rows)
        if present.any():
            hs = slots[present]
            # the recency clocks advance (eviction reads them); the
            # pull_bound budget does not
            self._ticks[hs] = self._tick
            self._freq[hs] += cnt[present]
            rows_out[present] = self._data[hs]
        return rows_out[inv]

    def refresh_stale(self):
        """Version-based refresh (read-only serving): one ``versions``
        fanout over every cached key, then one pull of exactly the rows
        whose server version advanced since their fill.  Both round trips
        run outside the lock, so lookups keep serving; the commit skips a
        slot that changed key meanwhile and only moves versions forward.
        Returns the rows refreshed (``emb_cache_refresh_rows``)."""
        if not hasattr(self.store, "versions"):
            return 0
        with self._lock:
            occ = np.flatnonzero(self._slotkey >= 0)
            if not occ.size:
                return 0
            keys = self._slotkey[occ]
            order = np.argsort(keys, kind="stable")   # deterministic wire
            keys = keys[order]
            have = self._vers[occ[order]].copy()
        vers = np.asarray(self.store.versions(self.table, keys), np.int64)
        stale = vers > have
        if not stale.any():
            return 0
        sk = keys[stale]
        rows = np.asarray(self.store.pull(self.table, sk), np.float32)
        sv = vers[stale]
        refreshed = 0
        with self._lock:
            slots = self._find(sk)
            live = slots >= 0
            if live.any():
                s = slots[live]
                newer = sv[live] > self._vers[s]
                s = s[newer]
                self._data[s] = rows[live][newer]
                self._vers[s] = sv[live][newer]
                refreshed = int(s.size)
        if refreshed:
            record_cache("emb_cache_refresh_rows", refreshed)
        return refreshed

    def _refresh_async(self):
        """:meth:`refresh_stale` on a background thread (at most one in
        flight): the lookup that trips ``refresh_every`` does not pay the
        sweep in its own latency."""
        with self._lock:
            if self._refresh_thread is not None \
                    and self._refresh_thread.is_alive():
                return
            t = threading.Thread(target=self._refresh_quiet, daemon=True,
                                 name="hetu-emb-refresh")
            # started under the lock: refresh_join never sees an
            # unstarted thread, and no second sweep starts beside it
            t.start()
            self._refresh_thread = t

    def _refresh_quiet(self):
        try:
            self.refresh_stale()
        except Exception:
            pass    # best effort: the next trip of the counter retries

    def refresh_join(self, timeout=None):
        """Wait for the sweep in flight; True when none runs after."""
        with self._lock:
            t = self._refresh_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    # -- device-resident mode ------------------------------------------------
    def _ensure_dev_slab(self):
        """The device row slab, built on first use."""
        if self._dev_slab is None:
            self._dev_slab = torch.zeros(
                (self.limit + self._dev_scratch + 1, self.width),
                dtype=torch.float32, device=self.slab_device)
        return self._dev_slab

    def begin_lookup(self, keys):
        """Device-mode lookup, phase 1 of 3: take the cache lock and PLAN
        (hit/refresh partition, victims, push payload copies, slab
        positions), the pre-round-trip half of the host ``lookup``.
        Returns a :class:`_DevLookup`; after its ``roundtrip``,
        :meth:`finish_lookup` commits or :meth:`abort_lookup` releases
        with the cache untouched.  The lock stays held until then."""
        if not self.device:
            raise RuntimeError("begin_lookup requires device=True")
        keys = np.ascontiguousarray(keys, np.int64)
        flat = keys.reshape(-1)
        self._lock.acquire()
        try:
            h = _DevLookup(self, flat)
            self._tick += 1
            self._batch_memo = None
            self.stats["lookups"] += int(flat.size)
            if not flat.size:
                return h
            uk, inv, cnt = np.unique(flat, return_inverse=True,
                                     return_counts=True)
            slots = self._find(uk)
            present = slots >= 0
            hit = np.zeros(uk.size, bool)
            hit[present] = self._uses[slots[present]] < self.pull_bound
            refresh = ~hit
            h.uk, h.inv, h.cnt = uk, inv, cnt
            h.slots, h.hit, h.refresh = slots, hit, refresh
            push_keys, push_grads = [], []
            if refresh.any():
                rkeys = uk[refresh]
                rslots = slots[refresh].copy()
                stale = rslots >= 0
                dirty, dkeys, dgrads = self._plan_dirty(rslots[stale])
                if dirty.size:
                    push_keys.append(dkeys)
                    push_grads.append(dgrads)
                absent = ~stale
                plan = None
                if absent.any():
                    plan = self._plan_slots(rkeys[absent], slots[present])
                    ev_dirty, evk, evg = self._plan_dirty(plan[2])
                    if ev_dirty.size:
                        push_keys.append(evk)
                        push_grads.append(evg)
                    rslots[absent] = plan[0]
                h.rkeys, h.rslots = rkeys, rslots
                h.dirty, h.plan, h.absent = dirty, plan, absent
            if push_keys:
                pk = np.concatenate(push_keys)
                pg = np.concatenate(push_grads)
                order = np.argsort(pk, kind="stable")  # deterministic wire
                h.pk, h.pg = pk[order], pg[order]
            # slab position per unique key: its committed or planned slot,
            # or a scratch row for a key beyond capacity (served uncached)
            pos = slots.copy()
            if h.rslots is not None:
                pos[refresh] = h.rslots
            over = pos < 0
            n_over = int(over.sum())
            if n_over > self._dev_scratch:
                raise RuntimeError(
                    f"device-mode batch overflow: {n_over} uncacheable "
                    f"unique keys exceed device_scratch="
                    f"{self._dev_scratch} — raise device_scratch (or "
                    f"limit), or use the host cache for this workload")
            pos[over] = self.limit + np.arange(n_over)
            h.positions = pos
            if h.rkeys is not None:
                h.fill_targets = pos[refresh]
            return h
        except BaseException:
            self._lock.release()
            raise

    def finish_lookup(self, h, rows):
        """Device-mode lookup, phase 3: COMMIT the plan with the pulled
        miss ``rows`` (aligned to ``h.rkeys``): slot registration, hit and
        eviction bookkeeping, counters, and the in-place slab fill; then
        release the lock."""
        try:
            if h.flat.size == 0:
                return
            uk, cnt, hit, refresh = h.uk, h.cnt, h.hit, h.refresh
            if h.pk is not None:
                self.stats["pushes"] += int(h.pk.size)
                self.stats["push_rpcs"] += 1
                record_cache("emb_cache_push_rows", int(h.pk.size))
                record_cache("emb_cache_push_rpcs", 1)
            slots = h.slots
            if h.rkeys is not None:
                rslots = h.rslots
                self.stats["fetches"] += int(h.rkeys.size)
                if h.dirty.size:
                    self._grad[h.dirty] = 0.0
                    self._gcnt[h.dirty] = 0
                if h.plan is not None:
                    self._commit_slots(h.rkeys[h.absent], h.plan)
                cached = rslots >= 0
                if cached.all():
                    cs, cnt_r = rslots, cnt[refresh]
                else:
                    cs = rslots[cached]
                    cnt_r = cnt[refresh][cached]
                self._uses[cs] = cnt_r
                self._ticks[cs] = self._tick
                self._freq[cs] += cnt_r
                self._maybe_rehash()
                slots = slots.copy()
                slots[refresh] = rslots
            n_hit_rows = int(cnt[hit].sum())
            self.stats["hits"] += n_hit_rows
            record_cache("emb_cache_hit_rows", n_hit_rows)
            record_cache("emb_cache_miss_rows",
                         int(h.flat.size) - n_hit_rows)
            if hit.any():
                hs = slots[hit]
                self._uses[hs] += cnt[hit]
                self._ticks[hs] = self._tick
                self._freq[hs] += cnt[hit]
            self._batch_memo = (h.flat, uk, h.inv, cnt, slots)
            if h.rkeys is not None:
                try:
                    self._apply_dev_fill(rows, h.fill_targets)
                except BaseException:
                    # the host commit above stands (the pushes landed); a
                    # slot whose row never reached the slab must not serve
                    if cs.size:
                        self._uses[cs] = self.pull_bound
                    raise
        finally:
            h.done = True
            self._lock.release()

    def _apply_dev_fill(self, rows, targets):
        """Land pulled rows in the device slab in place, on the current
        stream (a later gather on the same stream sees them)."""
        from ..ops.kernels import emb_cache as _emb
        slab = self._ensure_dev_slab()
        _emb.fill_rows(
            slab, torch.from_numpy(np.ascontiguousarray(rows, np.float32))
            .to(slab.device),
            torch.from_numpy(np.asarray(targets, np.int64)).to(slab.device))

    def abort_lookup(self, h):
        """Release a :meth:`begin_lookup` handle after a failed round
        trip: the plan is discarded and nothing was mutated by it."""
        if not h.done:
            h.done = True
            self._lock.release()

    def gather(self, h):
        """The batch's rows gathered from the slab, (n, width) on the
        slab's device (kernel B4 on a CUDA slab).  Call with the lock held
        across :meth:`finish_lookup` and this gather."""
        from ..ops.kernels import emb_cache as _emb
        slab = self._ensure_dev_slab()
        if not h.flat.size:
            return slab.new_zeros((0, self.width))
        slots = torch.from_numpy(h.positions[h.inv].astype(np.int32))
        return _emb.emb_gather(slab, slots.to(slab.device))

    def _lookup_device(self, keys):
        """Standalone device-mode lookup: begin → round trip → commit, and
        the gather.  The RLock is re-entered around commit + gather
        (depth 2: ``finish_lookup``'s release drops to 1), so no other
        thread evicts one of this batch's slots in between.  Returns host
        rows, as the host mode does."""
        h = self.begin_lookup(keys)
        try:
            rows = h.roundtrip()
        except BaseException:
            self.abort_lookup(h)
            raise
        self._lock.acquire()
        try:
            self.finish_lookup(h, rows)
            out = self.gather(h)
        finally:
            self._lock.release()
        return out.cpu().numpy().reshape(keys.shape + (self.width,))

    # -- host mode -----------------------------------------------------------
    def _lookup_locked(self, flat):
        self._tick += 1
        self._batch_memo = None
        self.stats["lookups"] += int(flat.size)
        if not flat.size:
            return np.empty((0, self.width), np.float32)
        uk, inv, cnt = np.unique(flat, return_inverse=True,
                                 return_counts=True)
        slots = self._find(uk)
        present = slots >= 0
        hit = np.zeros(uk.size, bool)
        hit[present] = self._uses[slots[present]] < self.pull_bound
        rows_out = np.empty((uk.size, self.width), np.float32)
        refresh = ~hit
        if refresh.any():
            rkeys = uk[refresh]
            rslots = slots[refresh].copy()
            push_keys, push_grads = [], []
            # stale rows keep their slots; their pending grads land BEFORE
            # the re-pull, so the refreshed value includes them
            stale = rslots >= 0
            dirty, dkeys, dgrads = self._plan_dirty(rslots[stale])
            if dirty.size:
                push_keys.append(dkeys)
                push_grads.append(dgrads)
            absent = ~stale
            plan = None
            if absent.any():
                plan = self._plan_slots(rkeys[absent], slots[present])
                ev_dirty, evk, evg = self._plan_dirty(plan[2])
                if ev_dirty.size:
                    push_keys.append(evk)
                    push_grads.append(evg)
                rslots[absent] = plan[0]
            # the one fallible step: a failure leaves the cache untouched
            rows = self._flush_to_store(push_keys, push_grads, rkeys)
            self.stats["fetches"] += int(rkeys.size)
            if dirty.size:
                self._grad[dirty] = 0.0
                self._gcnt[dirty] = 0
            if plan is not None:
                self._commit_slots(rkeys[absent], plan)
            cached = rslots >= 0
            if cached.all():
                cs, rows_c, cnt_r = rslots, rows, cnt[refresh]
            else:
                cs, rows_c = rslots[cached], rows[cached]
                cnt_r = cnt[refresh][cached]
            self._data[cs] = rows_c
            self._uses[cs] = cnt_r
            self._ticks[cs] = self._tick
            self._freq[cs] += cnt_r
            rows_out[refresh] = rows
            self._maybe_rehash()
            slots = slots.copy()
            slots[refresh] = rslots
        # hit bookkeeping after the round trip: a failed lookup burns no
        # pull_bound budget
        n_hit_rows = int(cnt[hit].sum())
        self.stats["hits"] += n_hit_rows
        record_cache("emb_cache_hit_rows", n_hit_rows)
        record_cache("emb_cache_miss_rows", int(flat.size) - n_hit_rows)
        if hit.any():
            hs = slots[hit]
            self._uses[hs] += cnt[hit]
            self._ticks[hs] = self._tick
            self._freq[hs] += cnt[hit]
            rows_out[hit] = self._data[hs]
        self._batch_memo = (flat, uk, inv, cnt, slots)
        return rows_out[inv]

    def update(self, keys, grads):
        """Accumulate per-occurrence ``grads`` for ``keys``."""
        if self.read_only:
            raise RuntimeError(
                "DistCacheTable(read_only=True) rejects update(): a "
                "serving replica must never push gradients — train "
                "through a read-write cache and serve through this one")
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        if not keys.size:
            return
        grads = np.ascontiguousarray(grads, np.float32).reshape(keys.size,
                                                                -1)
        if self.device:
            # the per-unique-key sum through the device scatter-add (the
            # executor hands in sums it made in the step instead)
            from ..ops.kernels import emb_cache as _emb
            uk, inv, cnt = np.unique(keys, return_inverse=True,
                                     return_counts=True)
            dev = self.slab_device
            acc = _emb.emb_scatter_add(
                torch.from_numpy(grads).to(dev),
                torch.from_numpy(inv.astype(np.int32)).to(dev))
            self.apply_update_summed(uk, acc[:uk.size].cpu().numpy(), cnt)
            return
        with self._lock:
            self._update_locked(keys, grads)

    def apply_update_summed(self, uk, acc, cnt):
        """Update entry for grads already summed per unique key: ``uk``
        the batch's sorted unique keys, ``acc`` their grad sums, ``cnt``
        their occurrence counts; the same integer decisions as ``update``
        on the same batch."""
        uk = np.ascontiguousarray(uk, np.int64).reshape(-1)
        acc = np.ascontiguousarray(acc, np.float32).reshape(uk.size, -1)
        cnt = np.ascontiguousarray(cnt, np.int64).reshape(-1)
        with self._lock:
            self._tick += 1
            self._batch_memo = None
            self.stats["updates"] += int(cnt.sum())
            if not uk.size:
                return
            self._apply_update(uk, cnt, self._find(uk), acc)

    def _update_locked(self, flat, grads):
        self._tick += 1
        memo, self._batch_memo = self._batch_memo, None
        self.stats["updates"] += int(flat.size)
        if memo is not None and memo[0].size == flat.size \
                and np.array_equal(memo[0], flat):
            # the preceding lookup partitioned this exact batch
            _, uk, inv, cnt, slots = memo
            slots = slots.copy()
        else:
            uk, inv, cnt = np.unique(flat, return_inverse=True,
                                     return_counts=True)
            slots = self._find(uk)
        acc = _segment_sum(grads, inv, cnt)
        self._apply_update(uk, cnt, slots, acc)

    def _apply_update(self, uk, cnt, slots, acc):
        """The post-segment-sum half of ``update``: slot planning for
        absent keys, push-bound accounting, the one batched push, and the
        commit."""
        present = slots >= 0
        push_keys, push_grads = [], []
        absent = ~present
        plan = None
        if absent.any():
            plan = self._plan_slots(uk[absent], slots[present])
            ev_dirty, evk, evg = self._plan_dirty(plan[2])
            if ev_dirty.size:
                push_keys.append(evk)
                push_grads.append(evg)
            slots[absent] = plan[0]
        cached = slots >= 0
        if cached.all():
            cs, acc_c, cnt_c = slots, acc, cnt
        else:
            cs, acc_c, cnt_c = slots[cached], acc[cached], cnt[cached]
            # keys beyond capacity push their grads at once
            push_keys.append(uk[~cached])
            push_grads.append(acc[~cached])
        # push-bound overflow on the post-batch counts; a slot planned for
        # a new key still holds its victim's gcnt/grad, so a fresh key
        # starts from zero
        fresh = None
        if plan is not None:
            fresh = (absent & (slots >= 0))[cached] if not cached.all() \
                else absent
        prior_gcnt = self._gcnt[cs] if fresh is None \
            else np.where(fresh, 0, self._gcnt[cs])
        new_gcnt = prior_gcnt + cnt_c
        exceed = new_gcnt >= self.push_bound
        if exceed.any():
            es = cs[exceed]
            pgrads = self._grad[es] + acc_c[exceed]
            if fresh is not None and fresh[exceed].any():
                pgrads[fresh[exceed]] = acc_c[exceed][fresh[exceed]]
            push_keys.append(uk[cached][exceed])
            push_grads.append(pgrads)
        # the one fallible step: one batched push
        self._flush_to_store(push_keys, push_grads)
        if plan is not None:
            regk, regs = self._commit_slots(uk[absent], plan)
            # grad-only slots were never pulled: born stale, never serve
            if not self.device:
                self._data[regs] = 0.0
            self._uses[regs] = self.pull_bound
        self._grad[cs] += acc_c
        self._gcnt[cs] = new_gcnt
        self._ticks[cs] = self._tick
        self._freq[cs] += cnt_c
        if exceed.any():
            self._grad[es] = 0.0
            self._gcnt[es] = 0
            self._uses[es] = self.pull_bound   # the server is ahead: stale
        self._maybe_rehash()

    def flush(self):
        """Push every pending accumulated grad (ONE batched push) and
        invalidate the pushed rows (a checkpoint barrier)."""
        with self._lock:
            d = np.flatnonzero((self._slotkey >= 0) & (self._gcnt > 0))
            if d.size:
                d = d[np.argsort(self._slotkey[d], kind="stable")]
                self._flush_to_store([self._slotkey[d].copy()],
                                     [self._grad[d].copy()])
                self._grad[d] = 0.0
                self._gcnt[d] = 0
                self._uses[d] = self.pull_bound

    def perf(self):
        """Counter snapshot and the read hit rate."""
        with self._lock:
            d = dict(self.stats)
            d["size"] = int((self._slotkey >= 0).sum())
        d["hit_rate"] = (d["hits"] / d["lookups"]) if d["lookups"] else 0.0
        return d

    def __len__(self):
        with self._lock:
            return int((self._slotkey >= 0).sum())
