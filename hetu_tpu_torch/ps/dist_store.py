"""The sharded parameter server and the HET bounded-staleness embedding
cache (twin of ``hetu_tpu/ps/dist_store.py``).

**The sharded store.**  Every process of a ``world`` owns the keys with
``key % world == rank``: a :class:`DistributedStore` keeps its shard in a
local :class:`~hetu_tpu_torch.ps.store.EmbeddingStore` (the native core),
answers for it over TCP through its :class:`StoreServer` thread, and
routes the keys it does not own to their owner over persistent sockets
in length-prefixed binary frames (int64 keys, float32 rows; no pickle).
The frame layout is the JAX package's byte for byte — an 8-byte length,
then the header ``<BiqdIqqqq`` (op, table, nkeys, lr, payload width,
client rank, client sequence number, shard, fencing epoch), the keys and
the payload — with the epoch sent as the JAX package sends it without
replication, so either package's client talks to either package's
server.  Transport discipline (ps-lite ``resender.h``): every socket op
has a timeout; a failed op drops the connection and retries on a fresh
one after a decorrelated-jitter backoff with the SAME (client, seq), and
the server's dedup window applies a retried push or clock tick once;
exhausted retries raise a RuntimeError naming the peer.  A frame length
outside ``[0, HETU_MAX_FRAME_MB]`` drops that connection only.

The client deduplicates keys with ``np.unique`` before the shard fanout
(duplicate grads pre-summed; a sorted unique batch, as the HET cache
hands over, skips it), fuses a push and a pull of one peer into one
``OP_PUSH_PULL`` frame, pushes asynchronously on a bounded queue
(``push_async`` / ``flush``, ASP), and keeps SSP clocks, in independent
channels, and heartbeats on rank 0 (the reference's scheduler role).

Not ported, refused by name (they come with the next slice): shard
replication (``replication=2``, ``HETU_PS_REPLICATION=2``), the standby
relaunch (``standby``, ``HETU_PS_STANDBY=1``), re-replication
(``re_replicate``, ``re_replicate_async``, ``maybe_re_replicate``), the
state digest (``table_checksum``) and fencing epochs (``shard_epoch``);
the server answers the replication opcodes (``OP_REPLICATE`` through
``OP_EPOCH``) with an error naming them.  Nor the chaos hooks.

**The cache** (``_segment_sum``, ``_DevLookup``, :class:`DistCacheTable`)
works over either store; its read-only serving mode (``read_only``,
``refresh_every``) is not ported.
"""
from __future__ import annotations

import itertools
import os
import queue
import random
import socket
import struct
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..context import resolve_device
from ..metrics import record_cache, record_fault, record_rpc
from .opcodes import defop as _defop, frame_repr, op_name
from .store import EmbeddingStore

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
#: the replication plane: registered for the wire's sake, answered with an
#: error naming them (not ported)
OP_REPLICATE = _defop("OP_REPLICATE", 12)
OP_PROMOTE = _defop("OP_PROMOTE", 13)
OP_INIT = _defop("OP_INIT", 14)
OP_SET_DATA = _defop("OP_SET_DATA", 15)
OP_SYNC = _defop("OP_SYNC", 16)
OP_SYNC_PUT = _defop("OP_SYNC_PUT", 17)
OP_CHECKSUM = _defop("OP_CHECKSUM", 18)
OP_EPOCH = _defop("OP_EPOCH", 19)
_NOT_PORTED_OPS = frozenset((OP_REPLICATE, OP_PROMOTE, OP_INIT, OP_SYNC,
                             OP_SYNC_PUT, OP_CHECKSUM, OP_EPOCH))

# op, table, nkeys, lr, payload width, client rank, client sequence number,
# shard (-1: the receiving server's own), fencing epoch (0 without
# replication).  (client, seq) lets the server apply a retried push or
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
    3*prev))``, so a fleet of retrying workers spreads out."""
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


def _recv_frame(sock):
    (n,) = struct.unpack("<q", _recv_exact(sock, 8))
    if n < 0 or n > MAX_FRAME_BYTES:
        record_fault("ps_bad_frame")
        raise FrameError(
            f"frame length {n} outside [0, {MAX_FRAME_BYTES}] "
            f"(HETU_MAX_FRAME_MB) — corrupt or hostile peer")
    return _recv_exact(sock, n)


def _refuse_replication(replication, standby):
    if replication is None:
        replication = int(os.environ.get("HETU_PS_REPLICATION", "1"))
    if int(replication) == 2:
        raise NotImplementedError(
            "replication=2 (a live ring backup of every shard, "
            "HETU_PS_REPLICATION=2) is not ported: the port's sharded store "
            "keeps one copy")
    if not 1 <= int(replication) <= 2:
        raise ValueError(f"replication={replication} unsupported: 1 (off) "
                         f"or 2 (primary + one ring backup)")
    if standby is None:
        standby = os.environ.get("HETU_PS_STANDBY", "") == "1"
    if standby:
        raise NotImplementedError(
            "standby=True (HETU_PS_STANDBY=1, a relaunched replacement "
            "rank) is not ported: it needs replication")


class StoreServer:
    """Serves one process's shard over TCP (the reference server role):
    an accept loop, a handler thread a connection, the ``(client, seq)``
    dedup window for pushes and clock ticks, SSP clock vectors by
    channel and the heartbeat table."""

    def __init__(self, local: EmbeddingStore, world: int, rank: int,
                 host="127.0.0.1", port=0, replication=1, standby=False):
        _refuse_replication(replication, standby)
        self.local, self.world, self.rank = local, world, rank
        self._ssp_lock = threading.Condition()
        self._clocks = {}          # channel -> per-worker clock vector
        self._hb = {}              # rank -> (monotonic last seen, step)
        self._hb_lock = threading.Lock()
        self._applied = {}         # client -> OrderedDict of recent seqs
        self._applied_lock = threading.Lock()
        self._live_conns = set()
        self._serving = {rank}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name=f"ps-accept-r{rank}")
        self._thread.start()

    def serves(self, shard):
        """True iff this server answers for ``shard``."""
        return shard in self._serving

    def _store_serving(self, shard):
        """(store, shard) serving ``shard`` (-1: our own), or an error the
        client sees."""
        if shard < 0:
            shard = self.rank
        if shard not in self._serving:
            raise RuntimeError(
                f"shard {shard} not served by rank {self.rank} "
                f"(serving {sorted(self._serving)})")
        return self.local, shard

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

    def _handle(self, conn, body):
        op, table, nkeys, lr, width, client, seq, shard, _epoch = \
            _HDR.unpack_from(body)
        off = _HDR.size
        keys = np.frombuffer(body, np.int64, nkeys, off)
        off += nkeys * 8
        if op == OP_PULL:
            store, _ = self._store_serving(shard)
            out = store.pull(table, keys // self.world)
            _send_frame(conn, b"\x00",
                        np.ascontiguousarray(out, np.float32).tobytes())
        elif op == OP_PUSH:
            store, _ = self._store_serving(shard)
            if not self._seen(client, seq):
                grads = np.frombuffer(body, np.float32, nkeys * width,
                                      off).reshape(nkeys, width)
                store.push(table, keys // self.world, grads, lr)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_PUSH_PULL:
            # the push half is as non-idempotent as OP_PUSH: a retried
            # frame skips it but still answers the (idempotent) pull
            store, _ = self._store_serving(shard)
            npush = int(keys[0])
            push_keys = keys[1:1 + npush]
            pull_keys = keys[1 + npush:]
            if npush and not self._seen(client, seq):
                grads = np.frombuffer(body, np.float32, npush * width,
                                      off).reshape(npush, width)
                store.push(table, push_keys // self.world, grads, lr)
            out = store.pull(table, pull_keys // self.world)
            _send_frame(conn, b"\x00",
                        np.ascontiguousarray(out, np.float32).tobytes())
        elif op == OP_VERSIONS:
            store, _ = self._store_serving(shard)
            v = store.versions(table, keys // self.world)
            _send_frame(conn, b"\x00",
                        np.ascontiguousarray(v, np.int64).tobytes())
        elif op == OP_SET_DATA:
            store, _ = self._store_serving(shard)
            n = (len(body) - off) // 4
            store.set_data(table, np.frombuffer(body, np.float32, n, off)
                           .reshape(-1, width))
            _send_frame(conn, b"\x00\x01")
        elif op == OP_SSP_INIT:
            n, channel = int(keys[0]), int(keys[1])
            with self._ssp_lock:
                # idempotent: every rank calls init; a different size is an
                # explicit reset
                cur = self._clocks.get(channel)
                if cur is None or cur.size != n:
                    self._clocks[channel] = np.zeros(n, np.int64)
            _send_frame(conn, b"\x00\x01")
        elif op == OP_CLOCK:
            # a retried tick whose ack was lost must not count twice
            channel = int(keys[1]) if nkeys > 1 else 0
            if not self._seen(client, seq):
                with self._ssp_lock:
                    self._clock_vec(channel)[int(keys[0])] += 1
                    self._ssp_lock.notify_all()
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
        elif op in _NOT_PORTED_OPS:
            raise NotImplementedError(
                f"{op_name(op)} (shard replication, fencing and failover) "
                f"is not ported")
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
    A shard process is one of these that serves until ``close``.
    """

    def __init__(self, rank, world, endpoints=None, host="127.0.0.1",
                 port=0, async_queue=64, rpc_timeout=60.0, rpc_retries=3,
                 connect_timeout=10.0, replication=None, standby=None):
        _refuse_replication(replication, standby)
        self.rank, self.world = rank, world
        self.local = EmbeddingStore()
        self.server = StoreServer(self.local, world, rank, host, port)
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
        self._queue = queue.Queue(maxsize=async_queue)
        self._async_thread = None
        self._hb_thread = None
        self._hb_stop = threading.Event()

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
        caller; ``record=False`` keeps a probe out of the counters."""
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

    def _rpc_shard(self, shard, op, table, keys, payload=b"", lr=-1.0,
                   width=0, op_timeout=None):
        """An RPC to the rank serving ``shard`` (its home rank)."""
        return self._rpc(shard, op, table, keys, payload, lr, width,
                         op_timeout, shard=shard, seq=next(self._seq))

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
        return shard == self.rank and self.server.serves(shard)

    # -- tables ------------------------------------------------------------
    def _shard_rows(self, rows, shard):
        return (rows - shard + self.world - 1) // self.world

    def init_table(self, rows, width, **kw):
        """This rank's shard of a ``rows x width`` table (every rank calls
        it with the same arguments); returns its id."""
        tid = self.local.init_table(self._shard_rows(rows, self.rank), width,
                                    **kw)
        self._tables[tid] = (rows, width)
        return tid

    def width(self, table):
        return self._tables[table][1]

    def set_data(self, table, arr):
        """Scatter a full ``(rows, width)`` array across every shard."""
        rows, width = self._tables[table]
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.shape != (rows, width):
            raise ValueError(f"set_data shape {arr.shape} != "
                             f"({rows}, {width})")
        jobs = []
        for s in range(self.world):
            part = np.ascontiguousarray(arr[s::self.world])
            if self._local(s):
                jobs.append(lambda part=part: self.local.set_data(table,
                                                                  part))
            else:
                jobs.append(lambda s=s, part=part: self._rpc_shard(
                    s, OP_SET_DATA, table, np.zeros(0, np.int64),
                    part.tobytes(), width=width))
        self._fanout(jobs)

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
                jobs.append(lambda sel=sel: out.__setitem__(
                    sel, self.local.pull(table, uk[sel] // self.world)))
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
                jobs.append(lambda sel=sel: self.local.push(
                    table, uk[sel] // self.world, acc[sel], lr))
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
                def local_job(psel=psel, lsel=lsel):
                    if psel.size:
                        self.local.push(table, upk[psel] // self.world,
                                        acc[psel], lr)
                    if lsel.size:
                        out[lsel] = self.local.pull(
                            table, ulk[lsel] // self.world)
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
                jobs.append(lambda sel=sel: out.__setitem__(
                    sel, self.local.versions(table, uk[sel] // self.world)))
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

    # -- SSP via rank 0 (the reference scheduler role) ----------------------
    # ``channel`` separates independent clock consumers: the executor's SSP
    # loop ticks channel 0, partial-reduce arrivals channel 1.
    def ssp_init(self, n_workers, channel=0):
        """Idempotent per (channel, size): every rank may call it."""
        self._rpc_shard(0, OP_SSP_INIT, 0,
                        np.asarray([n_workers, channel], np.int64))

    def clock(self, worker=None, channel=0):
        w = self.rank if worker is None else worker
        self._rpc_shard(0, OP_CLOCK, 0, np.asarray([w, channel], np.int64))

    def clocks(self, channel=0):
        """Every worker's clock (rank 0's copy): the arrival feed of
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

    # -- liveness: heartbeats on rank 0 -------------------------------------
    def heartbeat(self, rank=None, step=0):
        """Ping rank 0's liveness table."""
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
        answer to one direct probe either) and ``unreachable`` (the rank
        answers this client: it only fails to reach rank 0, counted as
        ``ps_unreachable``), beside ``alive``."""
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
            except RuntimeError as e:
                if "unreachable" in str(e):
                    report["dead"].append(r)
                    continue
            # any answer is a live server, the port's refusal of OP_EPOCH
            # included
            report["unreachable"].append(r)
            record_fault("ps_unreachable")
        return report

    # -- not ported: replication, fencing, failover --------------------------
    def _not_ported(self, what):
        raise NotImplementedError(
            f"DistributedStore.{what} (shard replication, fencing and "
            f"failover) is not ported")

    def re_replicate(self, shard=None):
        self._not_ported("re_replicate")

    def re_replicate_async(self, shard=None):
        self._not_ported("re_replicate_async")

    def maybe_re_replicate(self):
        self._not_ported("maybe_re_replicate")

    def table_checksum(self, table, shard, rank=None):
        self._not_ported("table_checksum")

    def shard_epoch(self, shard, rank=None):
        self._not_ported("shard_epoch")

    # -- shard persistence (reference per-server SaveParam) -----------------
    # Shard files are named by shard: ``<path>.shard<rank>``.
    def save(self, table, path):
        for shard in sorted(self.server._serving):
            self.local.save(table, f"{path}.shard{shard}")

    def load(self, table, path):
        for shard in sorted(self.server._serving):
            self.local.load(table, f"{path}.shard{shard}")

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
    """

    _EMPTY, _TOMB = -1, -2

    def __init__(self, store, table, limit=1 << 16, pull_bound=100,
                 push_bound=10, lr=-1.0, policy="lru", read_only=False,
                 refresh_every=0, device=False, device_scratch=None,
                 device_interpret=None, slab_device=None):
        if read_only or refresh_every:
            raise NotImplementedError(
                "DistCacheTable(read_only=, refresh_every=): the read-only "
                "serving cache is not ported")
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
        with self._lock:
            out = self._lookup_locked(keys.reshape(-1))
        return out.reshape(keys.shape + (self.width,))

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
