"""Host-resident embedding store with server-side optimizers (twin of
``hetu_tpu/ps/store.py``).

A store is a set of tables in host RAM, each with SGD / momentum /
Nesterov / AdaGrad / Adam updates applied on push, per-row versions, and
SSP worker clocks.  Its tables live in the native C++ core
(``csrc/ps_store.cc``, the JAX package's own, built by g++ at first use,
:mod:`hetu_tpu_torch.ps.build`), selected as the JAX package selects it,
so a table made from one seed is the same in both packages, bit for bit,
and a push moves both the same way.  Without a C++ toolchain the store
warns and keeps its tables in ``_NumpyTable``, the plain twin of the
native table (the same updates in numpy, within float32 rounding of it).

``save`` / ``load`` keep a table's whole state (data, optimizer slots,
versions).  The native table writes the core's own file; the numpy table
writes the JAX package's streamed v3 file (the magic ``HETUPS3\\n``, an
int64 header length, a JSON header naming each array's dtype and shape,
then the arrays' bytes in 64 MB slices) and also reads its v2 ``npz`` and
v1 ``.npy`` files.  Each file is byte for byte the one the JAX package's
table of the same flavour writes, and ``state_digest`` (the replica
divergence check behind ``OP_CHECKSUM`` and ``ps_fsck``) is the JAX
package's digest of the same table.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import tempfile
import threading

import numpy as np

from .build import get_lib

_OPT_IDS = {"sgd": 0, "momentum": 1, "nesterov": 2, "adagrad": 3, "adam": 4}

_V3_MAGIC = b"HETUPS3\n"
_V3_CHUNK = 1 << 26          # 64 MB a write / readinto slice

_FP = ctypes.POINTER(ctypes.c_float)
_LP = ctypes.POINTER(ctypes.c_int64)


def _fp(a):
    return a.ctypes.data_as(_FP)


def _lp(a):
    return a.ctypes.data_as(_LP)


def _write_chunked(f, arr):
    """Stream a C-contiguous array to ``f`` without copying it whole."""
    mv = memoryview(arr).cast("B")
    for off in range(0, len(mv), _V3_CHUNK):
        f.write(mv[off:off + _V3_CHUNK])


def _read_chunked(f, arr):
    """Stream bytes from ``f`` into ``arr``'s buffer."""
    mv = memoryview(arr).cast("B")
    off = 0
    while off < len(mv):
        n = f.readinto(mv[off:off + _V3_CHUNK])
        if not n:
            raise IOError(f"truncated v3 table checkpoint at byte {off}")
        off += n


class _NumpyTable:
    """The plain twin of the native table: data, per-row versions and
    optimizer slots in numpy, the same updates.  Used only without g++."""

    def __init__(self, rows, width, opt, lr, m1, m2, eps, seed, scale):
        rng = np.random.RandomState(seed & 0xFFFFFFFF)
        self.data = (rng.uniform(-scale, scale, (rows, width))
                     if scale else np.zeros((rows, width))).astype(np.float32)
        self.version = np.zeros(rows, np.int64)
        self.opt, self.lr, self.m1, self.m2, self.eps = opt, lr, m1, m2, eps
        self.s0 = np.zeros_like(self.data) if opt in (1, 2, 3, 4) else None
        self.s1 = np.zeros_like(self.data) if opt == 4 else None
        self.t = np.zeros(rows, np.int32) if opt == 4 else None
        # pushes arrive from the server's handler threads and the cache's
        # feed thread at once: the native table stripe-locks, this locks
        self._lock = threading.Lock()

    def pull(self, keys):
        with self._lock:
            return self.data[keys].copy()

    def push(self, keys, grads, lr=-1.0):
        with self._lock:
            self._push_locked(keys, grads, lr)

    def _push_locked(self, keys, grads, lr=-1.0):
        elr = self.lr if lr <= 0 else lr
        uk, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros((len(uk), self.data.shape[1]), np.float32)
        np.add.at(acc, inv, grads.reshape(len(keys), -1))
        if self.opt == 0:
            self.data[uk] -= elr * acc
        elif self.opt in (1, 2):
            prev = self.s0[uk]
            v = self.m1 * prev - elr * acc
            self.s0[uk] = v
            self.data[uk] += (-self.m1 * prev + (1 + self.m1) * v) \
                if self.opt == 2 else v
        elif self.opt == 3:
            self.s0[uk] += acc * acc
            self.data[uk] -= elr * acc / (np.sqrt(self.s0[uk]) + self.eps)
        else:
            self.t[uk] += 1
            t = self.t[uk][:, None].astype(np.float32)
            m = self.m1 * self.s0[uk] + (1 - self.m1) * acc
            v = self.m2 * self.s1[uk] + (1 - self.m2) * acc * acc
            self.s0[uk], self.s1[uk] = m, v
            self.data[uk] -= elr * (m / (1 - self.m1 ** t)) / (
                np.sqrt(v / (1 - self.m2 ** t)) + self.eps)
        self.version[uk] += 1


class EmbeddingStore:
    """A set of host-RAM parameter tables with server-side optimizers:
    the worker surface of the reference PS (init, pull, push, fused
    push-pull, dense push, versions, save / load) plus SSP clocks."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.hetu_ps_create() if self._lib else None
        self._np_tables = []

    @property
    def native(self):
        """True when the tables live in the native core."""
        return self._h is not None

    # -- table management --------------------------------------------------
    def init_table(self, rows, width, opt="sgd", lr=0.01, beta1=0.9,
                   beta2=0.999, eps=1e-7, seed=0, init_scale=None):
        """A new table, uniform in ±``init_scale`` (default
        sqrt(1 / width)) from ``seed``; returns its id."""
        if init_scale is None:
            init_scale = float(np.sqrt(1.0 / width))
        o = _OPT_IDS[opt]
        if self._lib:
            return int(self._lib.hetu_ps_init_table(
                self._h, rows, width, o, lr, beta1, beta2, eps, seed,
                init_scale))
        self._np_tables.append(
            _NumpyTable(rows, width, o, lr, beta1, beta2, eps, seed,
                        init_scale))
        return len(self._np_tables) - 1

    def set_data(self, table, arr):
        """The whole table's data from ``arr`` (rows, width)."""
        arr = np.ascontiguousarray(arr, np.float32)
        want = (self.rows(table), self.width(table))
        if arr.shape != want:
            raise ValueError(f"set_data shape {arr.shape} != {want}")
        if self._lib:
            self._lib.hetu_ps_set_data(self._h, table, _fp(arr))
            return
        t = self._np_tables[table]
        with t._lock:
            t.data[:] = arr

    def get_data(self, table):
        if self._lib:
            out = np.empty((self.rows(table), self.width(table)), np.float32)
            self._lib.hetu_ps_get_data(self._h, table, _fp(out))
            return out
        t = self._np_tables[table]
        with t._lock:
            return t.data.copy()

    def rows(self, table):
        """Row count of ``table``."""
        if self._lib:
            return int(self._lib.hetu_ps_rows(self._h, table))
        return int(self._np_tables[table].data.shape[0])

    def width(self, table):
        """Embedding width of ``table`` (the accessor the caches share
        with :class:`~hetu_tpu_torch.ps.dist_store.DistributedStore`)."""
        if self._lib:
            return int(self._lib.hetu_ps_width(self._h, table))
        return int(self._np_tables[table].data.shape[1])

    def _check_keys(self, table, keys):
        if keys.size == 0:
            return
        lo, hi = int(keys.min()), int(keys.max())
        rows = self.rows(table)
        if lo < 0 or hi >= rows:
            raise IndexError(f"embedding key out of range: [{lo}, {hi}] vs "
                             f"table rows {rows}")

    # -- load recording (reference startRecord / getLoads) ----------------
    def start_record(self):
        """Count the keys every later pull and push touches."""
        self._loads = {}

    def get_loads(self):
        """{(table, 'pull'|'push'): {key: count}} since start_record."""
        return getattr(self, "_loads", {})

    def _record(self, table, kind, keys):
        loads = getattr(self, "_loads", None)
        if loads is None:
            return
        bucket = loads.setdefault((table, kind), {})
        for k, n in zip(*np.unique(keys, return_counts=True)):
            bucket[int(k)] = bucket.get(int(k), 0) + int(n)

    # -- sparse ops --------------------------------------------------------
    def pull(self, table, keys):
        """Rows for ``keys`` (any shape) → keys.shape + (width,)."""
        keys = np.ascontiguousarray(keys, np.int64)
        self._check_keys(table, keys)
        flat = keys.reshape(-1)
        self._record(table, "pull", flat)
        if self._lib:
            out = np.empty((flat.size, self.width(table)), np.float32)
            self._lib.hetu_ps_pull(self._h, table, _lp(flat), flat.size,
                                   _fp(out))
        else:
            out = self._np_tables[table].pull(flat)
        return out.reshape(keys.shape + out.shape[-1:])

    def push(self, table, keys, grads, lr=-1.0):
        """Apply per-key accumulated grads through the table's optimizer
        (``lr`` > 0 overrides the table's rate)."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        self._check_keys(table, keys)
        self._record(table, "push", keys)
        grads = np.ascontiguousarray(grads, np.float32).reshape(keys.size, -1)
        if self._lib:
            self._lib.hetu_ps_push(self._h, table, _lp(keys), keys.size,
                                   _fp(grads), float(lr))
        else:
            self._np_tables[table].push(keys, grads, lr)

    def push_pull(self, table, push_keys, grads, pull_keys, lr=-1.0):
        """Push, then pull (the fused SDPushPull)."""
        self.push(table, push_keys, grads, lr)
        return self.pull(table, pull_keys)

    def dense_push(self, table, grad, lr=-1.0):
        """A whole-table gradient through the server optimizer (DensePush);
        excludes concurrent sparse pushes."""
        grad = np.ascontiguousarray(grad, np.float32)
        if self._lib:
            self._lib.hetu_ps_dense_push(self._h, table, _fp(grad), float(lr))
        else:
            t = self._np_tables[table]
            t.push(np.arange(t.data.shape[0]), grad, lr)

    def versions(self, table, keys):
        """Per-row update counts of ``keys``."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        if self._lib:
            out = np.empty(keys.size, np.int64)
            self._lib.hetu_ps_versions(self._h, table, _lp(keys), keys.size,
                                       _lp(out))
            return out
        t = self._np_tables[table]
        with t._lock:
            return t.version[keys].copy()

    # -- persistence -------------------------------------------------------
    def save(self, table, path):
        """The table's whole state (data, versions, optimizer slots) to
        ``path``: the core's file, or the v3 file of the numpy table."""
        if self._lib:
            rc = self._lib.hetu_ps_save(self._h, table, path.encode())
            if rc:
                raise IOError(f"ps save failed rc={rc}")
            return
        t = self._np_tables[table]
        with t._lock:
            blobs = [("data", t.data), ("version", t.version)]
            for name in ("s0", "s1", "t"):
                if getattr(t, name) is not None:
                    blobs.append((name, getattr(t, name)))
            header = json.dumps({"arrays": [
                {"name": n, "dtype": str(a.dtype), "shape": list(a.shape)}
                for n, a in blobs]}).encode()
            with open(path, "wb") as f:
                f.write(_V3_MAGIC)
                f.write(struct.pack("<q", len(header)))
                f.write(header)
                for _, a in blobs:
                    _write_chunked(f, a)

    def load(self, table, path):
        """Restore a table saved by :meth:`save` of the same flavour (the
        numpy table also reads the v2 ``npz`` and v1 ``.npy`` files)."""
        if self._lib:
            rc = self._lib.hetu_ps_load(self._h, table, path.encode())
            if rc:
                raise IOError(f"ps load failed rc={rc}")
            return
        t = self._np_tables[table]
        with t._lock, open(path, "rb") as f:
            head = f.read(8)
            if head == _V3_MAGIC:
                (hlen,) = struct.unpack("<q", f.read(8))
                meta = json.loads(f.read(hlen).decode())
                for spec in meta["arrays"]:
                    target = {"data": t.data, "version": t.version,
                              "s0": t.s0, "s1": t.s1, "t": t.t}.get(
                                  spec["name"])
                    nbytes = (int(np.prod(spec["shape"]))
                              * np.dtype(spec["dtype"]).itemsize)
                    if target is None:
                        f.seek(nbytes, 1)   # a slot this table lacks
                        continue
                    if (list(target.shape) != list(spec["shape"])
                            or str(target.dtype) != spec["dtype"]):
                        raise IOError(
                            f"v3 checkpoint array {spec['name']} is "
                            f"{spec['shape']}:{spec['dtype']}, table wants "
                            f"{list(target.shape)}:{target.dtype}")
                    _read_chunked(f, target)
                return
        if head[:2] == b"PK":      # v2: an npz archive of the full state
            blobs = np.load(path)
            with t._lock:
                t.data[:] = blobs["data"]
                t.version[:] = blobs["version"]
                for name in ("s0", "s1", "t"):
                    if name in blobs and getattr(t, name) is not None:
                        getattr(t, name)[:] = blobs[name]
        else:                      # v1: a bare .npy of the data
            with t._lock:
                t.data[:] = np.load(path)

    def state_digest(self, table, chunk=_V3_CHUNK):
        """sha256 hex digest of the table's whole state (data, optimizer
        slots, per-row versions), streamed in bounded slices: two
        replicas that applied one op-log agree iff their digests do.  A
        native table digests its save file; a numpy table its arrays in
        the order data, version, s0, s1, t.  Either is the JAX package's
        digest of the same table, byte for byte, so either package's
        ``ps_fsck`` checks either's cluster; compare like flavours only."""
        h = hashlib.sha256()
        if self._lib:
            fd, path = tempfile.mkstemp(prefix="hetu_ps_digest_")
            os.close(fd)
            try:
                self.save(table, path)
                with open(path, "rb") as f:
                    while True:
                        b = f.read(chunk)
                        if not b:
                            break
                        h.update(b)
            finally:
                os.unlink(path)
            return h.hexdigest()
        t = self._np_tables[table]
        with t._lock:   # a digest mid-push would tear data from moments
            for name in ("data", "version", "s0", "s1", "t"):
                a = getattr(t, name)
                if a is None:
                    continue
                mv = memoryview(np.ascontiguousarray(a)).cast("B")
                for off in range(0, len(mv), chunk):
                    h.update(mv[off:off + chunk])
        return h.hexdigest()

    # -- SSP (bounded staleness barrier) -----------------------------------
    #: set by ssp_init: the native clock entry points index the clock
    #: vector unchecked, so callers must not touch them before
    ssp_ready = False

    def ssp_init(self, n_workers):
        if self._lib:
            self._lib.hetu_ps_ssp_init(self._h, n_workers)
        else:
            self._clocks = np.zeros(n_workers, np.int64)
            self._clock_cv = threading.Condition()
        self.ssp_ready = True

    def clock(self, worker):
        if self._lib:
            self._lib.hetu_ps_clock(self._h, worker)
        else:
            with self._clock_cv:
                self._clocks[worker] += 1
                self._clock_cv.notify_all()

    def clock_value(self, worker):
        """This worker's current SSP clock."""
        if self._lib:
            return int(self._lib.hetu_ps_clock_value(self._h, worker))
        with self._clock_cv:
            return int(self._clocks[worker])

    #: every flavour blocks: the native condition variable, the numpy
    #: table's threading.Condition (and the distributed server's)
    ssp_blocking = True

    def ssp_sync(self, worker, staleness, timeout_ms=0):
        """Block until this worker is within ``staleness`` clocks of the
        slowest.  False on timeout; ``timeout_ms <= 0`` waits forever."""
        if self._lib:
            return self._lib.hetu_ps_ssp_sync(
                self._h, worker, staleness, timeout_ms) == 0

        def ok():
            return bool(self._clocks[worker] - self._clocks.min()
                        <= staleness)

        with self._clock_cv:
            return self._clock_cv.wait_for(
                ok, None if timeout_ms <= 0 else timeout_ms / 1e3)

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            try:
                self._lib.hetu_ps_destroy(self._h)
            except Exception:
                pass


_default_store = []


def default_store():
    """The process-wide store (the reference's implicit ``ps.get_comm()``)."""
    if not _default_store:
        _default_store.append(EmbeddingStore())
    return _default_store[0]
