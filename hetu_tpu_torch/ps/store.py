"""Host-resident embedding store with server-side optimizers (twin of
``hetu_tpu/ps/store.py``).

The port keeps the JAX package's pure-numpy table (``_NumpyTable``): a
``(rows, width)`` float32 array, per-row versions, and the SGD /
momentum / Nesterov / AdaGrad / Adam updates of the native store.  The
native C++ store (``ps/native/ps_store.cc``) is not ported yet; its
tables initialise from another generator, so a run that must match it
loads one table into both with :meth:`EmbeddingStore.set_data`.  Not
ported: save / load / digest, load recording, SSP clocks and dense push.
"""
from __future__ import annotations

import threading

import numpy as np

_OPT_IDS = {"sgd": 0, "momentum": 1, "nesterov": 2, "adagrad": 3, "adam": 4}


class _NumpyTable:
    """One table: data, per-row versions and optimizer slots."""

    def __init__(self, rows, width, opt, lr, m1, m2, eps, seed, scale):
        rng = np.random.RandomState(seed & 0xFFFFFFFF)
        self.data = (rng.uniform(-scale, scale, (rows, width))
                     if scale else np.zeros((rows, width))).astype(np.float32)
        self.version = np.zeros(rows, np.int64)
        self.opt, self.lr, self.m1, self.m2, self.eps = opt, lr, m1, m2, eps
        self.s0 = np.zeros_like(self.data) if opt in (1, 2, 3, 4) else None
        self.s1 = np.zeros_like(self.data) if opt == 4 else None
        self.t = np.zeros(rows, np.int32) if opt == 4 else None
        # a miss pull on the executor's feed thread may meet a push
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
    """A set of host-RAM parameter tables with server-side optimizers
    (the worker surface of the reference PS: init, pull, push, fused
    push-pull, versions)."""

    def __init__(self):
        self._tables = []

    def init_table(self, rows, width, opt="sgd", lr=0.01, beta1=0.9,
                   beta2=0.999, eps=1e-7, seed=0, init_scale=None):
        """A new table, uniform in ±``init_scale`` (default
        sqrt(1 / width)) from ``seed``; returns its id."""
        if init_scale is None:
            init_scale = float(np.sqrt(1.0 / width))
        self._tables.append(_NumpyTable(rows, width, _OPT_IDS[opt], lr,
                                        beta1, beta2, eps, seed, init_scale))
        return len(self._tables) - 1

    def set_data(self, table, arr):
        t = self._tables[table]
        with t._lock:
            t.data[:] = np.ascontiguousarray(arr, np.float32)

    def get_data(self, table):
        t = self._tables[table]
        with t._lock:
            return t.data.copy()

    def rows(self, table):
        """Row count of ``table``."""
        return int(self._tables[table].data.shape[0])

    def width(self, table):
        """Embedding width of ``table``."""
        return int(self._tables[table].data.shape[1])

    def _check_keys(self, table, keys):
        if keys.size == 0:
            return
        lo, hi = int(keys.min()), int(keys.max())
        rows = self.rows(table)
        if lo < 0 or hi >= rows:
            raise IndexError(f"embedding key out of range: [{lo}, {hi}] vs "
                             f"table rows {rows}")

    def pull(self, table, keys):
        """Rows for ``keys`` (any shape) → keys.shape + (width,)."""
        keys = np.ascontiguousarray(keys, np.int64)
        self._check_keys(table, keys)
        out = self._tables[table].pull(keys.reshape(-1))
        return out.reshape(keys.shape + out.shape[-1:])

    def push(self, table, keys, grads, lr=-1.0):
        """Apply per-key accumulated grads through the table's optimizer
        (``lr`` > 0 overrides the table's rate)."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        self._check_keys(table, keys)
        grads = np.ascontiguousarray(grads, np.float32).reshape(keys.size, -1)
        self._tables[table].push(keys, grads, lr)

    def push_pull(self, table, push_keys, grads, pull_keys, lr=-1.0):
        """Push, then pull (the fused SDPushPull)."""
        self.push(table, push_keys, grads, lr)
        return self.pull(table, pull_keys)

    def versions(self, table, keys):
        """Per-row update counts of ``keys``."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        t = self._tables[table]
        with t._lock:
            return t.version[keys].copy()


_default_store = []


def default_store():
    """The process-wide store (the reference's implicit ``ps.get_comm()``)."""
    if not _default_store:
        _default_store.append(EmbeddingStore())
    return _default_store[0]
