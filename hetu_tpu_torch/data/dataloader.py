"""Data pipeline (twin of ``hetu_tpu/data/dataloader.py``):
``Dataloader`` (shuffle, ``drop_last``, the data-parallel shard, a
prefetch thread, a resumable position) and ``DataloaderOp`` /
``dataloader_op``, the graph input it feeds.  Batches are host numpy
arrays; the executor places them on its device each step.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..graph.node import PlaceholderOp


class Dataloader:
    """One split of data batched for one subgraph name.

    ``dp_rank``/``dp_nrank`` shard the dataset across data-parallel
    workers (a contiguous shard each); ``prefetch`` batches are prepared on
    a daemon thread so host-side augmentation overlaps device compute.
    """

    def __init__(self, raw_data, batch_size, name="default", func=None,
                 drop_last=True, shuffle=False, seed=0,
                 dp_rank=0, dp_nrank=1, prefetch=2):
        data = np.asarray(raw_data, np.float32)
        self.dp_rank, self.dp_nrank = int(dp_rank), int(dp_nrank)
        if dp_nrank > 1:  # contiguous shard per dp worker
            per = len(data) // dp_nrank
            data = data[dp_rank * per:(dp_rank + 1) * per]
        self.raw_data = data
        self.batch_size = int(batch_size)
        self.name = name
        self.func = func
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(len(self.raw_data))
        self._cursor = 0
        if shuffle:
            self._rng.shuffle(self._order)
        self._queue = None
        self._prefetch = max(0, int(prefetch))
        self._consumed = 0        # batches handed to the consumer (resume pt)
        self._gen = 0             # bumped by load_state to retire producers
        self._plock = threading.Lock()

    @property
    def batch_num(self):
        n = len(self.raw_data) // self.batch_size
        if not self.drop_last and len(self.raw_data) % self.batch_size:
            n += 1
        return n

    def _advance_unlocked(self):
        idx = self._order[self._cursor * self.batch_size:
                          (self._cursor + 1) * self.batch_size]
        batch = self.raw_data[idx]
        self._cursor += 1
        if self._cursor >= self.batch_num:
            self._cursor = 0
            if self.shuffle:
                self._rng.shuffle(self._order)
        return batch

    def _produce(self):
        with self._plock:
            batch = self._advance_unlocked()
        if self.func is not None:
            batch = self.func(batch)
        return batch

    def _ensure_thread(self):
        if self._queue is not None or self._prefetch == 0:
            return
        self._queue = queue.Queue(maxsize=self._prefetch)

        def worker(q=self._queue, gen=self._gen):
            while True:
                # generation check and cursor advance are ATOMIC: a retired
                # producer (load_state bumped _gen) must not touch the
                # restored cursor/order/rng
                with self._plock:
                    if self._gen != gen:
                        return
                    batch = self._advance_unlocked()
                if self.func is not None:
                    batch = self.func(batch)
                while self._gen == gen:
                    try:
                        q.put(batch, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if self._gen != gen:
                    return

        t = threading.Thread(target=worker, daemon=True)
        t.start()

    def _take(self):
        if self._prefetch:
            self._ensure_thread()
            return self._queue.get()
        return self._produce()

    def get_arr(self):
        self._consumed += 1
        if getattr(self, "_peeked", None) is not None:
            batch, self._peeked = self._peeked, None
            return batch
        return self._take()

    # -- checkpointable position (resume at the exact next batch) ----------
    def state_dict(self):
        """Resume point: how many batches the CONSUMER has taken.  Batches
        sitting prefetched in the queue/peek are not counted — they are
        regenerated after restore (``func`` reruns on them; a stateful
        func's side effects replay).  Batching geometry is recorded so a
        restore into a DIFFERENTLY-batched loader fails loudly instead of
        resuming at a silently wrong data position."""
        return {"consumed": int(self._consumed), "seed": self._seed,
                "shuffle": bool(self.shuffle),
                "batch_size": self.batch_size,
                "drop_last": bool(self.drop_last),
                "n_rows": int(len(self.raw_data))}

    def load_state(self, state):
        """Rewind to a saved position: re-derive order/rng from the SAVED
        seed/shuffle (the live seed may differ — exact resume must follow
        the checkpoint) and fast-forward ``consumed`` batches without
        materialising them (one shuffle per completed epoch)."""
        for field, live in (("batch_size", self.batch_size),
                            ("drop_last", bool(self.drop_last)),
                            ("n_rows", int(len(self.raw_data)))):
            saved = state.get(field)
            if saved is not None and saved != live:
                raise ValueError(
                    f"dataloader '{self.name}' cannot resume: checkpoint "
                    f"{field}={saved} != live {field}={live} (the saved "
                    f"position is meaningless under different batching)")
        with self._plock:
            self._gen += 1              # retires any live prefetch thread
            self._queue = None
            self._peeked = None
            self._seed = state.get("seed", self._seed)
            self.shuffle = bool(state.get("shuffle", self.shuffle))
            self._rng = np.random.RandomState(self._seed)
            self._order = np.arange(len(self.raw_data))
            if self.shuffle:
                self._rng.shuffle(self._order)
            n = int(state["consumed"])
            epochs, self._cursor = divmod(n, self.batch_num)
            if self.shuffle:            # replay completed epochs' shuffles
                for _ in range(epochs):
                    self._rng.shuffle(self._order)
            self._consumed = n

    def get_next_arr(self):
        """Peek the upcoming batch without consuming it."""
        if getattr(self, "_peeked", None) is None:
            self._peeked = self._take()
        return self._peeked

    def get_cur_shape(self):
        return (self.batch_size,) + self.raw_data.shape[1:]


class DataloaderOp(PlaceholderOp):
    """Graph input fed from per-subgraph Dataloaders: ``Executor.run`` of
    subgraph ``name`` feeds it ``get_arr(name)`` when the feed dict does
    not hold it."""

    op_type = "DataloaderOp"

    def __init__(self, dataloaders, name=None):
        super().__init__(name or "dataloader")
        self.dataloaders = {dl.name: dl for dl in dataloaders}

    def get_batch_num(self, name):
        return self.dataloaders[name].batch_num

    def get_arr(self, name):
        return self.dataloaders[name].get_arr()

    def get_next_arr(self, name):
        return self.dataloaders[name].get_next_arr()

    def get_cur_shape(self, name):
        return self.dataloaders[name].get_cur_shape()


def dataloader_op(dataloaders, name=None):
    """``ht.dataloader_op([ht.Dataloader(x, bs, 'train'), ...])`` parity."""
    dls = []
    for d in dataloaders:
        if isinstance(d, Dataloader):
            dls.append(d)
        else:  # [raw_data, batch_size, name?, func?] list form
            dls.append(Dataloader(*d))
    return DataloaderOp(dls, name=name)
