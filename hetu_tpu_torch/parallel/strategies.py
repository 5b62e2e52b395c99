"""Distributed strategies (twin of ``hetu_tpu/parallel/strategies.py``;
reference ``python/hetu/distributed_strategies/``: Strategy base.py:11,
DataParallel simple.py:6).

A strategy owns a named mesh over the ``torch.distributed`` world and
answers which dim of a fed value is split over it.  The JAX package then
lets GSPMD run the single-device program on the global batch; the port
has no partitioner, so ``Executor(dist_strategy=DataParallel())`` keeps
those semantics by hand (``parallel/batch_axis.py``); ``zero`` stages 1-3
shard the weight update over it (``parallel/zero.py``).  Not ported,
refused by name: a ``num_devices`` other than the world size, and
``ModelParallel``.
"""
from __future__ import annotations

from ..context import make_mesh
from .zero import resolve_stage


class Strategy:
    def make_mesh(self):
        raise NotImplementedError

    def feed_spec(self, node, ndim):
        """The dim of a fed value split over the mesh; None: replicated."""
        return None


class DataParallel(Strategy):
    """Pure data parallelism: the batch dim of every fed value is split
    over the mesh's ``dp`` axis, every reduction over the batch is global,
    and the dense gradients are averaged over the group.

    ``aggregate`` ∈ {allreduce, ps, hybrid}, kept for reference API parity
    (simple.py:6): all three reduce dense gradients with the collective,
    as in the JAX package.  ``num_devices``: the world size (None: the
    world).  ``zero``: the ZeRO stage, 0..3 (True: 2), which
    ``Executor(zero=)`` and ``HETU_ZERO`` override (``parallel/zero.py``):
    1 shards the optimizer state over the ranks, 2 also reduce-scatters the
    gradients, 3 also keeps each rank's slice of the parameters between
    steps.  On the CPU the ranks run over gloo; on the card over NCCL, or
    over gloo for two ranks on one card."""

    def __init__(self, aggregate="allreduce", num_devices=None, zero=None):
        aggregate = (aggregate or "allreduce").lower()
        if aggregate not in ("allreduce", "ps", "hybrid"):
            raise ValueError(f"DataParallel(aggregate={aggregate!r}): "
                             f"expected allreduce, ps or hybrid")
        self.aggregate = aggregate
        self.num_devices = num_devices
        self.zero = resolve_stage(zero)

    def make_mesh(self):
        """The ``dp`` mesh over the initialised world."""
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "DataParallel needs an initialised torch.distributed process "
                "group: call torch.distributed.init_process_group (gloo on "
                "the CPU, NCCL on the card) first")
        world = dist.get_world_size()
        if self.num_devices is not None and int(self.num_devices) != world:
            raise NotImplementedError(
                f"DataParallel(num_devices={self.num_devices}): a group "
                f"other than the world ({world} ranks) is not ported")
        return make_mesh({"dp": world})

    def feed_spec(self, node, ndim):
        return 0 if ndim else None


class ModelParallel(Strategy):
    """Generic mesh strategy of the JAX package: not ported."""

    def __init__(self, axis_sizes):
        raise NotImplementedError(
            f"ModelParallel({dict(axis_sizes)!r}) is not ported; "
            f"DataParallel is")
