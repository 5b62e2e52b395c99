"""NDArray façade over ``torch.Tensor`` (twin of ``hetu_tpu/ndarray.py``).

``Executor.run`` returns its fetches wrapped in :class:`NDArray`, so
``ex.run(...)[0].asnumpy()`` works as it does with the JAX package.  The
tensor stays where the step left it (on the card, usually) until
``asnumpy()`` copies it to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def wrap_device(t):
    """Fetch-handle constructor for the executor: ``t`` is already a
    tensor the step produced."""
    nd = NDArray.__new__(NDArray)
    nd._t = t
    return nd


class NDArray:
    __slots__ = ("_t",)

    def __init__(self, arr):
        if isinstance(arr, NDArray):
            arr = arr._t
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.array(arr))
        self._t = arr

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return self._t.dtype

    def asnumpy(self):
        return self._t.detach().cpu().numpy()

    def numpy(self):
        return self.asnumpy()

    def torch(self):
        """The wrapped tensor (the counterpart of ``NDArray.jax()``)."""
        return self._t

    def __repr__(self):
        return f"NDArray(shape={self.shape}, dtype={self.dtype}, " \
               f"device={self._t.device})"
