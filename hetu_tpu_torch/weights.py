"""Carry named parameters into the port.

``params_from_named_arrays`` turns ``{checkpoint name: numpy array}`` —
for example the JAX package's parameters,
``{iex.var_names[n]: np.asarray(iex.params[iex._k(n)]) for n in
iex.var_nodes}`` — into float32 tensors on ``device``, ready for
``InferenceExecutor(weights=...)`` / ``DecodeEngine(weights=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import resolve_device


def params_from_named_arrays(named, device=None):
    """``{name: array}`` → ``{name: tensor on device}`` (float64 → float32;
    other dtypes kept)."""
    dev = resolve_device(device)
    out = {}
    for name, arr in named.items():
        a = np.asarray(arr)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(np.array(a)).to(dev)
    return out
