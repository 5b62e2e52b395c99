"""Device resolution for the PyTorch port (the device half of
``hetu_tpu/context.py``).

``gpu(i)`` names a CUDA device and ``cpu()`` the host.  Entry points
(``InferenceExecutor``, ``DecodeEngine``) take ``device=`` and resolve it
here: the default is CUDA, and a CUDA request on a machine without CUDA
raises.  There is no silent CPU fallback — the CPU is used only when the
caller asks for it (the CPU tests do).
"""
from __future__ import annotations

import torch


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def cpu(device_id: int = 0) -> torch.device:
    del device_id  # one host device
    return torch.device("cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; anything ``torch.device``
    accepts otherwise.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available — pass "
            f"device='cpu' explicitly to run on the host")
    return dev
