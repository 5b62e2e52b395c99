"""Device resolution and the device mesh of the PyTorch port (the device
and mesh halves of ``hetu_tpu/context.py``).

``gpu(i)`` names a CUDA device and ``cpu()`` the host.  Entry points
(``InferenceExecutor``, ``DecodeEngine``) take ``device=`` and resolve it
here: the default is CUDA, and a CUDA request on a machine without CUDA
raises.  There is no silent CPU fallback — the CPU is used only when the
caller asks for it (the CPU tests do).

``make_mesh`` names the axes of the initialised ``torch.distributed``
world as a ``DeviceMesh``; only the data-parallel axis ``dp`` is ported.
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


#: the JAX package's canonical mesh axes (only ``dp`` is ported)
MESH_AXES = ("dp", "pp", "tp", "ep", "cp")


def make_mesh(axis_sizes=None, devices=None, dcn_axes=None):
    """A ``torch.distributed.device_mesh.DeviceMesh`` with named axes over
    the initialised world (``torch.distributed.init_process_group``, which
    the caller runs, as ``jax.distributed`` is initialised outside the JAX
    package).

    ``axis_sizes``: ``{"dp": n}``; None puts the whole world on ``dp``.
    ``n`` must be the world size.  Any other axis (and ``dcn_axes``, the
    multi-slice placement) is not ported and raises by name.  ``devices``:
    the mesh's device type; None takes ``cuda`` under NCCL and ``cpu``
    under any other backend (gloo carries CPU or CUDA tensors alike)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if dcn_axes:
        raise NotImplementedError(
            f"make_mesh(dcn_axes={dcn_axes!r}): the multi-slice placement "
            f"is not ported")
    axis_sizes = {"dp": None} if axis_sizes is None else dict(axis_sizes)
    other = sorted(ax for ax in axis_sizes if ax != "dp")
    if other:
        raise NotImplementedError(
            f"make_mesh: the axes {other} are not ported; only 'dp' is")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = axis_sizes["dp"]
    n = world if n is None else int(n)
    if n > world:
        raise ValueError(f"mesh axes {{'dp': {n}}} need {n} ranks, the "
                         f"world has {world}")
    if n < world:
        raise NotImplementedError(
            f"make_mesh: a mesh over {n} of the world's {world} ranks is "
            f"not ported; 'dp' spans the world")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(torch.device(devices).type, list(range(n)),
                      mesh_dim_names=("dp",))
