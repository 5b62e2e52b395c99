"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see :mod:`hetu_tpu_torch.ops.kernels._build` for how they are
built and loaded)."""
