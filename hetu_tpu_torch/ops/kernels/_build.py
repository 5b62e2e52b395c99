"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``
inside the package (a directory ``.gitignore`` lists), then loaded with
``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused.  Nothing is built when a
module is imported: the first call that needs a kernel builds it.
:func:`build` starts one ``nvcc`` per missing source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: seconds one nvcc may take before the build is declared failed
NVCC_TIMEOUT = 600

_LOADED = {}
_SMS = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built on the machine with the card")
    return path


def sources():
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_path(name):
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name):
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names):
    """Compile every missing library among ``names``, one ``nvcc`` each,
    all started together.  Returns ``{name: (seconds, compiler log)}``
    for the ones built; raises with the log when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    done, failed = {}, []
    try:
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name} "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)   # atomic: a reader never sees half a file
            done[name] = (time.perf_counter() - t0, log)
    finally:
        for proc, tmp, _out, _t0 in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name):
    """The loaded ``ctypes`` library for ``csrc/<name>.cu``, built first
    if needed (once per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    return lib


def sm_count(device):
    """The SM count of CUDA ``device``, read once per device (the launch
    plans of the decode split and the row gather are made from it)."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return n
