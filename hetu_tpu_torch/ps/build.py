"""Build and load the native parameter-server library (twin of
``hetu_tpu/ps/build.py``).

``csrc/ps_store.cc`` (the store, its server-side optimizers, SSP clocks
and the HET client cache behind a flat C ABI) is compiled by ``g++`` —
never by ``nvcc``: ``ops/kernels/_build.py`` takes only ``.cu`` sources —
into ``_build/libhetu_ps-<hash>.so`` inside the package (a directory
``.gitignore`` lists), named by a hash of the source and the flags as the
CUDA libraries are, under a file lock, to a temporary name renamed into
place, and loaded with ``ctypes``.  Nothing is built at import: the first
store built needs the library.  Without a C++ toolchain :func:`get_lib`
warns and returns None, and the store falls back to its numpy table.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ..ops.kernels._build import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "ps_store.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = []


def library_path():
    """``_build/libhetu_ps-<hash>.so``: the hash covers the source and
    the flags, so an edited source rebuilds."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhetu_ps-{h.hexdigest()[:16]}.so")


def _compile(out):
    """Compile to a temporary name, then rename, under a cross-process
    file lock: a concurrent importer never loads half a file."""
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return          # another process built it while we waited
            tmp = f"{out}.tmp.{os.getpid()}"
            subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                           check=True, capture_output=True)
            os.rename(tmp, out)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def get_lib():
    """The loaded native library (built first if missing); None, with a
    warning, when it cannot be built or loaded."""
    with _lock:
        if _lib:
            return _lib[0]
        try:
            out = library_path()
            if not os.path.exists(out):
                _compile(out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError) as e:
            import warnings
            warnings.warn(f"hetu_tpu_torch.ps: native core unavailable "
                          f"({e}); falling back to the slow numpy store")
            return None
        c = ctypes
        P, F, I, L, U = (c.c_void_p, c.c_float, c.c_int, c.c_int64, c.c_uint64)
        FP = c.POINTER(c.c_float)
        LP = c.POINTER(c.c_int64)
        sigs = {
            "hetu_ps_create": (P, []),
            "hetu_ps_destroy": (None, [P]),
            "hetu_ps_init_table": (L, [P, L, I, I, F, F, F, F, U, F]),
            "hetu_ps_set_data": (None, [P, L, FP]),
            "hetu_ps_get_data": (None, [P, L, FP]),
            "hetu_ps_rows": (L, [P, L]),
            "hetu_ps_width": (I, [P, L]),
            "hetu_ps_pull": (None, [P, L, LP, L, FP]),
            "hetu_ps_push": (None, [P, L, LP, L, FP, F]),
            "hetu_ps_push_pull": (None, [P, L, LP, L, FP, F, LP, L, FP]),
            "hetu_ps_dense_push": (None, [P, L, FP, F]),
            "hetu_ps_versions": (None, [P, L, LP, L, LP]),
            "hetu_ps_save": (I, [P, L, c.c_char_p]),
            "hetu_ps_load": (I, [P, L, c.c_char_p]),
            "hetu_ps_ssp_init": (None, [P, I]),
            "hetu_ps_clock": (None, [P, I]),
            "hetu_ps_clock_value": (L, [P, I]),
            "hetu_ps_ssp_sync": (I, [P, I, I, I]),
            "hetu_cache_create": (P, [P, L, L, I, L, L]),
            "hetu_cache_destroy": (None, [P]),
            "hetu_cache_set_bounds": (None, [P, L, L]),
            "hetu_cache_bypass": (None, [P, I]),
            "hetu_cache_size": (L, [P]),
            "hetu_cache_lookup": (None, [P, LP, L, FP]),
            "hetu_cache_update": (None, [P, LP, L, FP]),
            "hetu_cache_push_pull": (None, [P, LP, L, FP, LP, L, FP]),
            "hetu_cache_flush": (None, [P]),
            "hetu_cache_perf": (None, [P, LP]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib.append(lib)
        return lib
