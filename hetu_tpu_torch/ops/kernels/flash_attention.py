"""Flash attention forward for the H100: the ``lengths`` specialization.

Replaces ``hetu_tpu/ops/pallas/flash_attention.py::_fwd_kernel`` (entered
through ``_flash_fwd`` / ``flash_attention(..., lengths=...)``) with the
hand-written CUDA kernel in ``csrc/flash_attention.cu``, built for
``sm_90a`` and bound through ``ctypes``.

It computes, per (b·h) row block, online-softmax attention over the keys
below ``lengths[b]`` and returns ``out`` plus the per-row float32
log-sum-exp; a row with no valid key outputs 0 with lse = -1e30.  At
decode (S_q = 1) it is bound by the K/V bytes read, so the kernel's tile
loop stops at ``lengths[b]`` and reads each valid row once; keys past the
length cost nothing.  Unlike the TPU entry, no sequence is padded to a
multiple of 128: ragged tiles are masked inside the kernel.

:func:`flash_fwd_plain` is the plain PyTorch version of the same
function.  :func:`flash_fwd` takes it only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts kernel
launches (a plain integer; reset it by assignment).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
#: largest head dim the kernel takes (and it must be a multiple of 4)
MAX_HEAD_DIM = 128

#: kernel launches made by :func:`flash_fwd` in this process
launches = 0

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").hetu_flash_fwd_lengths
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_fwd_plain(q, k, v, lengths, heads, scale):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    s_kv = k.shape[1]
    lens = lengths.to(device=q.device, dtype=torch.int64) \
        .repeat_interleave(heads)                          # (BH,)
    s = torch.matmul(q, k.transpose(1, 2)) * scale       # (BH, S_q, S_kv)
    valid = torch.arange(s_kv, device=q.device)[None, None, :] \
        < lens[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid                           # no all-masked leak
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p, v) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def _check(q, k, v, lengths, heads):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_fwd: {name} must be float32, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"flash_fwd: {name} must be (BH, S, D), "
                             f"got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_fwd: {name} on {t.device}, q on {q.device}")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not line up")
    if heads < 1 or bh % heads:
        raise ValueError(f"flash_fwd: BH={bh} is not a multiple of "
                         f"heads={heads}")
    if lengths.dtype != torch.int32 or lengths.shape != (bh // heads,) \
            or lengths.device != q.device:
        raise ValueError(f"flash_fwd: lengths must be int32 ({bh // heads},) "
                         f"on {q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")


def flash_fwd(q, k, v, lengths, heads, scale):
    """Attention over keys below ``lengths``: q (BH, S_q, D), k/v
    (BH, S_kv, D) float32, lengths (B,) int32 with B = BH / heads.
    Returns ``(out (BH, S_q, D), lse (BH, S_q))``."""
    global launches
    _check(q, k, v, lengths, heads)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, lengths, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    bh, s_q, d = q.shape
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"flash_fwd: head dim {d} must be a multiple of 4 "
                         f"and <= {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), lse.data_ptr(), bh, heads, s_q, k.shape[1], d,
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed (cudaError {rc})")
    launches += 1
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, lengths=None,
                    key_mask=None, mask=None, bias=None):
    """(B, H, S, D) entry with the JAX package's signature; only the
    ``lengths`` specialization is ported.  Returns ``out`` (B, H, S_q, D)."""
    for spec, given in (("causal", causal), ("key_mask", key_mask is not None),
                        ("mask", mask is not None), ("bias", bias is not None)):
        if given:
            raise NotImplementedError(
                f"flash_attention: the {spec} specialization is not ported")
    if lengths is None:
        raise NotImplementedError(
            "flash_attention: the dense specialization (lengths=None) is "
            "not ported")
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out, _ = flash_fwd(q.reshape(b * h, s_q, d), k.reshape(b * h, s_kv, d),
                       v.reshape(b * h, s_kv, d), lengths, h, scale)
    return out.reshape(b, h, s_q, d)
