"""Flash attention for the H100: forward (``lengths``, dense, ``key_mask``)
and backward (dQ, dK/dV).

Replaces the TPU kernels of ``hetu_tpu/ops/pallas/flash_attention.py``
with hand-written CUDA kernels, built for ``sm_90a`` and bound through
``ctypes``:

* ``_fwd_kernel`` (entered through ``_flash_fwd``) →
  ``csrc/flash_attention.cu``: ``hetu_flash_fwd_lengths`` for the
  ``lengths`` specialization (decode, :func:`flash_fwd`) and
  ``hetu_flash_fwd`` for the dense and ``key_mask`` ones (training,
  :func:`flash_fwd_masked`).
* ``_dq_kernel`` and ``_dkv_kernel`` (entered through ``_flash_bwd``) →
  ``csrc/flash_attention_bwd.cu``: ``hetu_flash_bwd_dq``
  (:func:`flash_bwd_dq`) and ``hetu_flash_bwd_dkv`` (:func:`flash_bwd_dkv`).

The forward returns ``out`` plus the per-row float32 log-sum-exp; a row
with no valid key outputs 0 with lse = -1e30.  The backward recomputes
the probabilities from that lse.  Unlike the TPU entry, no sequence is
padded to a multiple of 128: ragged tiles are masked inside the kernels.

Beside each kernel sits its plain PyTorch version
(:func:`flash_fwd_plain`, :func:`flash_bwd_plain`).  A wrapper takes the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises.  Each wrapper counts its launches in a plain
module integer (``launches``, ``fwd_launches``, ``dq_launches``,
``dkv_launches``; reset them by assignment).  :class:`FlashAttention` is
the autograd function of the dense/``key_mask`` path, the counterpart of
the JAX package's ``custom_vjp``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
#: largest head dim the kernels take (and it must be a multiple of 4)
MAX_HEAD_DIM = 128

#: kernel launches made in this process by :func:`flash_fwd` (lengths),
#: :func:`flash_fwd_masked`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
launches = 0
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

#: C entry → (source ``csrc/<source>.cu``, number of pointer arguments);
#: each takes its pointers, then (bh, heads, s_q, s_kv, d), scale, stream
ENTRIES = {"hetu_flash_fwd_lengths": ("flash_attention", 6),
           "hetu_flash_fwd": ("flash_attention", 6),
           "hetu_flash_bwd_dq": ("flash_attention_bwd", 8),
           "hetu_flash_bwd_dkv": ("flash_attention_bwd", 9)}

_FNS = {}


def kernel(name):
    """The bound C entry ``name`` (built and loaded on first use)."""
    fn = _FNS.get(name)
    if fn is None:
        source, n_ptr = ENTRIES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _valid(bh, s_kv, device, lengths=None, key_mask=None):
    """(BH, 1, S_kv) key validity from ``lengths`` (B,) or ``key_mask``
    (B, S_kv), or None (dense)."""
    if lengths is not None:
        b = lengths.shape[0]
        lens = lengths.to(device=device, dtype=torch.int64)
        valid = torch.arange(s_kv, device=device)[None, :] < lens[:, None]
    elif key_mask is not None:
        b = key_mask.shape[0]
        valid = key_mask.to(device) != 0
    else:
        return None
    return valid.repeat_interleave(bh // b, dim=0)[:, None, :]


def flash_fwd_plain(q, k, v, lengths, heads, scale, key_mask=None):
    """Plain PyTorch version of the forward kernels: same inputs, same
    outputs.  Keys are masked by ``lengths`` (B,), by ``key_mask``
    (B, S_kv) or, with both None, not at all (dense)."""
    del heads  # implied by B and BH
    s = torch.matmul(q, k.transpose(1, 2)) * scale       # (BH, S_q, S_kv)
    valid = _valid(q.shape[0], k.shape[1], q.device, lengths, key_mask)
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p * valid                                      # no all-masked leak
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p, v) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def _plain_grads(q, k, v, key_mask, lse, do, delta, scale):
    """dQ, dK, dV from the formulas the backward kernels compute."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    valid = _valid(q.shape[0], k.shape[1], q.device, key_mask=key_mask)
    if valid is not None:
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(1, 2), q),
            torch.matmul(p.transpose(1, 2), do))


def flash_bwd_plain(q, k, v, key_mask, out, lse, do, scale):
    """Plain PyTorch version of the backward kernels (not autograd):
    P = exp(s - lse) on valid keys, dP = dO.V^T, delta = rowsum(dO * O),
    dS = P * (dP - delta) * scale; returns (dQ = dS.K, dK = dS^T.Q,
    dV = P^T.dO)."""
    delta = (do * out).sum(-1)
    return _plain_grads(q, k, v, key_mask, lse, do, delta, scale)


# -- checks ------------------------------------------------------------------

def _check_qkv(fn, q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{fn}: {name} must be (BH, S, D), "
                             f"got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not line up")


def _check_key_mask(fn, q, k, key_mask):
    """Heads per mask row: 1 for dense (no mask)."""
    if key_mask is None:
        return 1
    bh, s_kv = q.shape[0], k.shape[1]
    if key_mask.dtype != torch.int32 or key_mask.ndim != 2 \
            or key_mask.shape[1] != s_kv or key_mask.shape[0] < 1 \
            or bh % key_mask.shape[0] or key_mask.device != q.device:
        raise ValueError(f"{fn}: key_mask must be int32 (B, {s_kv}) with "
                         f"BH={bh} a multiple of B, on {q.device}; got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)} on "
                         f"{key_mask.device}")
    return bh // key_mask.shape[0]


def _check_rows(fn, q, **rows):
    """Per-row float32 inputs (lse, delta: (BH, S_q)) and dO (BH, S_q, D)."""
    for name, t in rows.items():
        want = tuple(q.shape) if name == "do" else tuple(q.shape[:2])
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be float32 {want} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _check_launch(fn, d, **tensors):
    """What every kernel needs beyond the shapes: a CUDA device, a head
    dim it takes, contiguous 16-byte aligned buffers."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"{fn}: head dim {d} must be a multiple of 4 "
                         f"and <= {MAX_HEAD_DIM}")
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(fn, rc):
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {rc})")


# -- lengths (decode) --------------------------------------------------------

def _check(q, k, v, lengths, heads):
    _check_qkv("flash_fwd", q, k, v)
    bh = q.shape[0]
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
    bh, s_q, d = q.shape
    _check_launch("flash_fwd", d, q=q, k=k, v=v, lengths=lengths)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    fn = kernel("hetu_flash_fwd_lengths")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), lse.data_ptr(), bh, heads, s_q, k.shape[1], d,
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", rc)
    launches += 1
    return out, lse


# -- dense / key_mask (training) ---------------------------------------------

def flash_fwd_masked(q, k, v, key_mask, scale):
    """Attention over the keys where ``key_mask`` (B, S_kv) int32 is
    nonzero, or over every key when it is None: q (BH, S_q, D), k/v
    (BH, S_kv, D) float32.  Returns ``(out (BH, S_q, D), lse (BH, S_q))``."""
    global fwd_launches
    fn_name = "flash_fwd_masked"
    _check_qkv(fn_name, q, k, v)
    heads = _check_key_mask(fn_name, q, k, key_mask)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, None, heads, scale, key_mask=key_mask)
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    fn = kernel("hetu_flash_fwd")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                out.data_ptr(), lse.data_ptr(), bh, heads, s_q, k.shape[1], d,
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    fwd_launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, key_mask, do, lse, delta, scale):
    """dQ of :func:`flash_fwd_masked` given dO, its lse and
    delta = rowsum(dO * out), each (BH, S_q[, D]) float32."""
    global dq_launches
    fn_name = "flash_bwd_dq"
    _check_qkv(fn_name, q, k, v)
    heads = _check_key_mask(fn_name, q, k, key_mask)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return _plain_grads(q, k, v, key_mask, lse, do, delta, scale)[0]
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, do=do,
                  lse=lse, delta=delta)
    dq = torch.empty_like(q)
    fn = kernel("hetu_flash_bwd_dq")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                bh, heads, s_q, k.shape[1], d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, key_mask, do, lse, delta, scale):
    """(dK, dV) of :func:`flash_fwd_masked`; inputs as :func:`flash_bwd_dq`."""
    global dkv_launches
    fn_name = "flash_bwd_dkv"
    _check_qkv(fn_name, q, k, v)
    heads = _check_key_mask(fn_name, q, k, key_mask)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        _, dk, dv = _plain_grads(q, k, v, key_mask, lse, do, delta, scale)
        return dk, dv
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, do=do,
                  lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = kernel("hetu_flash_bwd_dkv")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), bh, heads, s_q, k.shape[1], d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    dkv_launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Dense / ``key_mask`` attention on (BH, S, D) tensors with the
    kernels' gradient: forward saves q, k, v, key_mask, out and lse; the
    backward forms delta = rowsum(dO * out) (one plain expression, as the
    JAX package leaves it to XLA) and launches dQ and dK/dV.  ``key_mask``
    and ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        out, lse = flash_fwd_masked(q, k, v, key_mask, scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        do = dout.contiguous()
        delta = (do * out).sum(-1)
        dq = flash_bwd_dq(q, k, v, key_mask, do, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, key_mask, do, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, lengths=None,
                    key_mask=None, mask=None, bias=None):
    """(B, H, S, D) entry with the JAX package's signature.  Ported:
    ``lengths`` (forward only, decode) and dense / ``key_mask`` (B, S_kv)
    with their gradient.  Returns ``out`` (B, H, S_q, D)."""
    for spec, given in (("causal", causal), ("mask", mask is not None),
                        ("bias", bias is not None)):
        if given:
            raise NotImplementedError(
                f"flash_attention: the {spec} specialization is not ported")
    if lengths is not None and key_mask is not None:
        raise NotImplementedError(
            "flash_attention: lengths together with key_mask is not ported")
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if lengths is not None:
        out, _ = flash_fwd(q.reshape(b * h, s_q, d),
                           k.reshape(b * h, s_kv, d),
                           v.reshape(b * h, s_kv, d), lengths, h, scale)
        return out.reshape(b, h, s_q, d)
    if key_mask is not None:
        key_mask = (key_mask != 0).to(torch.int32).contiguous()
    out = FlashAttention.apply(q.contiguous().view(b * h, s_q, d),
                               k.contiguous().view(b * h, s_kv, d),
                               v.contiguous().view(b * h, s_kv, d),
                               key_mask, scale)
    return out.view(b, h, s_q, d)
