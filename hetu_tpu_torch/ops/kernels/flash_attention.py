"""Flash attention for the H100: forward (``lengths``, dense, ``key_mask``,
causal, full mask) and backward (dQ, dK/dV: dense, ``key_mask``, causal).

Replaces the TPU kernels of ``hetu_tpu/ops/pallas/flash_attention.py``
with hand-written CUDA kernels, built for ``sm_90a`` and bound through
``ctypes``:

* ``_fwd_kernel`` (entered through ``_flash_fwd``) →
  ``csrc/flash_attention.cu``: ``hetu_flash_fwd_lengths`` for the
  ``lengths`` specialization (decode, :func:`flash_fwd`);
  ``hetu_flash_fwd`` for the dense and ``key_mask`` ones and
  ``hetu_flash_fwd_causal`` for the causal one, alone or with a
  ``key_mask`` (training, :func:`flash_fwd_masked`);
  ``hetu_flash_fwd_mask`` for the full-mask one, alone or with ``causal``
  and ``key_mask`` (chunked prefill, :func:`flash_fwd_fullmask`).
* ``_dq_kernel`` and ``_dkv_kernel`` (entered through ``_flash_bwd``) →
  ``csrc/flash_attention_bwd.cu``: ``hetu_flash_bwd_dq[_causal]``
  (:func:`flash_bwd_dq`) and ``hetu_flash_bwd_dkv[_causal]``
  (:func:`flash_bwd_dkv`).

Causal is bottom-right aligned, as in the TPU kernel: key ``c`` is
visible to query row ``r`` iff ``r + (S_kv - S_q) >= c``, and tiles
wholly above the diagonal are skipped.  A full mask is stored unbroadcast
as uint8 ``(G, S_q, S_kv)`` with ``G`` one of 1, H, B, B*H (``gmode``
``one``, ``h``, ``b``, ``bh``; the group of row ``bh`` is 0, ``bh % H``,
``bh // H``, ``bh``).

The forward returns ``out`` plus the per-row float32 log-sum-exp; a row
with no valid key outputs 0 with lse = -1e30.  The backward recomputes
the probabilities from that lse.  Unlike the TPU entry, no sequence is
padded to a multiple of 128: ragged tiles are masked inside the kernels,
so causal attention takes any pair of lengths.

Not ported yet, refused by name: an additive ``bias`` (and its dbias /
dkbias), the full-mask backward, ``lengths`` together with ``key_mask``,
``causal`` or ``mask``, the ``lengths`` backward, bf16 inputs.

Beside each kernel sits its plain PyTorch version
(:func:`flash_fwd_plain`, :func:`flash_bwd_plain`).  A wrapper takes the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises.  Each specialization counts its launches in a
plain module integer (``launches``, ``fwd_launches``, ``dq_launches``,
``dkv_launches``, ``fwd_causal_launches``, ``dq_causal_launches``,
``dkv_causal_launches``, ``fwd_mask_launches``; reset them by
assignment).  :class:`FlashAttention` is the autograd function of the
dense / ``key_mask`` / causal path, the counterpart of the JAX package's
``custom_vjp``.
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
#: without ``causal`` ...
launches = 0
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
#: ... by the same three with ``causal=True``, and by
#: :func:`flash_fwd_fullmask`
fwd_causal_launches = 0
dq_causal_launches = 0
dkv_causal_launches = 0
fwd_mask_launches = 0

#: C entry → (source ``csrc/<source>.cu``, pointer arguments, int
#: arguments); each takes its pointers, then its ints ((bh, heads, s_q,
#: s_kv, d), the full mask also (gmode, causal)), then scale, stream
ENTRIES = {"hetu_flash_fwd_lengths": ("flash_attention", 6, 5),
           "hetu_flash_fwd": ("flash_attention", 6, 5),
           "hetu_flash_fwd_causal": ("flash_attention", 6, 5),
           "hetu_flash_fwd_mask": ("flash_attention", 7, 7),
           "hetu_flash_bwd_dq": ("flash_attention_bwd", 8, 5),
           "hetu_flash_bwd_dq_causal": ("flash_attention_bwd", 8, 5),
           "hetu_flash_bwd_dkv": ("flash_attention_bwd", 9, 5),
           "hetu_flash_bwd_dkv_causal": ("flash_attention_bwd", 9, 5)}

#: broadcast-group modes of a full mask, in the kernel's numbering
GMODES = ("one", "h", "b", "bh")

_FNS = {}


def kernel(name):
    """The bound C entry ``name`` (built and loaded on first use)."""
    fn = _FNS.get(name)
    if fn is None:
        source, n_ptr, n_int = ENTRIES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _group_rows(gmode, bh, heads):
    """Rows G of a (G, S_q, S_kv) mask stored for ``gmode``."""
    return {"one": 1, "h": heads, "b": bh // heads, "bh": bh}[gmode]


def _valid(bh, s_q, s_kv, device, lengths=None, key_mask=None, causal=False,
           mask=None, gmode="bh", heads=1):
    """Validity of every (row, key) pair, boolean and broadcastable to
    (BH, S_q, S_kv): the logical and of ``lengths`` (B,), ``key_mask``
    (B, S_kv), the bottom-right aligned ``causal`` rule and a full
    ``mask`` (G, S_q, S_kv) of group mode ``gmode``; None when none is
    given (dense)."""
    valid = None
    if lengths is not None:
        lens = lengths.to(device=device, dtype=torch.int64)
        keys = torch.arange(s_kv, device=device)[None, :] < lens[:, None]
        valid = keys.repeat_interleave(bh // lengths.shape[0],
                                       dim=0)[:, None, :]
    if key_mask is not None:
        keys = (key_mask.to(device) != 0).repeat_interleave(
            bh // key_mask.shape[0], dim=0)[:, None, :]
        valid = keys if valid is None else valid & keys
    if causal:
        tri = torch.ones((s_q, s_kv), dtype=torch.bool,
                         device=device).tril(s_kv - s_q)[None]
        valid = tri if valid is None else valid & tri
    if mask is not None:
        m = mask.to(device) != 0
        if gmode == "h":
            m = m.repeat(bh // heads, 1, 1)
        elif gmode == "b":
            m = m.repeat_interleave(heads, dim=0)
        valid = m if valid is None else valid & m
    return valid


def flash_fwd_plain(q, k, v, lengths, heads, scale, key_mask=None,
                    causal=False, mask=None, gmode="bh"):
    """Plain PyTorch version of the forward kernels: same inputs, same
    outputs.  Keys are masked by ``lengths`` (B,), by ``key_mask``
    (B, S_kv), by ``causal``, by a full ``mask`` (G, S_q, S_kv) of group
    mode ``gmode`` (``heads`` = H tells the groups apart), by any of them
    together or, with none, not at all (dense)."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale       # (BH, S_q, S_kv)
    valid = _valid(q.shape[0], q.shape[1], k.shape[1], q.device, lengths,
                   key_mask, causal, mask, gmode, heads)
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


def _plain_grads(q, k, v, key_mask, lse, do, delta, scale, causal=False):
    """dQ, dK, dV from the formulas the backward kernels compute."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    valid = _valid(q.shape[0], q.shape[1], k.shape[1], q.device,
                   key_mask=key_mask, causal=causal)
    if valid is not None:
        # a select: a row with no valid key has lse = -1e30 and exp = inf
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(1, 2), q),
            torch.matmul(p.transpose(1, 2), do))


def flash_bwd_plain(q, k, v, key_mask, out, lse, do, scale, causal=False):
    """Plain PyTorch version of the backward kernels (not autograd):
    P = exp(s - lse) on valid (row, key) pairs, dP = dO.V^T,
    delta = rowsum(dO * O), dS = P * (dP - delta) * scale; returns
    (dQ = dS.K, dK = dS^T.Q, dV = P^T.dO)."""
    delta = (do * out).sum(-1)
    return _plain_grads(q, k, v, key_mask, lse, do, delta, scale, causal)


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


def _check_mask(fn, q, k, mask, gmode, heads):
    """A full mask: uint8 (G, S_q, S_kv), contiguous, G the rows of
    ``gmode`` for BH = B * ``heads``."""
    bh, s_q, s_kv = q.shape[0], q.shape[1], k.shape[1]
    if gmode not in GMODES:
        raise ValueError(f"{fn}: gmode must be one of {GMODES}, got {gmode!r}")
    if heads < 1 or bh % heads:
        raise ValueError(f"{fn}: BH={bh} is not a multiple of heads={heads}")
    want = (_group_rows(gmode, bh, heads), s_q, s_kv)
    if mask.dtype != torch.uint8 or tuple(mask.shape) != want \
            or mask.device != q.device or not mask.is_contiguous():
        raise ValueError(f"{fn}: mask must be contiguous uint8 {want} for "
                         f"gmode {gmode!r} on {q.device}; got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")


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


# -- dense / key_mask / causal (training) -------------------------------------

def flash_fwd_masked(q, k, v, key_mask, scale, causal=False):
    """Attention over the keys where ``key_mask`` (B, S_kv) int32 is
    nonzero, or over every key when it is None, and with ``causal`` only
    over the keys ``c <= r + S_kv - S_q`` of query row ``r``: q
    (BH, S_q, D), k/v (BH, S_kv, D) float32.  Returns
    ``(out (BH, S_q, D), lse (BH, S_q))``."""
    global fwd_launches, fwd_causal_launches
    fn_name = "flash_fwd_masked"
    _check_qkv(fn_name, q, k, v)
    heads = _check_key_mask(fn_name, q, k, key_mask)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, None, heads, scale, key_mask=key_mask,
                               causal=causal)
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    fn = kernel("hetu_flash_fwd_causal" if causal else "hetu_flash_fwd")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                out.data_ptr(), lse.data_ptr(), bh, heads, s_q, k.shape[1], d,
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    if causal:
        fwd_causal_launches += 1
    else:
        fwd_launches += 1
    return out, lse


def flash_fwd_fullmask(q, k, v, mask, gmode, heads, scale, key_mask=None,
                       causal=False):
    """Attention over the (row, key) pairs where the full ``mask`` is
    nonzero: uint8 (G, S_q, S_kv), stored unbroadcast, ``gmode`` one of
    ``one`` (G = 1), ``h`` (G = ``heads``, shared over the batch), ``b``
    (G = BH / ``heads``, shared over heads), ``bh`` (G = BH).  Composes
    with ``key_mask`` (B, S_kv) int32 and ``causal``.  q (BH, S_q, D),
    k/v (BH, S_kv, D) float32.  Forward only.  Returns
    ``(out (BH, S_q, D), lse (BH, S_q))``."""
    global fwd_mask_launches
    fn_name = "flash_fwd_fullmask"
    _check_qkv(fn_name, q, k, v)
    _check_mask(fn_name, q, k, mask, gmode, heads)
    if key_mask is not None \
            and _check_key_mask(fn_name, q, k, key_mask) != heads:
        raise ValueError(f"{fn_name}: key_mask has {key_mask.shape[0]} rows, "
                         f"BH / heads is {q.shape[0] // heads}")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, None, heads, scale, key_mask=key_mask,
                               causal=causal, mask=mask, gmode=gmode)
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    fn = kernel("hetu_flash_fwd_mask")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                mask.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, heads,
                s_q, k.shape[1], d, GMODES.index(gmode), int(bool(causal)),
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    fwd_mask_launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, key_mask, do, lse, delta, scale, causal=False):
    """dQ of :func:`flash_fwd_masked` given dO, its lse and
    delta = rowsum(dO * out), each (BH, S_q[, D]) float32."""
    global dq_launches, dq_causal_launches
    fn_name = "flash_bwd_dq"
    _check_qkv(fn_name, q, k, v)
    heads = _check_key_mask(fn_name, q, k, key_mask)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                            causal)[0]
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, do=do,
                  lse=lse, delta=delta)
    dq = torch.empty_like(q)
    fn = kernel("hetu_flash_bwd_dq_causal" if causal else "hetu_flash_bwd_dq")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                bh, heads, s_q, k.shape[1], d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    if causal:
        dq_causal_launches += 1
    else:
        dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, key_mask, do, lse, delta, scale, causal=False):
    """(dK, dV) of :func:`flash_fwd_masked`; inputs as :func:`flash_bwd_dq`."""
    global dkv_launches, dkv_causal_launches
    fn_name = "flash_bwd_dkv"
    _check_qkv(fn_name, q, k, v)
    heads = _check_key_mask(fn_name, q, k, key_mask)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        _, dk, dv = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                 causal)
        return dk, dv
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, do=do,
                  lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = kernel("hetu_flash_bwd_dkv_causal" if causal
                else "hetu_flash_bwd_dkv")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), bh, heads, s_q, k.shape[1], d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    if causal:
        dkv_causal_launches += 1
    else:
        dkv_launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Dense / ``key_mask`` / causal attention on (BH, S, D) tensors with
    the kernels' gradient: forward saves q, k, v, key_mask, out and lse;
    the backward forms delta = rowsum(dO * out) (one plain expression, as
    the JAX package leaves it to XLA) and launches dQ and dK/dV with the
    forward's ``causal``.  ``key_mask``, ``scale`` and ``causal`` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, causal=False):
        out, lse = flash_fwd_masked(q, k, v, key_mask, scale, causal)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale = scale
        ctx.causal = bool(causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        do = dout.contiguous()
        delta = (do * out).sum(-1)
        dq = flash_bwd_dq(q, k, v, key_mask, do, lse, delta, ctx.scale,
                          ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, key_mask, do, lse, delta, ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None, None


def classify_group(x, b, h, s_q, s_kv, name):
    """The broadcast-group mode of a (1|B, 1|H, S_q|1, S_kv) tensor
    (the JAX package's ``_classify_group``)."""
    if x.ndim != 4:
        raise ValueError(f"{name} must be rank-4 broadcastable, "
                         f"got {tuple(x.shape)}")
    xb, xh, xq, xk = x.shape
    if xk != s_kv or xq not in (1, s_q) or xb not in (1, b) \
            or xh not in (1, h):
        raise ValueError(f"{name} shape {tuple(x.shape)} not broadcastable "
                         f"to ({b}, {h}, {s_q}, {s_kv})")
    return {(True, True): "one", (True, False): "h",
            (False, True): "b", (False, False): "bh"}[(xb == 1, xh == 1)]


def broadcast_group(x, b, h, s_q, s_kv, name):
    """``x`` as unbroadcast uint8 (G, S_q, S_kv) storage plus its group
    mode (the JAX package's ``_broadcast_group``): only a (., ., 1, S_kv)
    mask is expanded, over the query rows."""
    gmode = classify_group(x, b, h, s_q, s_kv, name)
    if x.shape[2] == 1 and s_q != 1:
        x = x.expand(x.shape[0], x.shape[1], s_q, s_kv)
    return (x != 0).to(torch.uint8).reshape(-1, s_q, s_kv).contiguous(), gmode


def flash_attention(q, k, v, causal=False, scale=None, lengths=None,
                    key_mask=None, mask=None, bias=None):
    """(B, H, S, D) entry with the JAX package's signature.  Ported:
    ``lengths`` (forward only, decode); dense, ``key_mask`` (B, S_kv) and
    ``causal`` with their gradient; a full ``mask`` broadcastable as
    (1|B, 1|H, 1|S_q, S_kv), alone or with ``causal`` and ``key_mask``,
    forward only.  Returns ``out`` (B, H, S_q, D)."""
    if bias is not None:
        raise NotImplementedError(
            "flash_attention: the bias specialization is not ported")
    if lengths is not None and (key_mask is not None or mask is not None
                                or causal):
        raise NotImplementedError(
            "flash_attention: lengths together with key_mask, mask or "
            "causal is not ported")
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    q3 = q.contiguous().view(b * h, s_q, d)
    k3 = k.contiguous().view(b * h, s_kv, d)
    v3 = v.contiguous().view(b * h, s_kv, d)
    if lengths is not None:
        out, _ = flash_fwd(q3, k3, v3, lengths, h, scale)
        return out.view(b, h, s_q, d)
    if key_mask is not None:
        key_mask = (key_mask != 0).to(torch.int32).contiguous()
    if mask is not None:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention: the full-mask backward is not ported "
                "(call it under torch.no_grad or on detached tensors)")
        mask3, gmode = broadcast_group(mask, b, h, s_q, s_kv, "mask")
        out, _ = flash_fwd_fullmask(q3, k3, v3, mask3, gmode, h, scale,
                                    key_mask=key_mask, causal=causal)
        return out.view(b, h, s_q, d)
    out = FlashAttention.apply(q3, k3, v3, key_mask, scale, bool(causal))
    return out.view(b, h, s_q, d)
