"""Flash attention for the H100: forward and backward (dQ, dK/dV) of every
specialization of the TPU kernels: dense, ``key_mask``, ``lengths``,
causal, full mask, additive bias (with its gradient), full mask with a
bias, each alone or together.

Replaces the TPU kernels of ``hetu_tpu/ops/pallas/flash_attention.py``
with hand-written CUDA kernels, built for ``sm_90a`` and bound through
``ctypes``:

* ``_fwd_kernel`` (entered through ``_flash_fwd``) →
  ``csrc/flash_attention.cu``: ``hetu_flash_fwd_lengths`` for
  ``lengths`` alone at one query row without a gradient (decode,
  :func:`flash_fwd`: the cache split across CTAs by
  :func:`decode_split_plan`, the splits merged by a second kernel);
  ``hetu_flash_fwd`` for the dense and ``key_mask`` ones and
  ``hetu_flash_fwd_causal`` for the causal one, alone or with a
  ``key_mask`` (training, :func:`flash_fwd_masked`);
  ``hetu_flash_fwd_mask`` for the full-mask one, alone or with ``causal``,
  ``key_mask`` and a bias or strip (chunked prefill, Longformer, XLNet;
  :func:`flash_fwd_fullmask`);
  ``hetu_flash_fwd_bias`` for the additive-bias ones, a dense bias or a
  per-key strip, alone or with ``causal`` and ``key_mask`` (T5,
  :func:`flash_fwd_bias`).
* ``_dq_kernel`` and ``_dkv_kernel`` (entered through ``_flash_bwd``) →
  ``csrc/flash_attention_bwd.cuh`` (entries compiled in
  ``flash_attention_bwd.cu``): ``hetu_flash_bwd_dq[_causal]``
  (:func:`flash_bwd_dq`) and ``hetu_flash_bwd_dkv[_causal]``
  (:func:`flash_bwd_dkv`); with a bias ``hetu_flash_bwd_dq_bias``, which
  also writes dbias, the pre-scale dS (:func:`flash_bwd_dq_bias`), and
  ``hetu_flash_bwd_dkv_bias``, which with a key-bias strip also writes its
  column sums, dkbias (:func:`flash_bwd_dkv_bias`); with a full mask
  ``hetu_flash_bwd_dq_mask`` and ``hetu_flash_bwd_dkv_mask``, alone
  (Longformer) or with a bias or strip and its dbias / dkbias (XLNet;
  :func:`flash_bwd_dq_mask`, :func:`flash_bwd_dkv_mask`).

``lengths`` (B,) int32 composes with every other rule in every training
entry, as the TPU kernel's ``has_lengths`` flag does: each takes a
nullable ``lengths`` pointer after ``key_mask``, keys at or past
``lengths[b]`` are invisible (``<= 0``: none; ``>= S_kv``: all), the
key-tile loops end at the length and a dK/dV tile of keys at or past it
writes zeros without walking the queries, so dK and dV of every padded
key are exactly 0.  ``lengths`` gets no gradient.

Causal is bottom-right aligned, as in the TPU kernel: key ``c`` is
visible to query row ``r`` iff ``r + (S_kv - S_q) >= c``, and tiles
wholly above the diagonal are skipped.  A full mask is stored unbroadcast
as uint8 ``(G, S_q, S_kv)`` with ``G`` one of 1, H, B, B*H (``gmode``
``one``, ``h``, ``b``, ``bh``; the group of row ``bh`` is 0, ``bh % H``,
``bh // H``, ``bh``).  An additive bias is float32, stored the same way
as ``(G, S_q, S_kv)``, or as a per-key strip ``(G, 1, S_kv)``; it is added
to the scaled scores before the mask, and its gradient is summed over its
broadcast group (:func:`group_reduce`, the JAX package's
``_group_reduce``).  A full mask and a bias each keep their own group mode
(``gmode``, ``bgmode``): XLNet's permutation mask is group ``b`` and its
relative-position bias group ``h`` in one launch.

The forward returns ``out`` plus the per-row float32 log-sum-exp; a row
with no valid key outputs 0 with lse = -1e30.  The backward recomputes the
probabilities from that lse.  The float32 training kernels (forward, dQ,
dK/dV) walk only the tiles that hold a visible pair: each full-mask
wrapper passes its kernel the mask's one-byte-a-tile map from
:func:`tile_maps`, built on the device (one reduction a call, no host
sync), and the kernels check the key mask's tiles themselves
(:func:`walked_tiles` says which tiles a call walks).  dQ writes dbias
zeros on the tiles it skips.  Unlike the TPU entry, no sequence is padded
to a multiple of 128: ragged tiles are masked inside the kernels, so
causal attention takes any pair of lengths.

bfloat16: every training specialization takes bfloat16 q, k, v and dO
(the ``_bf16`` C entries, head dim a multiple of 8: the forward, dQ and
dK/dV on the tensor cores, ``mma.sync`` in ``csrc/flash_attention_bf16.cu``,
``csrc/flash_attention_dq_bf16.cu`` and
``csrc/flash_attention_dkv_bf16.cu``) and rounds where the
TPU kernel's bf16 instantiation rounds: products of bf16 operands
accumulate in float32; the row sum l sums the unrounded P; P is rounded
to bf16 before P·V and Pᵀ·dO, dS·scale before dS·K and dSᵀ·Q; out, dQ,
dK and dV are rounded to bf16 (round to nearest even).  lse, delta, the
bias, dbias and dkbias stay float32.  The decode kernel
(``hetu_flash_fwd_lengths``) takes float32 only: the decode caches are
float32 in both packages; bfloat16 ``lengths`` takes the training
kernels.

Beside each kernel sits its plain PyTorch version
(:func:`flash_fwd_plain`, :func:`flash_bwd_plain`).  A wrapper takes the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises.  Each specialization counts its launches in a
plain module integer (``launches`` and the decode merge's
``merge_launches``, ``fwd_launches``, ``dq_launches``,
``dkv_launches``, ``fwd_causal_launches``, ``dq_causal_launches``,
``dkv_causal_launches``, ``fwd_mask_launches``, and for a dense bias
``fwd_bias_launches``, ``dq_bias_launches``, ``dkv_bias_launches``, with
``causal`` ``fwd_bias_causal_launches``, ``dq_bias_causal_launches``,
``dkv_bias_causal_launches``, for a key-bias strip ``fwd_kbias_launches``,
``dq_kbias_launches``, ``dkv_kbias_launches``; for a full mask with or
without ``causal``: ``dq_mask_launches``, ``dkv_mask_launches``, with a
dense bias ``fwd_mask_bias_launches``, ``dq_mask_bias_launches``,
``dkv_mask_bias_launches``, with a strip ``fwd_mask_kbias_launches``,
``dq_mask_kbias_launches``, ``dkv_mask_kbias_launches``; with
``lengths`` the same names with ``_len`` before ``_launches``
(``fwd_len_launches``, ``dq_causal_len_launches``); with bfloat16
inputs the same names with a ``bf16_`` prefix; reset them by
assignment).  :class:`FlashAttention` is the autograd function of every
training path, the counterpart of the JAX package's ``custom_vjp``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
#: largest head dim the kernels take (and it must be a multiple of 4, of 8
#: with bfloat16 inputs)
MAX_HEAD_DIM = 128
#: the input dtypes of the training kernels
DTYPES = (torch.float32, torch.bfloat16)
#: query rows and keys of one tile of the float32 training forward
TILE = 64

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
#: ... by :func:`flash_fwd_bias`, :func:`flash_bwd_dq_bias` and
#: :func:`flash_bwd_dkv_bias` with a dense bias, without and with
#: ``causal``, and with a key-bias strip
fwd_bias_launches = 0
dq_bias_launches = 0
dkv_bias_launches = 0
fwd_bias_causal_launches = 0
dq_bias_causal_launches = 0
dkv_bias_causal_launches = 0
fwd_kbias_launches = 0
dq_kbias_launches = 0
dkv_kbias_launches = 0
#: ... by :func:`flash_bwd_dq_mask` and :func:`flash_bwd_dkv_mask` with a
#: full mask alone (with or without ``causal``), and by those two and
#: :func:`flash_fwd_fullmask` with a full mask and a dense bias or a strip
dq_mask_launches = 0
dkv_mask_launches = 0
fwd_mask_bias_launches = 0
dq_mask_bias_launches = 0
dkv_mask_bias_launches = 0
fwd_mask_kbias_launches = 0
dq_mask_kbias_launches = 0
dkv_mask_kbias_launches = 0
#: the same counts for bfloat16 inputs (the ``_bf16`` C entries)
bf16_fwd_launches = bf16_dq_launches = bf16_dkv_launches = 0
bf16_fwd_causal_launches = bf16_dq_causal_launches = 0
bf16_dkv_causal_launches = bf16_fwd_mask_launches = 0
bf16_fwd_bias_launches = bf16_dq_bias_launches = bf16_dkv_bias_launches = 0
bf16_fwd_bias_causal_launches = bf16_dq_bias_causal_launches = 0
bf16_dkv_bias_causal_launches = 0
bf16_fwd_kbias_launches = bf16_dq_kbias_launches = 0
bf16_dkv_kbias_launches = 0
bf16_dq_mask_launches = bf16_dkv_mask_launches = 0
bf16_fwd_mask_bias_launches = bf16_dq_mask_bias_launches = 0
bf16_dkv_mask_bias_launches = 0
bf16_fwd_mask_kbias_launches = bf16_dq_mask_kbias_launches = 0
bf16_dkv_mask_kbias_launches = 0
#: ... and each of them with ``lengths``: ``_len`` before ``_launches``
#: (``fwd_len_launches``, ``bf16_dkv_mask_bias_len_launches``)
for _name in [n for n in list(globals()) if n.endswith("_launches")]:
    globals()[_name[:-len("_launches")] + "_len_launches"] = 0
del _name
#: merge-kernel launches made by :func:`flash_fwd` (once a call whose split
#: plan has more than one split)
merge_launches = 0

#: C entry → (source ``csrc/<source>.cu``, pointer arguments, int
#: arguments); each takes its pointers, then its ints ((bh, heads, s_q,
#: s_kv, d), the decode entry also (n_split, split_tiles), a bias also
#: (gmode, strip, causal), a full mask with an optional bias (gmode,
#: bgmode, strip, causal)), then scale, stream
ENTRIES = {"hetu_flash_fwd_lengths": ("flash_attention", 7, 7),
           "hetu_flash_fwd": ("flash_attention", 6, 5),
           "hetu_flash_fwd_causal": ("flash_attention", 6, 5),
           "hetu_flash_fwd_mask": ("flash_attention", 8, 9),
           "hetu_flash_fwd_bias": ("flash_attention", 7, 8),
           "hetu_flash_bwd_dq": ("flash_attention_bwd", 8, 5),
           "hetu_flash_bwd_dq_causal": ("flash_attention_bwd", 8, 5),
           "hetu_flash_bwd_dkv": ("flash_attention_bwd", 9, 5),
           "hetu_flash_bwd_dkv_causal": ("flash_attention_bwd", 9, 5),
           "hetu_flash_bwd_dq_bias": ("flash_attention_bwd", 10, 8),
           "hetu_flash_bwd_dkv_bias": ("flash_attention_bwd", 11, 8),
           "hetu_flash_bwd_dq_mask": ("flash_attention_bwd", 11, 9),
           "hetu_flash_bwd_dkv_mask": ("flash_attention_bwd", 12, 9)}
#: the float32 entries that take a full mask's tile map
_TILE_MAP_ENTRIES = ("hetu_flash_fwd_mask", "hetu_flash_bwd_dq_mask",
                     "hetu_flash_bwd_dkv_mask")
# every training entry also has a bfloat16 twin, ``<entry>_bf16``, on the
# tensor cores, the forward, dQ and dK/dV each compiled from a source of its
# own so the sources build in parallel (``csrc/flash_attention_bf16.cu``,
# ``csrc/flash_attention_dq_bf16.cu``, ``csrc/flash_attention_dkv_bf16.cu``)
ENTRIES.update({
    name + "_bf16": ("flash_attention_bf16" if src == "flash_attention"
                     else "flash_attention_dkv_bf16" if "_dkv" in name
                     else "flash_attention_dq_bf16", n_ptr, n_int)
    for name, (src, n_ptr, n_int) in ENTRIES.items()
    if name != "hetu_flash_fwd_lengths"})
# every training entry takes the nullable ``lengths`` pointer after
# ``key_mask``, and the float32 full-mask entries (forward, dQ, dK/dV) also
# the mask's tile map (:func:`tile_maps`) after the mask
ENTRIES.update({name: (src, n_ptr + 1 + (name in _TILE_MAP_ENTRIES), n_int)
                for name, (src, n_ptr, n_int) in ENTRIES.items()
                if name != "hetu_flash_fwd_lengths"})

#: broadcast-group modes of a full mask or a bias, in the kernel's numbering
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


def _entry(name, q):
    """The C entry ``name`` for ``q``'s dtype (bfloat16: ``_bf16``)."""
    return name + "_bf16" if q.dtype == torch.bfloat16 else name


def _count(counter, q, lengths=None):
    """Add one to the launch counter ``counter`` of ``q``'s dtype
    (bfloat16: ``bf16_<counter>``), with ``lengths`` its ``_len`` twin."""
    if lengths is not None:
        counter = counter[:-len("_launches")] + "_len_launches"
    name = "bf16_" + counter if q.dtype == torch.bfloat16 else counter
    globals()[name] += 1


def _rnd(x, dtype):
    """float32 ``x`` rounded to ``dtype`` and back, where a kernel rounds
    for a product of ``dtype`` operands (float32: ``x`` itself)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _group_rows(gmode, bh, heads):
    """Rows G of a (G, S_q, S_kv) mask stored for ``gmode``."""
    return {"one": 1, "h": heads, "b": bh // heads, "bh": bh}[gmode]


def _expand_group(x, gmode, bh, heads):
    """A (G, ...) tensor stored for ``gmode`` as its (BH, ...) broadcast
    (row ``bh`` is group row 0, ``bh % heads``, ``bh // heads``, ``bh``)."""
    if gmode == "h":
        return x.repeat(bh // heads, *([1] * (x.ndim - 1)))
    if gmode == "b":
        return x.repeat_interleave(heads, dim=0)
    if gmode == "one":
        return x.expand(bh, *x.shape[1:])
    return x


def group_reduce(d, gmode, heads, shape):
    """Sum a per-(b·h) gradient ``d`` (BH, ...) over the broadcast group
    of ``gmode`` into the storage ``shape`` (the JAX package's
    ``_group_reduce``)."""
    g = d.reshape(d.shape[0] // heads, heads, *d.shape[1:])
    if gmode == "one":
        d = g.sum(dim=(0, 1))
    elif gmode == "h":
        d = g.sum(dim=0)
    elif gmode == "b":
        d = g.sum(dim=1)
    return d.reshape(shape)


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
        m = _expand_group(mask.to(device) != 0, gmode, bh, heads)
        valid = m if valid is None else valid & m
    return valid


def tile_maps(key_mask=None, mask=None, tile=TILE):
    """Which tiles of the attention matrix hold a visible pair, one byte a
    tile (nonzero: some pair visible), each one reduction (and a pad when
    a length is not a whole number of tiles) where the inputs lie, with no
    host sync: ``key_tiles`` (B, ceil(S_kv / tile)) bool from a
    ``key_mask`` (B, S_kv), ``mask_tiles`` (G, ceil(S_q / tile),
    ceil(S_kv / tile)) bool from a full uint8 ``mask`` (G, S_q, S_kv);
    None for what is not given.  The float32 forward, dQ and dK/dV take
    the mask's map and apply the key mask's rule to each key tile
    themselves (no launch): they walk only the tiles both mark (and, with
    ``causal``, those on or below the diagonal), so they skip a padded key
    tail and the empty tiles of a sparse mask (:func:`walked_tiles`)."""
    def split(s):   # (tiles, rows a tile); one tile needs no padding
        n_t = -(-s // tile)
        return n_t, (tile if n_t > 1 else s)

    key_tiles = mask_tiles = None
    if key_mask is not None:
        b, s_kv = key_mask.shape
        n_kt, cols = split(s_kv)
        km = key_mask
        if n_kt * cols != s_kv:
            km = torch.nn.functional.pad(km, (0, n_kt * cols - s_kv))
        key_tiles = km.view(b, n_kt, cols).any(dim=2)
    if mask is not None:
        g, s_q, s_kv = mask.shape
        (n_qt, rows), (n_kt, cols) = split(s_q), split(s_kv)
        m = mask
        if n_qt * rows != s_q or n_kt * cols != s_kv:
            m = torch.nn.functional.pad(m, (0, n_kt * cols - s_kv,
                                            0, n_qt * rows - s_q))
        if cols % 8 == 0 and m.is_contiguous() and m.storage_offset() % 8 == 0:
            m, cols = m.view(torch.int64), cols // 8   # 8 mask bytes a word
        mask_tiles = m.reshape(g, n_qt, rows, n_kt, cols).any(dim=(2, 4))
    return key_tiles, mask_tiles


def walked_tiles(bh, heads, s_q, s_kv, key_mask=None, causal=False,
                 mask=None, gmode="bh", tile=TILE, lengths=None, by="query"):
    """The (query tile, key tile) pairs the float32 training kernels walk,
    boolean (BH, ceil(S_q / tile), ceil(S_kv / tile)).  ``by="query"``
    follows the forward's and dQ's rule, a query tile's key tiles: those
    :func:`tile_maps` marks for the row's mask group (``mask`` of group
    mode ``gmode``, BH = B * ``heads``), that start before the row's
    ``lengths`` (B,) and, with a ``key_mask``, hold an unmasked key before
    it, and with ``causal`` those before the query tile's last visible
    key.  ``by="key"`` follows dK/dV's, a key tile's query tiles: none if
    the key tile holds no unmasked key before the length, else those the
    map marks in its column from the first that sees its first key under
    ``causal``.  The two rules give the same pairs.  With ``lengths`` and
    no other rule it is also the tiles every bf16 training kernel walks (the
    forward, dQ, and the dK/dV tiles that walk any query)."""
    device = next((t.device for t in (key_mask, mask, lengths)
                   if t is not None), torch.device("cpu"))
    n_qt, n_kt = -(-s_q // tile), -(-s_kv // tile)
    q_starts = torch.arange(n_qt, device=device) * tile
    k_starts = torch.arange(n_kt, device=device) * tile
    walk = torch.ones((bh, n_qt, n_kt), dtype=torch.bool, device=device)
    kv_off = s_kv - s_q
    if causal and by == "query":
        # keys [0, last) up to the tile's last row's last visible key
        last = torch.clamp(q_starts + tile, max=s_q) + kv_off
        walk &= (k_starts[None, :] < last[:, None])[None]
    elif causal:
        # query tiles from the one that holds the first row seeing the
        # key tile's first key (no such row at or past S_q)
        first = k_starts - kv_off
        walk &= ((first < s_q)[None, :]
                 & (q_starts[:, None] + tile > first[None, :]))[None]
    keys = None                       # (B, S_kv) keys below the length
    if lengths is not None:
        lens = lengths.to(device=device, dtype=torch.int64)
        keys = torch.arange(s_kv, device=device)[None, :] < lens[:, None]
        walk &= (k_starts[None, :] < lens[:, None]).repeat_interleave(
            bh // lengths.shape[0], dim=0)[:, None, :]
    if key_mask is not None:
        km = key_mask.to(device) != 0
        if keys is not None:
            km = km & keys
        key_tiles = tile_maps(key_mask=km.to(torch.uint8), tile=tile)[0]
        walk &= key_tiles.bool().repeat_interleave(
            bh // key_tiles.shape[0], dim=0)[:, None, :]
    if mask is not None:
        walk &= _expand_group(tile_maps(mask=mask, tile=tile)[1].bool(),
                              gmode, bh, heads)
    return walk


def _logits(q, k, scale, bias=None, kbias=None, bgmode="bh", heads=1):
    """Scaled float32 scores plus the additive ``bias`` (G, S_q, S_kv) or
    key-bias strip ``kbias`` (G, 1, S_kv) of group mode ``bgmode``."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    for b in (bias, kbias):
        if b is not None:
            s = s + _expand_group(b, bgmode, q.shape[0], heads)
    return s


def flash_fwd_plain(q, k, v, lengths, heads, scale, key_mask=None,
                    causal=False, mask=None, gmode="bh", bias=None,
                    kbias=None, bgmode="bh"):
    """Plain PyTorch version of the forward kernels: same inputs, same
    outputs.  Keys are masked by ``lengths`` (B,), by ``key_mask``
    (B, S_kv), by ``causal``, by a full ``mask`` (G, S_q, S_kv) of group
    mode ``gmode`` (``heads`` = H tells the groups apart), by any of them
    together or, with none, not at all (dense).  A ``bias``
    (G, S_q, S_kv) or key-bias strip ``kbias`` (G, 1, S_kv) of group mode
    ``bgmode`` is added to the scaled scores first.  bfloat16 inputs
    round where the kernels do (P before P·V, the output)."""
    s = _logits(q, k, scale, bias, kbias, bgmode, heads)
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
    out = torch.matmul(_rnd(p, v.dtype), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def _plain_grads(q, k, v, key_mask, lse, do, delta, scale, causal=False,
                 bias=None, kbias=None, bgmode="bh", heads=1, mask=None,
                 gmode="bh", lengths=None):
    """dQ, dK, dV and t = dL/d(logits) (BH, S_q, S_kv), the pre-scale dS,
    from the formulas the backward kernels compute; ``lengths`` (B,) and a
    full ``mask`` of group mode ``gmode`` join the validity, a ``bias`` or
    strip ``kbias`` of group mode ``bgmode`` the logits.  bfloat16 inputs round
    where the kernels do (P before Pᵀ·dO, dS before dS·K and dSᵀ·Q, the
    outputs); t stays float32."""
    s = _logits(q, k, scale, bias, kbias, bgmode, heads)
    p = torch.exp(s - lse[..., None])
    valid = _valid(q.shape[0], q.shape[1], k.shape[1], q.device,
                   lengths=lengths, key_mask=key_mask, causal=causal,
                   mask=mask, gmode=gmode, heads=heads)
    if valid is not None:
        # a select: a row with no valid key has lse = -1e30 and exp = inf
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    t = p * (dp - delta[..., None])
    ds = _rnd(t * scale, q.dtype)
    return (torch.matmul(ds, k.float()).to(q.dtype),
            torch.matmul(ds.transpose(1, 2), q.float()).to(k.dtype),
            torch.matmul(_rnd(p, do.dtype).transpose(1, 2),
                         do.float()).to(v.dtype), t)


def flash_bwd_plain(q, k, v, key_mask, out, lse, do, scale, causal=False,
                    mask=None, gmode="bh", heads=1, lengths=None):
    """Plain PyTorch version of the backward kernels (not autograd):
    P = exp(s - lse) on valid (row, key) pairs, dP = dO.V^T,
    delta = rowsum(dO * O), dS = P * (dP - delta) * scale; returns
    (dQ = dS.K, dK = dS^T.Q, dV = P^T.dO).  ``lengths`` (B,) and a full
    ``mask`` (G, S_q, S_kv) of group mode ``gmode`` (``heads`` = H) join
    the validity."""
    delta = (do.float() * out.float()).sum(-1)
    return _plain_grads(q, k, v, key_mask, lse, do, delta, scale, causal,
                        heads=heads, mask=mask, gmode=gmode,
                        lengths=lengths)[:3]


def flash_bwd_bias_plain(q, k, v, key_mask, bias, kbias, bgmode, heads, out,
                         lse, do, scale, causal=False, mask=None, gmode="bh",
                         lengths=None):
    """Plain PyTorch version of the bias backward kernels: as
    :func:`flash_bwd_plain` with the biased scores; returns (dQ, dK, dV,
    dbias, dkbias).  dbias (BH, S_q, S_kv) is the pre-scale dS when a dense
    ``bias`` is given, dkbias (BH, 1, S_kv) its sum over the query rows
    when a strip ``kbias`` is; the other is None.  Neither is summed over
    its group.  ``lengths`` (B,) and a full ``mask`` of its own group mode
    ``gmode`` join the validity."""
    delta = (do.float() * out.float()).sum(-1)
    dq, dk, dv, t = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                 causal, bias, kbias, bgmode, heads, mask,
                                 gmode, lengths)
    return (dq, dk, dv, t if bias is not None else None,
            t.sum(1, keepdim=True) if kbias is not None else None)


# -- checks ------------------------------------------------------------------

def _check_qkv(fn, q, k, v):
    if q.dtype not in DTYPES:
        raise TypeError(f"{fn}: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q {q.dtype}")
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


def _check_lengths(fn, q, lengths, heads=None):
    """``lengths``, when given: contiguous int32 (B,) on q's device with
    BH = B * ``heads`` (any B dividing BH when ``heads`` is None).
    Returns the heads per entry (None without ``lengths``)."""
    if lengths is None:
        return None
    bh = q.shape[0]
    if lengths.dtype != torch.int32 or lengths.ndim != 1 \
            or lengths.shape[0] < 1 or bh % lengths.shape[0] \
            or lengths.device != q.device or not lengths.is_contiguous() \
            or (heads is not None and bh != heads * lengths.shape[0]):
        want = "B" if heads is None else str(bh // heads)
        raise ValueError(f"{fn}: lengths must be contiguous int32 ({want},) "
                         f"with BH={bh} a multiple of it, on {q.device}; "
                         f"got {lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")
    return bh // lengths.shape[0]


def _key_heads(fn, q, k, key_mask, lengths):
    """Heads per key-mask and ``lengths`` row (1 for dense): the two must
    agree when both are given."""
    heads = _check_key_mask(fn, q, k, key_mask)
    if lengths is None:
        return heads
    lheads = _check_lengths(fn, q, lengths)
    if key_mask is not None and lheads != heads:
        raise ValueError(f"{fn}: key_mask has {key_mask.shape[0]} rows, "
                         f"lengths {lengths.shape[0]}")
    return lheads


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


def _check_bias(fn, q, k, key_mask, bias, kbias, gmode, heads):
    """Exactly one of a dense ``bias`` (G, S_q, S_kv) and a key-bias strip
    ``kbias`` (G, 1, S_kv): float32, contiguous, G the rows of ``gmode``
    for BH = B * ``heads``; a ``key_mask`` has BH / ``heads`` rows."""
    bh, s_q, s_kv = q.shape[0], q.shape[1], k.shape[1]
    if (bias is None) == (kbias is None):
        raise ValueError(f"{fn}: give exactly one of bias and kbias")
    if gmode not in GMODES:
        raise ValueError(f"{fn}: gmode must be one of {GMODES}, got {gmode!r}")
    if heads < 1 or bh % heads:
        raise ValueError(f"{fn}: BH={bh} is not a multiple of heads={heads}")
    t, name = (bias, "bias") if bias is not None else (kbias, "kbias")
    want = (_group_rows(gmode, bh, heads), s_q if bias is not None else 1,
            s_kv)
    if t.dtype != torch.float32 or tuple(t.shape) != want \
            or t.device != q.device or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous float32 {want} for "
                         f"gmode {gmode!r} on {q.device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if key_mask is not None \
            and _check_key_mask(fn, q, k, key_mask) != heads:
        raise ValueError(f"{fn}: key_mask has {key_mask.shape[0]} rows, "
                         f"BH / heads is {bh // heads}")


def _check_rows(fn, q, **rows):
    """Per-row float32 inputs (lse, delta: (BH, S_q)) and dO (BH, S_q, D)
    in q's dtype."""
    for name, t in rows.items():
        want = tuple(q.shape) if name == "do" else tuple(q.shape[:2])
        dtype = q.dtype if name == "do" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != want \
                or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be {dtype} {want} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _check_launch(fn, d, **tensors):
    """What every kernel needs beyond the shapes: a CUDA device, a head
    dim it takes (a multiple of 4, of 8 for bfloat16 q, whose 16-byte
    loads are 8 values), contiguous 16-byte aligned buffers."""
    first = next(iter(tensors.values()))
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    mult = 8 if first.dtype == torch.bfloat16 else 4
    if d > MAX_HEAD_DIM or d % mult:
        raise ValueError(f"{fn}: head dim {d} must be a multiple of {mult} "
                         f"and <= {MAX_HEAD_DIM} for {first.dtype}")
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
    if q.dtype != torch.float32:
        raise TypeError(f"flash_fwd: the lengths kernel takes float32 only, "
                        f"got {q.dtype}")
    bh = q.shape[0]
    if heads < 1 or bh % heads:
        raise ValueError(f"flash_fwd: BH={bh} is not a multiple of "
                         f"heads={heads}")
    if lengths.dtype != torch.int32 or lengths.shape != (bh // heads,) \
            or lengths.device != q.device:
        raise ValueError(f"flash_fwd: lengths must be int32 ({bh // heads},) "
                         f"on {q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")


#: keys of one tile of the decode kernel: its split plan cuts each row's
#: keys into runs of whole tiles
DECODE_TILE = 64
#: CTAs of the decode kernel one SM holds at D <= 64 (66 KB of shared memory
#: each), the grid the split plan aims for
DECODE_CTAS_PER_SM = 3
#: the fewest key tiles a split takes: a cache of at most three tiles keeps
#: one split and one launch
DECODE_MIN_SPLIT_TILES = 2

_SMS = {}


def decode_split_plan(bh, s_q, s_kv, sms):
    """How the decode kernel splits each row's keys across CTAs:
    ``(n_split, split_tiles)``, split ``s`` owning the key tiles
    ``[s * split_tiles, (s + 1) * split_tiles)`` of ``DECODE_TILE`` keys.
    Made from the shapes and the SM count alone, never from the values of
    ``lengths`` (they live on the card; reading them would stall the host):
    enough splits for ``DECODE_CTAS_PER_SM`` CTAs of the (BH * S_q,
    n_split) grid on each of ``sms`` SMs, at least
    ``DECODE_MIN_SPLIT_TILES`` tiles a split, the tiles shared as evenly as
    whole tiles allow, and no split past the last tile."""
    tiles = max(1, -(-s_kv // DECODE_TILE))
    want = -(-DECODE_CTAS_PER_SM * sms // (bh * s_q))
    n = max(1, min(want, tiles // DECODE_MIN_SPLIT_TILES))
    per = -(-tiles // n)
    return -(-tiles // per), per


def _sm_count(device):
    """The SM count of CUDA ``device``, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return n


def flash_fwd(q, k, v, lengths, heads, scale, plan=None):
    """Attention over keys below ``lengths``: q (BH, S_q, D), k/v
    (BH, S_kv, D) float32, lengths (B,) int32 with B = BH / heads.
    Returns ``(out (BH, S_q, D), lse (BH, S_q))``.  On the card the keys
    are split across CTAs by :func:`decode_split_plan`, or by ``plan``
    ``(n_split, split_tiles)`` when given (the tests and the timings force
    one); with more than one split a second kernel merges them."""
    global launches, merge_launches
    _check(q, k, v, lengths, heads)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, lengths, heads, scale)
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    _check_launch("flash_fwd", d, q=q, k=k, v=v, lengths=lengths)
    n_split, split_tiles = plan if plan is not None else decode_split_plan(
        bh, s_q, s_kv, _sm_count(q.device))
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    # the splits' (m, l, acc) partials, on the current stream's allocator
    part = torch.empty((bh, n_split, s_q, d + 2), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    fn = kernel("hetu_flash_fwd_lengths")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), lse.data_ptr(), _ptr(part), bh, heads, s_q,
                s_kv, d, n_split, split_tiles, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", rc)
    launches += 1
    merge_launches += n_split > 1
    return out, lse


def flash_fwd_split_plain(q, k, v, lengths, heads, scale, plan):
    """Plain PyTorch version of the decode kernel pair, split by ``plan``
    ``(n_split, split_tiles)`` as :func:`flash_fwd` splits it: each
    split's (max, sum, unnormalized output) over its keys below the
    length, then the merge in split order, skipping empty splits.  A K or
    V row at or past a length never reaches a sum (NaN there changes
    nothing).  Same outputs as :func:`flash_fwd_plain`; for the tests."""
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    n_split, split_tiles = plan
    span = split_tiles * DECODE_TILE
    lens = lengths.clamp(0, s_kv).repeat_interleave(heads)         # (BH,)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        k0, k1 = min(s * span, s_kv), min((s + 1) * span, s_kv)
        ok = torch.arange(k0, k1, device=q.device)[None, :] \
            < lens[:, None]                                         # (BH, n)
        kk = torch.where(ok[..., None], k[:, k0:k1], 0.0)
        vv = torch.where(ok[..., None], v[:, k0:k1], 0.0)
        sc = torch.matmul(q, kk.transpose(1, 2)) * scale
        sc = torch.where(ok[:, None, :], sc, -math.inf)
        live = ok.any(-1)[:, None]                                  # (BH, 1)
        m = torch.where(live, sc.amax(-1) if k1 > k0 else
                        torch.zeros(bh, s_q, device=q.device), 0.0)
        p = torch.exp(sc - m[..., None])                            # 0: not ok
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p, vv))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = l > 0
    mx = torch.where(live, m, -math.inf).amax(0)
    mx = torch.where(live.any(0), mx, 0.0)
    f = torch.where(live, torch.exp(m - mx), 0.0)
    total = (f * l).sum(0)
    o = (f[..., None] * acc).sum(0)
    empty = total == 0
    out = o / torch.where(empty, 1.0, total)[..., None]
    lse = torch.where(empty, NEG_INF, mx + torch.log(torch.where(empty, 1.0,
                                                                  total)))
    return out, lse


# -- dense / key_mask / causal (training) -------------------------------------

def flash_fwd_masked(q, k, v, key_mask, scale, causal=False, lengths=None):
    """Attention over the keys where ``key_mask`` (B, S_kv) int32 is
    nonzero and that lie below ``lengths`` (B,) int32, or over every key
    when both are None, and with ``causal`` only over the keys
    ``c <= r + S_kv - S_q`` of query row ``r``: q (BH, S_q, D), k/v
    (BH, S_kv, D) float32 or bfloat16.  Returns ``(out (BH, S_q, D) in
    q's dtype, lse (BH, S_q) float32)``."""
    fn_name = "flash_fwd_masked"
    _check_qkv(fn_name, q, k, v)
    heads = _key_heads(fn_name, q, k, key_mask, lengths)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, lengths, heads, scale,
                               key_mask=key_mask, causal=causal)
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    fn = kernel(_entry("hetu_flash_fwd_causal" if causal
                       else "hetu_flash_fwd", q))
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                _ptr(lengths), out.data_ptr(), lse.data_ptr(), bh, heads, s_q,
                k.shape[1], d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("fwd_causal_launches" if causal else "fwd_launches", q, lengths)
    return out, lse


def _check_fullmask(fn, q, k, key_mask, mask, gmode, heads, bias, kbias,
                    bgmode, lengths=None):
    """A full mask of group mode ``gmode`` and, when either is given, a
    bias or strip of group mode ``bgmode``; a ``key_mask`` and ``lengths``
    have BH / ``heads`` rows."""
    _check_mask(fn, q, k, mask, gmode, heads)
    _check_lengths(fn, q, lengths, heads)
    if bias is not None or kbias is not None:
        _check_bias(fn, q, k, key_mask, bias, kbias, bgmode, heads)
    elif key_mask is not None \
            and _check_key_mask(fn, q, k, key_mask) != heads:
        raise ValueError(f"{fn}: key_mask has {key_mask.shape[0]} rows, "
                         f"BH / heads is {q.shape[0] // heads}")


def _mask_ints(gmode, bias, kbias, bgmode, causal):
    """The mask C entries' (gmode, bgmode, strip, causal) ints."""
    biased = bias is not None or kbias is not None
    return (GMODES.index(gmode), GMODES.index(bgmode) if biased else 0,
            int(kbias is not None), int(bool(causal)))


def _mask_operands(q, mask, bias, kbias):
    """The mask C entries' tensors after ``lengths``: the mask, for
    float32 ``q`` its tile map (:func:`tile_maps`, built here on the
    device: one reduction, no host sync; the ``_bf16`` entries take none),
    the bias or strip (None: a null pointer).  The caller holds them until
    the launch is enqueued."""
    b = bias if bias is not None else kbias
    if q.dtype != torch.float32:
        return mask, b
    return mask, tile_maps(mask=mask)[1], b


def flash_fwd_fullmask(q, k, v, mask, gmode, heads, scale, key_mask=None,
                       causal=False, bias=None, kbias=None, bgmode="bh",
                       lengths=None):
    """Attention over the (row, key) pairs where the full ``mask`` is
    nonzero: uint8 (G, S_q, S_kv), stored unbroadcast, ``gmode`` one of
    ``one`` (G = 1), ``h`` (G = ``heads``, shared over the batch), ``b``
    (G = BH / ``heads``, shared over heads), ``bh`` (G = BH).  Composes
    with ``key_mask`` (B, S_kv) int32, ``lengths`` (B,) int32, ``causal``
    and an additive ``bias`` (G', S_q, S_kv) or key-bias strip ``kbias``
    (G', 1, S_kv) of its own group mode ``bgmode`` (as
    :func:`flash_fwd_bias` takes it).  q (BH, S_q, D), k/v (BH, S_kv, D)
    float32 or bfloat16.  Returns ``(out (BH, S_q, D) in q's dtype, lse
    (BH, S_q) float32)``."""
    fn_name = "flash_fwd_fullmask"
    _check_qkv(fn_name, q, k, v)
    _check_fullmask(fn_name, q, k, key_mask, mask, gmode, heads, bias, kbias,
                    bgmode, lengths)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, lengths, heads, scale,
                               key_mask=key_mask,
                               causal=causal, mask=mask, gmode=gmode,
                               bias=bias, kbias=kbias, bgmode=bgmode)
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, bias=bias,
                  kbias=kbias)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    operands = _mask_operands(q, mask, bias, kbias)
    with torch.cuda.device(q.device):
        rc = kernel(_entry("hetu_flash_fwd_mask", q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            _ptr(lengths), *map(_ptr, operands), out.data_ptr(),
            lse.data_ptr(), bh, heads, s_q, k.shape[1], d,
            *_mask_ints(gmode, bias, kbias, bgmode, causal),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("fwd_mask_bias_launches" if bias is not None
           else "fwd_mask_kbias_launches" if kbias is not None
           else "fwd_mask_launches", q, lengths)
    return out, lse


def flash_bwd_dq(q, k, v, key_mask, do, lse, delta, scale, causal=False,
                 lengths=None):
    """dQ of :func:`flash_fwd_masked` given dO, its lse and
    delta = rowsum(dO * out) (BH, S_q) float32, dO (BH, S_q, D) in q's
    dtype."""
    fn_name = "flash_bwd_dq"
    _check_qkv(fn_name, q, k, v)
    heads = _key_heads(fn_name, q, k, key_mask, lengths)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                            causal, lengths=lengths)[0]
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, do=do,
                  lse=lse, delta=delta)
    dq = torch.empty_like(q)
    fn = kernel(_entry("hetu_flash_bwd_dq_causal" if causal
                       else "hetu_flash_bwd_dq", q))
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                _ptr(lengths), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), bh, heads, s_q, k.shape[1], d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("dq_causal_launches" if causal else "dq_launches", q, lengths)
    return dq


def flash_bwd_dkv(q, k, v, key_mask, do, lse, delta, scale, causal=False,
                  lengths=None):
    """(dK, dV) of :func:`flash_fwd_masked`; inputs as :func:`flash_bwd_dq`.
    dK and dV are exactly 0 at every key at or past ``lengths``."""
    fn_name = "flash_bwd_dkv"
    _check_qkv(fn_name, q, k, v)
    heads = _key_heads(fn_name, q, k, key_mask, lengths)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        _, dk, dv, _ = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                    causal, lengths=lengths)
        return dk, dv
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, do=do,
                  lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = kernel(_entry("hetu_flash_bwd_dkv_causal" if causal
                       else "hetu_flash_bwd_dkv", q))
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                _ptr(lengths), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), bh, heads, s_q, k.shape[1], d,
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("dkv_causal_launches" if causal else "dkv_launches", q, lengths)
    return dk, dv


# -- additive bias (T5) ------------------------------------------------------

def _bias_args(bias, kbias, gmode, causal):
    """The C entries' bias pointer and its (gmode, strip, causal) ints."""
    strip = kbias is not None
    return ((kbias if strip else bias).data_ptr(),
            (GMODES.index(gmode), int(strip), int(bool(causal))))


def flash_fwd_bias(q, k, v, key_mask, bias, kbias, gmode, heads, scale,
                   causal=False, lengths=None):
    """Attention with an additive bias on the scaled scores: exactly one
    of ``bias`` (G, S_q, S_kv) and a per-key strip ``kbias`` (G, 1, S_kv),
    float32, stored unbroadcast for group mode ``gmode`` (as
    :func:`flash_fwd_fullmask`'s mask, BH = B * ``heads``).  Composes with
    ``key_mask`` (B, S_kv) int32, ``lengths`` (B,) int32 and ``causal``.
    q (BH, S_q, D), k/v (BH, S_kv, D) float32 or bfloat16.  Returns
    ``(out (BH, S_q, D) in q's dtype, lse (BH, S_q) float32)``."""
    fn_name = "flash_fwd_bias"
    _check_qkv(fn_name, q, k, v)
    _check_bias(fn_name, q, k, key_mask, bias, kbias, gmode, heads)
    _check_lengths(fn_name, q, lengths, heads)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, lengths, heads, scale,
                               key_mask=key_mask,
                               causal=causal, bias=bias, kbias=kbias,
                               bgmode=gmode)
    bh, s_q, d = q.shape
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, bias=bias,
                  kbias=kbias)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    b_ptr, b_ints = _bias_args(bias, kbias, gmode, causal)
    with torch.cuda.device(q.device):
        rc = kernel(_entry("hetu_flash_fwd_bias", q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            _ptr(lengths), b_ptr, out.data_ptr(), lse.data_ptr(), bh, heads,
            s_q, k.shape[1], d, *b_ints, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("fwd_kbias_launches" if bias is None
           else "fwd_bias_causal_launches" if causal
           else "fwd_bias_launches", q, lengths)
    return out, lse


def flash_bwd_dq_bias(q, k, v, key_mask, bias, kbias, gmode, heads, do, lse,
                      delta, scale, causal=False, lengths=None):
    """dQ of :func:`flash_fwd_bias`, and with a dense ``bias`` its
    gradient before the group sum: dbias (BH, S_q, S_kv) float32, the
    pre-scale dS, zero on every (row, key) pair the row does not see.
    Returns ``(dq, dbias)``; dbias is None with a strip ``kbias``."""
    fn_name = "flash_bwd_dq_bias"
    _check_qkv(fn_name, q, k, v)
    _check_bias(fn_name, q, k, key_mask, bias, kbias, gmode, heads)
    _check_lengths(fn_name, q, lengths, heads)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        dq, _, _, t = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                   causal, bias, kbias, gmode, heads,
                                   lengths=lengths)
        return dq, (t if bias is not None else None)
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, bias=bias,
                  kbias=kbias, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    dbias = None if bias is None else torch.empty(
        (bh, s_q, s_kv), dtype=torch.float32, device=q.device)
    b_ptr, b_ints = _bias_args(bias, kbias, gmode, causal)
    with torch.cuda.device(q.device):
        rc = kernel(_entry("hetu_flash_bwd_dq_bias", q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            _ptr(lengths), b_ptr, do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _ptr(dbias), bh, heads, s_q,
            s_kv, d, *b_ints, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("dq_kbias_launches" if bias is None
           else "dq_bias_causal_launches" if causal
           else "dq_bias_launches", q, lengths)
    return dq, dbias


def flash_bwd_dkv_bias(q, k, v, key_mask, bias, kbias, gmode, heads, do, lse,
                       delta, scale, causal=False, lengths=None):
    """(dK, dV) of :func:`flash_fwd_bias`, and with a strip ``kbias`` its
    gradient before the group sum: dkbias (BH, 1, S_kv) float32, the
    pre-scale dS summed over the query rows.  Returns ``(dk, dv,
    dkbias)``; dkbias is None with a dense ``bias``."""
    fn_name = "flash_bwd_dkv_bias"
    _check_qkv(fn_name, q, k, v)
    _check_bias(fn_name, q, k, key_mask, bias, kbias, gmode, heads)
    _check_lengths(fn_name, q, lengths, heads)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        _, dk, dv, t = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                    causal, bias, kbias, gmode, heads,
                                    lengths=lengths)
        return dk, dv, (t.sum(1, keepdim=True) if kbias is not None
                        else None)
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, bias=bias,
                  kbias=kbias, do=do, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkbias = None if kbias is None else torch.empty(
        (bh, 1, s_kv), dtype=torch.float32, device=q.device)
    b_ptr, b_ints = _bias_args(bias, kbias, gmode, causal)
    with torch.cuda.device(q.device):
        rc = kernel(_entry("hetu_flash_bwd_dkv_bias", q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            _ptr(lengths), b_ptr, do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dkbias), bh,
            heads, s_q, s_kv, d, *b_ints, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("dkv_kbias_launches" if bias is None
           else "dkv_bias_causal_launches" if causal
           else "dkv_bias_launches", q, lengths)
    return dk, dv, dkbias


# -- full mask, alone or with a bias (Longformer, XLNet) -------------------

def flash_bwd_dq_mask(q, k, v, key_mask, mask, gmode, heads, do, lse, delta,
                      scale, causal=False, bias=None, kbias=None, bgmode="bh",
                      lengths=None):
    """dQ of :func:`flash_fwd_fullmask` (the full ``mask`` of group mode
    ``gmode``, and optionally a ``bias`` or strip ``kbias`` of group mode
    ``bgmode``) given dO (BH, S_q, D) in q's dtype, its lse and delta =
    rowsum(dO * out), each (BH, S_q) float32.  With a dense ``bias`` also its gradient
    before the group sum, dbias (BH, S_q, S_kv), exactly 0 on every pair
    the row does not see.  Returns ``(dq, dbias)``; dbias is None without
    a dense bias."""
    fn_name = "flash_bwd_dq_mask"
    _check_qkv(fn_name, q, k, v)
    _check_fullmask(fn_name, q, k, key_mask, mask, gmode, heads, bias, kbias,
                    bgmode, lengths)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        dq, _, _, t = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                   causal, bias, kbias, bgmode, heads, mask,
                                   gmode, lengths)
        return dq, (t if bias is not None else None)
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, bias=bias,
                  kbias=kbias, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    dbias = None if bias is None else torch.empty(
        (bh, s_q, s_kv), dtype=torch.float32, device=q.device)
    operands = _mask_operands(q, mask, bias, kbias)
    with torch.cuda.device(q.device):
        rc = kernel(_entry("hetu_flash_bwd_dq_mask", q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            _ptr(lengths), *map(_ptr, operands), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(dbias), bh,
            heads, s_q, s_kv, d,
            *_mask_ints(gmode, bias, kbias, bgmode, causal),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("dq_mask_bias_launches" if bias is not None
           else "dq_mask_kbias_launches" if kbias is not None
           else "dq_mask_launches", q, lengths)
    return dq, dbias


def flash_bwd_dkv_mask(q, k, v, key_mask, mask, gmode, heads, do, lse, delta,
                       scale, causal=False, bias=None, kbias=None,
                       bgmode="bh", lengths=None):
    """(dK, dV) of :func:`flash_fwd_fullmask`; inputs as
    :func:`flash_bwd_dq_mask`.  With a strip ``kbias`` also its gradient
    before the group sum, dkbias (BH, 1, S_kv).  Returns ``(dk, dv,
    dkbias)``; dkbias is None without a strip."""
    fn_name = "flash_bwd_dkv_mask"
    _check_qkv(fn_name, q, k, v)
    _check_fullmask(fn_name, q, k, key_mask, mask, gmode, heads, bias, kbias,
                    bgmode, lengths)
    _check_rows(fn_name, q, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        _, dk, dv, t = _plain_grads(q, k, v, key_mask, lse, do, delta, scale,
                                    causal, bias, kbias, bgmode, heads, mask,
                                    gmode, lengths)
        return dk, dv, (t.sum(1, keepdim=True) if kbias is not None
                        else None)
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    _check_launch(fn_name, d, q=q, k=k, v=v, key_mask=key_mask, bias=bias,
                  kbias=kbias, do=do, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkbias = None if kbias is None else torch.empty(
        (bh, 1, s_kv), dtype=torch.float32, device=q.device)
    operands = _mask_operands(q, mask, bias, kbias)
    with torch.cuda.device(q.device):
        rc = kernel(_entry("hetu_flash_bwd_dkv_mask", q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            _ptr(lengths), *map(_ptr, operands), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(dkbias), bh, heads, s_q, s_kv, d,
            *_mask_ints(gmode, bias, kbias, bgmode, causal),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(fn_name, rc)
    _count("dkv_mask_bias_launches" if bias is not None
           else "dkv_mask_kbias_launches" if kbias is not None
           else "dkv_mask_launches", q, lengths)
    return dk, dv, dkbias


class FlashAttention(torch.autograd.Function):
    """Attention on (BH, S, D) tensors with the kernels' gradient, on every
    training path: dense, ``key_mask``, ``lengths`` (B,), causal, a full
    ``mask`` (uint8 (G, S_q, S_kv) of group mode ``gmode``) and a dense
    ``bias`` or key-bias strip ``kbias`` (group mode ``bgmode``, BH = B *
    ``heads``), each alone or together.  The forward saves q, k, v,
    key_mask, lengths, the mask, the bias, out and lse; the backward forms
    delta = rowsum(dO * out) in float32 (one plain expression, as the JAX
    package leaves it to XLA) and launches dQ and dK/dV with the forward's
    ``causal``, lengths, mask and bias.
    dbias / dkbias come back summed over the bias's group, in its storage
    shape (the JAX package's ``_flash_vjp_bwd``).  ``key_mask``,
    ``lengths``, the mask, ``scale`` and ``causal`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, causal=False, bias=None,
                kbias=None, bgmode="bh", heads=1, mask=None, gmode="bh",
                lengths=None):
        if mask is not None:
            out, lse = flash_fwd_fullmask(q, k, v, mask, gmode, heads, scale,
                                          key_mask=key_mask, causal=causal,
                                          bias=bias, kbias=kbias,
                                          bgmode=bgmode, lengths=lengths)
        elif bias is None and kbias is None:
            out, lse = flash_fwd_masked(q, k, v, key_mask, scale, causal,
                                        lengths=lengths)
        else:
            out, lse = flash_fwd_bias(q, k, v, key_mask, bias, kbias, bgmode,
                                      heads, scale, causal, lengths=lengths)
        ctx.save_for_backward(q, k, v, key_mask, lengths, mask, bias, kbias,
                              out, lse)
        ctx.scale = scale
        ctx.causal = bool(causal)
        ctx.bgmode, ctx.heads, ctx.gmode = bgmode, heads, gmode
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, lengths, mask, bias, kbias, out, lse = \
            ctx.saved_tensors
        do = dout.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        if mask is not None:
            kw = dict(causal=ctx.causal, bias=bias, kbias=kbias,
                      bgmode=ctx.bgmode, lengths=lengths)
            args = (q, k, v, key_mask, mask, ctx.gmode, ctx.heads, do, lse,
                    delta, ctx.scale)
            dq, dbias = flash_bwd_dq_mask(*args, **kw)
            dk, dv, dkbias = flash_bwd_dkv_mask(*args, **kw)
        elif bias is None and kbias is None:
            args = (q, k, v, key_mask, do, lse, delta, ctx.scale, ctx.causal)
            dq = flash_bwd_dq(*args, lengths=lengths)
            dk, dv = flash_bwd_dkv(*args, lengths=lengths)
            dbias = dkbias = None
        else:
            args = (q, k, v, key_mask, bias, kbias, ctx.bgmode, ctx.heads,
                    do, lse, delta, ctx.scale, ctx.causal)
            dq, dbias = flash_bwd_dq_bias(*args, lengths=lengths)
            dk, dv, dkbias = flash_bwd_dkv_bias(*args, lengths=lengths)
        if dbias is not None:
            dbias = group_reduce(dbias, ctx.bgmode, ctx.heads, bias.shape)
        if dkbias is not None:
            dkbias = group_reduce(dkbias, ctx.bgmode, ctx.heads, kbias.shape)
        return (dq, dk, dv, None, None, None, dbias, dkbias, None, None, None,
                None, None)


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
    """(B, H, S, D) entry with the JAX package's signature: dense,
    ``lengths`` (B,), ``key_mask`` (B, S_kv), ``causal``, a full ``mask``
    broadcastable as (1|B, 1|H, 1|S_q, S_kv) and an additive ``bias``
    broadcastable the same way, each alone or together, with their
    gradient (a (., ., 1, S_kv) bias takes the key-bias strip when
    S_q != 1, as in the JAX entry; the mask and the bias keep their own
    group modes).  ``lengths`` alone at one float32 query row with no
    gradient to take is the decode step: the ``lengths`` kernel
    (:func:`flash_fwd`); every other call goes through
    :class:`FlashAttention` and the training kernels.  Returns ``out``
    (B, H, S_q, D)."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    q3 = q.contiguous().view(b * h, s_q, d)
    k3 = k.contiguous().view(b * h, s_kv, d)
    v3 = v.contiguous().view(b * h, s_kv, d)
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
        decode = (s_q == 1 and q.dtype == torch.float32 and not causal
                  and key_mask is None and mask is None and bias is None
                  and not (torch.is_grad_enabled()
                           and any(t.requires_grad for t in (q, k, v))))
        if decode:
            out, _ = flash_fwd(q3, k3, v3, lengths, h, scale)
            return out.view(b, h, s_q, d)
    if key_mask is not None:
        key_mask = (key_mask != 0).to(torch.int32).contiguous()
    mask3, gmode = None, "bh"
    if mask is not None:
        mask3, gmode = broadcast_group(mask, b, h, s_q, s_kv, "mask")
    bias3 = kbias3 = None
    bgmode = "bh"
    if bias is not None:
        bgmode = classify_group(bias, b, h, s_q, s_kv, "bias")
        ba = bias.to(torch.float32)
        if bias.shape[2] == 1 and s_q != 1:
            # per-key (row-broadcast) bias: the O(S) strip path
            kbias3 = ba.reshape(-1, 1, s_kv).contiguous()
        else:
            bias3 = ba.reshape(-1, s_q, s_kv).contiguous()
    out = FlashAttention.apply(q3, k3, v3, key_mask, scale, bool(causal),
                               bias3, kbias3, bgmode, h, mask3, gmode,
                               lengths)
    return out.view(b, h, s_q, d)
