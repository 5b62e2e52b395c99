"""Swin Transformer image classification (twin of
``hetu_tpu/models/swin.py``).

Windows are cut by reshape + transpose alone (static shapes; every
stage's resolution a multiple of its window, and a stage smaller than the
window takes one window of its whole resolution, unshifted).  The cyclic
shift is ``roll_op``; its cross-region validity mask is a constant
(nW, 1, w², w²) Variable built on the host and tiled over the window
batch B·nW by ``repeat_op``.  The relative position bias is an embedding
lookup of a trainable ((2w-1)², heads) table by a constant index,
reshaped to (1, heads, w², w²).  On the card every block's attention
takes the flash kernels' bias specialization (bias group ``h``) and every
shifted block's the full-mask-with-bias one (mask group ``b`` over the
B·nW windows, bias group ``h``), forward, dQ (with dbias) and dK/dV:
49-token windows at Swin-T's window 7, each one ragged 64-row tile,
head dim 32.  Patch merging is reshape → transpose → LayerNorm → Linear.

The shared constants keep the JAX names (``swin.rel_idx.w{w}``,
``swin.shift_mask.r{res}w{w}s{s}``), so weights cross by name.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm
from .common import patchify


class SwinConfig:
    def __init__(self, image_size=224, patch_size=4, num_channels=3,
                 embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, mlp_ratio=4.0, hidden_dropout_prob=0.0,
                 layer_norm_eps=1e-5, num_classes=1000, batch_size=8):
        assert len(depths) == len(num_heads)
        assert image_size % patch_size == 0
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.mlp_ratio = mlp_ratio
        self.hidden_dropout_prob = hidden_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.num_classes = num_classes
        self.batch_size = batch_size
        res = image_size // patch_size
        for i in range(len(depths)):
            ws = min(window_size, res)
            assert res % ws == 0, (
                f"stage {i}: resolution {res} not divisible by window {ws}"
                " — pick image/patch/window sizes that tile exactly")
            res //= 2 if i + 1 < len(depths) else 1

    @classmethod
    def base(cls, **kw):
        """Swin-T (224², patch 4, embed 96, depths (2, 2, 6, 2), heads
        (3, 6, 12, 24), window 7)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 4)     # 8x8 grid
        kw.setdefault("embed_dim", 32)
        kw.setdefault("depths", (2, 2))    # stage 2 at 4x4
        kw.setdefault("num_heads", (2, 4))
        kw.setdefault("window_size", 4)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


def _rel_bias_index(w):
    """Flattened (w², w²) index into the (2w-1)² relative-coord table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)  # (2, w²)
    rel = coords[:, :, None] - coords[:, None, :]                 # (2,w²,w²)
    rel = rel + (w - 1)
    return (rel[0] * (2 * w - 1) + rel[1]).reshape(-1)            # (w⁴,)


def _shift_mask(H, W, w, s):
    """(nW, w², w²) validity mask (1 = attend) of shifted-window attention:
    pairs from different pre-roll regions do not attend."""
    img = np.zeros((H, W), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws_ in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws_] = cnt
            cnt += 1
    win = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)                                  # (nW, w²)
    diff = win[:, None, :] - win[:, :, None]
    return (diff == 0).astype(np.float32)


class _WindowBlock:
    """One Swin block: (shifted-)window attention + MLP, pre-LN."""

    def __init__(self, cfg, dim, heads, res, shift, name, consts=None):
        self.cfg, self.dim, self.heads, self.res = cfg, dim, heads, res
        self.w = min(cfg.window_size, res)
        self.shift = shift if self.w < res else 0
        self.name = name
        consts = consts if consts is not None else {}
        self.ln1 = LayerNorm(dim, cfg.layer_norm_eps, name + ".ln1")
        self.mha = MultiHeadAttention(dim, heads, name=name + ".attn")
        self.ln2 = LayerNorm(dim, cfg.layer_norm_eps, name + ".ln2")
        hid = int(dim * cfg.mlp_ratio)
        self.fc1 = Linear(dim, hid, activation="gelu",
                          initializer=init.GenTruncatedNormal(0.0, 0.02),
                          name=name + ".mlp1")
        self.fc2 = Linear(hid, dim,
                          initializer=init.GenTruncatedNormal(0.0, 0.02),
                          name=name + ".mlp2")
        w = self.w
        self.rel_table = init.truncated_normal(
            ((2 * w - 1) ** 2, heads), 0.0, 0.02, name=name + ".rel_table")
        # one non-trainable Variable per distinct geometry, shared by the
        # blocks and stages that have it
        ikey = ("idx", w)
        if ikey not in consts:
            consts[ikey] = Variable(
                f"swin.rel_idx.w{w}",
                value=_rel_bias_index(w).astype(np.float32),
                trainable=False)
        self.rel_idx = consts[ikey]
        if self.shift:
            mkey = ("mask", res, w, self.shift)
            if mkey not in consts:
                m = _shift_mask(res, res, w, self.shift)    # (nW, w², w²)
                consts[mkey] = Variable(
                    f"swin.shift_mask.r{res}w{w}s{self.shift}",
                    value=np.ascontiguousarray(m[:, None]),
                    trainable=False)
            self.mask = consts[mkey]
        else:
            self.mask = None

    def _windows(self, x):
        """(B*res², C) → (B*nW*w², C) by reshape/transpose only."""
        B, r, w, C = self.cfg.batch_size, self.res, self.w, self.dim
        x = ops.array_reshape_op(
            x, output_shape=(B, r // w, w, r // w, w, C))
        x = ops.transpose_op(x, perm=(0, 1, 3, 2, 4, 5))
        return ops.array_reshape_op(
            x, output_shape=(B * (r // w) ** 2 * w * w, C))

    def _unwindows(self, x):
        B, r, w, C = self.cfg.batch_size, self.res, self.w, self.dim
        x = ops.array_reshape_op(
            x, output_shape=(B, r // w, r // w, w, w, C))
        x = ops.transpose_op(x, perm=(0, 1, 3, 2, 4, 5))
        return ops.array_reshape_op(x, output_shape=(B * r * r, C))

    def _bias(self):
        """Relative-position logit bias (1, heads, w², w²), group ``h``."""
        w2 = self.w * self.w
        b = ops.embedding_lookup_op(self.rel_table, self.rel_idx)
        b = ops.array_reshape_op(b, output_shape=(w2, w2, self.heads))
        b = ops.transpose_op(b, perm=(2, 0, 1))
        return ops.array_reshape_op(b, output_shape=(1, self.heads, w2, w2))

    def __call__(self, x):
        B, r, w, C = self.cfg.batch_size, self.res, self.w, self.dim
        nwin = B * (r // w) ** 2
        h = self.ln1(x)
        if self.shift:
            h = ops.array_reshape_op(h, output_shape=(B, r, r, C))
            h = ops.roll_op(h, shift=(-self.shift, -self.shift), axis=(1, 2))
            h = ops.array_reshape_op(h, output_shape=(B * r * r, C))
        h = self._windows(h)
        mask = None
        if self.mask is not None:
            # (nW, 1, w², w²) → (B·nW, 1, w², w²): flat window t = b·nW + j
            # takes mask[j], as _windows flattens (B, nW) batch-major
            mask = ops.repeat_op(self.mask, reps=(B, 1, 1, 1))
        h = self.mha(h, nwin, w * w, mask=mask, bias=self._bias())
        h = self._unwindows(h)
        if self.shift:
            h = ops.array_reshape_op(h, output_shape=(B, r, r, C))
            h = ops.roll_op(h, shift=(self.shift, self.shift), axis=(1, 2))
            h = ops.array_reshape_op(h, output_shape=(B * r * r, C))
        p = self.cfg.hidden_dropout_prob
        x = x + ops.dropout_op(h, 1.0 - p) if p else x + h
        m = self.fc2(self.fc1(self.ln2(x)))
        return x + ops.dropout_op(m, 1.0 - p) if p else x + m


def _patch_merge(cfg, x, res, dim, name):
    """(B*res², C) → (B*(res/2)², 2C): 2×2 cell concat → LN → Linear."""
    B = cfg.batch_size
    x = ops.array_reshape_op(
        x, output_shape=(B, res // 2, 2, res // 2, 2, dim))
    x = ops.transpose_op(x, perm=(0, 1, 3, 2, 4, 5))
    x = ops.array_reshape_op(
        x, output_shape=(B * (res // 2) ** 2, 4 * dim))
    x = LayerNorm(4 * dim, cfg.layer_norm_eps, name + ".ln")(x)
    return Linear(4 * dim, 2 * dim, bias=False,
                  initializer=init.GenTruncatedNormal(0.0, 0.02),
                  name=name + ".reduce")(x)


def swin_model(cfg, images, name="swin"):
    """The hierarchical encoder.  Returns ``(hidden, res, dim)``: the last
    stage's hidden states (B*res², dim) and its grid resolution and
    width."""
    B = cfg.batch_size
    g = cfg.image_size // cfg.patch_size
    x = patchify(images, B, cfg.num_channels, cfg.image_size,
                 cfg.patch_size, cfg.embed_dim, name + ".patch")
    x = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, name + ".patch_ln")(x)

    res, dim = g, cfg.embed_dim
    consts = {}   # (res, w, shift) → shared mask / rel_idx constants
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        for bi in range(depth):
            blk = _WindowBlock(
                cfg, dim, heads, res,
                shift=(min(cfg.window_size, res) // 2) if bi % 2 else 0,
                name=f"{name}.s{si}.b{bi}", consts=consts)
            x = blk(x)
        if si + 1 < len(cfg.depths):
            x = _patch_merge(cfg, x, res, dim, f"{name}.s{si}.merge")
            res, dim = res // 2, dim * 2
    return LayerNorm(dim, cfg.layer_norm_eps, name + ".ln_f")(x), res, dim


def swin_classify_graph(cfg, name="swin"):
    """Image classification: mean-pooled tokens → linear head.  Returns
    (feeds dict, loss node, logits node)."""
    images = placeholder_op(
        "images", shape=(cfg.batch_size, cfg.num_channels,
                         cfg.image_size, cfg.image_size))
    labels = placeholder_op(
        "labels", shape=(cfg.batch_size, cfg.num_classes))
    x, res, dim = swin_model(cfg, images, name)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size, res * res, dim))
    pooled = ops.reduce_mean_op(x, [1])
    logits = Linear(dim, cfg.num_classes,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".head")(pooled)
    loss = ops.reduce_mean_op(
        ops.softmaxcrossentropy_op(logits, labels), [0])
    return {"images": images, "labels": labels}, loss, logits
