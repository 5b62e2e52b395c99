"""ViT image classification (twin of ``hetu_tpu/models/vit.py``).

Patchify is a reshape + transpose + one product (the strided convolution
of the original, laid out as a matrix product), learned position
embeddings, pre-LN encoder blocks whose attention is ``sdpa_op``: on the
card the flash kernels' dense specialization, forward, dQ and dK/dV
(ViT-B/16 at 224²: S = 196, one ragged 4-row tail tile past three full
64-row tiles).  The head pools by the mean over the patches or by a
prepended class token (``pool="cls"``).  Variable names equal the JAX
graph's, so ``Executor.load_dict`` carries ``hetu_tpu``'s weights
across.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, num_channels=3,
                 hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_dropout_prob=0.0, layer_norm_eps=1e-6,
                 num_classes=1000, batch_size=8, pool="mean"):
        assert image_size % patch_size == 0
        assert pool in ("mean", "cls")
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.pool = pool
        self.num_patches = (image_size // patch_size) ** 2
        #: sequence length through the encoder (CLS prepends a token)
        self.seq_len = self.num_patches + (1 if pool == "cls" else 0)

    @classmethod
    def base(cls, **kw):
        """ViT-B/16 (224², patch 16, 768 wide, 12 layers, 12 heads)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("hidden_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("intermediate_size", 256)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


def _patchify(cfg, images, name):
    """(B, C, H, W) → (B*P, hidden) with one product."""
    p = cfg.patch_size
    g = cfg.image_size // p
    x = ops.array_reshape_op(
        images, output_shape=(cfg.batch_size, cfg.num_channels, g, p, g, p))
    x = ops.transpose_op(x, perm=(0, 2, 4, 1, 3, 5))  # B,gh,gw,C,p,p
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size * g * g,
                         cfg.num_channels * p * p))
    return Linear(cfg.num_channels * p * p, cfg.hidden_size,
                  initializer=init.GenTruncatedNormal(0.0, 0.02),
                  name=name + ".proj")(x)


def vit_model(cfg, images, name="vit"):
    """Token hidden states (batch*seq_len, hidden); ``cfg.pool == "cls"``
    prepends a learned class token."""
    S = cfg.seq_len
    x = _patchify(cfg, images, name + ".patch")
    pos = init.truncated_normal((S, cfg.hidden_size), 0.0, 0.02,
                                name=name + ".pos_embed")
    pos_ids = Variable(name + ".pos_ids",
                       value=np.arange(S, dtype=np.float32),
                       trainable=False)
    pe = ops.embedding_lookup_op(pos, pos_ids)        # (S, hidden)
    pe = ops.array_reshape_op(pe, output_shape=(1, S, cfg.hidden_size))
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size, cfg.num_patches, cfg.hidden_size))
    if cfg.pool == "cls":
        cls = init.truncated_normal((1, 1, cfg.hidden_size), 0.0, 0.02,
                                    name=name + ".cls_token")
        x = ops.concatenate_op(
            [ops.broadcast_shape_op(
                cls, shape=(cfg.batch_size, 1, cfg.hidden_size)), x],
            axis=1)
    x = x + ops.broadcastto_op(pe, x)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size * S, cfg.hidden_size))
    x = ops.dropout_op(x, 1.0 - cfg.hidden_dropout_prob)
    for i in range(cfg.num_hidden_layers):
        ln = f"{name}.layer{i}"
        h = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, ln + ".ln1")(x)
        mha = MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads,
                                 name=ln + ".attn")
        x = x + mha(h, cfg.batch_size, S)
        h = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, ln + ".ln2")(x)
        h = Linear(cfg.hidden_size, cfg.intermediate_size, activation="gelu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".mlp1")(h)
        h = Linear(cfg.intermediate_size, cfg.hidden_size,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".mlp2")(h)
        x = x + ops.dropout_op(h, 1.0 - cfg.hidden_dropout_prob)
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, name + ".ln_f")(x)


def vit_classify_graph(cfg, name="vit"):
    """Image classification: pooled tokens → linear head (``cfg.pool``:
    the mean over the patches, or the CLS token).  Returns (feeds dict,
    loss node, logits node)."""
    images = placeholder_op("images", shape=(cfg.batch_size, cfg.num_channels,
                                             cfg.image_size, cfg.image_size))
    labels = placeholder_op("labels", shape=(cfg.batch_size,
                                             cfg.num_classes))
    x = vit_model(cfg, images, name)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size, cfg.seq_len, cfg.hidden_size))
    if cfg.pool == "cls":
        pooled = ops.array_reshape_op(
            ops.slice_op(x, begin=(0, 0, 0),
                         size=(cfg.batch_size, 1, cfg.hidden_size)),
            output_shape=(cfg.batch_size, cfg.hidden_size))
    else:
        pooled = ops.reduce_mean_op(x, [1])
    logits = Linear(cfg.hidden_size, cfg.num_classes,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".head")(pooled)
    loss = ops.reduce_mean_op(
        ops.softmaxcrossentropy_op(logits, labels), [0])
    return {"images": images, "labels": labels}, loss, logits


def synthetic_image_batch(cfg, seed=0):
    """Seeded ``rand`` images (B, C, H, W) and one-hot labels (B,
    classes), float32 (the JAX package's draw)."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(cfg.batch_size, cfg.num_channels, cfg.image_size,
                    cfg.image_size).astype(np.float32)
    y = np.eye(cfg.num_classes, dtype=np.float32)[
        rng.randint(0, cfg.num_classes, cfg.batch_size)]
    return imgs, y
