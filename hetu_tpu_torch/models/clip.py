"""CLIP contrastive pretraining (twin of ``hetu_tpu/models/clip.py``).

A ViT image tower (patchify as one product, mean-pooled) and a causal
text tower (last-token pooling), each projected to a shared space and
L2-normalized; the symmetric InfoNCE loss is one (B, B) logits product
scaled by ``exp`` of a learnable temperature.  On the card the image
tower's attention takes the flash kernels' dense specialization and the
text tower's the causal one (CLIP's S = 77), forward, dQ and dK/dV.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.core import Linear, LayerNorm
from .common import patchify, pre_ln_block


class CLIPConfig:
    def __init__(self, vocab_size=49408, text_hidden=512, text_layers=12,
                 text_heads=8, text_len=77, image_size=224, patch_size=32,
                 vision_hidden=768, vision_layers=12, vision_heads=12,
                 projection_dim=512, logit_scale_init=2.6592,
                 layer_norm_eps=1e-5, batch_size=8):
        self.vocab_size = vocab_size
        self.text_hidden = text_hidden
        self.text_layers = text_layers
        self.text_heads = text_heads
        self.text_len = text_len
        self.image_size = image_size
        self.patch_size = patch_size
        self.vision_hidden = vision_hidden
        self.vision_layers = vision_layers
        self.vision_heads = vision_heads
        self.projection_dim = projection_dim
        self.logit_scale_init = logit_scale_init
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.num_patches = (image_size // patch_size) ** 2

    @classmethod
    def base(cls, **kw):
        """CLIP ViT-B/32 (vision 768 wide, 12 layers, 12 heads, patch 32;
        text 512 wide, 12 layers, 8 heads, 77 tokens)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("text_hidden", 64)
        kw.setdefault("text_layers", 2)
        kw.setdefault("text_heads", 2)
        kw.setdefault("text_len", 16)
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("vision_hidden", 64)
        kw.setdefault("vision_layers", 2)
        kw.setdefault("vision_heads", 2)
        kw.setdefault("projection_dim", 32)
        return cls(**kw)


def clip_vision_tower(cfg, images, name="clip.vision"):
    """(B, C, H, W) → pooled (B, vision_hidden)."""
    x = patchify(images, cfg.batch_size, 3, cfg.image_size, cfg.patch_size,
                 cfg.vision_hidden, name + ".patch", bias=False)
    pos = init.truncated_normal((cfg.num_patches, cfg.vision_hidden),
                                0.0, 0.02, name=name + ".pos")
    pos_ids = Variable(name + ".pos_ids",
                       value=np.arange(cfg.num_patches, dtype=np.float32),
                       trainable=False)
    pe = ops.embedding_lookup_op(pos, pos_ids)
    pe = ops.array_reshape_op(
        pe, output_shape=(1, cfg.num_patches, cfg.vision_hidden))
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size, cfg.num_patches, cfg.vision_hidden))
    x = x + ops.broadcastto_op(pe, x)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size * cfg.num_patches, cfg.vision_hidden))
    x = LayerNorm(cfg.vision_hidden, cfg.layer_norm_eps, name + ".pre_ln")(x)
    for i in range(cfg.vision_layers):
        x = pre_ln_block(cfg.vision_hidden, cfg.vision_heads,
                         cfg.num_patches, cfg.batch_size,
                         cfg.layer_norm_eps, f"{name}.layer{i}")(x)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size, cfg.num_patches, cfg.vision_hidden))
    pooled = ops.reduce_mean_op(x, [1])
    return LayerNorm(cfg.vision_hidden, cfg.layer_norm_eps,
                     name + ".post_ln")(pooled)


def clip_text_tower(cfg, input_ids, name="clip.text"):
    """(B, L) ids → pooled (B, text_hidden), the last position (the EOS
    of fixed-length inputs)."""
    word = init.truncated_normal((cfg.vocab_size, cfg.text_hidden), 0.0, 0.02,
                                 name=name + ".word")
    pos = init.truncated_normal((cfg.text_len, cfg.text_hidden), 0.0, 0.01,
                                name=name + ".pos")
    pos_ids = Variable(name + ".pos_ids",
                       value=np.arange(cfg.text_len, dtype=np.float32),
                       trainable=False)
    x = ops.embedding_lookup_op(word, input_ids) \
        + ops.embedding_lookup_op(pos, pos_ids)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size * cfg.text_len, cfg.text_hidden))
    for i in range(cfg.text_layers):
        x = pre_ln_block(cfg.text_hidden, cfg.text_heads, cfg.text_len,
                         cfg.batch_size, cfg.layer_norm_eps,
                         f"{name}.layer{i}", causal=True)(x)
    x = LayerNorm(cfg.text_hidden, cfg.layer_norm_eps, name + ".ln_f")(x)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size, cfg.text_len, cfg.text_hidden))
    last = ops.slice_op(x, begin=(0, cfg.text_len - 1, 0),
                        size=(cfg.batch_size, 1, cfg.text_hidden))
    return ops.array_reshape_op(last, output_shape=(cfg.batch_size,
                                                    cfg.text_hidden))


def _l2_normalize(x):
    sq = ops.reduce_sum_op(ops.mul_op(x, x), [1], keepdims=True)
    return x / ops.broadcastto_op(ops.sqrt_op(sq + 1e-12), x)


def clip_graph(cfg, name="clip"):
    """Contrastive pretraining graph.  Returns (feeds dict, loss node,
    (img_emb, txt_emb) nodes)."""
    images = placeholder_op("images",
                            shape=(cfg.batch_size, 3, cfg.image_size,
                                   cfg.image_size))
    input_ids = placeholder_op("input_ids",
                               shape=(cfg.batch_size, cfg.text_len),
                               dtype=np.int32)
    iv = clip_vision_tower(cfg, images, name + ".vision")
    tv = clip_text_tower(cfg, input_ids, name + ".text")
    img = Linear(cfg.vision_hidden, cfg.projection_dim, bias=False,
                 name=name + ".visual_projection")(iv)
    txt = Linear(cfg.text_hidden, cfg.projection_dim, bias=False,
                 name=name + ".text_projection")(tv)
    img = _l2_normalize(img)
    txt = _l2_normalize(txt)
    scale = Variable(name + ".logit_scale",
                     value=np.asarray([cfg.logit_scale_init], np.float32))
    logits = ops.matmul_op(img, txt, trans_B=True)        # (B, B)
    logits = logits * ops.broadcastto_op(ops.exp_op(scale), logits)
    targets = Variable(name + ".targets",
                       value=np.arange(cfg.batch_size, dtype=np.float32),
                       trainable=False)
    li = ops.reduce_mean_op(
        ops.softmaxcrossentropy_sparse_op(logits, targets), [0])
    lt = ops.reduce_mean_op(
        ops.softmaxcrossentropy_sparse_op(
            ops.transpose_op(logits, perm=(1, 0)), targets), [0])
    loss = (li + lt) * 0.5
    return {"images": images, "input_ids": input_ids}, loss, (img, txt)
