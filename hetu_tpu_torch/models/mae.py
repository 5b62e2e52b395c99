"""MAE, the masked-autoencoder ViT (twin of ``hetu_tpu/models/mae.py``).

The random patch masking is a host-side permutation fed as an int32
placeholder (``shuffle``: its first ``num_visible`` entries are the kept
patches).  The encoder sees only the visible patches, gathered by
``indexing_op``; the decoder puts its rows and a learned mask token
broadcast to every masked row back in patch order with
``scatter1d_grad_op`` and reconstructs pixels; the loss is the MSE over
the masked patches only.  Both towers' attention is ``sdpa_op``: on the
card the flash kernels' dense specialization (MAE-base: S = 49 visible
patches, head dim 64, in the encoder; S = 196, head dim 32, in the
decoder).  The gathers are exact, and the mask token's gradient is the
sum over its rows, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.core import Linear, LayerNorm
from .common import pre_ln_block


class MAEConfig:
    def __init__(self, image_size=224, patch_size=16, encoder_hidden=768,
                 encoder_layers=12, encoder_heads=12, decoder_hidden=512,
                 decoder_layers=8, decoder_heads=16, mask_ratio=0.75,
                 layer_norm_eps=1e-6, batch_size=8):
        assert image_size % patch_size == 0
        self.image_size = image_size
        self.patch_size = patch_size
        self.encoder_hidden = encoder_hidden
        self.encoder_layers = encoder_layers
        self.encoder_heads = encoder_heads
        self.decoder_hidden = decoder_hidden
        self.decoder_layers = decoder_layers
        self.decoder_heads = decoder_heads
        self.mask_ratio = mask_ratio
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.num_patches = (image_size // patch_size) ** 2
        self.num_visible = max(1, int(round(
            self.num_patches * (1 - mask_ratio))))
        self.patch_dim = 3 * patch_size * patch_size

    @classmethod
    def base(cls, **kw):
        """MAE-base (ViT-B/16 encoder; decoder 512 wide, 8 layers, 16
        heads; 75 % of the patches masked)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("encoder_hidden", 64)
        kw.setdefault("encoder_layers", 2)
        kw.setdefault("encoder_heads", 2)
        kw.setdefault("decoder_hidden", 32)
        kw.setdefault("decoder_layers", 1)
        kw.setdefault("decoder_heads", 2)
        return cls(**kw)


def _blocks(hidden, heads, seq, batch, eps, n_layers, name):
    def run(x):
        for i in range(n_layers):
            x = pre_ln_block(hidden, heads, seq, batch, eps,
                             f"{name}.layer{i}")(x)
        return x
    return run


def _pos_embed_flat(n, batch, hidden, name):
    """Learned (n, hidden) position table, gathered as (batch*n, hidden)
    by one embedding lookup of tiled static ids."""
    pos = init.truncated_normal((n, hidden), 0.0, 0.02, name=name)
    ids = Variable(name + ".ids",
                   value=np.tile(np.arange(n), batch).astype(np.float32),
                   trainable=False)
    return ops.embedding_lookup_op(pos, ids)   # (batch*n, hidden)


def mae_pretrain_graph(cfg, name="mae"):
    """Masked-autoencoding pretraining graph.

    Feeds: ``images`` (B, 3, H, W) and ``shuffle`` (B, num_patches) int32,
    a per-sample permutation of the patch indices whose first
    ``num_visible`` entries are the kept patches.  Returns (feeds, loss,
    recon_patches)."""
    B, P, V = cfg.batch_size, cfg.num_patches, cfg.num_visible
    p, g = cfg.patch_size, cfg.image_size // cfg.patch_size
    images = placeholder_op(
        "images", shape=(B, 3, cfg.image_size, cfg.image_size))
    shuffle = placeholder_op("shuffle", shape=(B, P), dtype=np.int32)

    # patchify → (B*P, patch_dim) raw pixel targets
    x = ops.array_reshape_op(images, output_shape=(B, 3, g, p, g, p))
    x = ops.transpose_op(x, perm=(0, 2, 4, 1, 3, 5))
    patches = ops.array_reshape_op(x, output_shape=(B * P, cfg.patch_dim))

    # flat gather indices: row b of shuffle indexes into b's patches
    base = Variable(name + ".rowbase",
                    value=(np.arange(B)[:, None] * P
                           * np.ones((1, P))).astype(np.float32),
                    trainable=False)
    shuf2 = shuffle + base                                  # (B, P) flat ids
    vis_idx = ops.array_reshape_op(
        ops.slice_op(shuf2, begin=(0, 0), size=(B, V)),
        output_shape=(B * V,))
    mask_idx = ops.array_reshape_op(
        ops.slice_op(shuf2, begin=(0, V), size=(B, P - V)),
        output_shape=(B * (P - V),))

    # ---- encoder on the visible patches only
    enc_in = Linear(cfg.patch_dim, cfg.encoder_hidden, name=name + ".proj")(
        ops.indexing_op(patches, vis_idx))            # (B*V, enc_hidden)
    pe_flat = _pos_embed_flat(P, B, cfg.encoder_hidden, name + ".enc_pos")
    enc_in = enc_in + ops.indexing_op(pe_flat, vis_idx)
    enc = _blocks(cfg.encoder_hidden, cfg.encoder_heads, V, B,
                  cfg.layer_norm_eps, cfg.encoder_layers, name + ".enc")(
        enc_in)
    enc = LayerNorm(cfg.encoder_hidden, cfg.layer_norm_eps,
                    name + ".enc_ln")(enc)

    # ---- decoder: visible tokens + learned mask tokens, un-shuffled
    dec_vis = Linear(cfg.encoder_hidden, cfg.decoder_hidden,
                     name=name + ".dec_embed")(enc)        # (B*V, dec_h)
    mask_tok = init.truncated_normal((1, cfg.decoder_hidden), 0.0, 0.02,
                                     name=name + ".mask_token")
    zeros_ids = Variable(name + ".mask_tok_ids",
                         value=np.zeros(B * (P - V), np.float32),
                         trainable=False)
    mask_rows = ops.embedding_lookup_op(mask_tok, zeros_ids)  # (B*(P-V), h)
    shuffled_all = ops.concatenate_op([dec_vis, mask_rows], axis=0)
    # the rows are [every visible row, then every mask row]; their
    # destinations follow the same order
    scatter_idx = ops.concatenate_op([vis_idx, mask_idx], axis=0)
    dec_seq = ops.scatter1d_grad_op(shuffled_all, scatter_idx, size=B * P)
    dec_seq = dec_seq + _pos_embed_flat(P, B, cfg.decoder_hidden,
                                        name + ".dec_pos")
    dec = _blocks(cfg.decoder_hidden, cfg.decoder_heads, P, B,
                  cfg.layer_norm_eps, cfg.decoder_layers, name + ".dec")(
        dec_seq)
    dec = LayerNorm(cfg.decoder_hidden, cfg.layer_norm_eps,
                    name + ".dec_ln")(dec)
    recon = Linear(cfg.decoder_hidden, cfg.patch_dim,
                   name=name + ".pred")(dec)               # (B*P, patch_dim)

    # ---- MSE on the masked patches only (entries V..P of the shuffle)
    diff = ops.indexing_op(recon, mask_idx) \
        - ops.indexing_op(patches, mask_idx)
    loss = ops.reduce_mean_op(ops.mul_op(diff, diff), [0, 1])
    return {"images": images, "shuffle": shuffle}, loss, recon


def synthetic_mae_batch(cfg, seed=0):
    """Seeded ``rand`` images and one permutation of the patches a sample
    (the JAX package's draw)."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(cfg.batch_size, 3, cfg.image_size,
                    cfg.image_size).astype(np.float32)
    shuffle = np.stack([rng.permutation(cfg.num_patches)
                        for _ in range(cfg.batch_size)]).astype(np.int32)
    return imgs, shuffle
