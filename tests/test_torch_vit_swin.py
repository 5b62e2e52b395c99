"""ViT and Swin image classification in the port against the JAX package,
on the CPU.

Tiny ViT (``ViTConfig.tiny``: 32², patch 8, 128 wide, 2 layers, 2 heads;
batch 2) in both pool modes and tiny Swin (``SwinConfig.tiny``: 32²,
patch 4, embed 32, depths (2, 2), heads (2, 4), window 4; batch 2: the
second block of stage 1 shifted, stage 2 one unshifted 4x4 window) from
the JAX package's weights on ``synthetic_image_batch(seed=0)``, at the
gates of ``tests/_torch_model_parity.py``: step-1 loss atol 1e-5, every
gradient ``allclose(rtol=1e-4, atol=1e-6)`` (Swin's relative-position
tables, reached through the bias of the flash calls, included), 5 Adam
losses rtol 1e-5.  The JAX package's structural Swin tests are held in
the port too: the shift mask's properties and its equality with the JAX
package's constants, and a shifted-block graph held to the JAX package's
losses."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_model_parity as P                          # noqa: E402
from hetu_tpu.models import swin as jswin                # noqa: E402
from hetu_tpu.models import vit as jvit                  # noqa: E402
from hetu_tpu_torch.models import swin as tswin          # noqa: E402
from hetu_tpu_torch.models import vit as tvit            # noqa: E402

VIT = dict(batch_size=2)
SWIN = dict(batch_size=2)


def _images(cfg_cls, kw):
    cfg = cfg_cls.tiny(**kw)
    return dict(zip(("images", "labels"),
                    jvit.synthetic_image_batch(cfg, seed=0)))


@pytest.fixture(scope="module", params=["mean", "cls"])
def vit(request):
    kw = dict(VIT, pool=request.param)
    return P.train_both("ViTConfig", "vit_classify_graph", kw,
                        _images(jvit.ViTConfig, kw))


@pytest.fixture(scope="module")
def swin():
    return P.train_both("SwinConfig", "swin_classify_graph", SWIN,
                        _images(jswin.SwinConfig, SWIN))


def test_vit_training_step_matches_jax(vit):
    cfg = vit["cfg"]
    P.check_step(vit, cfg.num_hidden_layers)
    # patch proj, pos_embed, per layer 2 norms, q/k/v/o, mlp1/mlp2 (weight,
    # bias), ln_f, head; the class token with pool="cls"
    n = 2 + 1 + cfg.num_hidden_layers * (4 + 8 + 4) + 2 + 2 \
        + (cfg.pool == "cls")
    assert len(vit["names"]) == n


def test_vit_five_adam_steps_match_jax(vit):
    P.check_trajectory(vit)


def test_swin_training_step_matches_jax(swin):
    cfg = swin["cfg"]
    P.check_step(swin, sum(cfg.depths))
    tables = [g for name, g in zip(swin["names"], swin["tg"])
              if name.endswith(".rel_table")]
    assert len(tables) == sum(cfg.depths)
    assert all(np.abs(g).max() > 0 for g in tables)


def test_swin_five_adam_steps_match_jax(swin):
    P.check_trajectory(swin)


def test_vit_swin_configs_batches_and_names_equal_the_jax_package():
    for t, j in ((tvit.ViTConfig, jvit.ViTConfig),
                 (tswin.SwinConfig, jswin.SwinConfig)):
        for make in ("base", "tiny"):
            assert vars(getattr(t, make)()) == vars(getattr(j, make)())
    cfg = tvit.ViTConfig.tiny(**VIT)
    for a, b in zip(tvit.synthetic_image_batch(cfg, seed=3),
                    jvit.synthetic_image_batch(cfg, seed=3)):
        np.testing.assert_array_equal(a, b)
    for config, graph, kw in (("ViTConfig", "vit_classify_graph", VIT),
                              ("SwinConfig", "swin_classify_graph", SWIN)):
        assert P.names_and_shapes(True, config, graph, kw) \
            == P.names_and_shapes(False, config, graph, kw)
    # Swin-T's shared constants keep their JAX names
    names = {n for n, _, _ in P.names_and_shapes(
        True, "SwinConfig", "swin_classify_graph",
        dict(image_size=224, patch_size=4, embed_dim=96, depths=(2, 2, 6, 2),
             num_heads=(3, 6, 12, 24), window_size=7, num_classes=1000,
             batch_size=1))}
    assert {"swin.rel_idx.w7", "swin.shift_mask.r56w7s3",
            "swin.shift_mask.r28w7s3", "swin.shift_mask.r14w7s3"} <= names
    assert not any(n.startswith("swin.shift_mask.r7") for n in names)


def test_swin_shift_mask_properties():
    """The shifted-window validity mask keeps self-attention, is
    symmetric and blocks exactly the cross-region pairs of the rolled
    image; it and the relative index equal the JAX package's."""
    H = W = 8
    w, s = 4, 2
    m = tswin._shift_mask(H, W, w, s)               # (nW, w2, w2)
    np.testing.assert_array_equal(m, jswin._shift_mask(H, W, w, s))
    assert m.shape == ((H // w) * (W // w), w * w, w * w)
    assert set(np.unique(m)) <= {0.0, 1.0}
    for win in m:
        assert np.diag(win).all()
        assert (win == win.T).all()
    assert m[0].all()           # interior window, untouched by the seam
    assert not m[-1].all()      # the corner holds all 4 rolled regions
    idx = tswin._rel_bias_index(w).reshape(w * w, w * w)
    np.testing.assert_array_equal(idx.reshape(-1),
                                  jswin._rel_bias_index(w))
    assert len(set(idx[np.arange(w * w), np.arange(w * w)])) == 1
    assert idx.max() < (2 * w - 1) ** 2 and idx.min() >= 0
    # Swin-T's geometries: every mask of stages 1-3 as in the JAX package
    for res in (56, 28, 14):
        np.testing.assert_array_equal(tswin._shift_mask(res, res, 7, 3),
                                      jswin._shift_mask(res, res, 7, 3))


def test_swin_shifted_blocks_isolate_rolled_regions():
    """A one-stage Swin with a shifted block (the mask live) trains
    finitely, 2 Adam steps, and its losses are the JAX package's."""
    kw = dict(batch_size=2, depths=(2,), num_heads=(2,))
    rec = P.train_both("SwinConfig", "swin_classify_graph", kw,
                       _images(jswin.SwinConfig, kw), steps=2)
    assert np.isfinite(rec["tl"]).all()
    np.testing.assert_allclose(rec["tl"], rec["jl"], rtol=P.TRAJ_RTOL,
                               atol=P.LOSS_ATOL)
    masks = [n for n in rec["tex"].var_names.values()
             if n.startswith("swin.shift_mask")]
    assert masks == ["swin.shift_mask.r8w4s2"]


def test_step_flops_count_attention_on_visible_pairs():
    """``profile_train.graph_flops``'s attention (in the numerator of
    phase 44's MFU) against a count by hand: tiny ViT's dense attention
    2 x D multiply-adds a pair of every (b, h); tiny Swin's unshifted
    windows every pair, its shifted ones only the pairs the shift mask
    keeps."""
    import hetu_tpu_torch as tht
    from hetu_tpu_torch.tools import profile_train as pt
    tht.metrics.reset_flash_fallbacks()
    cfg = tvit.ViTConfig.tiny(**VIT)
    feeds, loss, _ = tvit.vit_classify_graph(cfg)
    shapes = {feeds["images"]: (2, 3, 32, 32), feeds["labels"]: (2, 10)}
    d = cfg.hidden_size // cfg.num_attention_heads
    macs = pt.graph_flops(loss, shapes)
    assert macs["attention"] == cfg.num_hidden_layers * 2 \
        * cfg.num_attention_heads * cfg.seq_len ** 2 * 2 * d
    cfg = tswin.SwinConfig.tiny(**SWIN)
    feeds, loss, _ = tswin.swin_classify_graph(cfg)
    w, res = cfg.window_size, cfg.image_size // cfg.patch_size
    kept = int(tswin._shift_mask(res, res, w, w // 2).sum())
    dense = (res // w) ** 2 * (w * w) ** 2          # stage 1: 4 windows
    d = cfg.embed_dim // cfg.num_heads[0]           # 16 at both stages
    want = 2 * d * cfg.batch_size * (
        cfg.num_heads[0] * (dense + kept)            # unshifted, shifted
        + 2 * cfg.num_heads[1] * (w * w) ** 2)       # stage 2: one window
    got = pt.graph_flops(loss, {feeds["images"]: (2, 3, 32, 32),
                                feeds["labels"]: (2, 10)})
    assert kept < dense and got["attention"] == want
    assert tht.metrics.flash_fallback_counts() == {}
