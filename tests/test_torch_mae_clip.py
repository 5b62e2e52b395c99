"""MAE and CLIP pretraining in the port against the JAX package, on the
CPU.

Tiny MAE (``MAEConfig.tiny``: 32², patch 8, encoder 64 wide 2 layers,
decoder 32 wide 1 layer, 75 % masked; batch 2) on
``synthetic_mae_batch(seed=0)`` and tiny CLIP (``CLIPConfig.tiny``: both
towers 64 wide, 2 layers, 2 heads, text 16 tokens; batch 4) on seeded
images and ids, from the JAX package's weights, at the gates of
``tests/_torch_model_parity.py``: step-1 loss atol 1e-5, every gradient
``allclose(rtol=1e-4, atol=1e-6)``, 5 Adam losses rtol 1e-5.  MAE's
gathers (``indexing_op``) and un-shuffle scatter (``scatter1d_grad_op``)
are exact; its mask token's gradient, a sum over the masked rows, is
held to the JAX gradient with the others.  The JAX package's
``test_mae_samples_are_isolated`` is held in the port, and its
reconstruction against the JAX package's."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_model_parity as P                          # noqa: E402
from hetu_tpu.models import clip as jclip                # noqa: E402
from hetu_tpu.models import mae as jmae                  # noqa: E402
from hetu_tpu_torch.models import clip as tclip          # noqa: E402
from hetu_tpu_torch.models import mae as tmae            # noqa: E402

MAE = dict(batch_size=2)
CLIP = dict(batch_size=4)


def _clip_batch(seed=0):
    cfg = jclip.CLIPConfig.tiny(**CLIP)
    rng = np.random.RandomState(seed)
    return {"images": rng.rand(cfg.batch_size, 3, cfg.image_size,
                               cfg.image_size).astype(np.float32),
            "input_ids": rng.randint(0, cfg.vocab_size,
                                     (cfg.batch_size, cfg.text_len)
                                     ).astype(np.int32)}


@pytest.fixture(scope="module")
def mae():
    cfg = jmae.MAEConfig.tiny(**MAE)
    return P.train_both("MAEConfig", "mae_pretrain_graph", MAE, dict(zip(
        ("images", "shuffle"), jmae.synthetic_mae_batch(cfg, seed=0))))


@pytest.fixture(scope="module")
def clip():
    return P.train_both("CLIPConfig", "clip_graph", CLIP, _clip_batch())


def test_mae_training_step_matches_jax(mae):
    cfg = mae["cfg"]
    P.check_step(mae, cfg.encoder_layers + cfg.decoder_layers)
    g = dict(zip(mae["names"], mae["tg"]))["mae.mask_token"]
    assert g.shape == (1, cfg.decoder_hidden) and np.abs(g).max() > 0


def test_mae_five_adam_steps_match_jax(mae):
    P.check_trajectory(mae)


def test_clip_training_step_matches_jax(clip):
    cfg = clip["cfg"]
    P.check_step(clip, cfg.vision_layers + cfg.text_layers)
    g = dict(zip(clip["names"], clip["tg"]))["clip.logit_scale"]
    assert g.shape == (1,) and abs(float(g[0])) > 0


def test_clip_five_adam_steps_match_jax(clip):
    P.check_trajectory(clip)
    # the symmetric InfoNCE over B = 4 starts near ln 4
    assert abs(clip["tl"][0] - np.log(4)) < 1.0


def test_mae_clip_configs_batches_and_names_equal_the_jax_package():
    for t, j in ((tmae.MAEConfig, jmae.MAEConfig),
                 (tclip.CLIPConfig, jclip.CLIPConfig)):
        for make in ("base", "tiny"):
            assert vars(getattr(t, make)()) == vars(getattr(j, make)())
    cfg = tmae.MAEConfig.tiny(**MAE)
    for a, b in zip(tmae.synthetic_mae_batch(cfg, seed=3),
                    jmae.synthetic_mae_batch(cfg, seed=3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tmae.MAEConfig.base().num_visible == 49
    for config, graph, kw in (("MAEConfig", "mae_pretrain_graph", MAE),
                              ("CLIPConfig", "clip_graph", CLIP)):
        assert P.names_and_shapes(True, config, graph, kw) \
            == P.names_and_shapes(False, config, graph, kw)


def test_mae_samples_are_isolated():
    """Un-shuffle wiring: changing sample 1's image and shuffle does not
    change sample 0's reconstruction; each reconstruction is the JAX
    package's from the same weights."""
    import hetu_tpu as jht
    import hetu_tpu_torch as tht

    cfg = tmae.MAEConfig.tiny(**MAE)
    jfeeds, _, jrecon = jmae.mae_pretrain_graph(cfg)
    tfeeds, _, trecon = tmae.mae_pretrain_graph(cfg)
    jex = jht.Executor({"fwd": [jrecon]}, seed=0)
    tex = tht.Executor({"fwd": [trecon]}, seed=0, device="cpu")
    tex.load_dict(jex.return_tensor_values())
    imgs, shuffle = tmae.synthetic_mae_batch(cfg)
    imgs2 = imgs.copy()
    imgs2[1] = np.roll(imgs2[1], 3)
    shuffle2 = shuffle.copy()
    shuffle2[1] = np.random.RandomState(99).permutation(cfg.num_patches)
    runs = []
    for im, sh in ((imgs, shuffle), (imgs2, shuffle2)):
        r = tex.run("fwd", feed_dict={tfeeds["images"]: im,
                                      tfeeds["shuffle"]: sh})[0].asnumpy()
        j = np.asarray(jex.run("fwd", feed_dict={
            jfeeds["images"]: im, jfeeds["shuffle"]: sh})[0].asnumpy())
        np.testing.assert_allclose(r, j, rtol=1e-5, atol=1e-6)
        runs.append(r)
    r1, r2 = runs
    n = cfg.num_patches
    np.testing.assert_allclose(r1[:n], r2[:n], rtol=1e-5, atol=1e-6)
    assert np.abs(r1[n:] - r2[n:]).max() > 1e-4
