"""The base Transformer, BART and BigBird in the port against the JAX
package, on the CPU.

Tiny Transformer (``TransformerConfig.tiny``: 64 wide, 2 + 2 layers, 2
heads, vocabulary 256; batch 2, 16 + 16 tokens, dropout 0) on
``synthetic_copy_batch(seed=0)``, tiny BART (``BartConfig.tiny``: 128
wide, 2 + 2 layers, 2 heads, vocabulary 512; batch 2, 16 + 16 tokens,
dropout 0) on seeded ids and tiny BigBird (``BigBirdConfig.tiny``: 128
wide, 2 layers, 2 heads, blocks of 8, 2 random blocks, S = 64; batch 2,
dropout 0) on seeded MLM ids, from the JAX package's weights, at the
gates of ``tests/_torch_model_parity.py``: step-1 loss atol 1e-5, every
gradient ``allclose(rtol=1e-4, atol=1e-6)``, 5 Adam losses rtol 1e-5.
The JAX package's ``test_bigbird_mask_structure`` is held in the port,
and the seeded mask equals the JAX package's."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_model_parity as P                          # noqa: E402
from hetu_tpu.models import bart as jbart                # noqa: E402
from hetu_tpu.models import bigbird as jbb               # noqa: E402
from hetu_tpu.models import transformer as jtr           # noqa: E402
from hetu_tpu_torch.models import bart as tbart          # noqa: E402
from hetu_tpu_torch.models import bigbird as tbb         # noqa: E402
from hetu_tpu_torch.models import transformer as ttr     # noqa: E402

TR = dict(batch_size=2, dropout=0.0, src_len=16, tgt_len=16)
BART = dict(batch_size=2, dropout=0.0, src_len=16, tgt_len=16)
BB = dict(batch_size=2, hidden_dropout_prob=0.0)


def _bart_batch(seed=0):
    cfg = jbart.BartConfig.tiny(**BART)
    rng = np.random.RandomState(seed)
    src = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.src_len))
    tgt = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.tgt_len + 1))
    return {"input_ids": src.astype(np.int32),
            "decoder_input_ids": tgt[:, :-1].astype(np.int32),
            "labels": tgt[:, 1:].astype(np.int32)}


def _batch(model):
    if model == "transformer":
        cfg = jtr.TransformerConfig.tiny(**TR)
        return dict(zip(("src_ids", "tgt_ids", "labels"),
                        jtr.synthetic_copy_batch(cfg, seed=0)))
    if model == "bart":
        return _bart_batch()
    cfg = jbb.BigBirdConfig.tiny(**BB)
    return P.mlm_batch(cfg.vocab_size, cfg.batch_size, cfg.seq_len)


#: model -> (config, graph, config keywords, attention calls a step)
MODELS = {"transformer": ("TransformerConfig", "transformer_graph", TR, 6),
          "bart": ("BartConfig", "bart_seq2seq_graph", BART, 6),
          "bigbird": ("BigBirdConfig", "bigbird_mlm_graph", BB, 2)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def trained(request):
    config, graph, kw, calls = MODELS[request.param]
    rec = P.train_both(config, graph, kw, _batch(request.param))
    rec["calls"] = calls
    return rec


def test_training_step_matches_jax(trained):
    P.check_step(trained, trained["calls"])


def test_five_adam_steps_match_jax(trained):
    P.check_trajectory(trained)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_configs_and_names_equal_the_jax_package(model):
    config, graph, kw, _ = MODELS[model]
    tmod = {"transformer": ttr, "bart": tbart, "bigbird": tbb}[model]
    jmod = {"transformer": jtr, "bart": jbart, "bigbird": jbb}[model]
    makes = ("tiny",) if model == "transformer" else ("base", "tiny")
    for make in makes:
        assert vars(getattr(getattr(tmod, config), make)()) \
            == vars(getattr(getattr(jmod, config), make)())
    assert P.names_and_shapes(True, config, graph, kw) \
        == P.names_and_shapes(False, config, graph, kw)
    if model == "transformer":
        cfg = ttr.TransformerConfig.tiny(**TR)
        for a, b in zip(ttr.synthetic_copy_batch(cfg, seed=3),
                        jtr.synthetic_copy_batch(cfg, seed=3)):
            np.testing.assert_array_equal(a, b)


def test_bigbird_mask_structure():
    m = tbb.bigbird_attention_mask(32, 8, num_random_blocks=1,
                                   num_global_blocks=1, seed=0)
    assert m.shape == (32, 32)
    assert m[:8].all() and m[:, :8].all()          # global block
    assert m[16, 16] == 1 and m[16, 9] == 1 and m[16, 25] == 1  # window
    nb_attended = (m.reshape(4, 8, 4, 8).max(axis=(1, 3)) > 0).sum(1)
    assert (nb_attended <= 1 + 3 + 1).all()        # global+window+random
    # seeded: both packages draw the same mask, BigBird-base's too
    for args in ((32, 8, 1, 1, 0), (64, 8, 2, 1, 0), (1024, 64, 3, 1, 0)):
        np.testing.assert_array_equal(tbb.bigbird_attention_mask(*args),
                                      jbb.bigbird_attention_mask(*args))
