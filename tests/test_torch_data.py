"""The port's data package (``hetu_tpu_torch/data``) against the JAX
package's (``hetu_tpu/data``): the datasets bit for bit (the synthetic
sets and files on disk), every transform on seeded batches, the
``Dataloader``'s batches, shuffle order, ``drop_last``, data-parallel
shard, peek and resume, and a ``DataloaderOp``-fed graph through
``Executor.run`` with no feed dict (float32 losses rtol 1e-5)."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                  # noqa: E402
from hetu_tpu.data import datasets as jds               # noqa: E402
from hetu_tpu.data import transforms as jtf             # noqa: E402
import hetu_tpu_torch as tht                            # noqa: E402
from hetu_tpu_torch.data import datasets as tds         # noqa: E402
from hetu_tpu_torch.data import transforms as ttf       # noqa: E402
from test_torch_cnn import jax_cnn_models               # noqa: E402


def _equal(a, b):
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype and a.shape == b.shape


def _equal_tree(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    else:
        _equal(a, b)


@pytest.fixture
def no_data_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("name", ["mnist", "cifar10", "cifar100",
                                  "normalize_cifar"])
def test_synthetic_datasets_are_the_jax_packages(no_data_dir, name):
    _equal_tree(getattr(tds, name)(), getattr(jds, name)())


def test_synthetic_and_one_hot_are_the_jax_packages():
    _equal_tree(tds._synthetic(37, (3, 4), 7, 5),
                jds._synthetic(37, (3, 4), 7, 5))
    labels = np.random.RandomState(0).randint(0, 9, size=50)
    _equal(tds.convert_to_one_hot(labels), jds.convert_to_one_hot(labels))
    _equal(tds.convert_to_one_hot(labels, 12),
           jds.convert_to_one_hot(labels, 12))


def test_datasets_on_disk_load_as_the_jax_packages(no_data_dir):
    rng = np.random.RandomState(1)
    np.savez(no_data_dir / "mnist.npz",
             x_train=rng.randint(0, 256, (60, 28, 28)).astype(np.uint8),
             y_train=rng.randint(0, 10, 60),
             x_test=rng.randint(0, 256, (12, 28, 28)).astype(np.uint8),
             y_test=rng.randint(0, 10, 12))
    cdir = no_data_dir / "cifar10"
    cdir.mkdir()
    np.save(cdir / "train_x.npy", rng.rand(20, 3, 32, 32).astype(np.float32))
    np.save(cdir / "train_y.npy", rng.randint(0, 10, 20))
    np.save(cdir / "test_x.npy", rng.rand(8, 3, 32, 32).astype(np.float32))
    np.save(cdir / "test_y.npy", rng.randint(0, 10, 8))
    _equal_tree(tds.mnist(), jds.mnist())
    _equal_tree(tds.cifar10(), jds.cifar10())


def _batch(shape=(6, 3, 10, 12), seed=2, dtype=np.float32):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(0, 256, shape).astype(dtype)
    return rng.rand(*shape).astype(dtype)


TRANSFORMS = {
    "compose": lambda tf: tf.Compose([tf.Normalize([0.4, 0.5, 0.6],
                                                   [0.2, 0.25, 0.3]),
                                      tf.RandomHorizontalFlip(0.5, seed=3)]),
    "normalize_flat": lambda tf: tf.Normalize(0.5, 0.25),
    "flip": lambda tf: tf.RandomHorizontalFlip(0.7, seed=4),
    "crop": lambda tf: tf.RandomCrop(8, padding=3, seed=5),
    "cutout": lambda tf: tf.Cutout(6, seed=6),
    "resize_down": lambda tf: tf.Resize(3),
    "resize_up": lambda tf: tf.Resize((15, 17)),
    "center_crop": lambda tf: tf.CenterCrop((7, 9)),
    "center_pad": lambda tf: tf.CenterCrop(14),
}


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in sorted(TRANSFORMS)
    for dtype in ((np.float32,) if name.startswith(("compose", "normalize"))
                  else (np.float32, np.uint8))])
def test_transform_matches_jax(name, dtype):
    """Three batches through one instance (a seeded transform's state
    advances batch by batch), bit for bit; the geometric ones on uint8
    images too (``Resize`` rounds them)."""
    shape = (6, 20) if name == "normalize_flat" else (6, 3, 10, 12)
    t, j = TRANSFORMS[name](ttf), TRANSFORMS[name](jtf)
    for seed in range(3):
        b = _batch(shape, seed, dtype)
        _equal(t(b.copy()), j(b.copy()))


def _loader(pkg, **kw):
    data = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    return pkg.Dataloader(data, 4, "train", **kw)


LOADERS = [dict(), dict(shuffle=True, seed=7), dict(drop_last=False),
           dict(shuffle=True, drop_last=False, seed=1),
           dict(dp_rank=1, dp_nrank=3, shuffle=True, seed=2),
           dict(prefetch=0, shuffle=True, seed=3)]


@pytest.mark.parametrize("kw", LOADERS)
def test_dataloader_batches_match_jax(kw):
    """Three epochs and a bit: every batch, the shuffle order each epoch,
    the remainder batch, the shard of one data-parallel worker."""
    t, j = _loader(tht, **kw), _loader(jht, **kw)
    assert t.batch_num == j.batch_num
    assert t.get_cur_shape() == j.get_cur_shape()
    for _ in range(3 * t.batch_num + 2):
        _equal(t.get_arr(), j.get_arr())


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=7),
                                dict(prefetch=0, drop_last=False)])
def test_dataloader_resumes_as_the_jax_package(kw):
    """``state_dict`` after 7 batches (a peek pending) equals the JAX
    package's; a fresh loader of either package that loads it hands out
    the same next batches, past the epoch's end; another batching
    refuses the state by name."""
    t, j = _loader(tht, **kw), _loader(jht, **kw)
    for _ in range(7):
        _equal(t.get_arr(), j.get_arr())
    _equal(t.get_next_arr(), j.get_next_arr())
    state = t.state_dict()
    assert state == j.state_dict()
    want = [j.get_arr() for _ in range(9)]
    for resumed in (_loader(tht, **kw), _loader(tht, **kw)):
        resumed.load_state(state)
        for w in want:
            _equal(resumed.get_arr(), w)
    other = tht.Dataloader(np.zeros((23, 3), np.float32), 5, "train")
    with pytest.raises(ValueError, match="batch_size"):
        other.load_state(state)


def _mlp_graph(ht, tx, ty, vx, vy):
    x = ht.dataloader_op([ht.Dataloader(tx, 16, "train", shuffle=True),
                          ht.Dataloader(vx, 16, "validate")])
    y = ht.dataloader_op([ht.Dataloader(ty, 16, "train", shuffle=True),
                          ht.Dataloader(vy, 16, "validate")])
    models = tht.models if ht is tht else jax_cnn_models()
    loss, pred = models.mlp(x, y)
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    kw = {"device": "cpu"} if ht is tht else {"validate": "off"}
    return x, y, ht.Executor({"train": [loss, pred, y, train],
                              "validate": [loss, pred, y]}, seed=0, **kw)


def test_dataloader_fed_mlp_trains_as_the_jax_package(no_data_dir):
    """``examples/cnn/main.py``'s loop at a small size: the MLP on the
    synthetic MNIST, fed by ``dataloader_op`` (a shuffled train split, a
    validate split), ``run("train")`` and ``run("validate")`` with no feed
    dict, from the JAX package's weights: 6 SGD steps' losses and labels
    and a validate pass match the JAX package's at rtol 1e-5, and
    ``get_batch_num`` is its."""
    (tx, ty), (vx, vy), _ = tds.mnist()
    tx, ty, vx, vy = tx[:96], ty[:96], vx[:32], vy[:32]
    _, _, jex = _mlp_graph(jht, tx, ty, vx, vy)
    x, y, tex = _mlp_graph(tht, tx, ty, vx, vy)
    tex.load_dict(jex.return_tensor_values())
    assert tex.get_batch_num("train") == jex.get_batch_num("train") == 6
    assert tex.get_batch_num("validate") == jex.get_batch_num("validate")
    tl, jl = [], []
    for _ in range(6):
        tout, jout = tex.run("train"), jex.run("train")
        _equal(tout[2].asnumpy(), np.asarray(jout[2].asnumpy()))
        tl.append(float(tout[0].asnumpy()))
        jl.append(float(np.asarray(jout[0].asnumpy())))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tv, jv = tex.run("validate"), jex.run("validate")
    np.testing.assert_allclose(tv[1].asnumpy(), np.asarray(jv[1].asnumpy()),
                               rtol=1e-5, atol=1e-6)
    # a feed dict entry takes the place of the loader's batch
    out = tex.run("validate", feed_dict={x: vx[:16], y: vy[:16]})
    _equal(out[2].asnumpy(), vy[:16])


def test_get_batch_num_is_none_without_a_dataloader():
    x = tht.placeholder_op("x")
    ex = tht.Executor([x * 2.0], device="cpu")
    assert ex.get_batch_num() is None
    with pytest.raises(ValueError, match="missing feed"):
        ex.run()
