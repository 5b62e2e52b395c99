"""Dataset loaders (twin of ``hetu_tpu/data/datasets.py``: MNIST,
CIFAR-10/100).

Looks for on-disk datasets under ``$HETU_DATA_DIR`` (``mnist.npz``,
``cifar<N>/*.npy``); when absent, generates the JAX package's
deterministic synthetic set, the same arrays bit for bit (seeded numpy),
with the real shapes and dtypes.  ``ImageNetFolder`` / ``imagenet`` are
not ported.
"""
from __future__ import annotations

import os

import numpy as np


def _data_dir():
    """Resolved per call so tests can point ``HETU_DATA_DIR`` at a tmp dir
    after import."""
    return os.environ.get("HETU_DATA_DIR",
                          os.path.expanduser("~/.hetu/data"))


def _synthetic(n, shape, num_class, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *shape).astype(np.float32)
    labels = rng.randint(0, num_class, size=n)
    y = np.zeros((n, num_class), np.float32)
    y[np.arange(n), labels] = 1.0
    return x, y


def mnist(onehot=True):
    """[(train_x, train_y), (valid_x, valid_y), (test_x, test_y)]; x
    (N, 784) float32 in [0, 1], y (N, 10) one-hot."""
    path = os.path.join(_data_dir(), "mnist.npz")
    if os.path.exists(path):
        with np.load(path) as d:
            xs = d["x_train"].reshape(-1, 784).astype(np.float32) / 255.0
            ys = np.eye(10, dtype=np.float32)[d["y_train"]]
            xt = d["x_test"].reshape(-1, 784).astype(np.float32) / 255.0
            yt = np.eye(10, dtype=np.float32)[d["y_test"]]
        # 50k train / 10k valid; a smaller set splits 5/6 so the valid
        # split is never empty
        n_tr = min(50000, len(xs) * 5 // 6)
        return [(xs[:n_tr], ys[:n_tr]), (xs[n_tr:], ys[n_tr:]), (xt, yt)]
    tx, ty = _synthetic(8192, (784,), 10, 0)
    vx, vy = _synthetic(1024, (784,), 10, 1)
    sx, sy = _synthetic(1024, (784,), 10, 2)
    return [(tx, ty), (vx, vy), (sx, sy)]


def normalize_cifar(num_class=10):
    """(train_x (N, 3, 32, 32) normalized per channel, train_y one-hot,
    test_x, test_y)."""
    path = os.path.join(_data_dir(), f"cifar{num_class}")
    if os.path.isdir(path):
        tx = np.load(os.path.join(path, "train_x.npy"))
        ty = np.load(os.path.join(path, "train_y.npy"))
        vx = np.load(os.path.join(path, "test_x.npy"))
        vy = np.load(os.path.join(path, "test_y.npy"))
        mean = tx.mean(axis=(0, 2, 3), keepdims=True)
        std = tx.std(axis=(0, 2, 3), keepdims=True)
        tx = (tx - mean) / std
        vx = (vx - mean) / std
        if ty.ndim == 1:
            ty = np.eye(num_class, dtype=np.float32)[ty]
            vy = np.eye(num_class, dtype=np.float32)[vy]
        return tx.astype(np.float32), ty, vx.astype(np.float32), vy
    tx, ty = _synthetic(8192, (3, 32, 32), num_class, 0)
    vx, vy = _synthetic(1024, (3, 32, 32), num_class, 1)
    return tx, ty, vx, vy


def cifar10():
    return normalize_cifar(10)


def cifar100():
    return normalize_cifar(100)


def convert_to_one_hot(vals, max_val=0):
    """Label array → one-hot float32 (``max_val`` 0: the largest label
    plus one)."""
    vals = np.asarray(vals).astype(np.int64).reshape(-1)
    if max_val == 0:
        max_val = int(vals.max()) + 1
    out = np.zeros((vals.size, max_val), np.float32)
    out[np.arange(vals.size), vals] = 1.0
    return out
