"""Host-side data transforms (twin of ``hetu_tpu/data/transforms.py``).

Numpy-batch functions composable via :class:`Compose` and passable as the
``func=`` of :class:`hetu_tpu_torch.data.Dataloader` — they run on the
prefetch thread, overlapping device compute.  Seeded numpy, so a
transform gives the JAX package's batch bit for bit.
"""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, batch):
        for t in self.transforms:
            batch = t(batch)
        return batch


class Normalize:
    """(x - mean) / std per channel (NCHW or flat)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, batch):
        if batch.ndim == 4:  # NCHW
            m = self.mean.reshape(1, -1, 1, 1)
            s = self.std.reshape(1, -1, 1, 1)
        else:
            m, s = self.mean, self.std
        return (batch - m) / s


class RandomHorizontalFlip:
    def __init__(self, p=0.5, seed=0):
        self.p = p
        self._rng = np.random.RandomState(seed)

    def __call__(self, batch):
        flip = self._rng.rand(len(batch)) < self.p
        out = batch.copy()
        out[flip] = out[flip, ..., ::-1]
        return out


class RandomCrop:
    """Pad-and-crop augmentation (NCHW)."""

    def __init__(self, size, padding=4, seed=0):
        self.size = size
        self.padding = padding
        self._rng = np.random.RandomState(seed)

    def __call__(self, batch):
        n, c, h, w = batch.shape
        p = self.padding
        padded = np.pad(batch, ((0, 0), (0, 0), (p, p), (p, p)))
        out = np.empty((n, c, self.size, self.size), batch.dtype)
        ys = self._rng.randint(0, h + 2 * p - self.size + 1, n)
        xs = self._rng.randint(0, w + 2 * p - self.size + 1, n)
        for i in range(n):
            out[i] = padded[i, :, ys[i]:ys[i] + self.size,
                            xs[i]:xs[i] + self.size]
        return out


class Cutout:
    def __init__(self, length=8, seed=0):
        self.length = length
        self._rng = np.random.RandomState(seed)

    def __call__(self, batch):
        n, _, h, w = batch.shape
        out = batch.copy()
        ys = self._rng.randint(0, h, n)
        xs = self._rng.randint(0, w, n)
        half = self.length // 2
        for i in range(n):
            y0, y1 = max(0, ys[i] - half), min(h, ys[i] + half)
            x0, x1 = max(0, xs[i] - half), min(w, xs[i] + half)
            out[i, :, y0:y1, x0:x1] = 0.0
        return out


__all__ = ["Compose", "Normalize", "RandomHorizontalFlip", "RandomCrop",
           "Cutout", "Resize", "CenterCrop"]


class Resize:
    """Resize an NCHW batch to ``size`` (int or (H, W)) — reference
    ``transforms.py:13`` (PIL bilinear), vectorised numpy (no per-image
    PIL round-trip).  PIL area-weights over the full source footprint on
    downscale (antialias); a plain 2-tap bilinear would alias past 2×
    reduction, so heavier downscales box-prefilter by 2× halvings (the
    mipmap construction) until within bilinear range."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    @staticmethod
    def _halve(batch, axis):
        n = batch.shape[axis]
        if n % 2:   # drop the trailing odd row/col (size-preserving
            batch = np.take(batch, range(n - 1), axis=axis)  # enough here)
        sl0 = [slice(None)] * batch.ndim
        sl1 = [slice(None)] * batch.ndim
        sl0[axis] = slice(0, None, 2)
        sl1[axis] = slice(1, None, 2)
        return (batch[tuple(sl0)].astype(np.float32)
                + batch[tuple(sl1)]) * 0.5

    def __call__(self, batch):
        oh, ow = self.size
        if (oh, ow) == batch.shape[2:]:
            return np.array(batch, copy=True)   # uniform fresh-array
        dt = batch.dtype                        # contract (see CenterCrop)
        work = batch
        while work.shape[2] >= 2 * oh and work.shape[2] >= 4:
            work = self._halve(work, 2)
        while work.shape[3] >= 2 * ow and work.shape[3] >= 4:
            work = self._halve(work, 3)
        n, c, h, w = work.shape
        ys = (np.arange(oh) + 0.5) * h / oh - 0.5
        xs = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
        wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
        rows0 = work[:, :, y0]       # hoisted: one gather per source row
        rows1 = work[:, :, y1]
        top = rows0[..., x0] * (1 - wx) + rows0[..., x1] * wx
        bot = rows1[..., x0] * (1 - wx) + rows1[..., x1] * wx
        out = top * (1 - wy[:, None]) + bot * wy[:, None]
        if np.issubdtype(dt, np.integer):
            out = np.rint(out)       # PIL rounds; truncation would darken
        return out.astype(dt)


class CenterCrop:
    """Center-crop an NCHW batch to ``size`` (reference
    ``transforms.py:22``); pads with zeros when the target exceeds the
    input, matching the reference's behavior for small images."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, batch):
        n, c, h, w = batch.shape
        th, tw = self.size
        if th > h or tw > w:
            out = np.zeros((n, c, max(th, h), max(tw, w)), batch.dtype)
            out[:, :, (out.shape[2] - h) // 2:(out.shape[2] - h) // 2 + h,
                (out.shape[3] - w) // 2:(out.shape[3] - w) // 2 + w] = batch
            batch = out
            n, c, h, w = batch.shape
        i = (h - th) // 2
        j = (w - tw) // 2
        # fresh contiguous array, not a view: transforms run on the
        # dataloader prefetch thread and a view would alias the cached
        # dataset (and pin the uncropped parent buffer)
        return np.ascontiguousarray(batch[:, :, i:i + th, j:j + tw])
