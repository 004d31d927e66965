"""Host-side (cv2) augmentation, a jax-free copy of
``unet_zoo_tpu.data.augment_host``: the reference's cv2 chain run on the
host in a thread pool (cv2 releases the GIL), inside a prefetching loader
that overlaps it with the device's step.

Selected per experiment with ``augment_on="host"`` (default "device", the
warp on the card in ``data/augment.py``). The chain is numpy and cv2 in
both packages, so equal seeds give equal batches. cv2 is imported where
the chain runs, never at import: the card's machine has no cv2, and there
``Trainer`` raises an ``ImportError`` for a host-augmented experiment
instead of warping on the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from unet_zoo_tpu_torch.data.augment import Augment3DOptions, AugmentOptions


def _cv2():
    """cv2, or an ImportError that says what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("augment_on='host' needs OpenCV (cv2), which does not import here; use "
                          "augment_on='device'") from e
    return cv2


def host_augmentation_available() -> bool:
    try:
        _cv2()
    except ImportError:
        return False
    return True


def _rotate(img, angle, interp):
    cv2 = _cv2()
    rows, cols = img.shape[:2]
    m = cv2.getRotationMatrix2D((cols / 2, rows / 2), angle, 1)
    return cv2.warpAffine(img, m, (cols, rows), flags=interp)


def _warp_onehot(lbl, warp_fn, nlabels):
    """Bilinear interpolation of the one-hot encoding, then argmax (the
    reference's rule for up to 4 labels)."""
    oh = np.eye(nlabels, dtype=np.float32)[lbl.astype(np.int64)]
    warped = warp_fn(oh)
    if warped.ndim == 2:  # cv2 squeezes a single channel
        warped = warped[..., None]
    return np.argmax(warped, axis=-1).astype(lbl.dtype)


def _elastic_maps(rng, sigma: float, n_x: int, n_y: int):
    """The remap coordinates of a 3x3 N(0, sigma) displacement grid upsampled bicubically."""
    cv2 = _cv2()
    dx = cv2.resize(rng.normal(0, sigma, (3, 3)).astype(np.float32), (n_x, n_y), interpolation=cv2.INTER_CUBIC)
    dy = cv2.resize(rng.normal(0, sigma, (3, 3)).astype(np.float32), (n_x, n_y), interpolation=cv2.INTER_CUBIC)
    gx, gy = np.meshgrid(np.arange(n_x, dtype=np.float32), np.arange(n_y, dtype=np.float32))
    return gx + dx, gy + dy


def _augment_one(img, lbl, opts: AugmentOptions, seed: int):
    """One (H, W) image and its (H, W) int labels: rotation, the square
    crop rescaled to the image (side in [n - offset, n]), the elastic warp,
    each on one image in ``augment_every_nth``, then the flips."""
    cv2 = _cv2()
    rng = np.random.default_rng(seed)
    img = np.ascontiguousarray(img.astype(np.float32))
    lbl = np.ascontiguousarray(lbl)
    n_y, n_x = img.shape[:2]
    use_onehot = opts.label_interp == "onehot_linear" and opts.nlabels <= 4
    lbl_interp = cv2.INTER_NEAREST

    if rng.integers(0, opts.augment_every_nth) == 0:
        if opts.do_rotations:
            angle = rng.uniform(-opts.rot_degrees, opts.rot_degrees)
            img = _rotate(img, angle, cv2.INTER_LINEAR)
            if use_onehot:
                lbl = _warp_onehot(lbl, lambda oh: _rotate(oh, angle, cv2.INTER_LINEAR), opts.nlabels)
            else:
                lbl = _rotate(lbl, angle, lbl_interp)

        if opts.do_scaleaug:
            r = int(rng.integers(n_y - opts.offset, n_y + 1))
            p_x = int(rng.integers(0, n_x - r + 1))
            p_y = int(rng.integers(0, n_y - r + 1))
            img = cv2.resize(img[p_y:p_y + r, p_x:p_x + r], (n_x, n_y), interpolation=cv2.INTER_LINEAR)
            lcrop = lbl[p_y:p_y + r, p_x:p_x + r]
            if use_onehot:
                lbl = _warp_onehot(lcrop, lambda oh: cv2.resize(oh, (n_x, n_y), interpolation=cv2.INTER_LINEAR),
                                   opts.nlabels)
            else:
                lbl = cv2.resize(lcrop, (n_x, n_y), interpolation=lbl_interp)

        if opts.do_elasticaug:
            mx, my = _elastic_maps(rng, opts.elastic_sigma, n_x, n_y)
            img = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR)
            if use_onehot:
                lbl = _warp_onehot(lbl, lambda oh: cv2.remap(oh, mx, my, interpolation=cv2.INTER_LINEAR),
                                   opts.nlabels)
            else:
                lbl = cv2.remap(lbl, mx, my, interpolation=lbl_interp)

    p_flip = max(2, opts.augment_every_nth)
    if opts.do_fliplr and rng.integers(0, p_flip) == 0:
        img, lbl = np.fliplr(img), np.fliplr(lbl)
    if opts.do_flipud and rng.integers(0, p_flip) == 0:
        img, lbl = np.flipud(img), np.flipud(lbl)
    return np.ascontiguousarray(img), np.ascontiguousarray(lbl)


def _keep_shape(fn, arr):
    """cv2 squeezes a trailing singleton channel axis; put it back."""
    out = fn(arr)
    if out.ndim < arr.ndim:
        out = out[..., None]
    return out


def _augment_one_3d_host(img, lbl, opts: Augment3DOptions, seed: int):
    """One (D, H, W, C) volume and its (D, H, W, L) soft one-hot labels (or
    (D, H, W) int labels): the reference's slice-wise cv2 chain with one
    draw a volume (rotation with border replicate; scale by a resize of
    each slice and a centre pad with the background or crop; the 3x3
    elastic warp with border reflect; a shift a channel; flips on the three
    axes). One-hot labels warp bilinearly into soft labels, as on the
    device."""
    cv2 = _cv2()
    rng = np.random.default_rng(seed)
    img = np.ascontiguousarray(img, dtype=np.float32).copy()
    squeeze_lbl = lbl.ndim == 3  # int labels without a channel axis
    lblf = (lbl[..., None].astype(np.float32) if squeeze_lbl else np.ascontiguousarray(lbl, dtype=np.float32)).copy()
    depth, n_h, n_w = img.shape[:3]
    default_img = img[0, 0, 0, :].copy()  # the reference's background a channel
    lbl_interp = cv2.INTER_NEAREST if squeeze_lbl else cv2.INTER_LINEAR

    if opts.do_rotate:
        angle = rng.uniform(-opts.rot_degrees, opts.rot_degrees)
        m = cv2.getRotationMatrix2D((n_w / 2, n_h / 2), angle, 1)

        def rot(sl, interp):
            return cv2.warpAffine(sl, m, (n_w, n_h), flags=interp, borderMode=cv2.BORDER_REPLICATE)

        for z in range(depth):
            img[z] = _keep_shape(lambda s: rot(s, cv2.INTER_LINEAR), img[z])
            lblf[z] = _keep_shape(lambda s: rot(s, lbl_interp), lblf[z])

    if opts.do_scale:
        scale = rng.uniform(1.0 / opts.scale_factor, opts.scale_factor)
        m_h, m_w = round(n_h * scale), round(n_w * scale)

        def rescale(sl, interp, background):
            scaled = _keep_shape(lambda s: cv2.resize(s, (m_w, m_h), interpolation=interp), sl)
            if scale < 1:  # centre pad with the background value
                out = np.ones((n_h, n_w, sl.shape[-1]), np.float32) * background
                oy, ox = (n_h - m_h) // 2, (n_w - m_w) // 2
                out[oy:oy + m_h, ox:ox + m_w] = scaled
                return out
            oy, ox = (m_h - n_h) // 2, (m_w - n_w) // 2
            return scaled[oy:oy + n_h, ox:ox + n_w]

        for z in range(depth):
            img[z] = rescale(img[z], cv2.INTER_LINEAR, default_img)
            lblf[z] = rescale(lblf[z], lbl_interp, 0.0)

    if opts.do_elastic:
        mx, my = _elastic_maps(rng, opts.elastic_sigma, n_w, n_h)

        def warp(sl, interp):
            return cv2.remap(sl, mx, my, interpolation=interp, borderMode=cv2.BORDER_REFLECT)

        for z in range(depth):
            img[z] = _keep_shape(lambda s: warp(s, cv2.INTER_LINEAR), img[z])
            lblf[z] = _keep_shape(lambda s: warp(s, lbl_interp), lblf[z])

    if opts.do_intensity_shift:
        img += rng.uniform(-opts.max_intensity_shift, opts.max_intensity_shift, img.shape[-1]).astype(np.float32)

    if opts.do_flip:
        for ax in range(3):
            if rng.random() < 0.5:
                img = np.flip(img, axis=ax)
                lblf = np.flip(lblf, axis=ax)

    out_lbl = lblf[..., 0].astype(lbl.dtype) if squeeze_lbl else lblf
    return np.ascontiguousarray(img), np.ascontiguousarray(out_lbl)


_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=8)
    return _POOL


def _seed_root(rng: Optional[np.random.Generator]) -> int:
    """One draw a batch: image i of the batch takes seed ``root + i``."""
    return int(rng.integers(0, 2 ** 31)) if rng is not None else 0


def augment_batch_host(images: np.ndarray, labels: np.ndarray, opts: AugmentOptions,
                       rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
    """images (B, H, W) or (B, H, W, 1) float, labels (B, H, W) int: the
    2D chain an image on the thread pool."""
    _cv2()
    squeeze = images.ndim == 4
    imgs = images[..., 0] if squeeze else images
    root = _seed_root(rng)
    results = list(_pool().map(lambda i: _augment_one(imgs[i], labels[i], opts, root + i), range(imgs.shape[0])))
    out_i = np.stack([r[0] for r in results])
    out_l = np.stack([r[1] for r in results])
    if squeeze:
        out_i = out_i[..., None]
    return out_i.astype(images.dtype), out_l.astype(labels.dtype)


def augment_batch_host_3d(images: np.ndarray, labels: np.ndarray, opts: Augment3DOptions,
                          rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
    """images (B, D, H, W, C), labels (B, D, H, W, L) one-hot float or (B,
    D, H, W) int: the 3D chain a volume on the thread pool."""
    _cv2()
    root = _seed_root(rng)
    results = list(_pool().map(lambda i: _augment_one_3d_host(images[i], labels[i], opts, root + i),
                               range(images.shape[0])))
    return (np.stack([r[0] for r in results]).astype(images.dtype),
            np.stack([r[1] for r in results]).astype(labels.dtype))


class PrefetchingLoader:
    """Wraps a provider: a background thread keeps ``depth`` augmented
    batches ready (``opts``: ``AugmentOptions`` for the 2D chain,
    ``Augment3DOptions`` for the 3D one, None for none), so the host's
    augmentation overlaps the device's step. An exception in the producer
    (a cv2 failure, a read error) is raised in the consumer's
    ``next_batch``, and the producer stops; ``close`` stops it too."""

    def __init__(self, provider, batch_size: int, opts=None, rng: Optional[np.random.Generator] = None,
                 depth: int = 2):
        self.provider = provider
        self.batch_size = batch_size
        self.opts = opts
        self.rng = rng if rng is not None else np.random.default_rng()
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                x, y = self.provider.next_batch(self.batch_size)
                if isinstance(self.opts, Augment3DOptions):
                    x, y = augment_batch_host_3d(x, y, self.opts, self.rng)
                elif self.opts is not None:
                    x, y = augment_batch_host(x, y, self.opts, self.rng)
                item = ("batch", (x, y))
            except BaseException as exc:  # surfaced to the consumer
                item = ("error", exc)
            while not self._stop.is_set():  # give up as soon as close() is called
                try:
                    self._q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if item[0] == "error":
                return

    def next_batch(self, batch_size: Optional[int] = None):
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"PrefetchingLoader serves batches of {self.batch_size}, asked for {batch_size}")
        while True:
            try:
                kind, payload = self._q.get(timeout=5.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("prefetch producer thread died without a batch")
                continue
            if kind == "error":
                raise payload
            return payload

    def close(self) -> None:
        self._stop.set()
        try:  # drain, so that a producer blocked in put() sees the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
