"""Raster filters as XLA programs (conv / reduce_window).

Device replacements for the scipy.ndimage / skimage.rank kernels the
reference leans on (SURVEY.md §2b): gaussian_filter (seeds.py:17-33),
maximum_filter (seeds.py:20), uniform_filter (image.py:106-107), sobel
(cost.py:30-31), windowed-histogram entropy (cost.py:39-41, skimage
``rank.entropy`` with a disk footprint).

Boundary handling matches each caller's scipy mode: ``reflect``
(scipy's default, = np.pad 'symmetric') or ``nearest`` (= np.pad 'edge').
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PAD_MODE = {"reflect": "symmetric", "nearest": "edge", "mirror": "reflect",
             "constant": "constant"}


def _pad2d(x: jnp.ndarray, ry: int, rx: int, mode: str) -> jnp.ndarray:
    return jnp.pad(x, ((ry, ry), (rx, rx)), mode=_PAD_MODE[mode])


def _conv2d_single(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """VALID 2-D correlation of a (H, W) image with a (kh, kw) kernel."""
    return jax.lax.conv_general_dilated(
        x[None, None, :, :], kernel[None, None, :, :],
        window_strides=(1, 1), padding="VALID")[0, 0]


def _gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@functools.partial(jax.jit, static_argnames=("sigma", "mode", "truncate"))
def gaussian_filter(x: jnp.ndarray, sigma: float, mode: str = "reflect",
                    truncate: float = 4.0) -> jnp.ndarray:
    """scipy.ndimage.gaussian_filter for 2-D float input."""
    if sigma < 0:
        raise ValueError(f"sigma must be >= 0, got {sigma}")
    if sigma == 0:
        # identity, but with the SAME float32 output contract as every
        # filtered path — returning the raw integer dtype would make
        # downstream arithmetic wrap for sigma=0 only
        return x.astype(jnp.float32)
    radius = int(truncate * sigma + 0.5)
    k = _gaussian_kernel1d(sigma, radius)
    xp = _pad2d(x.astype(jnp.float32), radius, radius, mode)
    out = _conv2d_single(xp, k[:, None])
    return _conv2d_single(out, k[None, :])


@functools.partial(jax.jit, static_argnames=("size", "mode"))
def maximum_filter(x: jnp.ndarray, size: int, mode: str = "reflect"
                   ) -> jnp.ndarray:
    """scipy.ndimage.maximum_filter (square window)."""
    r = size // 2
    r2 = size - 1 - r
    xp = jnp.pad(x, ((r, r2), (r, r2)), mode=_PAD_MODE[mode])
    return jax.lax.reduce_window(
        xp, -jnp.inf, jax.lax.max, (size, size), (1, 1), "VALID")


@functools.partial(jax.jit, static_argnames=("size", "mode"))
def uniform_filter(x: jnp.ndarray, size: int, mode: str = "reflect"
                   ) -> jnp.ndarray:
    """scipy.ndimage.uniform_filter (square window mean)."""
    r = size // 2
    r2 = size - 1 - r
    xp = jnp.pad(x.astype(jnp.float32), ((r, r2), (r, r2)),
                 mode=_PAD_MODE[mode])
    s = jax.lax.reduce_window(
        xp, 0.0, jax.lax.add, (size, size), (1, 1), "VALID")
    return s / (size * size)


@functools.partial(jax.jit, static_argnames=("axis", "mode"))
def sobel(x: jnp.ndarray, axis: int = -1, mode: str = "reflect"
          ) -> jnp.ndarray:
    """scipy.ndimage.sobel: derivative [-1,0,1] along ``axis``, smoothing
    [1,2,1] along the other."""
    deriv = jnp.asarray([-1.0, 0.0, 1.0], jnp.float32)
    smooth = jnp.asarray([1.0, 2.0, 1.0], jnp.float32)
    axis = axis % 2
    xp = _pad2d(x.astype(jnp.float32), 1, 1, mode)
    # XLA conv_general_dilated is cross-correlation (no kernel flip), which
    # matches scipy.ndimage.correlate1d directly
    if axis == 0:
        out = _conv2d_single(xp, deriv[:, None])
        return _conv2d_single(out, smooth[None, :])
    out = _conv2d_single(xp, deriv[None, :])
    return _conv2d_single(out, smooth[:, None])


def disk_footprint(radius: int) -> np.ndarray:
    """skimage.morphology.disk."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("n_levels",))
def _entropy_impl(q: jnp.ndarray, footprint: jnp.ndarray, n_levels: int):
    H, W = q.shape
    kh, kw = footprint.shape
    ry, rx = kh // 2, kw // 2
    qp = jnp.pad(q, ((ry, ry), (rx, rx)), mode="symmetric")
    total = footprint.sum()

    def level_step(acc, level):
        mask = (qp == level).astype(jnp.float32)
        cnt = _conv2d_single(mask, footprint)
        p = cnt / total
        term = jnp.where(p > 0, -p * jnp.log2(p), 0.0)
        return acc + term, None

    out, _ = jax.lax.scan(level_step, jnp.zeros((H, W), jnp.float32),
                          jnp.arange(n_levels))
    return out


def local_entropy(image_u8: jnp.ndarray, footprint: np.ndarray,
                  n_levels: int = 256) -> jnp.ndarray:
    """skimage.filters.rank.entropy: Shannon entropy (bits) of the local
    histogram under ``footprint``. Input is uint8-valued."""
    q = jnp.asarray(image_u8, jnp.int32)
    return _entropy_impl(q, jnp.asarray(footprint, jnp.float32), n_levels)


@functools.partial(jax.jit, static_argnames=("mode",))
def laplacian_3x3(x: jnp.ndarray, mode: str = "reflect") -> jnp.ndarray:
    """OpenCV ``cv2.Laplacian(ksize=3)`` kernel [[2,0,2],[0,-8,0],[2,0,2]]
    (the aperture cv2 builds from second-derivative Sobels) — the XLA
    twin of the host sharpness path in :mod:`obia_tpu.utils.image`
    ``variance_of_laplacian``; the kernels must match or device and host
    sharpness rasters diverge."""
    k = jnp.asarray([[2, 0, 2], [0, -8, 0], [2, 0, 2]], jnp.float32)
    xp = _pad2d(x.astype(jnp.float32), 1, 1, mode)
    return _conv2d_single(xp, k)
