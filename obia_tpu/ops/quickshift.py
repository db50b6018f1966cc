"""Quickshift mode-seeking segmentation as an XLA program.

Array-program re-design of the Cython quickshift the reference calls
(``skimage.segmentation.quickshift`` at reference segment_boundaries.py:49):

* Parzen density estimate: ``lax.scan`` over all window offsets, each step a
  fused shift + 5-D distance + exp accumulation over the whole raster (the
  sequential per-pixel window loop becomes raster-wide vector ops).
* Parent link: second scan over the ``max_dist`` window picking, per pixel,
  the nearest (5-D) neighbour with strictly higher density.
* Tree flattening: pointer jumping (``parent = parent[parent]``) inside a
  ``lax.while_loop`` — O(log depth) gathers instead of recursive climbs.

Semantics follow skimage: the image is scaled by ``ratio``; distances are
Euclidean in (scaled colour, y, x); density kernel
``exp(-d^2 / (2 kernel_size^2))`` over a window of radius
``ceil(3 * kernel_size)``; pixels with no higher-density neighbour within
``max_dist`` are modes (roots). A deterministic tiny noise seeded by
``random_seed`` breaks density ties the way skimage's rng does. Labels are
root linear indices compacted in raster order.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("seed", "shape"))
def _tie_noise(seed: int, shape) -> jnp.ndarray:
    key = jax.random.PRNGKey(seed)
    return jax.random.normal(key, shape, jnp.float32) * 1e-5


def _offsets(radius: int) -> np.ndarray:
    offs = [(dy, dx)
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if not (dy == 0 and dx == 0)]
    return np.asarray(offs, np.int32)


@functools.partial(jax.jit, static_argnames=("kernel_size", "max_dist",
                                             "ratio", "radius_d", "radius_p"))
def _quickshift_core(img: jnp.ndarray, noise: jnp.ndarray,
                     kernel_size: float, max_dist: float, ratio: float,
                     radius_d: int, radius_p: int):
    H, W, C = img.shape
    scaled = img * ratio
    inv2k2 = 1.0 / (2.0 * kernel_size * kernel_size)

    pad_d = radius_d
    padded_d = jnp.pad(scaled, ((pad_d, pad_d), (pad_d, pad_d), (0, 0)),
                       constant_values=jnp.inf)

    def _chunked(offs: np.ndarray, chunk: int) -> jnp.ndarray:
        """Pad the offset list to a multiple of ``chunk`` with (0, 0)
        self-offsets (their contributions are masked/neutral) and reshape
        to (n_chunks, chunk, 2) — scan over chunks, vmap within: scan-step
        dispatch overhead dominates 1000+ single-offset steps."""
        pad = (-len(offs)) % chunk
        offs = np.concatenate([offs, np.zeros((pad, 2), np.int32)])
        return jnp.asarray(offs.reshape(-1, chunk, 2))

    CHUNK = 32
    offs_d = _chunked(_offsets(radius_d), CHUNK)

    def density_contrib(off):
        dy, dx = off[0], off[1]
        shifted = jax.lax.dynamic_slice(
            padded_d, (pad_d + dy, pad_d + dx, 0), (H, W, C))
        d2 = jnp.sum((scaled - shifted) ** 2, axis=-1) \
            + (dy * dy + dx * dx).astype(jnp.float32)
        is_self = (dy == 0) & (dx == 0)  # padding self-offsets contribute 0
        contrib = jnp.where(jnp.isfinite(d2) & ~is_self,
                            jnp.exp(-d2 * inv2k2), 0.0)
        return contrib

    def density_step(acc, off_chunk):
        return acc + jax.vmap(density_contrib)(off_chunk).sum(0), None

    density, _ = jax.lax.scan(density_step, jnp.ones((H, W), jnp.float32),
                              offs_d)
    density = density + noise  # deterministic tie-break

    # --- parent search over the max_dist window ------------------------------
    pad_p = radius_p
    padded_p = jnp.pad(scaled, ((pad_p, pad_p), (pad_p, pad_p), (0, 0)),
                       constant_values=jnp.inf)
    padded_rho = jnp.pad(density, ((pad_p, pad_p), (pad_p, pad_p)),
                         constant_values=-jnp.inf)
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    padded_idx = jnp.pad(idx, ((pad_p, pad_p), (pad_p, pad_p)),
                         constant_values=-1)

    offs_p = _chunked(_offsets(radius_p), CHUNK)
    max_d2 = jnp.float32(max_dist * max_dist)

    def parent_candidate(off):
        dy, dx = off[0], off[1]
        nb = jax.lax.dynamic_slice(
            padded_p, (pad_p + dy, pad_p + dx, 0), (H, W, C))
        nb_rho = jax.lax.dynamic_slice(
            padded_rho, (pad_p + dy, pad_p + dx), (H, W))
        nb_idx = jax.lax.dynamic_slice(
            padded_idx, (pad_p + dy, pad_p + dx), (H, W))
        d2 = jnp.sum((scaled - nb) ** 2, axis=-1) \
            + (dy * dy + dx * dx).astype(jnp.float32)
        is_self = (dy == 0) & (dx == 0)
        ok = (nb_rho > density) & (d2 <= max_d2) & jnp.isfinite(d2) \
            & ~is_self
        return jnp.where(ok, d2, jnp.inf), jnp.where(ok, nb_idx, -1)

    def parent_step(carry, off_chunk):
        best_d2, best_parent = carry
        d2s, idxs = jax.vmap(parent_candidate)(off_chunk)  # (CHUNK, H, W)
        k = jnp.argmin(d2s, axis=0)
        d2c = jnp.take_along_axis(d2s, k[None], axis=0)[0]
        idc = jnp.take_along_axis(idxs, k[None], axis=0)[0]
        better = d2c < best_d2
        best_d2 = jnp.where(better, d2c, best_d2)
        best_parent = jnp.where(better, idc, best_parent)
        return (best_d2, best_parent), None

    init = (jnp.full((H, W), jnp.inf, jnp.float32), idx)
    (best_d2, parent), _ = jax.lax.scan(parent_step, init, offs_p)

    # --- flatten tree via pointer jumping -----------------------------------
    parent_flat = parent.reshape(-1)
    n_iter = max(1, int(math.ceil(math.log2(max(H * W, 2)))) + 1)

    def jump_body(_, p):
        return p[p]

    root = jax.lax.fori_loop(0, n_iter, jump_body, parent_flat)
    return root.reshape(H, W), density, parent, jnp.sqrt(best_d2)


def quickshift(image,
               ratio: float = 1.0,
               kernel_size: float = 5.0,
               max_dist: float = 10.0,
               sigma: float = 0.0,
               convert2lab: bool = True,
               rng=42,
               random_seed=None,
               return_tree: bool = False,
               channel_axis: int = -1) -> np.ndarray:
    """skimage-compatible entry point. Returns (H, W) int labels, compacted
    in raster order from 0 (first-occurrence order, like the CCL relabel)."""
    arr = np.asarray(image)
    if arr.dtype.kind in "ui":
        # skimage runs img_as_float first: integer images scale to [0, 1].
        # Feeding raw 0-255 values to rgb_to_lab (which clips to [0, 1])
        # would flatten the image to near-constant white
        img = jnp.asarray(arr, jnp.float32) / float(np.iinfo(arr.dtype).max)
    else:
        img = jnp.asarray(arr, jnp.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if channel_axis not in (-1, 2):
        img = jnp.moveaxis(img, channel_axis, -1)
    # skimage quickshift converts 3-channel input to CIELAB by default
    if convert2lab and img.shape[-1] == 3:
        from .color import rgb_to_lab
        img = rgb_to_lab(img)
    if sigma and sigma > 0:
        from .slic import _gaussian_blur
        img = _gaussian_blur(img, float(sigma))
    H, W, _ = img.shape

    seed = random_seed if random_seed is not None else (
        rng if isinstance(rng, (int, np.integer)) else 42)
    noise = _tie_noise(int(seed), (H, W))

    radius_d = max(1, int(math.ceil(3.0 * kernel_size)))
    # skimage searches for higher-density parents inside the SAME
    # ceil(3*kernel_size) window and only then cuts links longer than
    # max_dist — a max_dist-sized window would link pixels skimage
    # leaves as roots whenever max_dist > 3*kernel_size
    radius_p = radius_d
    root, _, parent, dist = _quickshift_core(
        img, noise, float(kernel_size), float(max_dist), float(ratio),
        radius_d, radius_p)
    root_np = np.asarray(root)
    uniq, first_idx, inv = np.unique(root_np.reshape(-1), return_index=True,
                                     return_inverse=True)
    # raster-order (first-occurrence) compaction, as documented — sorted
    # root indices are NOT first-occurrence order (a segment's first
    # member pixel can precede another segment's root)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(uniq))
    labels = rank[inv].reshape(H, W)
    if return_tree:
        # skimage semantics: also return the segmentation hierarchy —
        # per-pixel parent (linear index of the nearest higher-density
        # pixel within max_dist; roots point to themselves) and the
        # feature-space distance to it (inf at roots)
        return labels, np.asarray(parent).astype(np.int64), np.asarray(dist)
    return labels
