"""Colorspace conversion: sRGB → CIELAB on device.

skimage's slic/quickshift convert 3-channel inputs to Lab by default
(``convert2lab``), which the reference inherits for RGB scenes
(segment_boundaries.py:48-53). Standard sRGB (D65) pipeline:
linearise → XYZ → Lab.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# sRGB -> XYZ (D65) matrix
_M = ((0.412453, 0.357580, 0.180423),
      (0.212671, 0.715160, 0.072169),
      (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


@jax.jit
def rgb_to_lab(rgb: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) sRGB in [0, 1] → (..., 3) CIELAB (L in [0, 100])."""
    rgb = jnp.clip(rgb, 0.0, 1.0)
    linear = jnp.where(rgb > 0.04045,
                       ((rgb + 0.055) / 1.055) ** 2.4,
                       rgb / 12.92)
    # per-channel weighted sums, not a matmul: a float32 matmul may run
    # in TF32 at the default precision, which moves Lab values by ~1e-3
    # and with them SLIC's assignments
    r, g, b = linear[..., 0], linear[..., 1], linear[..., 2]
    xyz_n = jnp.stack([(m[0] * r + m[1] * g + m[2] * b) / wp
                       for m, wp in zip(_M, _WHITE)], axis=-1)
    eps = 0.008856
    kappa = 903.3
    f = jnp.where(xyz_n > eps, jnp.cbrt(xyz_n),
                  (kappa * xyz_n + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return jnp.stack([L, a, b], axis=-1)
