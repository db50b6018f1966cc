"""Halo exchange over the device mesh (``lax.ppermute`` boundary strips).

SURVEY.md §5: the device-mesh answer to the reference's overlap-buffer
re-reads (tiling.py:155-287) is exchanging boundary strips between mesh
neighbours. SLIC assignment itself needs no halo (centers are
replicated), but neighbourhood-coupled kernels do — the sharded GLCM
exchanges ``distance``-deep halos so cross-seam pixel pairs are counted
exactly (:func:`obia_tpu.parallel.sharded.sharded_glcm_props` /
``_halo2d``). The single-strip ring-exchange helpers here are the
building blocks.

All functions are shard_map bodies or helpers intended to run inside one.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def exchange_halo_rows(x: jnp.ndarray, axis_name: str) -> Tuple[jnp.ndarray,
                                                                jnp.ndarray]:
    """Inside shard_map: send the first/last row strip to the previous/next
    shard along ``axis_name`` (ring ppermute). Returns
    (row_from_prev, row_from_next), each shaped (1, W...). Edge shards
    receive the wrapped-around strip; callers mask it with the axis index.
    """
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_prev = jax.lax.ppermute(x[-1:, ...], axis_name, fwd)
    from_next = jax.lax.ppermute(x[:1, ...], axis_name, bwd)
    return from_prev, from_next


def exchange_halo_cols(x: jnp.ndarray, axis_name: str):
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_prev = jax.lax.ppermute(x[:, -1:, ...], axis_name, fwd)
    from_next = jax.lax.ppermute(x[:, :1, ...], axis_name, bwd)
    return from_prev, from_next
