"""Sharded (multi-chip) segmentation + statistics over a device mesh.

The reference has no distributed layer at all (SURVEY.md §2c) — its only
scale-out is the sequential checkerboard tile loop (reference
tiling.py:62-291). This module is the device-mesh replacement: the raster
shards 2-D over a ``jax.sharding.Mesh`` ("ty", "tx") and EVERY device
stage of the production pipeline runs sharded:

* k-means: centers replicated (tiny), per-shard assignment + partial
  sums, ``psum`` across devices (:func:`sharded_slic_assign`). Assignment needs
  NO halo exchange (a pixel's candidate centers depend only on its own
  global coordinates).
* connectivity: per-shard scan-CCL + per-shard dense relabel, then the
  cross-shard equivalences are reduced from one-pixel boundary strips
  (thin) and a replicated LUT glues the pieces — the raster itself never
  gathers to one device (:func:`sharded_ccl_merge`).
* small-segment merge: per-shard label-adjacency edge lists (+ seam
  edges from the strips), K-sized adoption sweeps on the replicated
  side, LUT applied shard-wise (:func:`sharded_merge_small`).
* per-object statistics: per-shard ``segment_sum`` partial moments +
  ``psum`` / ``pmin`` / ``pmax`` (:func:`sharded_spectral_moments`).
* GLCM texture: 2-px ``ppermute`` halo exchange for cross-seam pixel
  pairs, per-shard pairwise sums + joint-histogram ASM, ``psum``
  (:func:`sharded_glcm_props`).

Label numbering is raster-order first occurrence on the GLOBAL raster, so
sharded labels are bitwise-identical to the single-device path whenever
the raster divides the mesh evenly (verified by test_mosaic).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.slic import (_grid_half, _grid_shape, _grid_step, initial_centers,
                        slic_assign_block, slic_update_sums)

_AXES = ("ty", "tx")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = _AXES) -> Mesh:
    """2-D mesh over the first n devices (most-square factorisation)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    ty = int(math.sqrt(n))
    while n % ty:
        ty -= 1
    tx = n // ty
    return Mesh(np.asarray(devs).reshape(ty, tx), axis_names)


def sharded_slic_assign(mesh: Mesh, image: jnp.ndarray,
                        n_segments: int, compactness: float = 10.0,
                        max_num_iter: int = 10):
    """Run the full SLIC k-means loop sharded over ``mesh``.

    Args:
      image: (H, W, C) float32, H divisible by mesh "ty" size, W by "tx".
    Returns:
      (labels (H, W) int32 in [0, gh*gw), centers (gh, gw, C+2)) with
      labels sharded like the image.
    """
    H, W, C = image.shape
    gh, gw = _grid_shape(H, W, n_segments)
    K = gh * gw
    # same integer grid step/start as the single-device path (skimage
    # regular_grid semantics) so sharded labels are bit-identical to it
    step = _grid_step(H, W, n_segments)
    ratio = (compactness / step) ** 2
    ty, tx = mesh.devices.shape
    h_loc, w_loc = H // ty, W // tx

    centers0 = initial_centers(image, gh, gw, step,
                               _grid_half(H, W, n_segments))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx", None), P(None, None, None)),
        out_specs=(P("ty", "tx"), P(None, None, None)))
    def run(local_img, centers):
        iy = jax.lax.axis_index("ty")
        ix = jax.lax.axis_index("tx")
        row0 = (iy * h_loc).astype(jnp.float32)
        col0 = (ix * w_loc).astype(jnp.float32)
        valid = jnp.ones(local_img.shape[:2], bool)

        def body(_, c):
            lab = slic_assign_block(local_img, valid, c, row0, col0,
                                    gh, gw, H, W, ratio)
            sums, cnts = slic_update_sums(local_img, lab, row0, col0, K)
            sums = jax.lax.psum(sums, _AXES)
            cnts = jax.lax.psum(cnts, _AXES)
            means = sums / jnp.maximum(cnts, 1.0)[:, None]
            means = jnp.where((cnts > 0)[:, None], means,
                              c.reshape(K, -1))
            return means.reshape(gh, gw, -1)

        centers_f = jax.lax.fori_loop(0, max_num_iter, body, centers)
        labels = slic_assign_block(local_img, valid, centers_f, row0, col0,
                                   gh, gw, H, W, ratio)
        return labels, centers_f

    return run(image, centers0)


# ---------------------------------------------------------------------------
# Distributed connectivity: per-shard scan-CCL + strip merge (SURVEY.md §7
# hard part #2 — segments spanning shard boundaries — without ever
# gathering the label raster to one device).
# ---------------------------------------------------------------------------


def _local_ccl_factory(mesh: Mesh, Hp: int, Wp: int, crop_hw: Tuple[int, int],
                       k_max: int):
    ty, tx = mesh.devices.shape
    h_loc, w_loc = Hp // ty, Wp // tx
    H, W = crop_hw
    INF32 = jnp.int32(np.iinfo(np.int32).max)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx"),),
        out_specs=(P("ty", "tx"), P("ty", "tx", None), P("ty", "tx"),
                   P("ty", "tx"), P("ty", "tx"),
                   P("ty", "tx"), P("ty", "tx"),
                   P("ty", "tx"), P("ty", "tx"),
                   P("ty", "tx"), P("ty", "tx")))
    def run(lab_loc):
        from ..ops.connectivity import _dense_relabel_device, _scan_ccl_exact

        iy = jax.lax.axis_index("ty")
        ix = jax.lax.axis_index("tx")
        row0 = iy * h_loc
        col0 = ix * w_loc
        rr = jax.lax.broadcasted_iota(jnp.int32, (h_loc, w_loc), 0) + row0
        cc = jax.lax.broadcasted_iota(jnp.int32, (h_loc, w_loc), 1) + col0
        in_crop = (rr < H) & (cc < W)
        lab = jnp.where(in_crop & (lab_loc >= 0), lab_loc, -1)

        # _scan_ccl_exact: scan-CCL with the on-device FastSV fallback, so
        # a shard whose component out-snakes the alternation cap cannot be
        # silently split (which would duplicate global labels)
        comp = _scan_ccl_exact(lab)
        piece, _ = _dense_relabel_device(comp.reshape(-1))
        piece = piece.reshape(h_loc, w_loc)
        k_loc = piece.max() + 1

        # raster-order key: min GLOBAL linear index per piece (W-based;
        # pad columns are invalid so Wp- and W-order agree on the crop)
        gidx = (rr * W + cc).reshape(-1)
        pflat = piece.reshape(-1)
        min_g = jax.ops.segment_min(
            jnp.where(pflat >= 0, gidx, INF32),
            jnp.where(pflat >= 0, pflat, k_max), num_segments=k_max + 1
        )[:k_max]

        sid = iy * tx + ix
        gid = jnp.where(piece >= 0, piece + sid * k_max, -1)
        return (gid, min_g[None, None, :], k_loc[None, None],
                gid[:1, :], gid[-1:, :], gid[:, :1], gid[:, -1:],
                lab[:1, :], lab[-1:, :], lab[:, :1], lab[:, -1:])

    return run, (ty, tx, h_loc, w_loc)


def _seam_pairs(bot_a, top_b, lab_bot_a, lab_top_b):
    """Equal-cluster pixel pairs across one seam (host, numpy)."""
    same = (lab_bot_a == lab_top_b) & (lab_bot_a >= 0) \
        & (bot_a >= 0) & (top_b >= 0)
    return bot_a[same], top_b[same]


def sharded_ccl_merge(mesh: Mesh, labels: jnp.ndarray,
                      crop_hw: Tuple[int, int],
                      k_max: Optional[int] = None,
                      n_segments: Optional[int] = None
                      ) -> Tuple[jnp.ndarray, int]:
    """Connectivity enforcement of a SHARDED cluster-label raster without
    gathering it: per-shard scan-CCL + local dense relabel, cross-shard
    piece equivalences from one-pixel boundary strips (thin host arrays),
    native union-find over piece ids, then a replicated LUT relabels every
    shard to GLOBAL raster-order first-occurrence dense labels.

    Args:
      labels: (Hp, Wp) int32 sharded P("ty","tx") — SLIC cluster ids.
      crop_hw: the un-padded (H, W); pad pixels get label -1.
      k_max: static per-shard piece-count cap (default sized from
        ``n_segments``; a cap overflow raises and the caller retries).
    Returns:
      ((Hp, Wp) int32 sharded dense labels 0..K-1 / -1 on pads, K).
    """
    Hp, Wp = labels.shape
    ty, tx = mesh.devices.shape
    n_shards = ty * tx
    if k_max is None:
        base = (n_segments or 1024) * 4 // max(n_shards, 1)
        k_max = max(512, base + 512)

    run, (ty, tx, h_loc, w_loc) = _local_ccl_factory(
        mesh, Hp, Wp, crop_hw, k_max)
    (gid, min_g, k_loc, g_top, g_bot, g_lft, g_rgt,
     l_top, l_bot, l_lft, l_rgt) = run(labels)

    k_loc_np = np.asarray(k_loc)  # (ty, tx)
    if int(k_loc_np.max()) > k_max:
        # rare: heavy pre-merge fragmentation; retry with a bigger cap
        return sharded_ccl_merge(mesh, labels, crop_hw,
                                 k_max=int(k_loc_np.max()) * 2)

    # strips arrive as (ty, Wp) / (Hp, tx) global arrays (1-row/col per
    # shard concatenated by the out_specs); host pairing is thin
    g_top, g_bot = np.asarray(g_top), np.asarray(g_bot)
    l_top, l_bot = np.asarray(l_top), np.asarray(l_bot)
    g_lft, g_rgt = np.asarray(g_lft), np.asarray(g_rgt)
    l_lft, l_rgt = np.asarray(l_lft), np.asarray(l_rgt)

    pa_v, pb_v = _seam_pairs(g_bot[:-1], g_top[1:], l_bot[:-1], l_top[1:])
    pa_h, pb_h = _seam_pairs(g_rgt[:, :-1].T, g_lft[:, 1:].T,
                             l_rgt[:, :-1].T, l_lft[:, 1:].T)
    pa = np.concatenate([pa_v.reshape(-1), pa_h.reshape(-1)])
    pb = np.concatenate([pb_v.reshape(-1), pb_h.reshape(-1)])

    n_ids = n_shards * k_max
    from .. import native
    identity = np.arange(n_ids, dtype=np.int64)[None, :]
    roots = native.resolve_components(identity, pa.astype(np.int64),
                                      pb.astype(np.int64))[0]

    # component key = min global first-occurrence index over the class
    INF = np.iinfo(np.int32).max
    min_g_flat = np.asarray(min_g).reshape(n_ids).astype(np.int64)
    keys = np.full(n_ids, INF, np.int64)
    np.minimum.at(keys, roots, min_g_flat)
    used_root = np.zeros(n_ids, bool)
    used_root[roots[min_g_flat < INF]] = True
    order = np.argsort(np.where(used_root, keys, INF), kind="stable")
    rank = np.full(n_ids, -1, np.int32)
    K = int(used_root.sum())
    rank[order[:K]] = np.arange(K, dtype=np.int32)
    final_lut = np.where(used_root[roots], rank[roots], -1).astype(np.int32)

    lut_dev = jnp.asarray(final_lut)
    lab_final = _apply_lut(gid, lut_dev)
    return lab_final, K


@jax.jit
def _apply_lut(gid: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """labels = lut[gid] with -1 passthrough; gid sharded, lut replicated
    (GSPMD partitions the gather trivially)."""
    return jnp.where(gid >= 0, lut[jnp.clip(gid, 0, lut.shape[0] - 1)], -1)


def _merge_edges_factory(mesh: Mesh, K_pad: int):
    """The device stage of :func:`sharded_merge_small`: per-shard sizes
    (psum'd), label-adjacency edge lists, and the four seam strips.
    Exposed as a factory so it can be AOT-compiled on its own
    (tests/test_compile_lower.py)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx"),),
        out_specs=(P(), P(("ty", "tx")), P(("ty", "tx")),
                   P("ty", "tx"), P("ty", "tx"),
                   P("ty", "tx"), P("ty", "tx")))
    def edges_sizes_strips(lab_loc):
        from ..ops.connectivity import _label_edges, _segment_sizes
        sizes = jax.lax.psum(_segment_sizes(lab_loc, K_pad), _AXES)
        ea, eb = _label_edges(lab_loc, K_pad)
        return (sizes, ea, eb,
                lab_loc[:1, :], lab_loc[-1:, :],
                lab_loc[:, :1], lab_loc[:, -1:])

    return edges_sizes_strips


def sharded_merge_small(mesh: Mesh, labels: jnp.ndarray, num_labels: int,
                        min_size: int, max_size: int,
                        max_iters: int = 512) -> Tuple[jnp.ndarray, int]:
    """Small-segment merge over SHARDED dense labels: per-shard
    label-adjacency edge lists + seam edges (all K-sized), the edge-domain
    adoption sweeps on the replicated side, LUT applied shard-wise.
    Mirrors :func:`obia_tpu.ops.connectivity.merge_small_device` exactly
    (duplicate edges across shards are harmless — the sweeps reduce with
    min).

    The dust regime (raw-CCL K past ``_MERGE_TWO_PHASE_MIN_K``, the
    north-star's 5.5 M fragments) routes to the sharded two-phase merge
    instead: the per-shard DEDUP'd edge build here would pay a per-shard
    sort at dust K and hand the replicated sweeps a 4*K_pad*n_shards-row
    buffer — exactly the structure the single-device two-phase path was
    built to avoid."""
    from ..ops.connectivity import (_MERGE_TWO_PHASE_MIN_K,
                                    merge_lut_from_edges)
    from ..ops.stats import pad_num_segments

    K_pad = pad_num_segments(max(num_labels, 1))
    if K_pad > _MERGE_TWO_PHASE_MIN_K:
        return _sharded_merge_small_dust(mesh, labels, num_labels,
                                         min_size, max_size, max_iters)

    edges_sizes_strips = _merge_edges_factory(mesh, K_pad)
    sizes0, ea, eb, s_top, s_bot, s_lft, s_rgt = edges_sizes_strips(labels)

    # seam edges (host, thin): adjacent differing labels across shard cuts
    def cross(a, b):
        a, b = np.asarray(a), np.asarray(b)
        m = (a != b) & (a >= 0) & (b >= 0)
        return np.where(m, a, -1), np.where(m, b, -1)

    sa_v, sb_v = cross(np.asarray(s_bot)[:-1], np.asarray(s_top)[1:])
    sa_h, sb_h = cross(np.asarray(s_rgt)[:, :-1], np.asarray(s_lft)[:, 1:])
    ea_all = jnp.concatenate([ea, jnp.asarray(sa_v.reshape(-1), jnp.int32),
                              jnp.asarray(sa_h.reshape(-1), jnp.int32)])
    eb_all = jnp.concatenate([eb, jnp.asarray(sb_v.reshape(-1), jnp.int32),
                              jnp.asarray(sb_h.reshape(-1), jnp.int32)])

    final_lut, k_dev = merge_lut_from_edges(
        ea_all, eb_all, sizes0, jnp.float32(min_size), jnp.float32(max_size),
        K_pad, max_iters)
    lab = _apply_lut(labels, final_lut)
    return lab, int(jax.device_get(k_dev))


def _shard_boundary_pairs(lab_loc, sentinel):
    """Inside shard_map: enumerate the differing-label 4-adjacency pairs
    this shard OWNS — local pairs plus the cross-seam pairs whose FIRST
    (top/left) pixel it holds, with the partner row/col supplied by a
    1-px bottom/right ``ppermute`` halo. Non-pair slots read ``sentinel``
    so both the count pass and the buffer build share ONE enumeration
    (they previously drifted-prone duplicates; the count sizes the raw
    buckets that prevent scatter-drop edge loss, so a drift would be
    silent data loss). Returns flat (lo, hi) int32 arrays."""
    ty_n = jax.lax.axis_size("ty")
    tx_n = jax.lax.axis_size("tx")
    iy = jax.lax.axis_index("ty")
    ix = jax.lax.axis_index("tx")
    bot = jax.lax.ppermute(lab_loc[:1, :], "ty",
                           [(i + 1, i) for i in range(ty_n - 1)])
    bot = jnp.where(iy == ty_n - 1, -1, bot)
    rgt = jax.lax.ppermute(lab_loc[:, :1], "tx",
                           [(i + 1, i) for i in range(tx_n - 1)])
    rgt = jnp.where(ix == tx_n - 1, -1, rgt)
    lab_v = jnp.concatenate([lab_loc, bot], axis=0)
    lab_h = jnp.concatenate([lab_loc, rgt], axis=1)

    def pairs(a, b):
        a = a.reshape(-1)
        b = b.reshape(-1)
        m = (a != b) & (a >= 0) & (b >= 0)
        return jnp.where(m, a, sentinel), jnp.where(m, b, sentinel)

    h_a, h_b = pairs(lab_h[:, :-1], lab_h[:, 1:])
    v_a, v_b = pairs(lab_v[:-1, :], lab_v[1:, :])
    return jnp.concatenate([h_a, v_a]), jnp.concatenate([h_b, v_b])


def _dust_phase_a_factory(mesh: Mesh, K_pad: int, cap_shard: int, s0: int):
    """The sharded head of the two-phase dust merge, one shard_map
    program: per-shard RAW boundary-pair buffers (local pairs + the seam
    pairs each shard owns via a 1-px bottom/right ppermute halo), ``s0``
    head sweeps whose biased min-scatter runs per shard and ``pmin``s
    across devices (min is associative — bitwise-equal to the single-buffer
    sweep in ops.connectivity._merge_phase_a), then per-shard compaction
    of the edges still able to drive an adoption. Everything raster- or
    edge-buffer-sized divides over the mesh; only the K-sized lut algebra
    is replicated."""
    from ..ops.connectivity import (_segment_sizes, _sweep_apply,
                                    _sweep_biased)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx"), P(), P()),
        out_specs=(P(), P(), P(("ty", "tx")), P(("ty", "tx")),
                   P("ty", "tx"), P()))
    def phase_a(lab_loc, mn, mx):
        sizes0 = jax.lax.psum(_segment_sizes(lab_loc, K_pad), _AXES)
        SENT = jnp.int32(K_pad)

        # each shard owns the pairs whose FIRST (top/left) pixel it holds
        # (same enumeration the count pass used to size cap_shard)
        lo, hi = _shard_boundary_pairs(lab_loc, SENT)
        valid = lo < SENT
        pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
        idxr = jnp.where(valid, pos, cap_shard)
        ea = jnp.full((cap_shard,), -1, jnp.int32).at[idxr].set(
            lo, mode="drop")
        eb = jnp.full((cap_shard,), -1, jnp.int32).at[idxr].set(
            hi, mode="drop")

        lut = jnp.arange(K_pad, dtype=jnp.int32)
        for _ in range(s0):
            sizes = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
            small = (sizes > 0) & (sizes < mn)
            biased = jax.lax.pmin(_sweep_biased(ea, eb, lut, small, K_pad),
                                  _AXES)
            lut, _ = _sweep_apply(biased, lut, sizes, small, mn, mx,
                                  K_pad, True)

        # per-shard compaction to edges still able to enable an adoption
        # (see ops.connectivity._merge_phase_a for the exactness argument)
        ok = ea >= 0
        a = jnp.where(ok, lut[jnp.clip(ea, 0, K_pad - 1)], -1)
        b = jnp.where(ok, lut[jnp.clip(eb, 0, K_pad - 1)], -1)
        sizes_now = jax.ops.segment_sum(sizes0, lut, num_segments=K_pad)
        small = (sizes_now > 0) & (sizes_now < mn)
        ac = jnp.clip(a, 0, K_pad - 1)
        bc = jnp.clip(b, 0, K_pad - 1)
        ext = ok & (a != b) & (small[ac] | small[bc])
        pos = jnp.cumsum(ext.astype(jnp.int32)) - 1
        idx = jnp.where(ext, pos, cap_shard)
        ea2 = jnp.full((cap_shard,), -1, jnp.int32).at[idx].set(
            a, mode="drop")
        eb2 = jnp.full((cap_shard,), -1, jnp.int32).at[idx].set(
            b, mode="drop")
        n_live = (sizes_now > 0).sum().astype(jnp.int32)
        return (lut, sizes0, ea2, eb2,
                (pos[-1] + 1).reshape(1, 1), n_live)

    return phase_a


def _sharded_merge_small_dust(mesh: Mesh, labels: jnp.ndarray,
                              num_labels: int, min_size: int, max_size: int,
                              max_iters: int = 512
                              ) -> Tuple[jnp.ndarray, int]:
    """Sharded two-phase small-segment merge for the dust regime: the
    sharded mirror of ops.connectivity.merge_small_device's big-K path.
    Final labels are bitwise-identical to the single-device two-phase
    merge (test_mosaic): sizes are psums of exact integer counts, the
    global raw edge SET is the disjoint union of per-shard pair sets, and
    every sweep reduction is a min (associative, order-free)."""
    from ..ops.connectivity import (_MERGE_EDGE_BUCKET, _MERGE_HEAD_SWEEPS,
                                    _MERGE_RAW_BUCKET, _merge_final_lut,
                                    _merge_phase_b_lut)
    from ..ops.stats import pad_num_segments

    K_pad = pad_num_segments(max(num_labels, 1))
    ty, tx = mesh.devices.shape
    n_shards = ty * tx
    mn = jnp.float32(min_size)
    mx = jnp.float32(max_size)

    # per-shard boundary-pair counts size the static raw buckets
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("ty", "tx"),),
                       out_specs=P("ty", "tx"))
    def count(lab_loc):
        SENT = jnp.int32(K_pad)
        lo, _ = _shard_boundary_pairs(lab_loc, SENT)
        return (lo < SENT).sum().astype(jnp.int32).reshape(1, 1)

    from .. import telemetry
    with telemetry.stage("merge.count"):
        counts = np.asarray(jax.device_get(count(labels)))
    bucket = max(_MERGE_RAW_BUCKET // n_shards, 1 << 16)
    cap_shard = max(bucket, -(-int(counts.max()) // bucket) * bucket)

    with telemetry.stage("merge.phase_a"):
        phase_a = _dust_phase_a_factory(mesh, K_pad, cap_shard,
                                        _MERGE_HEAD_SWEEPS)
        lut, sizes0, ea2, eb2, n_ext, n_live = phase_a(labels, mn, mx)
        n_ext_np, n_live = jax.device_get((n_ext, n_live))
        n_live = int(n_live)

    eb_bucket = max(_MERGE_EDGE_BUCKET // n_shards, 1 << 14)
    E2_shard = min(cap_shard,
                   max(eb_bucket,
                       -(-int(n_ext_np.max()) // eb_bucket) * eb_bucket))
    K2_pad = min(K_pad, pad_num_segments(max(n_live, 1)))

    @functools.partial(jax.jit, static_argnames=("E2_shard", "K2_pad"))
    def phase_b(labels, lut, sizes0, ea2, eb2, E2_shard: int, K2_pad: int):
        # take each shard's live prefix; -1 pad slots are inert in the
        # min-reduction sweeps, so the concatenation needs no exact sizes
        ea_c = ea2.reshape(n_shards, cap_shard)[:, :E2_shard].reshape(-1)
        eb_c = eb2.reshape(n_shards, cap_shard)[:, :E2_shard].reshape(-1)
        lut_full = _merge_phase_b_lut(lut, sizes0, ea_c, eb_c, mn, mx,
                                      K_pad, K2_pad,
                                      n_shards * E2_shard, max_iters)
        final_lut, k_dev = _merge_final_lut(lut_full, sizes0, K_pad)
        return _apply_lut(labels, final_lut), k_dev

    with telemetry.stage("merge.phase_b"):
        lab, k_dev = phase_b(labels, lut, sizes0, ea2, eb2,
                             E2_shard, K2_pad)
        k = int(jax.device_get(k_dev))
    return lab, k


# ---------------------------------------------------------------------------
# Sharded per-object statistics (SURVEY.md §5: "global per-object moment
# accumulation" — per-shard segment_sum partials + psum/pmin/pmax).
# ---------------------------------------------------------------------------


def sharded_spectral_moments(mesh: Mesh, image: jnp.ndarray,
                             labels: jnp.ndarray, num_segments: int,
                             packed: bool = False):
    """Full spectral stat set (count/mean/variance/min/max/skewness/
    kurtosis, each (K, C)) with the raster sharded over the mesh. Uses the
    same two-pass centred-moment formulation as the single-device program
    (:mod:`obia_tpu.ops.stats`), with a psum between the passes.

    With ``packed=True`` returns ``(names, (n_stats, K, C) device
    array)`` — ONE value to download — instead of the per-stat dict."""
    from ..ops.stats import (_moment_minmax, _moment_pass1, _moment_pass2,
                             _moments_finalize)

    H, W, C = image.shape
    K = num_segments

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx", None), P("ty", "tx")),
        out_specs=P())
    def run(img_loc, lab_loc):
        chans = [img_loc[..., c].reshape(-1) for c in range(C)]
        lab = lab_loc.reshape(-1)
        ok = lab >= 0
        lab_safe = jnp.where(ok, lab, K)
        okf = ok.astype(img_loc.dtype)

        s1c = jax.lax.psum(_moment_pass1(chans, lab_safe, okf, K), _AXES)
        cnt1 = s1c[:, 0]
        s1 = s1c[:, 1:]
        mean = s1 / jnp.maximum(cnt1[:, None], 1.0)
        lab_c = jnp.clip(lab, 0, K - 1)
        p2 = jax.lax.psum(
            _moment_pass2(chans, mean, lab_c, okf, lab_safe, K), _AXES)
        xmin, xmax = _moment_minmax(chans, ok, lab_safe, K, img_loc.dtype)
        xmin = jax.lax.pmin(xmin, _AXES)
        xmax = jax.lax.pmax(xmax, _AXES)
        out = _moments_finalize(cnt1, s1, p2, xmin, xmax, C, img_loc.dtype)
        names = sorted(out)
        return jnp.stack([out[n] for n in names])

    names = sorted(["count", "mean", "variance", "min", "max",
                    "skewness", "kurtosis"])
    out = run(image, labels)
    if packed:
        return names, out  # (n_stats, K, C) — one download
    return dict(zip(names, out))


def _halo2d(arr: jnp.ndarray, d: int, fill):
    """Inside shard_map: extend a local 2-D block by ``d`` pixels of halo
    from the 4 mesh neighbours (corners included via the two-stage
    row-then-column exchange). Mesh-edge halos get ``fill``."""
    ty_n = jax.lax.axis_size("ty")
    tx_n = jax.lax.axis_size("tx")
    iy = jax.lax.axis_index("ty")
    ix = jax.lax.axis_index("tx")

    def perm_fwd(n):
        return [(i, i + 1) for i in range(n - 1)]

    def perm_bwd(n):
        return [(i + 1, i) for i in range(n - 1)]

    top = jax.lax.ppermute(arr[-d:, :], "ty", perm_fwd(ty_n))
    bot = jax.lax.ppermute(arr[:d, :], "ty", perm_bwd(ty_n))
    top = jnp.where(iy == 0, fill, top)
    bot = jnp.where(iy == ty_n - 1, fill, bot)
    ext = jnp.concatenate([top, arr, bot], axis=0)
    lft = jax.lax.ppermute(ext[:, -d:], "tx", perm_fwd(tx_n))
    rgt = jax.lax.ppermute(ext[:, :d], "tx", perm_bwd(tx_n))
    lft = jnp.where(ix == 0, fill, lft)
    rgt = jnp.where(ix == tx_n - 1, fill, rgt)
    return jnp.concatenate([lft, ext, rgt], axis=1)


def _count_multi_factory(mesh: Mesh, K: int):
    """Pre-pass: count + mask the SHARD-SPANNING objects (present on >1
    shard). K-sized collective only; one N-row segment_sum per shard.
    Sizes the hybrid-ASM compact histogram EXACTLY before the main GLCM
    program launches, so (a) the main program is AOT-lowerable (no
    mid-trace host sync — the round-4 retry did ``int(device_get(...))``
    inside the traced function, which broke ``jit(...).lower()`` at
    exactly the program whose memory analysis matters most), and (b) a
    dusty scene can never pay a doubled full GLCM execution on a cap
    overflow."""

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("ty", "tx"),), out_specs=(P(), P()))
    def count(lab_loc):
        lab_flat = lab_loc.reshape(-1)
        ok = lab_flat >= 0
        lab_safe = jnp.where(ok, lab_flat, K)
        cnt_loc = jax.ops.segment_sum(ok.astype(jnp.float32), lab_safe,
                                      num_segments=K + 1)[:K]
        n_sh = jax.lax.psum((cnt_loc > 0).astype(jnp.int32), _AXES)
        multi = n_sh > 1
        return multi.sum().astype(jnp.int32), multi

    return count


def count_shard_spanning(mesh: Mesh, labels: jnp.ndarray, num_segments: int):
    """(n_multi, (K,) bool mask) of objects spanning >1 shard (host)."""
    n_multi, multi = _count_multi_factory(mesh, num_segments)(labels)
    n_multi, multi = jax.device_get((n_multi, multi))
    return int(n_multi), np.asarray(multi)


def sharded_glcm_props(mesh: Mesh, image: jnp.ndarray, labels: jnp.ndarray,
                       num_segments: int, levels: int = 256,
                       distance: int = 2,
                       angles: Optional[Sequence[float]] = None,
                       compute_asm: bool = True,
                       bands: Optional[Tuple[int, ...]] = None,
                       packed: bool = False,
                       multi_cap: Optional[int] = None):
    """Per-object GLCM props with the raster sharded over the mesh.

    Quantisation bounds reduce with pmin/pmax; cross-seam pixel pairs come
    from a ``distance``-deep ppermute halo exchange of the band + label
    blocks (each pair is counted by the shard owning its CENTER pixel, so
    counts match the single-device path exactly); the seven pairwise sums
    psum across devices (additive, (K, 7) — tiny).

    Exact symmetric ASM is HYBRID: sum-of-squared-counts is quadratic, so
    per-shard values do not add — but an object whose pixels live on ONE
    shard has its full histogram locally, and its local sumsq is already
    exact. Only shard-SPANNING objects (those crossing mesh seams — a
    ~1-D subset, ranked into a compact id space of ``multi_cap`` slots)
    reduce a psum'd (multi_cap, levels^2) histogram, which cuts the ASM
    collective volume from angles*bands*(K, L^2) by the share of objects
    that span a seam. ``multi_cap`` is sized
    EXACTLY by a cheap pre-pass (:func:`count_shard_spanning`) when not
    given; pass it explicitly to make this function fully AOT-lowerable
    (tests/test_compile_lower.py does — an explicit cap smaller than the
    true spanning count would alias histogram rows, so production
    callers should leave it to the pre-pass).

    With ``packed=True`` returns ``(GLCM_PROP_NAMES, (B, 6, K) device
    array)`` — ONE value to download — instead of the per-prop dict
    (whose device transposes cost an eager dispatch each)."""
    from ..ops.glcm import (_ASM_HIST_MAX_ELEMS, DEFAULT_ANGLES,
                            _check_levels, _glcm_props_from_sums,
                            _pair_weight_table, angle_offsets,
                            pair_sum_rows, scale_quantise)

    levels = _check_levels(levels)
    if not jnp.issubdtype(jnp.asarray(image).dtype, jnp.floating):
        image = jnp.asarray(image, jnp.float32)
    angles = tuple(angles) if angles is not None else DEFAULT_ANGLES

    offs = angle_offsets(distance, angles)
    K = num_segments
    L = levels
    band_ids = (tuple(bands) if bands is not None
                else tuple(range(image.shape[2])))
    table = K * L * L
    if compute_asm and table > _ASM_HIST_MAX_ELEMS:
        # the fused int32 key (lab*L^2 + lo*L + hi) overflows and the
        # psum'd (K, L^2) f32 table outgrows device memory past this
        # bound (the bound
        # itself keeps key_max = table <= 2^28 < 2^31). The single-device
        # kernel falls back to its sort path there — exact sorted-run ASM
        # has no sharded reduction (global pair counts are not reducible
        # from per-shard runs), so refuse loudly rather than alias
        # histogram rows silently.
        raise ValueError(
            f"sharded_glcm_props exact-ASM table (K={K}, levels={L}) "
            "exceeds the joint-histogram budget; reduce `levels`, drop "
            "ASM/energy, or use the single-device "
            "ops.glcm.segment_glcm_props sort path")

    if multi_cap is not None:
        MCAP = multi_cap
    else:
        n_multi, _ = count_shard_spanning(mesh, labels, K)
        MCAP = max(64, -(-n_multi // 64) * 64)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx", None), P("ty", "tx")),
        out_specs=P())
    def run(img_loc, lab_loc):
        h, w, _ = img_loc.shape
        d = distance
        lab_ext = _halo2d(lab_loc, d, jnp.int32(-1))
        lab_flat = lab_loc.reshape(-1)
        ok = lab_flat >= 0
        lab_safe = jnp.where(ok, lab_flat, K)
        lab_c = jnp.clip(lab_flat, 0, K - 1)
        W8 = _pair_weight_table(L)
        big = jnp.asarray(jnp.finfo(img_loc.dtype).max, img_loc.dtype)

        # shard-spanning objects (band-independent): compact replicated
        # rank for the hybrid-ASM histogram
        cnt_loc = jax.ops.segment_sum(ok.astype(jnp.float32), lab_safe,
                                      num_segments=K + 1)[:K]
        n_sh = jax.lax.psum((cnt_loc > 0).astype(jnp.int32), _AXES)
        multi = n_sh > 1
        midx = jnp.cumsum(multi.astype(jnp.int32)) - 1
        own_whole = (~multi) & (cnt_loc > 0)
        mrank = jnp.where(multi, jnp.clip(midx, 0, MCAP - 1), MCAP)
        mr_px = mrank[lab_c]
        mtable = MCAP * L * L

        # scan over bands, NOT a traced python loop: with the loop
        # unrolled XLA co-schedules the independent bands' (K, L^2)
        # histogram temporaries, B times one band's memory at the
        # north-star shape; the scan keeps exactly one band's
        # temporaries live, the same fix
        # the single-device kernel took at 100 MP (per-band programs)
        bands_stack = jnp.stack([img_loc[..., b] for b in band_ids])

        def one_band(carry, band):
            flat = band.reshape(-1)
            mn = jax.lax.pmin(jax.ops.segment_min(
                jnp.where(ok, flat, big), lab_safe,
                num_segments=K + 1)[:K], _AXES)
            mx = jax.lax.pmax(jax.ops.segment_max(
                jnp.where(ok, flat, -big), lab_safe,
                num_segments=K + 1)[:K], _AXES)
            rng = mx - mn

            def quantise(vals, labs):
                lc = jnp.clip(labs, 0, K - 1)
                return scale_quantise(vals, mn[lc], rng[lc], L)

            band_ext = _halo2d(band, d, jnp.asarray(0.0, band.dtype))
            q_ext = quantise(band_ext, lab_ext)
            q1 = q_ext[d:d + h, d:d + w].reshape(-1)

            sums_A = []
            asm_A = []
            for (dr, dc) in offs:
                lab2 = jax.lax.dynamic_slice(lab_ext, (d + dr, d + dc),
                                             (h, w)).reshape(-1)
                q2 = jax.lax.dynamic_slice(q_ext, (d + dr, d + dc),
                                           (h, w)).reshape(-1)
                v = ok & (lab2 == lab_flat)
                wgt = v.astype(jnp.float32)
                from ..ops.stats import featurewise_segment_sum
                rows = pair_sum_rows(q1.astype(jnp.float32), q2, v)
                s7 = jax.lax.psum(
                    featurewise_segment_sum(rows, lab_safe, K + 1)[:K],
                    _AXES)
                sums_A.append(s7)
                if compute_asm:
                    lo = jnp.minimum(q1, q2)
                    hi = jnp.maximum(q1, q2)
                    # interior objects: the LOCAL histogram is the global
                    # one (all pixels here), so the local sumsq is exact
                    key = jnp.where(v, lab_c * (L * L) + lo * L + hi, table)
                    hist_loc = jax.ops.segment_sum(
                        wgt, key, num_segments=table + 1)[:table] \
                        .reshape(K, L * L)
                    # HIGHEST: at the default precision the squared
                    # counts may be rounded to TF32 — see ops/glcm.py
                    sumsq_loc = jnp.dot(hist_loc * hist_loc, W8[:, 7],
                                        precision=jax.lax.Precision.HIGHEST)
                    sumsq = jax.lax.psum(
                        jnp.where(own_whole, sumsq_loc, 0.0), _AXES)
                    # shard-spanning objects: psum the compact-ranked
                    # (MCAP, L^2) histogram, then square
                    keym = jnp.where(v & multi[lab_c],
                                     mr_px * (L * L) + lo * L + hi, mtable)
                    hist_m = jax.lax.psum(jax.ops.segment_sum(
                        wgt, keym, num_segments=mtable + 1)[:mtable],
                        _AXES).reshape(MCAP, L * L)
                    sumsq_m = jnp.dot(hist_m * hist_m, W8[:, 7],
                                      precision=jax.lax.Precision.HIGHEST)
                    sumsq = sumsq + jnp.where(
                        multi, sumsq_m[jnp.clip(midx, 0, MCAP - 1)], 0.0)
                    asm_A.append(
                        sumsq / jnp.maximum(2.0 * s7[:, 0], 1.0) ** 2)
                else:
                    asm_A.append(jnp.full((K,), jnp.nan, jnp.float32))
            props = _glcm_props_from_sums(jnp.stack(sums_A),
                                          jnp.stack(asm_A), compute_asm)
            return carry, props  # (6, K)

        _, per_band = jax.lax.scan(one_band, jnp.int32(0), bands_stack)
        return per_band  # (B, 6, K)

    out = run(image, labels)
    from ..ops.glcm import GLCM_PROP_NAMES
    if packed:
        return GLCM_PROP_NAMES, out  # (B, 6, K) — one download
    return {name: out[:, i, :].T for i, name in enumerate(GLCM_PROP_NAMES)}


def shard_raster(mesh: Mesh, arr: np.ndarray, fill=0):
    """Pad an (H, W[, C]) host array to mesh-divisible shape and place it
    sharded P("ty","tx"[, None]). Returns (device array, (H, W))."""
    ty, tx = mesh.devices.shape
    H, W = arr.shape[:2]
    Hp = ((H + ty - 1) // ty) * ty
    Wp = ((W + tx - 1) // tx) * tx
    if (Hp, Wp) != (H, W):
        pad = [(0, Hp - H), (0, Wp - W)] + [(0, 0)] * (arr.ndim - 2)
        arr = np.pad(arr, pad, constant_values=fill)
    spec = P("ty", "tx") if arr.ndim == 2 else P("ty", "tx", None)
    return jax.device_put(arr, NamedSharding(mesh, spec)), (H, W)
