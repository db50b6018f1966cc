"""Fused per-object spectral statistics on the device.

Replaces the reference's per-segment Python loop (reference
segment_statistics.py:475-508: windowed disk read + polygon mask + scipy
stats per object — hot loop #2) with ONE pass over the label raster:
per-(segment, band) sums of 1, x, x2, centred x2/x3/x4 via
``jax.ops.segment_sum``, then closed-form mean/variance/min/max/
skewness/kurtosis.

Statistical definitions match scipy defaults used by the reference
(segment_statistics.py:173-175): variance = biased (ddof=0), skewness =
Fisher-Pearson g1 (bias=True), kurtosis = Fisher excess g2 (bias=True).
A two-pass centred-moment formulation keeps float32 accurate.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

SPECTRAL_STAT_NAMES = ("mean", "variance", "min", "max", "skewness", "kurtosis")


def featurewise_segment_sum(feat_rows, seg: jnp.ndarray,
                            num_segments: int) -> jnp.ndarray:
    """segment_sum of F feature rows (an (F, N) array or a sequence of
    (N,) arrays) → (num_segments, F).

    One BATCHED scatter instead of F 1-D scatters: the F rows share one
    index vector, so the index handling is paid once. The payload is
    stacked FEATURE-MAJOR (F, N) and the scatter vmapped over F, keeping
    the large dimension minor.
    """
    return _batched_segment_reduce(feat_rows, seg, num_segments,
                                   jax.ops.segment_sum)


# the chunk cap bounds each batched scatter's update copy (two are live at
# a time: current + prefetch); it was sized for a layout that pads the
# update's minor dim and for a device with a fraction of the GPU's
# memory, so on the GPU it may be pure overhead (ROADMAP A5). The elem
# budget still shrinks the chunk further when F is large so the
# (F, N_chunk) payload stack stays small. Total device work is unchanged.
_SCATTER_N_CHUNK = 1 << 21
_SCATTER_ELEM_BUDGET = 1 << 26  # elements per chunk payload (256 MB f32)


def _batched_segment_reduce(feat_rows, seg, num_segments, reducer):
    rows = list(feat_rows)
    if len(rows) == 1 and rows[0].ndim == 2:
        rows = list(rows[0])
    n = rows[0].shape[0]
    chunk_n = min(_SCATTER_N_CHUNK,
                  max(1 << 18, _SCATTER_ELEM_BUDGET // max(len(rows), 1)))
    # ALL sizes route through the accumulator-operand batched scatter
    # (_scatter_rows_into): scatter each chunk INTO the running
    # accumulator instead of summing independent partials — the data
    # dependency serialises the chunks, so at most one chunk's padded
    # update copy plus one prefetch is ever live. Independent partials
    # let XLA overlap every chunk's payload copy, which ran a 100 MP x
    # 8-band compile out of device memory. A vmap of INDEPENDENT per-row
    # scatters is worse on both axes: each row pays its own index
    # handling AND its own update copy, and a program with many
    # concurrent reductions (the fused config-2 GLCM) schedules dozens of
    # those copies at once.
    op = "add" if reducer is jax.ops.segment_sum else (
        "min" if reducer is jax.ops.segment_min else "max")
    acc = _reduce_init(len(rows), num_segments, rows[0].dtype, op)
    for j in range(0, n, chunk_n):
        acc = _scatter_rows_into(
            acc, [r[j:j + chunk_n] for r in rows], seg[j:j + chunk_n], op)
    return acc.T


def _reduce_init(F: int, B: int, dtype, op: str) -> jnp.ndarray:
    if op == "add":
        return jnp.zeros((F, B), dtype)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    return jnp.full((F, B), big if op == "min" else -big, dtype)


def _scatter_rows_into(acc: jnp.ndarray, rows, seg: jnp.ndarray,
                       op: str = "add") -> jnp.ndarray:
    """One batched scatter of F feature rows into an (F, B) accumulator.

    Taking ``acc`` as the scatter operand (``.at[seg].add/min/max``)
    chains successive calls: each chunk's scatter consumes the previous
    result, which bounds live padded-update temps to ~2 chunks no matter
    how many chunks a raster needs."""
    payload = jnp.stack(list(rows), axis=0)                 # (F, N)
    if op == "add":
        return jax.vmap(lambda a, r: a.at[seg].add(r))(acc, payload)
    if op == "min":
        return jax.vmap(lambda a, r: a.at[seg].min(r))(acc, payload)
    return jax.vmap(lambda a, r: a.at[seg].max(r))(acc, payload)


def pad_num_segments(num_segments: int, bucket: int = 512) -> int:
    """Round the static segment count up to a bucket boundary so compiled
    programs serve any K in the bucket: caches survive the data-dependent
    K jitter between scenes and hot programs can be compile-warmed with a
    synthetic K before memory-heavy runs."""
    return max(bucket, -(-int(num_segments) // bucket) * bucket)


def segment_spectral_moments(image: jnp.ndarray,
                             labels: jnp.ndarray,
                             num_segments: int,
                             valid: Optional[jnp.ndarray] = None):
    """Bucketed-K wrapper around the fused moment program (see
    :func:`pad_num_segments`)."""
    K_pad = pad_num_segments(num_segments)
    out = _segment_spectral_moments(image, labels, K_pad, valid)
    if K_pad == num_segments:
        return out
    return {k: v[:num_segments] for k, v in out.items()}


SPECTRAL_PACK_ORDER = ("count", "mean", "variance", "min", "max",
                       "skewness", "kurtosis")


@functools.partial(jax.jit, static_argnames=("num_segments",))
def _segment_spectral_moments_stacked(image, labels, num_segments,
                                      valid=None):
    out = _segment_spectral_moments(image, labels, num_segments, valid)
    return jnp.stack([out[k] for k in SPECTRAL_PACK_ORDER])


def spectral_moments_packed(image: jnp.ndarray, labels: jnp.ndarray,
                            num_segments: int,
                            valid: Optional[jnp.ndarray] = None):
    """All spectral moments as ONE device value and ONE host transfer:
    (SPECTRAL_PACK_ORDER, (7, num_segments, C) numpy). The per-stat
    ``[:K]`` trims and the re-stack of :func:`segment_spectral_moments`'s
    dict each cost an eager device dispatch — the pipeline path packs
    inside the jit and trims on host instead."""
    K_pad = pad_num_segments(num_segments)
    dev = _segment_spectral_moments_stacked(image, labels, K_pad, valid)
    return SPECTRAL_PACK_ORDER, np.asarray(dev)[:, :num_segments]


def _pass1_rows(chans, okf):
    """[count | x per channel] — count rides as an extra feature lane
    (index handling dominates scatter cost, extra rows are ~free)."""
    return [okf] + [v * okf for v in chans]


def _pass2_rows(chans, mean, lab_c, okf):
    """Centred 2nd/3rd/4th power rows (numerically stable in f32); the
    per-channel centred differences fuse into their scatters."""
    C = len(chans)
    # ONE payload-batched gather of every channel's segment mean per
    # pixel ((C, K) operand, C values per index row) — C independent
    # (N,)-row gathers would be C x N random-access rows, most of the
    # spectral stage at 100 MP x 8-band
    mu = jnp.take(mean.T, lab_c, axis=1)  # (C, N)
    d = [(chans[c] - mu[c]) * okf for c in range(C)]
    return ([dc * dc for dc in d]
            + [dc * dc * dc for dc in d]
            + [(dc * dc) * (dc * dc) for dc in d])


def _minmax_rows(chans, ok, dtype):
    """Min AND max rows for ONE batched min-scatter (max rides as min of
    the negated rows). Exact regardless of reduction order."""
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    return ([jnp.where(ok, v, big) for v in chans]
            + [jnp.where(ok, -v, big) for v in chans])


def _moment_pass1(chans, lab_safe, okf, K: int) -> jnp.ndarray:
    """Counts + first moments in ONE batched scatter.
    Returns (K, 1+C): [count | sum_x per channel]."""
    return featurewise_segment_sum(_pass1_rows(chans, okf),
                                   lab_safe, K + 1)[:K]


def _moment_pass2(chans, mean, lab_c, okf, lab_safe, K: int) -> jnp.ndarray:
    """Centred 2nd/3rd/4th power sums. Returns (K, 3C)."""
    return featurewise_segment_sum(_pass2_rows(chans, mean, lab_c, okf),
                                   lab_safe, K + 1)[:K]


def _moment_minmax(chans, ok, lab_safe, K: int, dtype):
    """Min AND max in ONE batched scatter (scatter cost is
    index-dominated, so 2C rows cost the same as C and the separate max
    pass is free). Returns (xmin, xmax), each (K, C)."""
    C = len(chans)
    both = _batched_segment_reduce(
        _minmax_rows(chans, ok, dtype), lab_safe, K + 1,
        jax.ops.segment_min)[:K]
    return both[:, :C], -both[:, C:]


def _moments_finalize(cnt1, s1, p2, xmin, xmax, C: int, dtype):
    """Reduced moment sums -> the public stats dict (shared by the
    single-device program and the sharded psum path)."""
    K = cnt1.shape[0]
    cnt = jnp.broadcast_to(cnt1[:, None], (K, C))
    safe_cnt = jnp.maximum(cnt, 1.0)
    mean = s1 / safe_cnt
    m2 = p2[:, :C] / safe_cnt
    m3 = p2[:, C:2 * C] / safe_cnt
    m4 = p2[:, 2 * C:] / safe_cnt

    nan = jnp.asarray(jnp.nan, dtype)
    empty = cnt == 0
    # scipy.stats.skew(bias=True): g1 = m3 / m2^1.5 ; 0/0 -> 0 per scipy,
    # but scipy returns nan for constant input in recent versions; follow
    # nan-on-zero-variance.
    zero_var = m2 <= 0
    skew = jnp.where(zero_var, nan, m3 / jnp.where(zero_var, 1.0, m2) ** 1.5)
    kurt = jnp.where(zero_var, nan,
                     m4 / jnp.where(zero_var, 1.0, m2) ** 2 - 3.0)

    def mask_empty(a):
        return jnp.where(empty, nan, a)

    return {
        "count": cnt,
        "mean": mask_empty(mean),
        "variance": mask_empty(m2),
        "min": mask_empty(xmin),
        "max": mask_empty(xmax),
        "skewness": mask_empty(skew),
        "kurtosis": mask_empty(kurt),
    }


# beyond this pixel count the moment passes accumulate over row ranges:
# full-length per-channel row EXPRESSIONS (ok*v, centred powers, negated
# min/max rows) otherwise materialise N-sized f32 temps each — tens of
# GB at 100 MP x 8 bands
_SPECTRAL_ONE_SHOT_MAX = 1 << 24


def _row_ranges(H: int, W: int):
    # ~2M px per range: each range's batched scatter materialises an
    # update copy; ranges bound it (sized for the layout that pads the
    # minor dim — ROADMAP A5)
    ch = max(1, (1 << 21) // max(W, 1))
    return [(h0, min(H, h0 + ch)) for h0 in range(0, H, ch)]


def _chunk_inputs(image, labels, valid, h0, h1, K):
    C = image.shape[2]
    im = image[h0:h1]
    chans = [im[..., c].reshape(-1) for c in range(C)]
    lab = labels[h0:h1].reshape(-1)
    ok = lab >= 0
    if valid is not None:
        ok = ok & valid[h0:h1].reshape(-1)
    lab_safe = jnp.where(ok, lab, K)
    return chans, lab, ok, lab_safe, ok.astype(image.dtype)


@functools.partial(jax.jit, static_argnames=("num_segments",))
def _segment_spectral_moments(image: jnp.ndarray,
                              labels: jnp.ndarray,
                              num_segments: int,
                              valid: Optional[jnp.ndarray] = None):
    """Fused moment accumulation.

    Args:
      image: (H, W, C) float32.
      labels: (H, W) int32 segment ids in [0, num_segments); pixels with
        negative labels (masked out) are ignored.
      num_segments: static segment count K.
      valid: optional (H, W) bool of additionally-valid pixels.

    Returns:
      dict of (K, C) arrays: count, mean, variance, min, max, skewness,
      kurtosis. Empty segments yield NaN stats (count 0), matching the
      reference's empty-mask behavior (segment_statistics.py:152-165).
    """
    H, W, C = image.shape
    K = num_segments
    if H * W <= _SPECTRAL_ONE_SHOT_MAX:
        # per-channel 1-D rows, NEVER a stacked (C, N) value: XLA may lay
        # an image-derived (C, N) / (C, H, W) array out channel-minor and
        # pad C; minor-dim slices fuse cleanly and only small stacked
        # CHUNKS ever materialise (inside the batched scatter helper)
        chans, lab, ok, lab_safe, okf = _chunk_inputs(
            image, labels, valid, 0, H, K)
        s1c = _moment_pass1(chans, lab_safe, okf, K)
        cnt1 = s1c[:, 0]
        s1 = s1c[:, 1:]
        mean = s1 / jnp.maximum(cnt1[:, None], 1.0)
        lab_c = jnp.clip(lab, 0, K - 1)
        p2 = _moment_pass2(chans, mean, lab_c, okf, lab_safe, K)
        xmin, xmax = _moment_minmax(chans, ok, lab_safe, K, image.dtype)
        return _moments_finalize(cnt1, s1, p2, xmin, xmax, C, image.dtype)

    # large rasters: accumulate every pass over row ranges by scattering
    # each range INTO a carried (F, K+1) accumulator. The accumulator is
    # the scatter's operand, so range i+1's scatter consumes range i's
    # result — the data dependency serialises the ranges and bounds live
    # update temps to ~one per chain. Summing independent per-range
    # partials instead let XLA overlap all ranges' payload copies, which
    # ran the 100 MP x 8-band compile out of device memory.
    ranges = _row_ranges(H, W)
    acc1 = _reduce_init(1 + C, K + 1, image.dtype, "add")
    for h0, h1 in ranges:
        chans, _, _, lab_safe, okf = _chunk_inputs(
            image, labels, valid, h0, h1, K)
        acc1 = _scatter_rows_into(acc1, _pass1_rows(chans, okf),
                                  lab_safe, "add")
    s1c = acc1.T[:K]
    cnt1 = s1c[:, 0]
    s1 = s1c[:, 1:]
    mean = s1 / jnp.maximum(cnt1[:, None], 1.0)

    acc2 = _reduce_init(3 * C, K + 1, image.dtype, "add")
    accmm = _reduce_init(2 * C, K + 1, image.dtype, "min")
    for h0, h1 in ranges:
        chans, lab, ok, lab_safe, okf = _chunk_inputs(
            image, labels, valid, h0, h1, K)
        lab_c = jnp.clip(lab, 0, K - 1)
        acc2 = _scatter_rows_into(acc2, _pass2_rows(chans, mean, lab_c, okf),
                                  lab_safe, "add")
        accmm = _scatter_rows_into(accmm, _minmax_rows(chans, ok, image.dtype),
                                   lab_safe, "min")
    p2 = acc2.T[:K]
    both = accmm.T[:K]
    xmin, xmax = both[:, :C], -both[:, C:]
    return _moments_finalize(cnt1, s1, p2, xmin, xmax, C, image.dtype)


def spectral_stats_table(image, labels, num_segments: int,
                         valid=None) -> Dict[str, np.ndarray]:
    """Host-friendly wrapper returning numpy arrays."""
    out = segment_spectral_moments(jnp.asarray(image, jnp.float32),
                                   jnp.asarray(labels, jnp.int32),
                                   num_segments,
                                   None if valid is None else jnp.asarray(valid))
    return {k: np.asarray(v) for k, v in out.items()}
