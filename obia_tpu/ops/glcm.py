"""Per-object GLCM texture properties, fused across all objects.

Replaces the reference's per-segment ``skimage.feature.graycomatrix`` /
``graycoprops`` calls (reference segment_statistics.py:262-296: distance 2,
angles 0/45/90/135 deg, levels=256, symmetric, normed, props averaged over
angles) with full-raster passes:

* Quantisation: per-object min-max rescale to [0, levels-1] with floor,
  the reference's ``((x - min) / (max - min) * 255).astype(uint8)``.
* contrast / dissimilarity / homogeneity / correlation reduce to
  ``segment_sum`` accumulations over co-occurring pixel pairs — no
  co-occurrence matrix is ever materialised.
* ASM (and energy = sqrt(ASM)) needs the joint distribution; computed
  exactly with a sort-and-run-length pass (`lax.sort` with two keys),
  O(N log N) instead of K x levels^2 memory.

Documented divergences from the reference (SURVEY.md quirk #2 and §7):
pairs are counted only when BOTH pixels belong to the object (the reference
computes the GLCM over the object's bounding-box crop with background
zeroed, so background pairs leak in — and, due to its axis bug, on the
wrong array slice entirely). Quantisation stats likewise use object pixels
only. Angles with no pairs are excluded from the angle average; objects
with no pairs at any angle yield NaN.

skimage angle convention preserved: pixel pair offset =
(round(sin(a)*d), round(cos(a)*d)).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .stats import _batched_segment_reduce, featurewise_segment_sum

GLCM_PROP_NAMES = ("contrast", "dissimilarity", "homogeneity", "ASM",
                   "energy", "correlation")

DEFAULT_ANGLES = (0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4)


def angle_offsets(distance: int, angles: Sequence[float]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(round(math.sin(a) * distance)),
                  int(round(math.cos(a) * distance))) for a in angles)


def _shift_pairs(arr: jnp.ndarray, dr: int, dc: int, fill):
    """arr2 aligned so that arr2[r, c] = arr[r+dr, c+dc] (fill outside),
    keeping the original shape. GLCM pair shifts share the exact edge
    semantics of the CCL neighbour shift — one implementation."""
    from .connectivity import _shift2d
    return _shift2d(arr, dr, dc, fill)


def scale_quantise(vals: jnp.ndarray, mn_px: jnp.ndarray,
                   rng_px: jnp.ndarray, levels: int) -> jnp.ndarray:
    """Per-pixel min-max scaling to [0, levels-1] (floor semantics,
    constant objects -> 0). THE quantisation formula — shared by the
    single-device path and the sharded mesh path so the two can never
    drift (reference semantics: segment_statistics.py:256-260).

    The level of d = vals - min is the q with
    q * range <= d * (levels-1) < (q+1) * range, each product rounded to
    float32 — on integer rasters (d * (levels-1) < 2^24) that is exactly
    floor(d * (levels-1) / range). See :func:`_levels_from_inverse`."""
    has = rng_px > 0
    safe = jnp.where(has, rng_px, 1.0)
    inv = jnp.float32(levels - 1) / safe
    return _levels_from_inverse(vals - mn_px, safe, has, inv, levels)


def _levels_from_inverse(d, rng, has, inv, levels: int) -> jnp.ndarray:
    """Levels from d * inv, corrected by one step to satisfy the product
    inequality of :func:`scale_quantise`. The inverse only has to be
    within a few ulp: a float32 division may round differently on another
    backend (on the GPU it is not the CPU's correctly rounded one), and
    on integer rasters every exact-integer quotient (d * (levels-1) a
    multiple of the range) would otherwise flip a level with it."""
    top = jnp.float32(levels - 1)
    q = jnp.floor(d * inv)
    num = d * top
    q = (q + ((q + 1.0) * rng <= num).astype(q.dtype)
         - (q * rng > num).astype(q.dtype))
    return jnp.clip(jnp.where(has, q, 0.0), 0, levels - 1).astype(jnp.int32)


def pair_sum_rows(l1: jnp.ndarray, q2, v) -> list:
    """The seven pairwise-sum rows (weight, contrast, dissimilarity,
    homogeneity, l1+l2, l1^2+l2^2, l1*l2) every GLCM prop except exact
    ASM reduces from. Column order mirrors ``_pair_weight_table`` 0..6.
    Shared by the single-device scatter path and the sharded psum path.
    ``l1`` is the center pixel's quantised level as float32."""
    l2 = q2.astype(jnp.float32)
    w = v.astype(jnp.float32)
    d = l1 - l2
    return [
        w,
        w * d * d,
        w * jnp.abs(d),
        w / (1.0 + d * d),
        w * (l1 + l2),
        w * (l1 * l1 + l2 * l2),
        w * l1 * l2,
    ]


def _check_levels(levels: int) -> int:
    """The quantised co-occurrence stacks are uint8: more than 256 grey
    levels would silently wrap (and the (K, L^2) histogram table would be
    enormous anyway). The reference default is 16."""
    levels = int(levels)
    if not 1 <= levels <= 256:
        raise ValueError(
            f"levels={levels} out of range: 1..256 grey levels supported")
    return levels


def quantize_per_segment(band: jnp.ndarray, labels: jnp.ndarray,
                         num_segments: int, levels: int) -> jnp.ndarray:
    """Per-object min-max quantisation to [0, levels-1] (floor semantics,
    constant objects -> 0), matching reference segment_statistics.py:256-260."""
    levels = _check_levels(levels)
    if not jnp.issubdtype(jnp.asarray(band).dtype, jnp.floating):
        band = jnp.asarray(band, jnp.float32)
    flat = band.reshape(-1)
    lab = labels.reshape(-1)
    ok = lab >= 0
    lab_safe = jnp.where(ok, lab, num_segments)
    big = jnp.asarray(jnp.finfo(band.dtype).max, band.dtype)
    # min and max in ONE batched scatter (max rides as min of -band),
    # via the chunked helper: an unchunked (2, N) vmapped scatter lets
    # XLA materialise the whole update copy as (N, 2) at once
    both = _batched_segment_reduce(
        [jnp.where(ok, flat, big), jnp.where(ok, -flat, big)],
        lab_safe, num_segments + 1, jax.ops.segment_min)   # (K+1, 2)
    mn = both[:num_segments, 0]
    mx = -both[:num_segments, 1]
    rng = mx - mn
    lab_c = jnp.clip(lab, 0, num_segments - 1)
    # ONE payload-batched gather for (min, range) — two independent
    # (N,)-row gathers pay the random-access cost twice
    rec = jnp.take(jnp.stack([mn, rng]), lab_c, axis=1)  # (2, N)
    q = scale_quantise(flat, rec[0], rec[1], levels)
    return q.reshape(band.shape)


def _asm_sumsq(seg_key: jnp.ndarray, pair_key: jnp.ndarray,
               num_segments: int, sentinel_pk: int) -> jnp.ndarray:
    """Exact sum over (segment, l1, l2) of squared co-occurrence counts.

    seg_key: (M,) int32 in [0, K] (K = invalid sentinel).
    pair_key: (M,) int32 (sentinel_pk = invalid).
    Returns (K,) float32 of sum-of-squared counts per segment.

    When the fused key (segment, pair) fits 31 bits, a single-operand sort
    is used (cheaper than the lexicographic two-key sort).
    """
    M = seg_key.shape[0]
    L = int(math.isqrt(sentinel_pk))
    stride = sentinel_pk + 1
    if (num_segments + 1) * stride < 2 ** 31:
        fused = seg_key * stride + pair_key
        sorted_fused = jnp.sort(fused)
        prev = jnp.concatenate(
            [jnp.full((1,), -1, sorted_fused.dtype), sorted_fused[:-1]])
        change = sorted_fused != prev
        sseg = sorted_fused // stride
        spk = sorted_fused - sseg * stride
    else:
        sseg, spk = jax.lax.sort((seg_key, pair_key), num_keys=2)
        prev_seg = jnp.concatenate([jnp.full((1,), -1, sseg.dtype), sseg[:-1]])
        prev_pk = jnp.concatenate([jnp.full((1,), -1, spk.dtype), spk[:-1]])
        change = (sseg != prev_seg) | (spk != prev_pk)
    # run lengths via a reverse cumulative-min scan over change positions —
    # no full-length scatter needed (length = next run start - own start)
    pos = jnp.arange(M, dtype=jnp.int32)
    arr = jnp.where(change, pos, M)
    # native cumulative-min (associative_scan's recursive construction
    # takes minutes to COMPILE at >16M elements; lax.cummin lowers natively)
    next_incl = jax.lax.cummin(arr, axis=0, reverse=True)
    next_after = jnp.concatenate([next_incl[1:], jnp.full((1,), M, jnp.int32)])
    run_len = (next_after - pos).astype(jnp.float32)
    # keys are CANONICAL unordered pairs: for the symmetric GLCM,
    # sum C_sym^2 = 2 * sum_{i<j} U^2 + 4 * sum_i D^2 with U = unordered
    # off-diagonal counts and D = diagonal counts
    is_diag = (spk // L) == (spk % L)
    weight = jnp.where(is_diag, 4.0, 2.0)
    contrib = jnp.where(change & (spk < sentinel_pk),
                        weight * run_len * run_len, 0.0)
    seg_of = jnp.where(change & (spk < sentinel_pk),
                       jnp.clip(sseg, 0, num_segments), num_segments)
    return jax.ops.segment_sum(contrib, seg_of,
                               num_segments=num_segments + 1)[:num_segments]


def segment_glcm_props(image: jnp.ndarray,
                       labels: jnp.ndarray,
                       num_segments: int,
                       levels: int = 256,
                       distance: int = 2,
                       angles: Tuple[float, ...] = DEFAULT_ANGLES,
                       compute_asm: bool = True,
                       bands: Optional[Tuple[int, ...]] = None
                       ) -> Dict[str, np.ndarray]:
    """Public entry: dict of (K, B) arrays per prop (host numpy — the
    packed core below does one download; slicing per prop on device would
    cost an eager dispatch each)."""
    names, packed = segment_glcm_props_packed(
        image, labels, num_segments, levels=levels, distance=distance,
        angles=angles, compute_asm=compute_asm, bands=bands)
    return dict(zip(names, packed))


def segment_glcm_props_packed(image: jnp.ndarray,
                              labels: jnp.ndarray,
                              num_segments: int,
                              levels: int = 256,
                              distance: int = 2,
                              angles: Tuple[float, ...] = DEFAULT_ANGLES,
                              compute_asm: bool = True,
                              bands: Optional[Tuple[int, ...]] = None):
    """All props for all bands with ONE host transfer:
    (GLCM_PROP_NAMES, (6, K, B) numpy). At small scale every band runs in
    ONE device program (dispatch overhead dominates there); at large scale
    each band is its own program (a band-fused program's sort temporaries
    ran the compiler out of memory at ≥16 MP). Per-(band, prop)
    device-side ``[:K]`` trims would cost an eager dispatch each (48 of
    them at 8 bands) — everything packs device-side and trims on host."""
    levels = _check_levels(levels)
    if not jnp.issubdtype(jnp.asarray(image).dtype, jnp.floating):
        # integer rasters (uint16 satellite bands) would crash jnp.finfo
        # deep inside the quantiser; quantisation math is float anyway
        image = jnp.asarray(image, jnp.float32)
    band_ids = (tuple(bands) if bands is not None
                else tuple(range(image.shape[2])))
    from .stats import pad_num_segments
    H, W = labels.shape
    K_pad = pad_num_segments(num_segments)
    if (H * W * len(band_ids) <= _FUSE_BANDS_MAX_ELEMS
            and K_pad <= _FUSE_BANDS_MAX_K):
        out = np.asarray(_glcm_bands(image, labels, K_pad, levels, distance,
                                     angles, compute_asm, band_ids))
        # (B, 6, K_pad) -> (6, K, B)
        return GLCM_PROP_NAMES, np.moveaxis(out, 0, 2)[:, :num_segments]
    # the static segment count is bucketed (next multiple of 512): the
    # compiled program serves any K in the bucket, so caches survive the
    # data-dependent K jitter between scenes and the hot program can be
    # compile-warmed ahead of time (ops.stats.pad_num_segments)
    #
    # three programs per scene: (1) ALL bands quantised at once — the
    # per-band min/max scatters and (min, range) lookups share one label
    # index, so batching them across bands divides that cost by B
    # (scatter/gather cost is dominated by the index rows);
    # (2) the per-angle label-validity stack, which depends only on the
    # labels and was previously recomputed identically for every band;
    # (3) the GLCM proper, one program reused across bands (equal shapes)
    q_all = _quantize_bands(image, labels, K_pad, levels, band_ids)
    valid_stack = _glcm_valid_stack(labels, distance, angles)
    outs = [
        # band selected INSIDE the program by a traced index: a host-side
        # q_all[i] is an eager dynamic-slice dispatch per band
        _glcm_from_q_jit(q_all, jnp.int32(i), labels, K_pad, levels,
                         distance, angles, compute_asm, valid_stack)
        for i in range(len(band_ids))
    ]
    packed = np.asarray(jnp.stack(outs))  # (B, 6, K_pad), one download
    return GLCM_PROP_NAMES, np.moveaxis(packed, 0, 2)[:, :num_segments]


# above this (pixels x bands) count, bands run as separate device programs
# (a few more dispatches cost less than a compiler out of memory at
# 100 MP)
_FUSE_BANDS_MAX_ELEMS = 1 << 24

# above this segment count the band-fused / all-angles-one-scatter
# branches split up even on small scenes: XLA may lay the stacked (F, N)
# scatter payloads out FEATURE-MINOR in the big-K programs, and the fused
# config-2 program (3 bands x 4 angles x 7 rows, K=54k) then scheduled
# ~72 padded row copies concurrently — out of device memory at compile
# time, invisible to every CPU test. Per-band programs with per-angle
# scans keep the copies transient.
_FUSE_BANDS_MAX_K = 1 << 14

# joint-histogram ASM path: per-(segment, pair) counts scattered into a
# (K, levels^2) table — ONE N-row scatter per angle yields ALL six props
# (weighted reductions over the table), replacing both the 7-row feature
# scatter and the O(N log N) sort per angle. Only viable while the table
# fits device memory comfortably and the scatter dominates the table
# traffic.
_ASM_HIST_MAX_ELEMS = 1 << 28


def _use_histogram(n_pixels: int, num_segments: int, levels: int) -> bool:
    table = (num_segments + 1) * levels * levels
    # table traffic (~3 reads/writes per angle) must stay small next to
    # the N-row scatter for the trade to pay; 16x covers the measured
    # scatter-vs-bandwidth ratio with margin
    return table <= _ASM_HIST_MAX_ELEMS and table <= 16 * n_pixels


@functools.partial(jax.jit,
                   static_argnames=("num_segments", "levels", "distance",
                                    "angles", "compute_asm", "band_ids"))
def _glcm_bands(image: jnp.ndarray, labels: jnp.ndarray, num_segments: int,
                levels: int, distance: int, angles: Tuple[float, ...],
                compute_asm: bool, band_ids: Tuple[int, ...]) -> jnp.ndarray:
    """All bands' GLCM props as ONE device program -> (B, 6, K)."""
    return jnp.stack([
        _glcm_one_band_impl(_band_select(image, jnp.int32(b)), labels,
                            num_segments, levels, distance, angles,
                            compute_asm)
        for b in band_ids
    ])


def _band_select(image: jnp.ndarray, band_idx) -> jnp.ndarray:
    """Band plane as a sum of unrolled minor-dim slices (the pattern the
    k-means assignment proves safe at 100 MP). A channel-axis reduce or
    a leading-axis transpose may make XLA materialise a padded
    channel-minor copy; per-channel slices fuse cleanly. ``band_idx`` may
    be traced."""
    C = image.shape[2]
    out = image[..., 0] * (band_idx == 0)
    for c in range(1, C):
        out = out + image[..., c] * (band_idx == c)
    return out


@functools.partial(jax.jit,
                   static_argnames=("num_segments", "levels", "band_ids"))
def _quantize_bands(image: jnp.ndarray, labels: jnp.ndarray,
                    num_segments: int, levels: int,
                    band_ids: Tuple[int, ...]) -> jnp.ndarray:
    """ALL texture bands per-object quantised in ONE program -> (B, H, W)
    uint8 (reference quantise semantics, segment_statistics.py:256-260).

    Every band's min/max rides ONE batched scatter (2B payload rows share
    the label index — index rows dominate scatter cost) and every pixel's
    (min, range, has-range) lookup rides ONE packed gather per row range.
    The row-range loop threads chunks through the output accumulator so
    only ~one chunk's gather temp is ever live (the 100 MP discipline of
    ops.stats._segment_spectral_moments). Per-channel minor-dim slices
    are used throughout — stacked (C, N) image-derived arrays may be laid
    out channel-minor with C padded."""
    from .stats import _batched_segment_reduce, _row_ranges
    H, W = labels.shape
    K = num_segments
    B = len(band_ids)
    lab_flat = labels.reshape(-1)
    ok = lab_flat >= 0
    lab_safe = jnp.where(ok, lab_flat, K)
    big = jnp.asarray(jnp.finfo(image.dtype).max, image.dtype)
    rows = []
    for c in band_ids:
        v = image[..., c].reshape(-1)
        rows.append(jnp.where(ok, v, big))
        rows.append(jnp.where(ok, -v, big))
    both = _batched_segment_reduce(rows, lab_safe, K + 1,
                                   jax.ops.segment_min)     # (K+1, 2B)
    mn = both[:K, 0::2].T                                   # (B, K)
    rng = -both[:K, 1::2].T - mn                            # max - min
    has = rng > 0
    table = jnp.concatenate([mn, jnp.where(has, rng, 1.0),
                             has.astype(image.dtype)])      # (3B, K)
    q_all = jnp.zeros((B, H, W), jnp.uint8)
    for h0, h1 in _row_ranges(H, W):
        lab_c = jnp.clip(labels[h0:h1].reshape(-1), 0, K - 1)
        rec = jnp.take(table, lab_c, axis=1)                # (3B, n)
        qs = []
        for i, c in enumerate(band_ids):
            v = image[h0:h1, :, c].reshape(-1)
            # reconstruct the zero-range signal from the has flag so THE
            # shared quantise formula applies (empty segments carry
            # f32-max sentinels; scale_quantise's where keeps them out)
            rng_eff = jnp.where(rec[2 * B + i] > 0, rec[B + i], 0.0)
            qs.append(scale_quantise(v, rec[i], rng_eff, levels))
        chunk = jnp.stack(qs).astype(jnp.uint8).reshape(B, h1 - h0, W)
        q_all = jax.lax.dynamic_update_slice(q_all, chunk, (0, h0, 0))
    return q_all


@functools.partial(jax.jit, static_argnames=("distance", "angles"))
def _glcm_valid_stack(labels: jnp.ndarray, distance: int,
                      angles: Tuple[float, ...]) -> jnp.ndarray:
    """(A, N) bool: per angle, does the offset neighbour share the pixel's
    (non-masked) label. Depends only on the labels — computed once per
    scene and reused by every band's GLCM program."""
    lab_flat = labels.reshape(-1)
    return jnp.stack([
        (lab_flat >= 0)
        & (_shift_pairs(labels, dr, dc, fill=-1).reshape(-1) == lab_flat)
        for dr, dc in angle_offsets(distance, angles)])


@functools.partial(jax.jit,
                   static_argnames=("num_segments", "levels",
                                    "distance", "angles", "compute_asm"))
def _glcm_from_q_jit(q_all: jnp.ndarray, band_pos: jnp.ndarray,
                     labels: jnp.ndarray,
                     num_segments: int, levels: int, distance: int,
                     angles: Tuple[float, ...], compute_asm: bool,
                     valid_stack: jnp.ndarray) -> jnp.ndarray:
    """One band's props from the (B, H, W) quantised stack; ``band_pos``
    is TRACED so one compiled program serves every band."""
    q_u8 = jax.lax.dynamic_index_in_dim(q_all, band_pos, 0, keepdims=False)
    return _glcm_from_q(q_u8, labels, num_segments, levels, distance,
                        angles, compute_asm, valid_stack)


@functools.partial(jax.jit,
                   static_argnames=("num_segments", "levels",
                                    "distance", "angles", "compute_asm"))
def _glcm_one_band(band: jnp.ndarray,
                   labels: jnp.ndarray,
                   num_segments: int,
                   levels: int,
                   distance: int,
                   angles: Tuple[float, ...],
                   compute_asm: bool) -> jnp.ndarray:
    return _glcm_one_band_impl(band, labels, num_segments, levels,
                               distance, angles, compute_asm)


def _glcm_one_band_impl(band: jnp.ndarray,
                        labels: jnp.ndarray,
                        num_segments: int,
                        levels: int,
                        distance: int,
                        angles: Tuple[float, ...],
                        compute_asm: bool) -> jnp.ndarray:
    """All six GLCM props for one float band (quantises inline)."""
    q = quantize_per_segment(band, labels, num_segments, levels)
    return _glcm_from_q(q.astype(jnp.uint8), labels, num_segments, levels,
                        distance, angles, compute_asm)


def _glcm_from_q(q_u8: jnp.ndarray,
                 labels: jnp.ndarray,
                 num_segments: int,
                 levels: int,
                 distance: int,
                 angles: Tuple[float, ...],
                 compute_asm: bool,
                 valid_stack: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """All six GLCM props for every object from the pre-quantised band.

    Args:
      q_u8: (H, W) uint8 per-object quantised levels (uint8 stacks keep
        the 100 MP program small — int32 stacks alone are 3 GB).
      labels: (H, W) int32, -1 = masked out.
      num_segments: static K.
      valid_stack: optional precomputed (A, N) bool per-angle validity
        (label-only, band-independent — see _glcm_valid_stack); computed
        inline when absent (single-band / fused small-scene callers).

    Returns (6, K) float32 in GLCM_PROP_NAMES order.
    """
    H, W = q_u8.shape
    offs = angle_offsets(distance, angles)
    A = len(offs)
    K = num_segments
    L = levels
    sentinel_pk = L * L

    lab_flat = labels.reshape(-1)
    if valid_stack is None:
        # per-angle validity: neighbour shares the label — (A, N) bool;
        # the shifted-label stack is transient (the int32 (A, N) stacks
        # would be 1.6 GB each at 100 MP, so only bool/uint8 stacks
        # persist)
        valid_stack = _glcm_valid_stack(labels, distance, angles)
    q_flat = q_u8.reshape(-1).astype(jnp.int32)
    q2_stack = jnp.stack([_shift_pairs(q_u8, dr, dc, fill=0).reshape(-1)
                          for dr, dc in offs])  # (A, N) uint8

    if _use_histogram(H * W, K, L):
        sums_A, asm_A = _glcm_hist_angles(q_flat, q2_stack, valid_stack,
                                          lab_flat, K, L, compute_asm)
        return _glcm_props_from_sums(sums_A, asm_A, compute_asm)

    # ---- all angles' pairwise sums in ONE batched scatter -----------------
    # every row is keyed by the CENTER pixel's own label (invalid pairs
    # contribute 0 through w=0), so the 7*A rows share one index vector
    # and the index handling is paid once. Above ~16 MP the 4 angles'
    # live f32 temps grow too large, so the sums move into a per-angle
    # scan instead (transient temps per iteration).
    key = jnp.where(lab_flat >= 0, lab_flat, K)
    l1 = q_flat.astype(jnp.float32)

    def angle_rows(q2_u8, v):
        return pair_sum_rows(l1, q2_u8, v)

    if H * W <= _FUSE_BANDS_MAX_ELEMS and K <= _FUSE_BANDS_MAX_K:
        rows = []
        for a in range(A):
            rows += angle_rows(q2_stack[a], valid_stack[a])
        sums_all = featurewise_segment_sum(rows, key, K + 1)[:K]  # (K, 7A)
        sums_A = jnp.moveaxis(sums_all.reshape(K, A, 7), 0, 1)    # (A, K, 7)
    else:
        def sums_body(carry, inputs):
            q2, v = inputs
            return carry, featurewise_segment_sum(
                angle_rows(q2, v), key, K + 1)[:K]                # (K, 7)

        _, sums_A = jax.lax.scan(sums_body, 0, (q2_stack, valid_stack))

    n_A = sums_A[:, :, 0]                                     # (A, K)

    if compute_asm:
        def one_angle(carry, inputs):
            q2_u8, v, n = inputs
            q2 = q2_u8.astype(jnp.int32)
            seg = jnp.where(v, lab_flat, K)
            # canonical unordered pair key: HALVES the sort input vs
            # symmetrised duplication (weights in _asm_sumsq account
            # for the symmetry)
            lo = jnp.minimum(q_flat, q2)
            hi = jnp.maximum(q_flat, q2)
            pk = jnp.where(v, lo * L + hi, sentinel_pk)
            sumsq = _asm_sumsq(seg, pk, K, sentinel_pk)
            return carry, sumsq / jnp.maximum(2.0 * n, 1.0) ** 2

        _, asm_A = jax.lax.scan(
            one_angle, 0, (q2_stack, valid_stack, n_A))
    else:
        asm_A = jnp.full((A, K), jnp.nan, jnp.float32)

    return _glcm_props_from_sums(sums_A, asm_A, compute_asm)


def _pair_weight_table(levels: int) -> jnp.ndarray:
    """(levels^2, 8) weight table over canonical pair keys lo*L+hi:
    columns 0..6 mirror ``angle_rows`` (1, d^2, |d|, 1/(1+d^2), lo+hi,
    lo^2+hi^2, lo*hi — every prop kernel is symmetric in (l1, l2), so
    unordered-pair sums equal the ordered ones), column 7 is the
    symmetric-ASM squared-count weight (2 off-diagonal, 4 diagonal)."""
    L = levels
    pk = jnp.arange(L * L, dtype=jnp.int32)
    lo = (pk // L).astype(jnp.float32)
    hi = (pk % L).astype(jnp.float32)
    pk = pk.astype(jnp.float32)
    d = hi - lo  # hi >= lo on canonical keys; others never occur
    return jnp.stack([
        jnp.ones_like(pk), d * d, jnp.abs(d), 1.0 / (1.0 + d * d),
        lo + hi, lo * lo + hi * hi, lo * hi,
        jnp.where(lo == hi, 4.0, 2.0),
    ], axis=1)


def _glcm_hist_angles(q_flat, q2_stack, valid_stack, lab_flat,
                      K: int, L: int, compute_asm: bool):
    """All-props-from-histogram path: per angle, ONE N-row scatter builds
    the (K, L^2) joint co-occurrence count table; the seven pairwise sums
    AND the exact symmetric-ASM sum-of-squares are then weighted
    reductions over the table (a (K, L^2) x (L^2, 8) matmul, bound by
    memory bandwidth). Replaces the 7-row feature scatter + O(N log N) sort
    per angle of the small-scene path; exact, not approximate.

    Returns (sums_A (A, K, 7), asm_A (A, K))."""
    table = K * L * L
    W8 = _pair_weight_table(L)
    lab_safe = jnp.where(lab_flat >= 0, lab_flat, 0)

    def one_angle(carry, inputs):
        q2_u8, v = inputs
        q2 = q2_u8.astype(jnp.int32)
        lo = jnp.minimum(q_flat, q2)
        hi = jnp.maximum(q_flat, q2)
        key = jnp.where(v, lab_safe * (L * L) + lo * L + hi, table)
        hist = jax.ops.segment_sum(
            v.astype(jnp.float32), key,
            num_segments=table + 1)[:table].reshape(K, L * L)
        # HIGHEST precision is load-bearing: at the default precision a
        # float32 matmul may round its operands to TF32 (10-bit
        # mantissa), and neither the counts nor the moment weights (d^2
        # up to 65025) fit it — correlation, a difference of moments,
        # would move at O(1) and contrast at ~1e-3.
        sums8 = jnp.dot(hist, W8,
                        precision=jax.lax.Precision.HIGHEST)  # (K, 8)
        if compute_asm:
            sumsq = jnp.dot(hist * hist, W8[:, 7],
                            precision=jax.lax.Precision.HIGHEST)
            n = sums8[:, 0]
            asm = sumsq / jnp.maximum(2.0 * n, 1.0) ** 2
        else:
            asm = jnp.full((K,), jnp.nan, jnp.float32)
        return carry, (sums8[:, :7], asm)

    _, (sums_A, asm_A) = jax.lax.scan(one_angle, 0, (q2_stack, valid_stack))
    return sums_A, asm_A


def _glcm_props_from_sums(sums_A: jnp.ndarray, asm_A: jnp.ndarray,
                          compute_asm: bool) -> jnp.ndarray:
    """(A, K, 7) pairwise sums + (A, K) ASM -> (6, K) angle-averaged
    props (shared tail of the sort and histogram paths)."""
    n_A = sums_A[:, :, 0]
    safe_n = jnp.maximum(n_A, 1.0)
    mu = (sums_A[:, :, 4] / 2.0) / safe_n
    var = (sums_A[:, :, 5] / 2.0) / safe_n - mu * mu
    cov = sums_A[:, :, 6] / safe_n - mu * mu
    corr = jnp.where(var > 1e-12, cov / jnp.where(var > 1e-12, var, 1.0),
                     1.0)  # skimage: correlation := 1 when std ~ 0
    energy_A = jnp.sqrt(asm_A) if compute_asm else asm_A

    props_A = jnp.stack([sums_A[:, :, 1] / safe_n,
                         sums_A[:, :, 2] / safe_n,
                         sums_A[:, :, 3] / safe_n,
                         asm_A, energy_A, corr], axis=1)      # (A, 6, K)
    # average over angles with pairs
    has_pairs = n_A > 0
    n_ok = jnp.maximum(has_pairs.sum(0).astype(jnp.float32), 1.0)
    any_pairs = has_pairs.any(0)
    avg = (jnp.where(has_pairs[:, None, :], props_A, 0.0).sum(0)
           / n_ok[None, :])
    return jnp.where(any_pairs[None, :], avg, jnp.nan)  # (6, K)


def graycomatrix_reference(arr: np.ndarray, distance: int = 2,
                           angles: Sequence[float] = DEFAULT_ANGLES,
                           levels: int = 256) -> np.ndarray:
    """Host reimplementation of ``skimage.feature.graycomatrix`` with
    ``symmetric=True, normed=True`` (the reference's call,
    segment_statistics.py:262-269): returns (levels, levels, 1, A)."""
    arr = np.asarray(arr)
    H, W = arr.shape
    offs = angle_offsets(distance, tuple(angles))
    out = np.zeros((levels, levels, 1, len(offs)), np.float64)
    for a, (dr, dc) in enumerate(offs):
        r0, r1 = max(0, -dr), min(H, H - dr)
        c0, c1 = max(0, -dc), min(W, W - dc)
        if r1 <= r0 or c1 <= c0:
            continue
        i = arr[r0:r1, c0:c1].ravel().astype(np.int64)
        j = arr[r0 + dr:r1 + dr, c0 + dc:c1 + dc].ravel().astype(np.int64)
        P = np.zeros((levels, levels), np.float64)
        np.add.at(P, (i, j), 1.0)
        P = P + P.T  # symmetric
        s = P.sum()
        if s > 0:
            P = P / s  # normed
        out[:, :, 0, a] = P
    return out


def graycoprops_reference(P: np.ndarray, prop: str) -> np.ndarray:
    """``skimage.feature.graycoprops`` formulas over a (L, L, 1, A)
    normalised GLCM -> (1, A)."""
    L = P.shape[0]
    i = np.arange(L, dtype=np.float64)[:, None]
    j = np.arange(L, dtype=np.float64)[None, :]
    A = P.shape[3]
    out = np.zeros((1, A))
    for a in range(A):
        G = P[:, :, 0, a]
        if prop == "contrast":
            out[0, a] = (G * (i - j) ** 2).sum()
        elif prop == "dissimilarity":
            out[0, a] = (G * np.abs(i - j)).sum()
        elif prop == "homogeneity":
            out[0, a] = (G / (1.0 + (i - j) ** 2)).sum()
        elif prop == "ASM":
            out[0, a] = (G ** 2).sum()
        elif prop == "energy":
            out[0, a] = np.sqrt((G ** 2).sum())
        elif prop == "correlation":
            px = G.sum(axis=1)
            mu_i = (np.arange(L) * px).sum()
            var_i = ((np.arange(L) - mu_i) ** 2 * px).sum()
            py = G.sum(axis=0)
            mu_j = (np.arange(L) * py).sum()
            var_j = ((np.arange(L) - mu_j) ** 2 * py).sum()
            if var_i < 1e-15 or var_j < 1e-15:
                out[0, a] = 1.0
            else:
                out[0, a] = (((i - mu_i) * (j - mu_j) * G).sum()
                             / np.sqrt(var_i * var_j))
        else:
            raise ValueError(prop)
    return out


def glcm_table(image, labels, num_segments: int, **kw) -> Dict[str, np.ndarray]:
    out = segment_glcm_props(jnp.asarray(image, jnp.float32),
                             jnp.asarray(labels, jnp.int32),
                             num_segments, **kw)
    return {k: np.asarray(v) for k, v in out.items()}
