"""SLIC superpixels as an XLA program.

Array-program re-design of the Cython k-means SLIC the reference calls
(``skimage.segmentation.slic`` at reference segment_boundaries.py:51).
Instead of a per-center local-window scan, every pixel evaluates the 3x3
neighbourhood of grid cluster centers around its own grid cell — the same
candidate set SLIC's 2S x 2S window yields — so the assignment step is nine
fused gather+distance passes over the raster and the update step is one
batched ``segment_sum``. All shapes are static; the iteration loop is a
``lax.fori_loop``; connectivity enforcement is the gather-free segmented
min-scan CCL + on-device small-segment merge in
:mod:`obia_tpu.ops.connectivity` — k-means, CCL, dense relabel, and merge
run device-resident, and the final labels leave the chip once (RLE at
large sizes).

Parameter surface mirrors skimage: ``n_segments``, ``compactness``,
``max_num_iter``, ``sigma``, ``mask``, ``min_size_factor``,
``max_size_factor`` (size-capped merging via the native sequential
union-find), ``enforce_connectivity``, ``start_label``, ``slic_zero``,
``convert2lab``, ``spacing``.

Distance: D^2 = d_color^2 + (compactness / S)^2 * d_spatial^2 with
S = sqrt(H*W / n_segments) (classic SLIC; same argmin as skimage's
scaled-image formulation).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .stats import featurewise_segment_sum

_OFFSETS9 = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


@functools.partial(jax.jit, static_argnames=("sigma",))
def _gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Per-channel gaussian with scipy reflect padding — skimage slic /
    quickshift pre-smooth with ``ndi.gaussian_filter`` (scipy defaults),
    and a roll-based blur would wrap circularly, blending opposite image
    edges into the border superpixels."""
    from .filters import gaussian_filter
    if img.ndim == 2:
        return gaussian_filter(img, sigma)
    return jnp.stack([gaussian_filter(img[..., c], sigma)
                      for c in range(img.shape[2])], axis=-1)


def _grid_step(h: int, w: int, n_segments: int) -> int:
    return max(1, round(math.sqrt(h * w / max(n_segments, 1))))


def _grid_half(h: int, w: int, n_segments: int) -> int:
    """First-seed offset with exact skimage ``util.regular_grid``
    semantics: the start is ``int(float_step // 2)`` computed from the
    FLOAT step BEFORE rounding (for steps like 19.6 the rounded-step
    ``//2`` shifts the lattice 1 px and can change the per-axis seed
    count)."""
    return int(math.sqrt(h * w / max(n_segments, 1)) // 2)


def _grid_shape(h: int, w: int, n_segments: int) -> Tuple[int, int]:
    """Seed-grid shape with skimage ``util.regular_grid`` semantics
    (integer step = round(float_step), first seed at int(float_step // 2))
    so segment counts and the seed lattice match the reference's skimage
    slic call."""
    s = _grid_step(h, w, n_segments)
    half = _grid_half(h, w, n_segments)
    gh = max(1, len(range(half, h, s)))
    gw = max(1, len(range(half, w, s)))
    return gh, gw


def initial_centers(img: jnp.ndarray, gh: int, gw: int,
                    step: Optional[int] = None,
                    half: Optional[int] = None) -> jnp.ndarray:
    """Grid-seeded centers (gh, gw, C+2): image features + (y, x), seeded
    at skimage's regular-grid positions (half + k*step, clamped); pass
    ``half`` from :func:`_grid_half` for exact regular_grid parity."""
    H, W, C = img.shape
    # recover the integer grid step when not given (gh/gw from _grid_shape)
    si = step if step else max(1, round((H / gh + W / gw) / 2.0))
    if half is None:
        half = si // 2
    cy0 = jnp.minimum(half + jnp.arange(gh, dtype=jnp.float32) * si, H - 1.0)
    cx0 = jnp.minimum(half + jnp.arange(gw, dtype=jnp.float32) * si, W - 1.0)
    cyi = jnp.clip(jnp.round(cy0), 0, H - 1).astype(jnp.int32)
    cxi = jnp.clip(jnp.round(cx0), 0, W - 1).astype(jnp.int32)
    feat0 = img[cyi][:, cxi]  # (gh, gw, C)
    cy_grid = jnp.broadcast_to(cy0[:, None], (gh, gw))
    cx_grid = jnp.broadcast_to(cx0[None, :], (gh, gw))
    return jnp.concatenate(
        [feat0, cy_grid[..., None], cx_grid[..., None]], axis=-1)


def slic_assign_block(img: jnp.ndarray, valid: jnp.ndarray,
                      centers: jnp.ndarray, row0, col0,
                      gh: int, gw: int, H: int, W: int,
                      ratio: float,
                      inv_max_dc: Optional[jnp.ndarray] = None,
                      step: float = 1.0,
                      spacing: Optional[Tuple[float, float]] = None
                      ) -> jnp.ndarray:
    """Assignment step for a (h, w) block whose top-left global pixel is
    (row0, col0). ``centers`` is the full replicated (gh, gw, C+2) grid —
    this is the shard_map building block: centers are tiny and replicated,
    pixel blocks shard over the mesh, so assignment needs NO halo exchange.
    Returns block labels in [0, gh*gw) (-1 where invalid)."""
    h, w, C = img.shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + row0
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + col0
    row_cell = jnp.clip((yy[:, 0].astype(jnp.int32) * gh) // H, 0, gh - 1)
    col_cell = jnp.clip((xx[0, :].astype(jnp.int32) * gw) // W, 0, gw - 1)

    def _plane(grid2d, ri, ci):
        # separable row/col gather of a (gh, gw) center channel to (h, w);
        # gathering all channels at once materialises an (h, w, C+2)
        # volume — several stay live across the 9 candidates (30 GB at
        # 100 MP), while per-channel planes fuse into the distance sum
        return jnp.take(jnp.take(grid2d, ri, axis=0), ci, axis=1)

    # the 9 candidates run under a fori_loop: unrolled, the scheduler keeps
    # every candidate's gather planes live at once (9 x (C+2) full-raster
    # temps = 17 GB at 100 MP); the loop bounds live memory to ONE
    # candidate's working set
    di_arr = jnp.asarray([o[0] for o in _OFFSETS9], jnp.int32)
    dj_arr = jnp.asarray([o[1] for o in _OFFSETS9], jnp.int32)

    def body(t, carry):
        best_d, best_k = carry
        ri = jnp.clip(row_cell + di_arr[t], 0, gh - 1)
        ci = jnp.clip(col_cell + dj_arr[t], 0, gw - 1)
        d_color = jnp.zeros((h, w), jnp.float32)
        for c in range(C):
            d_color = d_color + (img[..., c]
                                 - _plane(centers[..., c], ri, ci)) ** 2
        dy = yy - _plane(centers[..., C], ri, ci)
        dx = xx - _plane(centers[..., C + 1], ri, ci)
        if spacing is not None:
            # anisotropic pixel spacing (skimage `spacing`): scale each
            # spatial axis before the squared distance
            dy = dy * spacing[0]
            dx = dx * spacing[1]
        d_sp = dy * dy + dx * dx
        if inv_max_dc is not None:
            # SLICO: per-cluster adaptive compactness
            # D^2 = d_c^2 / m_k^2 + d_s^2 / S^2
            imd = jnp.take(jnp.take(inv_max_dc, ri, axis=0), ci, axis=1)
            d = d_color * imd + d_sp * (1.0 / (step * step))
        else:
            d = d_color + ratio * d_sp
        kid = ri[:, None] * gw + ci[None, :]
        better = d < best_d
        return (jnp.where(better, d, best_d),
                jnp.where(better, kid, best_k))

    # derive the initial carry from img so it inherits any shard_map
    # varying axes (a plain jnp.full carry fails the scan type check
    # under shard_map)
    zero = jnp.zeros_like(img[..., 0])
    best_d, best_k = jax.lax.fori_loop(
        0, len(_OFFSETS9), body,
        (zero + jnp.inf, zero.astype(jnp.int32) - 1))
    return jnp.where(valid, best_k, -1)


def slic_update_sums(img: jnp.ndarray, labels: jnp.ndarray, row0, col0,
                     K: int):
    """Partial center-update sums for a block: (K, C+2) feature+position
    sums and (K,) counts. psum these across shards, then divide."""
    h, w, C = img.shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + row0
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + col0
    lab = labels.reshape(-1)
    ok = lab >= 0
    safe = jnp.where(ok, lab, 0)
    wpx = ok.astype(jnp.float32)
    # ONE batched (N, C+3) scatter per update step — counts ride as an
    # extra feature row (the rows share one index vector)
    rows = ([img[..., c].reshape(-1) * wpx for c in range(C)]
            + [yy.reshape(-1) * wpx, xx.reshape(-1) * wpx, wpx])
    out = featurewise_segment_sum(rows, safe, K)
    return out[:, :C + 2], out[:, C + 2]


# at or above this pixel count the k-means center update runs scatter-free
# (structured block reductions): the (N, C+3) update scatter is bound by
# its index rows while the block-reduction path is plain bandwidth; the
# threshold was set on other hardware and awaits a GPU A/B (ROADMAP A5)
_STRUCTURED_UPDATE_MIN_PIXELS = 1 << 24


def _block_gather_plan(n: int, g: int):
    """Static (numpy) plan for reducing an axis of length ``n`` over the
    ``g`` home-cell blocks ``cell(i) = (i * g) // n``: row-gather indices
    (g, bs) into the axis plus a float validity mask (variable block
    sizes are padded to the max and masked)."""
    cell = (np.arange(n, dtype=np.int64) * g) // n
    sizes = np.bincount(cell, minlength=g)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    bs = int(sizes.max())
    t = np.arange(bs)
    idx = np.minimum(starts[:, None] + t[None, :], n - 1).astype(np.int32)
    mask = (t[None, :] < sizes[:, None]).astype(np.float32)
    return idx, mask


def _slic_update_sums_structured(img: jnp.ndarray, labels: jnp.ndarray,
                                 gh: int, gw: int):
    """Scatter-free center-update sums, exploiting SLIC's 3x3-grid
    locality: every pixel's assigned center is one of the nine grid
    neighbours of its home cell, so per-center sums decompose into nine
    offset-masked per-home-cell block sums — whole-row/-column gathers
    with STATIC indices plus reductions (bandwidth-bound), instead of an
    (N, C+3) random scatter (index-row bound, ~1 s/iteration at 100 MP).
    Bit-exactness vs the scatter path is NOT preserved (summation order
    differs in f32 ulps), hence the _STRUCTURED_UPDATE_MIN_PIXELS gate.
    Returns ((K, C+2) sums, (K,) counts), K = gh * gw."""
    H, W, C = img.shape
    F = C + 3  # features + y + x + count
    ridx, rmask = _block_gather_plan(H, gh)   # (gh, bsh)
    cidx, cmask = _block_gather_plan(W, gw)   # (gw, bsw)
    row_cell = jnp.asarray((np.arange(H, dtype=np.int64) * gh) // H,
                           jnp.int32)
    col_cell = jnp.asarray((np.arange(W, dtype=np.int64) * gw) // W,
                           jnp.int32)
    ri = labels // gw            # floor: -1 -> -1, matches no offset
    ci = labels - ri * gw
    di = ri - row_cell[:, None]  # in {-1, 0, 1} for valid pixels
    dj = ci - col_cell[None, :]
    ok = labels >= 0

    yy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    planes = [img[..., c] for c in range(C)] + [yy, xx, None]

    ridx_j = jnp.asarray(ridx)
    rmask_j = jnp.asarray(rmask)
    cidx_j = jnp.asarray(cidx)
    cmask_j = jnp.asarray(cmask)

    def one_offset(t, acc):
        a = t // 3
        b = t - a * 3
        m = (ok & (di == a - 1) & (dj == b - 1)).astype(jnp.float32)
        # row stage: (gh, bsh, W) whole-row gathers (static indices,
        # coalesced), masked-reduced over the block axis -> (F, gh, W)
        mg = jnp.take(m, ridx_j.reshape(-1), axis=0).reshape(
            gh, -1, W) * rmask_j[:, :, None]
        rows = []
        for p in planes:
            if p is None:
                rows.append(mg.sum(axis=1))
            else:
                pg = jnp.take(p, ridx_j.reshape(-1), axis=0).reshape(
                    gh, -1, W)
                rows.append((pg * mg).sum(axis=1))
        stage1 = jnp.stack(rows)                      # (F, gh, W)
        # column stage on the tiny (F, gh, W) intermediate -> (F, gh, gw)
        sg = jnp.take(stage1, cidx_j.reshape(-1), axis=2).reshape(
            F, gh, gw, -1) * cmask_j[None, None, :, :]
        cell = sg.sum(axis=3)                         # (F, gh, gw)
        # cellsum of home cell g contributes to center g + (a-1, b-1):
        # accumulate into the 1-padded grid at offset (a, b)
        upd = jax.lax.dynamic_slice(acc, (0, a, b), (F, gh, gw)) + cell
        return jax.lax.dynamic_update_slice(acc, upd, (0, a, b))

    acc = jax.lax.fori_loop(
        0, 9, one_offset, jnp.zeros((F, gh + 2, gw + 2), jnp.float32))
    out = acc[:, 1:gh + 1, 1:gw + 1].reshape(F, gh * gw).T  # (K, F)
    return out[:, :C + 2], out[:, C + 2]


@functools.partial(
    jax.jit,
    static_argnames=("gh", "gw", "max_num_iter", "compactness",
                     "ccl_block", "slic_zero", "grid_step", "grid_half",
                     "spacing"))
def _slic_iterate_resolve(img: jnp.ndarray, valid: jnp.ndarray, gh: int,
                          gw: int, compactness: float, max_num_iter: int,
                          ccl_block: int = 32,
                          slic_zero: bool = False, grid_step: int = 0,
                          grid_half: int = -1,
                          spacing: Optional[Tuple[float, float]] = None):
    """SLIC k-means + gather-free scan-CCL + dense relabel as ONE device
    program: a single dispatch yields the compact connected labels and K
    — nothing but K crosses to host. (The scan CCL replaced the
    block-CCL + pointer-jump union-find, which pays a full-raster
    random-access gather per hop.)"""
    from .connectivity import scan_ccl_dense_labels

    labels = _slic_iterate(img, valid, gh, gw, compactness, max_num_iter,
                           slic_zero=slic_zero, grid_step=grid_step,
                           grid_half=grid_half, spacing=spacing)
    return scan_ccl_dense_labels(labels)


# beyond this pixel count the k-means loop and the CCL run as two device
# programs: fused, the combined HLO-temp footprint at 100 MP outgrew the
# device memory it was first run on; the GPU has more (ROADMAP A5)
_FUSE_CCL_MAX_PIXELS = 1 << 25


@functools.partial(
    jax.jit,
    static_argnames=("gh", "gw", "max_num_iter", "compactness",
                     "slic_zero", "grid_step", "grid_half", "spacing"))
def _slic_iterate(img: jnp.ndarray, valid: jnp.ndarray, gh: int, gw: int,
                  compactness: float, max_num_iter: int,
                  slic_zero: bool = False, grid_step: int = 0,
                  grid_half: int = -1,
                  spacing: Optional[Tuple[float, float]] = None
                  ) -> jnp.ndarray:
    """Core k-means loop. Returns (H, W) int32 cluster ids in [0, gh*gw);
    invalid pixels get -1. ``slic_zero`` enables SLICO's per-cluster
    adaptive compactness (max observed colour distance per cluster)."""
    H, W, C = img.shape
    K = gh * gw
    step = float(grid_step) if grid_step else math.sqrt(H * W / K)
    ratio = (compactness / step) ** 2
    centers0 = initial_centers(img, gh, gw, grid_step or None,
                               grid_half if grid_half >= 0 else None)

    def assign(centers, inv_max_dc=None):
        return slic_assign_block(img, valid, centers, 0.0, 0.0,
                                 gh, gw, H, W, ratio,
                                 inv_max_dc=inv_max_dc, step=step,
                                 spacing=spacing)

    def update(labels, centers):
        if H * W >= _STRUCTURED_UPDATE_MIN_PIXELS:
            sums, cnts = _slic_update_sums_structured(img, labels, gh, gw)
        else:
            sums, cnts = slic_update_sums(img, labels, 0.0, 0.0, K)
        means = sums / jnp.maximum(cnts, 1.0)[:, None]
        means = jnp.where((cnts > 0)[:, None], means,
                          centers.reshape(K, C + 2))
        return means.reshape(gh, gw, C + 2)

    def color_dist_max(labels, centers):
        """Per-cluster max colour distance of assigned pixels (SLICO)."""
        flat_centers = centers.reshape(K, C + 2)
        lab_safe = jnp.clip(labels, 0, K - 1)
        own = flat_centers[lab_safe.reshape(-1)].reshape(H, W, C + 2)
        d_c = jnp.sqrt(jnp.sum((img - own[..., :C]) ** 2, axis=-1))
        d_c = jnp.where(labels >= 0, d_c, 0.0)
        mx = jax.ops.segment_max(
            d_c.reshape(-1), jnp.where(labels.reshape(-1) >= 0,
                                       labels.reshape(-1), K),
            num_segments=K + 1)[:K]
        return jnp.maximum(mx, 1e-3)

    if slic_zero:
        inv0 = jnp.full((gh, gw), 1.0 / (10.0 ** 2), jnp.float32)

        def body(_, carry):
            centers, inv_max_dc, labels = carry
            labels = assign(centers, inv_max_dc)
            centers = update(labels, centers)
            mx = color_dist_max(labels, centers)
            inv_max_dc = (1.0 / (mx * mx)).reshape(gh, gw)
            return centers, inv_max_dc, labels

        centers, inv_max_dc, labels = jax.lax.fori_loop(
            0, max_num_iter, body,
            (centers0, inv0, jnp.full((H, W), -1, jnp.int32)))
        return assign(centers, inv_max_dc)

    def body(_, carry):
        centers, labels = carry
        labels = assign(centers)
        centers = update(labels, centers)
        return centers, labels

    centers, labels = jax.lax.fori_loop(
        0, max_num_iter, body,
        (centers0, jnp.full((H, W), -1, jnp.int32)))
    # final assignment with converged centers
    return assign(centers)


def slic(image,
         n_segments: int = 100,
         compactness: float = 10.0,
         max_num_iter: int = 10,
         sigma: float = 0.0,
         mask: Optional[np.ndarray] = None,
         enforce_connectivity: bool = True,
         min_size_factor: float = 0.5,
         max_size_factor: float = 3.0,
         start_label: int = 1,
         channel_axis: int = -1,
         convert2lab: Optional[bool] = None,
         slic_zero: bool = False,
         spacing=None) -> np.ndarray:
    """skimage-compatible entry point. Returns (H, W) int labels; with a
    mask, masked-out pixels get label 0 and segments start at
    max(start_label, 1) — matching skimage's masked behavior the reference
    relies on (segment_boundaries.py:55-57)."""
    lab_dev, K = slic_dense(
        image, n_segments=n_segments, compactness=compactness,
        max_num_iter=max_num_iter, sigma=sigma, mask=mask,
        enforce_connectivity=enforce_connectivity,
        min_size_factor=min_size_factor, max_size_factor=max_size_factor,
        channel_axis=channel_axis, convert2lab=convert2lab,
        slic_zero=slic_zero, spacing=spacing)
    lab_np = download_labels(lab_dev, K)

    if mask is not None:
        out = np.where(lab_np >= 0, lab_np + max(start_label, 1), 0)
    else:
        out = lab_np + start_label
    return out.astype(np.int64)


def slic_dense(image,
               n_segments: int = 100,
               compactness: float = 10.0,
               max_num_iter: int = 10,
               sigma: float = 0.0,
               mask: Optional[np.ndarray] = None,
               enforce_connectivity: bool = True,
               min_size_factor: float = 0.5,
               max_size_factor: float = 3.0,
               channel_axis: int = -1,
               convert2lab: Optional[bool] = None,
               slic_zero: bool = False,
               spacing=None) -> Tuple[jnp.ndarray, int]:
    """SLIC returning DEVICE-resident dense labels ((H, W) int32 in
    0..K-1, -1 where masked out) and K — the zero-download entry point
    for fused downstream statistics (download once with
    :func:`download_labels` when host polygonisation needs them)."""
    img = jnp.asarray(image, jnp.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if channel_axis not in (-1, 2):
        img = jnp.moveaxis(img, channel_axis, -1)
    H, W, C = img.shape
    # skimage converts 3-channel input to CIELAB unless told otherwise
    if convert2lab or (convert2lab is None and C == 3):
        from .color import rgb_to_lab
        img = rgb_to_lab(img)
    if sigma and sigma > 0:
        img = _gaussian_blur(img, float(sigma))
    spacing_yx = None
    if spacing is not None:
        # skimage `spacing`: per-axis physical pixel sizes scale the
        # spatial term of the SLIC distance (anisotropic supported)
        spacing_yx = (float(spacing[0]), float(spacing[1]))
        if spacing_yx == (1.0, 1.0):
            spacing_yx = None

    valid = (jnp.asarray(mask) != 0 if mask is not None
             else jnp.ones((H, W), bool))
    gh, gw = _grid_shape(H, W, n_segments)

    return _slic_labels_device(
        img, valid, gh, gw, float(compactness), int(max_num_iter),
        bool(slic_zero), float(min_size_factor),
        float(max_size_factor), bool(enforce_connectivity),
        grid_step=_grid_step(H, W, n_segments),
        grid_half=_grid_half(H, W, n_segments), spacing=spacing_yx)


def _slic_labels_device(img: jnp.ndarray, valid: jnp.ndarray, gh: int,
                        gw: int, compactness: float, max_num_iter: int,
                        slic_zero: bool,
                        min_size_factor: float, max_size_factor: float,
                        enforce_connectivity: bool, grid_step: int = 0,
                        grid_half: int = -1,
                        spacing: Optional[Tuple[float, float]] = None
                        ) -> Tuple[jnp.ndarray, int]:
    """Device-resident SLIC: k-means + CCL + pair union-find + dense
    relabel + small-segment merge all on device — only K (a scalar per
    stage) syncs to host. Returns ((H, W) int32 device labels 0..K-1 /
    -1 invalid, K)."""
    from .. import telemetry
    from .connectivity import (fastsv_dense_labels, merge_small_device,
                               scan_ccl_dense_labels)

    H, W, _ = img.shape
    if enforce_connectivity:
        labels = None
        if H * W <= _FUSE_CCL_MAX_PIXELS:
            with telemetry.stage("slic.iterate"):
                lab_dev, k_dev, conv_dev = _slic_iterate_resolve(
                    img, valid, gh, gw, compactness, max_num_iter,
                    slic_zero=slic_zero, grid_step=grid_step,
                    grid_half=grid_half, spacing=spacing)
                K, conv = jax.device_get((k_dev, conv_dev))
                K = int(K)
        else:
            with telemetry.stage("slic.iterate"):
                # separate device programs at large scale (see _FUSE_CCL_
                # MAX_PIXELS); the label raster stays on device in between
                labels = telemetry.sync(_slic_iterate(
                    img, valid, gh, gw, compactness, max_num_iter,
                    slic_zero=slic_zero, grid_step=grid_step,
                    grid_half=grid_half, spacing=spacing))
            with telemetry.stage("slic.connectivity"):
                # tiled scan-CCL: block-local scans + seam union —
                # bitwise-equal to the global scan, ~3x fewer
                # full-raster passes at 100 MP (see connectivity.py)
                from .connectivity import tiled_scan_ccl_dense_labels
                lab_dev, k_dev, conv_dev = tiled_scan_ccl_dense_labels(
                    labels)
                if lab_dev is None:
                    conv = False
                else:
                    K, conv = jax.device_get((k_dev, conv_dev))
                    K = int(K)
        if not bool(conv):
            # a component out-snaked the scan-CCL alternation cap (labels
            # would be silently split): exact O(log n) FastSV fallback
            with telemetry.stage("slic.ccl_fallback"):
                if labels is None:
                    labels = _slic_iterate(
                        img, valid, gh, gw, compactness, max_num_iter,
                        slic_zero=slic_zero, grid_step=grid_step,
                        grid_half=grid_half, spacing=spacing)
                lab_dev, k_dev = fastsv_dense_labels(labels)
                K = int(jax.device_get(k_dev))
        with telemetry.stage("slic.merge_small"):
            seg_size = H * W / (gh * gw)
            min_size = max(1, int(min_size_factor * seg_size))
            max_size = max(min_size + 1, int(max_size_factor * seg_size))
            lab_dev, K = merge_small_device(lab_dev, K, min_size, max_size)
        return lab_dev, K

    with telemetry.stage("slic.iterate"):
        labels = _slic_iterate(img, valid, gh, gw, compactness, max_num_iter,
                               slic_zero=slic_zero, grid_step=grid_step,
                               grid_half=grid_half, spacing=spacing)
    return _compact_first_occurrence_device(labels, gh * gw)


@functools.partial(jax.jit, static_argnames=("K",))
def _compact_first_occurrence(labels: jnp.ndarray, K: int):
    """Dense-compact arbitrary label ids in [0, K) by raster-order first
    occurrence, on device (replaces the host ``compact_labels`` download)."""
    flat = labels.reshape(-1)
    ok = flat >= 0
    idx = jnp.arange(flat.shape[0], dtype=jnp.int32)
    lab_safe = jnp.where(ok, flat, K)
    first = jax.ops.segment_min(idx, lab_safe, num_segments=K + 1)[:K]
    used = first < flat.shape[0]
    INF = jnp.int32(np.iinfo(np.int32).max)
    order = jnp.argsort(jnp.where(used, first, INF))
    rank = jnp.zeros((K,), jnp.int32).at[order].set(
        jnp.arange(K, dtype=jnp.int32))
    lab = jnp.where(ok, rank[jnp.where(ok, flat, 0)], -1)
    return lab.reshape(labels.shape), used.sum()


def _compact_first_occurrence_device(labels: jnp.ndarray, K: int
                                     ) -> Tuple[jnp.ndarray, int]:
    lab, k_dev = _compact_first_occurrence(labels, K)
    return lab, int(jax.device_get(k_dev))


@jax.jit
def _labels_to_u16(lab: jnp.ndarray) -> jnp.ndarray:
    return (lab + 1).astype(jnp.uint16)


@jax.jit
def _rle_run_ids(lab: jnp.ndarray):
    """Row-major run ids of a label raster (runs also break at row ends,
    bounding every run length by W). Returns ((N,) run ids, run count)."""
    H, W = lab.shape
    flat = lab.reshape(-1)
    prev = jnp.concatenate([jnp.full((1,), -2, flat.dtype), flat[:-1]])
    pos = jnp.arange(flat.shape[0], dtype=jnp.int32)
    start = (flat != prev) | (pos % W == 0)
    run_id = jnp.cumsum(start.astype(jnp.int32)) - 1
    return run_id, run_id[-1] + 1


@functools.partial(jax.jit, static_argnames=("R_pad", "wide"))
def _rle_compact(lab: jnp.ndarray, run_id: jnp.ndarray, R_pad: int,
                 wide: bool = False):
    """Per-run (value+1, length) arrays (zeros past the end): packed
    (R_pad, 2) uint16 when the label count allows, else int32 values +
    uint16 lengths (``wide``) — run lengths are bounded by W either way
    (runs break at row ends)."""
    N = lab.size
    flat = lab.reshape(-1)
    pos = jnp.arange(N, dtype=jnp.int32)
    starts = jax.ops.segment_min(pos, run_id, num_segments=R_pad + 1)[:R_pad]
    valid = starts < N
    starts_c = jnp.where(valid, starts, 0)
    nxt = jnp.concatenate([starts[1:], jnp.full((1,), N, starts.dtype)])
    nxt = jnp.where(nxt < N, nxt, N)
    lengths = jnp.where(valid, nxt - starts_c, 0)
    values = jnp.where(valid, flat[starts_c] + 1, 0)
    if wide:
        return values.astype(jnp.int32), lengths.astype(jnp.uint16)
    return jnp.stack([values.astype(jnp.uint16),
                      lengths.astype(jnp.uint16)], axis=1)


# direct downloads below this pixel count (RLE costs 2 extra dispatches)
_RLE_MIN_PIXELS = 1 << 22


def download_labels_rle(lab_dev: jnp.ndarray, K: int):
    """Row-wise RLE download of a label raster: (values int32 (R,),
    lengths int64 (R,), (H, W)), or None when the dense path applies
    (small raster / K or W beyond uint16). ~4 bytes per RUN crosses the
    link instead of 4 bytes per pixel."""
    H, W = lab_dev.shape
    if H * W < _RLE_MIN_PIXELS or W >= 65536:
        return None
    run_id, r_dev = _rle_run_ids(lab_dev)
    R = int(jax.device_get(r_dev))
    R_pad = max(1 << 16, 1 << (R - 1).bit_length())
    if K >= 65534:
        vals_d, lens_d = _rle_compact(lab_dev, run_id, R_pad, wide=True)
        values = np.asarray(vals_d)[:R].astype(np.int32) - 1
        lengths = np.asarray(lens_d)[:R].astype(np.int64)
        return values, lengths, (H, W)
    packed = np.asarray(_rle_compact(lab_dev, run_id, R_pad))[:R]
    values = packed[:, 0].astype(np.int32) - 1
    lengths = packed[:, 1].astype(np.int64)
    return values, lengths, (H, W)


def decode_rle_labels(values: np.ndarray, lengths: np.ndarray,
                      shape) -> np.ndarray:
    return np.repeat(values, lengths).reshape(shape)


class LazyRLERaster:
    """Dense label raster materialised from RLE on first array access —
    when polygonisation and statistics consume the RLE / device copies,
    the dense host raster never needs to exist (the host CPU here is
    burst-throttled; a 100 MP decode can sporadically cost seconds)."""

    __slots__ = ("values", "lengths", "shape", "_dense")

    def __init__(self, values, lengths, shape):
        self.values = values
        self.lengths = lengths
        self.shape = shape
        self._dense = None

    def materialise(self) -> np.ndarray:
        if self._dense is None:
            self._dense = decode_rle_labels(self.values, self.lengths,
                                            self.shape)
        return self._dense

    def __array__(self, dtype=None, copy=None):
        arr = self.materialise()
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self):
        return self.shape[0]

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self

    # ndarray-ish surface: consumers that index/compare the attached
    # label raster (boundary overlays slice ``labels[:, 1:]``,
    # ``write_geotiff`` does ``lab >= 0`` / ``lab + 1``) must behave as
    # if the dense raster were attached — materialise on demand
    @property
    def dtype(self):
        return self.values.dtype

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        h, w = self.shape
        return h * w

    def astype(self, dtype):
        return self.materialise().astype(dtype)

    def __getitem__(self, idx):
        return self.materialise()[idx]

    def __eq__(self, other):
        return self.materialise() == other

    def __ne__(self, other):
        return self.materialise() != other

    __hash__ = None

    def __ge__(self, other):
        return self.materialise() >= other

    def __gt__(self, other):
        return self.materialise() > other

    def __le__(self, other):
        return self.materialise() <= other

    def __lt__(self, other):
        return self.materialise() < other

    def __add__(self, other):
        return self.materialise() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.materialise() - other

    def __rsub__(self, other):
        return other - self.materialise()

    def __mul__(self, other):
        return self.materialise() * other

    __rmul__ = __mul__

    def min(self, *a, **kw):
        return self.materialise().min(*a, **kw)

    def max(self, *a, **kw):
        return self.materialise().max(*a, **kw)


def download_labels(lab_dev: jnp.ndarray, K: int) -> np.ndarray:
    """Single label-raster download.

    Large rasters ship as device-computed row-wise RLE — SLIC labels run
    ~15-60 px, so ~4 bytes/run instead of 4 bytes/pixel (a 100 MP label
    download drops from 400 MB to a few MB). Small rasters ship dense,
    uint16 when K allows."""
    from .. import telemetry
    with telemetry.stage("slic.download"):
        rle = download_labels_rle(lab_dev, K)
        if rle is not None:
            return decode_rle_labels(*rle)
        if K < 65535:
            u = np.asarray(_labels_to_u16(lab_dev))
            return u.astype(np.int32) - 1
        return np.asarray(lab_dev)
