"""Per-segment point-cloud structural + radiometric statistics.

The reference stubs this entire family out (its
``calculate_structural_stats`` raises NotImplementedError at reference
segment_statistics.py:301-329 and ``create_objects`` refuses point-cloud
work at :435-439 — the PDAL/EPT dependencies were removed upstream).
This framework implements the statistics natively for in-memory point
clouds (structured numpy array or dict with ``X``/``Y``/``Z`` and
optional ``Intensity``), assigned to segments through the label raster:

* **CH** (canopy height): max of Z per segment — Z is assumed
  height-normalised (a CHM-style point cloud).
* **FHD** (foliage height diversity): Shannon entropy ``-sum p_i ln p_i``
  of the per-segment vertical return distribution in ``dz``-sized layers
  (MacArthur & MacArthur 1961).
* **PAI** (plant area index): MacArthur-Horn gap-fraction estimate
  ``ln(N_total / N_ground)`` per segment, where ground returns are those
  in the lowest layer (Z < dz). NaN when a segment has no ground returns
  (fully occluded) or no returns at all.
* **mean/variance intensity**: per-segment moments of ``Intensity``.

Everything is one vectorised pass: points → pixel via the inverse
affine, segment id via the label raster, per-segment reductions via
``np.bincount``. Point clouds are ragged and typically orders of
magnitude smaller than the raster, so this runs on host; the raster
work stays on the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _field(points, name: str):
    if isinstance(points, np.ndarray) and points.dtype.names:
        return np.asarray(points[name]) if name in points.dtype.names else None
    if isinstance(points, dict):
        v = points.get(name)
        return None if v is None else np.asarray(v)
    return None


def assign_points_to_segments(points, labels: np.ndarray, transform
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Per-point segment id via the label raster.

    Returns (seg, keep_mask) where ``seg`` indexes kept points only.
    Points outside the raster or on unlabelled (< 0) pixels are dropped.
    """
    x = _field(points, "X")
    y = _field(points, "Y")
    if x is None or y is None:
        raise ValueError("point cloud must provide 'X' and 'Y' fields")
    inv = ~transform
    col = np.floor(inv.a * x + inv.b * y + inv.c).astype(np.int64)
    row = np.floor(inv.d * x + inv.e * y + inv.f).astype(np.int64)
    H, W = labels.shape
    inside = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    seg = np.full(x.shape, -1, np.int64)
    seg[inside] = labels[row[inside], col[inside]]
    keep = seg >= 0
    return seg[keep], keep


def segment_pointcloud_stats(points, labels: np.ndarray, transform,
                             num_segments: int,
                             voxel_resolution: Optional[float] = None,
                             calc_pai: bool = True, calc_fhd: bool = True,
                             calc_ch: bool = True,
                             calc_mean_intensity: bool = True,
                             calc_variance_intensity: bool = True
                             ) -> Dict[str, np.ndarray]:
    """All requested per-segment point-cloud statistics in one pass.

    Args:
      points: structured array / dict with X, Y, Z (and Intensity).
      labels: (H, W) int32 label raster (−1 = unlabelled).
      transform: pixel→world affine of the raster.
      num_segments: K; outputs are (K,) float arrays (NaN = no data).
      voxel_resolution: vertical layer size dz for PAI/FHD. Required
        when either is requested (matches the reference signature's
        ``voxel_resolution`` argument).
    """
    K = int(num_segments)
    nan = np.full(K, np.nan)
    out: Dict[str, np.ndarray] = {}
    want_struct = calc_pai or calc_fhd or calc_ch
    if (calc_pai or calc_fhd) and voxel_resolution is None:
        raise ValueError("voxel_resolution is required for PAI/FHD")

    seg, keep = assign_points_to_segments(points, labels, transform)
    n_total = np.bincount(seg, minlength=K)[:K].astype(np.float64)
    has = n_total > 0

    if want_struct:
        z = _field(points, "Z")
        if z is None:
            raise ValueError("point cloud must provide 'Z' for structural "
                             "statistics")
        z = np.asarray(z, np.float64)[keep]
        if calc_ch:
            ch = np.full(K, -np.inf)
            np.maximum.at(ch, seg, z)
            out["ch"] = np.where(has, ch, np.nan)
        if calc_pai or calc_fhd:
            dz = float(voxel_resolution)
            zmin = np.full(K, np.inf)
            np.minimum.at(zmin, seg, z)
            layer = np.floor((z - np.where(has, zmin, 0.0)[seg]) / dz)
            layer = np.clip(layer, 0, None).astype(np.int64)
            if calc_pai:
                # MacArthur-Horn: PAI = ln(N_total / N_ground); ground =
                # lowest layer. No ground returns -> fully occluded -> NaN.
                n_ground = np.bincount(seg[layer == 0], minlength=K)[:K]
                with np.errstate(divide="ignore", invalid="ignore"):
                    pai = np.log(n_total / n_ground)
                out["pai"] = np.where(has & (n_ground > 0), pai, np.nan)
            if calc_fhd:
                nl = int(layer.max()) + 1 if layer.size else 1
                hist = np.zeros((K, nl))
                np.add.at(hist, (seg, layer), 1.0)
                p = hist / np.maximum(n_total, 1.0)[:, None]
                with np.errstate(divide="ignore", invalid="ignore"):
                    ent = -np.where(p > 0, p * np.log(p), 0.0).sum(axis=1)
                out["fhd"] = np.where(has, ent, np.nan)

    if calc_mean_intensity or calc_variance_intensity:
        inten = _field(points, "Intensity")
        if inten is None:
            if calc_mean_intensity:
                out["mean_intensity"] = nan.copy()
            if calc_variance_intensity:
                out["variance_intensity"] = nan.copy()
        else:
            inten = np.asarray(inten, np.float64)[keep]
            s1 = np.bincount(seg, weights=inten, minlength=K)[:K]
            mean = np.where(has, s1 / np.maximum(n_total, 1.0), np.nan)
            if calc_mean_intensity:
                out["mean_intensity"] = mean
            if calc_variance_intensity:
                d = inten - np.where(np.isnan(mean), 0.0, mean)[seg]
                s2 = np.bincount(seg, weights=d * d, minlength=K)[:K]
                out["variance_intensity"] = np.where(
                    has, s2 / np.maximum(n_total, 1.0), np.nan)
    return out
