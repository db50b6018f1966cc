"""Seed-point generation: CHM/density peaks + canonical merging.

API-parity module for reference obia/utils/seeds.py: peak detection
(``_detect_chm_peaks`` :11-22, ``_detect_den_peaks`` :25-35),
``make_density_seeds`` (:38-69), ``make_chm_seeds`` (:72-102), and
``make_canonical_seeds`` (:168-262) with its adaptive-eps stage-1
clustering, cost-weighted distance matrix, precomputed DBSCAN, optional
height split, per-cluster trim, and KD-tree NMS.

Device changes: gaussian smoothing + local-maxima detection run as XLA
reduce_window programs (:mod:`obia_tpu.ops.filters`), and the reference's
O(n^2) Python double loop over 12-sample cost-line integrals (hot loop #4,
reference seeds.py:139-165) is ONE vectorised device pass
(:func:`build_distance_matrix`). Small-N clustering (DBSCAN / cKDTree NMS)
stays host-side (sklearn / scipy), as planned in SURVEY.md §7 step 6.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..geometry.geom import Point
from ..io.tiff import TiffReader
from ..ops.filters import gaussian_filter, maximum_filter
from ..vector import GeoDataFrame, read_file


def _detect_peaks(arr: np.ndarray, v_min: float, min_dist_px: int,
                  sigma: float = 0) -> np.ndarray:
    """(row, col) indices of local maxima >= v_min (reference
    seeds.py:11-35) — smoothing + window-max on device."""
    valid = np.isfinite(arr)
    if sigma and sigma > 0:
        # masked smoothing: smoothing a -inf nodata fill would bleed -inf
        # over the whole kernel support and silently suppress every peak
        # within the truncation radius of a nodata border/hole
        w = gaussian_filter(jnp.asarray(valid, jnp.float32), float(sigma))
        v = gaussian_filter(jnp.asarray(np.where(valid, arr, 0.0),
                                        jnp.float32), float(sigma))
        x = jnp.where(jnp.asarray(valid) & (w > 1e-6), v / jnp.maximum(
            w, 1e-6), -jnp.inf)
    else:
        x = jnp.asarray(np.where(valid, arr, -np.inf), jnp.float32)
    size = 2 * int(min_dist_px) + 1
    mx = maximum_filter(x, size)
    peaks = np.asarray((x == mx) & (x >= v_min))
    return np.column_stack(np.where(peaks))


# reference-compatible aliases
def _detect_chm_peaks(arr, h_min, min_dist_px, sigma=0):
    return _detect_peaks(arr, h_min, min_dist_px, sigma)


def _detect_den_peaks(arr, v_min, min_dist_px, sigma=0):
    return _detect_peaks(arr, v_min, min_dist_px, sigma)


def _read_band_nan(path: str):
    r = TiffReader(path)
    arr = r.read()[:, :, 0].astype(np.float32)
    if r.nodata is not None:
        arr = np.where(arr == r.nodata, np.nan, arr)
    return arr, r


def _peaks_to_gdf(arr, peak_rc, reader, value_col: str) -> GeoDataFrame:
    rows, cols = peak_rc[:, 0], peak_rc[:, 1]
    t = reader.transform
    xs = t.a * (cols + 0.5) + t.b * (rows + 0.5) + t.c
    ys = t.d * (cols + 0.5) + t.e * (rows + 0.5) + t.f
    vals = arr[rows, cols]
    return GeoDataFrame({"id": np.arange(len(xs)), value_col: vals},
                        geometry=[Point(x, y) for x, y in zip(xs, ys)],
                        crs=reader.crs)


def make_density_seeds(density_raster, seeds_gpkg, d_min: float = 4.5,
                       min_dist_px: int = 4, gauss_sigma: float = 2) -> None:
    """Density-raster peak seeds → GPKG (reference seeds.py:38-69)."""
    raster_path = Path(density_raster)
    if not raster_path.exists():
        raise SystemExit(f"density raster not found: {raster_path}")
    den, reader = _read_band_nan(str(raster_path))
    peak_rc = _detect_peaks(den, d_min, min_dist_px, gauss_sigma)
    if peak_rc.size == 0:
        raise SystemExit("No density peaks found - lower D_MIN or check raster.")
    gdf = _peaks_to_gdf(den, peak_rc, reader, "den_max")
    Path(seeds_gpkg).parent.mkdir(parents=True, exist_ok=True)
    gdf.to_file(str(seeds_gpkg), driver="GPKG")
    print(f"wrote {len(gdf):,} density-seed points -> {seeds_gpkg}")


def make_chm_seeds(chm_raster, seeds_gpkg, h_min_m: float = 2.5,
                   min_dist_px: int = 3, gauss_sigma: float = 1) -> None:
    """Canopy-height-model peak seeds → GPKG (reference seeds.py:72-102)."""
    chm_path = Path(chm_raster)
    if not chm_path.exists():
        raise SystemExit(f"CHM raster not found: {chm_path}")
    chm, reader = _read_band_nan(str(chm_path))
    peak_rc = _detect_peaks(chm, h_min_m, min_dist_px, gauss_sigma)
    if peak_rc.size == 0:
        raise SystemExit("No peaks found - adjust H_MIN_M or check CHM.")
    gdf = _peaks_to_gdf(chm, peak_rc, reader, "ch_max")
    Path(seeds_gpkg).parent.mkdir(parents=True, exist_ok=True)
    gdf.to_file(str(seeds_gpkg), driver="GPKG")
    print(f"wrote {len(gdf):,} CHM seed points -> {seeds_gpkg}")


def _add_chm_height(gdf: GeoDataFrame, chm_path) -> GeoDataFrame:
    """Sample the CHM at each point (reference seeds.py:105-112)."""
    chm, reader = _read_band_nan(str(chm_path))
    inv = ~reader.transform
    vals = []
    H, W = chm.shape
    for p in gdf.geometry:
        c, r = inv * (p.x, p.y)
        # floor, not int(): truncation maps -0.4 to pixel 0, silently
        # sampling the border pixel for points just OUTSIDE the raster
        ri, ci = int(np.floor(r)), int(np.floor(c))
        vals.append(chm[ri, ci] if 0 <= ri < H and 0 <= ci < W else np.nan)
    out = gdf.copy()
    out["height"] = np.asarray(vals, np.float32)
    crs_prev = getattr(gdf, "crs", None)
    out = GeoDataFrame(out[out["height"].notna()])
    object.__setattr__(out, "crs", crs_prev)  # rebuild resets crs to None
    return out


@jax.jit
def _line_cost_matrix(xs, ys, cost, inv_rows, samples_t):
    """Vectorised replacement for the reference's O(n^2) double loop with
    12-sample line integrals (seeds.py:139-165): all (i, j, sample) cost
    lookups in one gather."""
    n = xs.shape[0]
    dx = xs[None, :] - xs[:, None]          # (n, n)
    dy = ys[None, :] - ys[:, None]
    xy_dist = jnp.hypot(dx, dy)
    # sample points along each line: (n, n, S)
    xs_line = xs[:, None, None] + samples_t[None, None, :] * dx[:, :, None]
    ys_line = ys[:, None, None] + samples_t[None, None, :] * dy[:, :, None]
    a, b, c, d, e, f = inv_rows
    cols = a * xs_line + b * ys_line + c
    rows = d * xs_line + e * ys_line + f
    H, W = cost.shape
    ri = jnp.clip(jnp.round(rows).astype(jnp.int32), 0, H - 1)
    ci = jnp.clip(jnp.round(cols).astype(jnp.int32), 0, W - 1)
    mean_cost = cost[ri, ci].mean(axis=-1)  # (n, n)
    return xy_dist, mean_cost


def build_distance_matrix(xs: np.ndarray, ys: np.ndarray, cost: np.ndarray,
                          transform, weight: float, xy_thresh: float,
                          samples: int = 8) -> np.ndarray:
    """Cost-weighted effective distance matrix (reference
    seeds.py:139-165): D = xy_dist * (1 + weight * mean_line_cost) beyond
    ``xy_thresh``, plain xy_dist within."""
    n = len(xs)
    if n == 0:
        return np.zeros((0, 0), np.float32)
    inv = ~transform
    ts = np.linspace(0.0, 1.0, samples + 2, dtype=np.float32)[1:-1]
    xy_dist, mean_cost = _line_cost_matrix(
        jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
        jnp.asarray(cost, jnp.float32),
        tuple(np.float32(v) for v in (inv.a, inv.b, inv.c, inv.d, inv.e, inv.f)),
        jnp.asarray(ts))
    xy_dist = np.asarray(xy_dist)
    mean_cost = np.asarray(mean_cost)
    D = np.where((xy_dist <= xy_thresh) | (weight == 0),
                 xy_dist, xy_dist * (1.0 + weight * mean_cost))
    # the reference computes each pair once and mirrors it (seeds.py:160);
    # enforce exact symmetry (f32 sampling order differs i->j vs j->i)
    D = np.triu(D, 1)
    D = D + D.T
    return D.astype(np.float32)


# reference-compatible alias
def _build_distance_matrix(xs, ys, cost, tfm, weight, xy_thresh, samples=8):
    return build_distance_matrix(xs, ys, cost, tfm, weight, xy_thresh, samples)


def _nms_per_crown(df: pd.DataFrame, base_r: float, scale_r: float
                   ) -> pd.DataFrame:
    """Greedy per-cluster NMS keeping the tallest seed within an adaptive
    radius (reference seeds.py:115-136)."""
    if base_r <= 0 and scale_r <= 0:
        return df
    from scipy.spatial import cKDTree
    kept = []
    for _, sub in df.groupby("cluster"):
        sub = sub.sort_values("height", ascending=False).copy()
        pts = np.c_[[g.x for g in sub.geometry], [g.y for g in sub.geometry]]
        tree = cKDTree(pts)
        keep = np.zeros(len(sub), bool)
        suppressed = np.zeros(len(sub), bool)
        for i, (x, y, h) in enumerate(zip(pts[:, 0], pts[:, 1],
                                          sub["height"])):
            if suppressed[i] or keep[i]:
                continue
            keep[i] = True
            r = max(base_r, scale_r * h)
            suppressed[tree.query_ball_point([x, y], r)] = True
        kept.append(sub[keep])
    return pd.concat(kept, ignore_index=True)


def make_canonical_seeds(chm_seeds, den_seeds, chm_raster, cost_surface,
                         out_path, eps_scale=0.4, min_eps=2, max_eps=8,
                         z_thresh=-1, min_samples=2, merge_radius=1.5,
                         cost_weight=0.5, xy_thresh=0.8, dz_merge=0,
                         keep_all_stage1=True, stage1_top=1,
                         max_per_cluster=0, nms_base=0, nms_scale=0,
                         debug_dist=True, keep=None, nodata_cost=1):
    """Merge CHM + density seeds into canonical seed points (reference
    seeds.py:168-262)."""
    from sklearn.cluster import DBSCAN
    from scipy.spatial import cKDTree

    if keep is None:
        keep = ["geometry", "height", "origin"]
    chm = read_file(str(chm_seeds))
    chm["origin"] = "chm"
    den = read_file(str(den_seeds))
    den["origin"] = "density"
    chm = chm.rename(columns={"ch_max": "height"})
    den = den.rename(columns={"den_max": "height"})
    if "height" not in chm.columns:
        chm = _add_chm_height(chm, chm_raster)
    if "height" not in den.columns:
        den = _add_chm_height(den, chm_raster)

    seeds = GeoDataFrame(pd.concat(
        [pd.DataFrame(chm)[keep], pd.DataFrame(den)[keep]],
        ignore_index=True))
    object.__setattr__(seeds, "crs", chm.crs)
    if len(seeds) == 0:
        print("No seeds after CHM sampling.", file=sys.stderr)
        sys.exit(1)

    seeds["x"] = [g.x for g in seeds.geometry]
    seeds["y"] = [g.y for g in seeds.geometry]
    pts_xy = seeds[["x", "y"]].to_numpy(dtype=float)
    tree = cKDTree(pts_xy)

    heights = seeds["height"].to_numpy(dtype=float)
    cl1 = -np.ones(len(seeds), int)
    cid = 0
    for i in range(len(seeds)):
        if cl1[i] != -1:
            continue
        eps = float(np.clip(eps_scale * heights[i], min_eps, max_eps))
        idx = tree.query_ball_point(pts_xy[i], eps)
        if z_thresh >= 0 and np.ptp(heights[idx]) > z_thresh:
            continue
        if len(idx) >= min_samples:
            cl1[idx] = cid
            cid += 1
    seeds["cluster1"] = cl1

    if keep_all_stage1:
        stage1 = seeds.copy()
    else:
        top = max(1, stage1_top)
        clustered = pd.DataFrame(seeds[seeds["cluster1"] != -1])
        tall = (clustered.sort_values("height", ascending=False)
                .groupby("cluster1").head(top))
        single = pd.DataFrame(seeds[seeds["cluster1"] == -1])
        stage1 = GeoDataFrame(pd.concat([tall, single], ignore_index=True))

    cost_reader = TiffReader(str(cost_surface))
    cost_arr = cost_reader.read()[:, :, 0].astype(np.float32)
    if cost_reader.nodata is not None:
        cost_arr[cost_arr == cost_reader.nodata] = nodata_cost

    xs = np.asarray(stage1["x"], float)
    ys = np.asarray(stage1["y"], float)
    D = build_distance_matrix(xs, ys, cost_arr, cost_reader.transform,
                              cost_weight, xy_thresh, samples=12)
    if debug_dist and len(D) > 1:
        dvals = D[np.triu_indices(len(D), 1)]
        print(f"d_eff  min/median/max = {dvals.min():.2f} / "
              f"{np.median(dvals):.2f} / {dvals.max():.2f}")

    db = DBSCAN(eps=merge_radius, min_samples=1, metric="precomputed").fit(D)
    stage1 = pd.DataFrame(stage1)
    stage1["cluster"] = db.labels_

    if dz_merge > 0:
        parts, new_id = [], 0
        for _, sub in stage1.groupby("cluster"):
            sub = sub.copy()
            if np.ptp(sub["height"]) <= dz_merge:
                sub["cluster"] = new_id
                parts.append(sub)
                new_id += 1
            else:
                mid = sub["height"].median()
                for g in (sub[sub["height"] <= mid], sub[sub["height"] > mid]):
                    if not g.empty:
                        g = g.copy()
                        g["cluster"] = new_id
                        parts.append(g)
                        new_id += 1
        stage1 = pd.concat(parts, ignore_index=True)

    if max_per_cluster > 0:
        trimmed = (stage1.sort_values("height", ascending=False)
                   .groupby("cluster").head(max_per_cluster)
                   .sort_index().reset_index(drop=True))
    else:
        trimmed = stage1.reset_index(drop=True)
    final = _nms_per_crown(trimmed, nms_base, nms_scale)

    final = final.rename(columns={"height": "ch_max"})
    final.insert(0, "id", range(len(final)))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out = GeoDataFrame(final[["id", "cluster", "ch_max", "origin",
                              "geometry"]])
    object.__setattr__(out, "crs", chm.crs)
    out.to_file(str(out_path), layer="canonical_seeds", driver="GPKG")
    print(f"canonical seeds: {len(final):,}  ->  {out_path}")
    return out
