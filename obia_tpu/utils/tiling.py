"""Tiled segmentation driver: checkerboard two-pass with seam handling.

API-parity module for reference obia/utils/tiling.py (``get_raster_bbox``
:19-34, ``_create_tile`` :37-59, ``create_tiled_segments`` :62-291). The
semantics are the reference's checkerboard algorithm:

* PASS 1 segments the "black" tiles ((i//ts + j//ts) % 2 == 0) at native
  tile windows.
* PASS 2 expands each "white" tile window by ``buffer`` px on every side,
  removes two bottom corner squares (side ``buffer/2``) from the tile
  polygon, deletes previously-created segments fully within the tile
  polygon, rasterises the surviving *overlapping* neighbours (plus the
  corner squares) into the mask, and re-segments only the uncovered area —
  seams stitch by construction against frozen neighbours.
* Black + white segments concatenate, ``segment_id`` renumbered 1..N,
  written to ``segments.gpkg``.

I/O goes through this framework's own GeoTIFF reader (no GDAL), and the
per-tile segmentation is the device SLIC. For the fully device-resident
sharded path, see :mod:`obia_tpu.parallel.mosaic` — this module is the
reference-compatible host orchestration.

Divergences (SURVEY.md §7 quirks):
* #13 — ``input_mask`` is genuinely optional: auto ``n_segments`` falls
  back to the full tile area when no mask is given.
* In the reference's white pass without an input mask the rasterised
  coverage is used as the mask directly (tiling.py:262-265), which
  re-segments exactly the frozen area instead of the uncovered area; here
  the coverage is inverted so the uncovered area is segmented in both
  cases.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import pandas as pd

from ..geometry.affine import Affine
from ..geometry.geom import Polygon, box
from ..geometry.rasterize import rasterize
from ..handlers.geotif import Image, image_from_array
from ..io.tiff import TiffReader
from ..segmentation.segment_boundaries import create_segments
from ..vector import GeoDataFrame


def get_raster_bbox(reader: TiffReader):
    """(min_x, min_y, max_x, max_y) of a raster (reference tiling.py:19-34)."""
    t = reader.transform
    min_x, max_y = t.c, t.f
    max_x = min_x + reader.width * t.a
    min_y = max_y + reader.height * t.e
    return (min_x, min_y, max_x, max_y)


def _create_tile(reader: TiffReader, full_data: Optional[np.ndarray],
                 i_offset: int, j_offset: int, w: int, h: int,
                 binary_mask: bool = False):
    """Window a tile out of the raster (reference tiling.py:37-59 reads
    per-window via GDAL ``ReadAsArray(i, j, w, h)``). ``full_data`` is
    None on the streaming path: the tile decodes through the codec's
    windowed read, so rasters larger than host RAM never materialise."""
    if full_data is None:
        window = reader.read(window=(j_offset, i_offset, h, w))
    else:
        window = full_data[j_offset:j_offset + h, i_offset:i_offset + w]
    if binary_mask:
        return window[:, :, 0].astype(bool)
    t = reader.transform
    tile_transform = Affine(t.a, t.b, t.c + i_offset * t.a,
                            t.d, t.e, t.f + j_offset * t.e)
    return image_from_array(window.astype(np.float32), tile_transform,
                            crs=reader.crs)


def _auto_n_segments(mask: Optional[np.ndarray], h: int, w: int,
                     pixel_area: float, crown_radius: float) -> int:
    crown_area = math.pi * (crown_radius ** 2)
    covered = float(mask.sum()) if mask is not None else float(h * w)
    return max(1, round(covered * pixel_area / crown_area))


# tile rasters are padded (with masked-out pixels) up to this shape bucket
# so edge tiles reuse the interior tiles' compiled device programs — every
# distinct tile shape otherwise compiles its own SLIC pipeline
_TILE_SHAPE_BUCKET = 64


def _pad_tile_to_bucket(image, mask: Optional[np.ndarray]):
    """Pad a tile Image (+ mask) to the next _TILE_SHAPE_BUCKET multiple.
    Padding pixels are mask=0 (invalid), so segmentation results are
    confined to the real window; the affine origin is unchanged."""
    h, w, c = image.img_data.shape
    hp = -(-h // _TILE_SHAPE_BUCKET) * _TILE_SHAPE_BUCKET
    wp = -(-w // _TILE_SHAPE_BUCKET) * _TILE_SHAPE_BUCKET
    if hp == h and wp == w:
        return image, mask
    data = np.zeros((hp, wp, c), image.img_data.dtype)
    data[:h, :w] = image.img_data
    m = np.zeros((hp, wp), bool)
    m[:h, :w] = True if mask is None else np.asarray(mask, bool)
    padded = image_from_array(data, image.transform, crs=image.crs)
    return padded, m


def create_tiled_segments(input_raster: str, output_dir: str,
                          input_mask: Optional[str] = None,
                          method: str = "slic", tile_size: int = 200,
                          buffer: int = 30, crown_radius: float = 5,
                          resume: bool = False, retries: int = 1,
                          **kwargs) -> GeoDataFrame:
    """Checkerboard two-pass tiled segmentation (reference
    tiling.py:62-291). Returns the combined GeoDataFrame and writes
    ``segments.gpkg`` into ``output_dir``."""
    if method != "slic":
        raise ValueError(
            "Currently, only the 'slic' method is supported for segmentation.")
    reader = TiffReader(input_raster)
    # stream tiles through the codec's windowed decode (planar=2 files
    # can't window-decode without a full pass, so those pre-read once)
    full = reader.read() if reader.planar == 2 else None
    mask_reader = mask_full = None
    if input_mask is not None:
        mask_reader = TiffReader(input_mask)
        mask_full = mask_reader.read() if mask_reader.planar == 2 else None

    width, height = reader.width, reader.height
    t = reader.transform
    pixel_area = abs(t.a) * abs(t.e)
    os.makedirs(output_dir, exist_ok=True)

    user_n_segments = kwargs.pop("n_segments", None)

    # tile-granular failure detection / resume (SURVEY.md §5): each tile's
    # result is durably cached and recorded in a manifest; a re-run with
    # resume=True skips completed tiles and retries failed ones
    from ..checkpoint import TileManifest
    from ..vector import read_file as _read_file
    tiles_dir = os.path.join(output_dir, "tiles")
    os.makedirs(tiles_dir, exist_ok=True)
    manifest = TileManifest(os.path.join(output_dir, "manifest.json"))

    def _run_tile(tile_id, fn):
        """Run one tile with retry + manifest bookkeeping; returns a
        GeoDataFrame or None."""
        cache = os.path.join(tiles_dir, f"{tile_id}.gpkg")
        if resume and manifest.is_done(tile_id) and os.path.exists(cache):
            return _read_file(cache)
        last_err = None
        for _ in range(max(1, retries)):
            try:
                seg = fn()
                seg.attrs = {}
                if len(seg):
                    seg.to_file(cache, layer="tile")
                manifest.mark(tile_id, "done", n_segments=len(seg))
                return seg if len(seg) else None
            except Exception as e:  # every failure retries — genuinely
                last_err = e       # empty tiles are skipped BEFORE this
        manifest.mark(tile_id, "failed", error=str(last_err))
        print(f"tile FAILED after {max(1, retries)} attempts: "
              f"{tile_id} ({last_err})")
        return None

    black_gdf = GeoDataFrame({"segment_id": []}, geometry=[])

    # ---- PASS 1: black tiles ------------------------------------------------
    frames = []
    for j in range(0, height, tile_size):
        for i in range(0, width, tile_size):
            if (i // tile_size + j // tile_size) % 2 != 0:
                continue
            w = min(tile_size, width - i)
            h = min(tile_size, height - j)
            if w == 0 or h == 0:
                continue
            image = _create_tile(reader, full, i, j, w, h)
            mask = (None if mask_reader is None
                    else _create_tile(mask_reader, mask_full, i, j, w, h,
                                      True))
            if mask is not None and not mask.any():
                # genuinely empty tile (fully masked): record and move on
                # — failures inside _run_tile always mean real errors
                manifest.mark(f"black_{j}_{i}", "done", n_segments=0)
                continue
            n_segments = user_n_segments or _auto_n_segments(
                mask, h, w, pixel_area, crown_radius)
            image, mask = _pad_tile_to_bucket(image, mask)
            # NOTE: tiles keep SYNCHRONOUS polygonisation — _run_tile
            # writes each tile's durable resume cache (and clears attrs)
            # immediately, which requires real geometry; the async
            # overlap applies to the whole-raster segment() path
            seg = _run_tile(
                f"black_{j}_{i}",
                lambda: create_segments(image=image, mask=mask,
                                        n_segments=n_segments,
                                        method="slic", **kwargs))
            if seg is not None:
                frames.append(seg)
    if frames:
        black_gdf = GeoDataFrame(pd.concat(frames, ignore_index=True))
        object.__setattr__(black_gdf, "crs", frames[0].crs)

    # ---- PASS 2: white tiles with buffered windows --------------------------
    white_frames = []
    for j in range(0, height, tile_size):
        for i in range(0, width, tile_size):
            if (i // tile_size + j // tile_size) % 2 == 0:
                continue
            i_offset = max(0, i - buffer)
            right_edge = min(width, i + tile_size + buffer)
            w = right_edge - i_offset
            j_offset = max(0, j - buffer)
            bottom_edge = min(height, j + tile_size + buffer)
            h = bottom_edge - j_offset
            if w <= 0 or h <= 0:
                continue

            image = _create_tile(reader, full, i_offset, j_offset, w, h)
            mask = (None if mask_reader is None
                    else _create_tile(mask_reader, mask_full, i_offset,
                                      j_offset, w, h, True))

            tt = image.transform
            left, top = tt * (0, 0)
            right, bottom = tt * (w, h)
            tile_polygon = box(left, bottom, right, top)

            corner = buffer / 2 * abs(tt.a)
            minx, miny, maxx, maxy = tile_polygon.bounds
            bl_square = box(minx, miny, minx + corner, miny + corner)
            br_square = box(maxx - corner, miny, maxx, miny + corner)

            def reduced_predicates(gdf):
                """within/frozen selection against the tile polygon MINUS
                the two bottom corner squares (the reference's
                .difference()): a segment fully inside the box but poking
                into a corner square must be FROZEN, not deleted — its
                corner-square pixels are masked out of re-segmentation,
                so deleting it would leave them permanently uncovered on
                edge tiles no later diagonal tile re-covers."""
                within_box = gdf.within(tile_polygon)
                pokes = gdf.intersects(bl_square) | gdf.intersects(br_square)
                within = within_box & ~pokes
                frozen = (gdf.overlaps(tile_polygon)
                          | (within_box & pokes)) & ~within
                return within, frozen

            frozen_geoms = []
            if len(black_gdf):
                within, frozen = reduced_predicates(black_gdf)
                if (within | frozen).any():
                    frozen_geoms.extend(
                        list(black_gdf.loc[frozen, "geometry"]))
                    # delete fully-within previous segments (re-segmented
                    # now)
                    crs_prev = black_gdf.crs
                    black_gdf = GeoDataFrame(black_gdf[~within])
                    object.__setattr__(black_gdf, "crs", crs_prev)
            # earlier white frames are visited PER FRAME — concatenating
            # the accumulated frames for every tile made pass 2 quadratic
            # in tile count
            for k, f in enumerate(white_frames):
                if len(f) == 0:
                    continue
                within, frozen = reduced_predicates(f)
                if not (within | frozen).any():
                    continue
                frozen_geoms.extend(list(f.loc[frozen, "geometry"]))
                if within.any():
                    crs_prev = f.crs
                    white_frames[k] = GeoDataFrame(f[~within])
                    object.__setattr__(white_frames[k], "crs", crs_prev)

            if frozen_geoms:
                shapes = [(g, 1) for g in frozen_geoms]
                shapes += [(bl_square, 1), (br_square, 1)]
                covered = rasterize(shapes, (h, w), transform=tt, fill=0,
                                    dtype=np.uint8)
                if mask is not None:
                    mask = mask.copy()
                    mask[covered == 1] = False
                else:
                    mask = covered == 0  # uncovered area (the reference
                    # passes the coverage directly here, inverting intent)
            else:
                # reference behavior: no frozen neighbours -> mask unchanged
                print(f"No overlapping black segments found for tile "
                      f"({i}, {j}).")
                if mask is None:
                    mask = np.ones((h, w), bool)

            if not mask.any():
                manifest.mark(f"white_{j}_{i}", "done", n_segments=0)
                continue
            n_segments = user_n_segments or _auto_n_segments(
                mask, h, w, pixel_area, crown_radius)
            image, mask = _pad_tile_to_bucket(image, mask)
            seg = _run_tile(
                f"white_{j}_{i}",
                lambda: create_segments(image=image,
                                        mask=mask.astype(np.uint8),
                                        n_segments=n_segments,
                                        method="slic", **kwargs))
            if seg is not None:
                white_frames.append(seg)

    parts = []
    if len(black_gdf):
        parts.append(pd.DataFrame(black_gdf))
    parts.extend(pd.DataFrame(f) for f in white_frames if len(f))
    if parts:
        combined = pd.concat(parts, ignore_index=True)
    else:
        combined = pd.DataFrame({"geometry": [], "segment_id": []})
    out = GeoDataFrame(combined)
    out["segment_id"] = range(1, len(out) + 1)
    object.__setattr__(out, "crs", reader.crs)
    out.to_file(os.path.join(output_dir, "segments.gpkg"), driver="GPKG",
                layer="segments")
    return out

