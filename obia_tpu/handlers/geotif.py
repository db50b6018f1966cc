"""Raster container + GeoTIFF I/O.

API-parity module for reference obia/handlers/geotif.py: ``Image`` (:8-75),
``open_geotiff`` (:78-106), ``_write_geotiff`` (:109-151),
``open_binary_geotiff_as_mask`` (:154-170). Reference behavior preserved:

* ``Image.img_data`` is an (H, W, C) float32 numpy array (geotif.py:100-104).
* ``affine_transformation`` is the 6-list in shapely ``affine_transform``
  order ``[a, b, d, e, c, f]`` (geotif.py:91).
* ``open_geotiff(path, bands)`` takes 1-based band indices.
* ``open_binary_geotiff_as_mask`` returns the 4-tuple
  (mask, bbox, transform, profile) (geotif.py:170).

Divergences (deliberate, see SURVEY.md quirk #9): the image stays fully
in memory — downstream feature extraction never re-reads from disk, so an
``Image`` constructed in memory (``rasterio_obj=None`` analog) works
everywhere. The live-handle attribute is kept as ``reader`` (with a
``rasterio_obj`` alias) holding this framework's own :class:`TiffReader`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..geometry.affine import Affine
from ..geometry.crs import CRS
from ..io.tiff import TiffReader, write_tiff
from ..utils.image import (apply_clahe, apply_histogram_equalization,
                           rescale_to_8bit)

_to_f32_jit = None


def _to_f32(a):
    """Device-side cast program, created ONCE at module scope — a fresh
    ``jax.jit(lambda ...)`` per call misses the jit cache and recompiles
    on every pipeline run."""
    global _to_f32_jit
    if _to_f32_jit is None:
        import jax
        import jax.numpy as jnp
        _to_f32_jit = jax.jit(lambda x: x.astype(jnp.float32))
    return _to_f32_jit(a)


class Image:
    """Geo-referenced raster: (H, W, C) float32 data + CRS + affine."""

    def __init__(self, img_data: np.ndarray, crs, affine_transformation,
                 transform, rasterio_obj=None, nodata: Optional[float] = None,
                 raw_data: Optional[np.ndarray] = None):
        self.img_data = img_data
        self.crs = crs
        self.affine_transformation = affine_transformation
        self.transform = transform
        self.reader = rasterio_obj
        self.nodata = nodata
        self._raw = raw_data  # source-dtype copy for cheap uploads
        self._device_cache = None

    def device_array(self):
        """The raster as a device-resident float32 jnp array, uploaded ONCE
        and cached — every downstream stage (segmentation, statistics,
        GLCM) reuses it, so the host→device transfer is paid a single time.
        When the source raster has a narrow dtype (uint8/uint16) the upload
        ships the NATIVE bytes and casts to float32 on device — a 2-4x
        transfer saving. (img_data is never mutated by this framework —
        quirk #1 fixed — so the cache stays valid.)"""
        import jax
        import jax.numpy as jnp
        if (self._device_cache is None
                or self._device_cache.shape != self.img_data.shape):
            if (self._raw is not None
                    and self._raw.dtype.itemsize < 4
                    and self._raw.shape == self.img_data.shape):
                raw_dev = jnp.asarray(np.ascontiguousarray(self._raw))
                self._device_cache = _to_f32(raw_dev)
            else:
                self._device_cache = jnp.asarray(self.img_data, jnp.float32)
        return self._device_cache

    # Reference-compatible alias (reference geotif.py:44).
    @property
    def rasterio_obj(self):
        return self.reader

    @rasterio_obj.setter
    def rasterio_obj(self, value):
        self.reader = value

    @property
    def shape(self):
        return self.img_data.shape

    @property
    def height(self) -> int:
        return self.img_data.shape[0]

    @property
    def width(self) -> int:
        return self.img_data.shape[1]

    @property
    def count(self) -> int:
        return self.img_data.shape[2]

    def to_image(self, bands: Sequence[int], p_min: int = 2, p_max: int = 98,
                 stretch_type: Optional[str] = None):
        """Render three bands as a stretched RGB PIL image
        (reference geotif.py:46-75)."""
        if not isinstance(bands, (list, tuple)) or len(bands) != 3:
            raise ValueError("'bands' should be a list or tuple of exactly three elements")
        num_bands = self.img_data.shape[2]
        rgb = np.empty((self.height, self.width, 3), dtype=np.float32)
        for i, band in enumerate(bands):
            if band >= num_bands or band < 0:
                raise IndexError(
                    f"Band index {band} out of range. Available bands indices: 0 to {num_bands - 1}.")
            rgb[:, :, i] = self.img_data[:, :, band]
        rgb8 = rescale_to_8bit(rgb, min=p_min, max=p_max)
        if stretch_type == "histogram_equalization":
            rgb8 = apply_histogram_equalization(rgb8)
        elif stretch_type == "clahe":
            rgb8 = apply_clahe(rgb8)
        elif stretch_type is not None:
            raise ValueError(f"Unknown stretch_type: {stretch_type}")
        from PIL.Image import fromarray
        return fromarray(rgb8.astype(np.uint8))


def open_geotiff(image_path: str, bands: Optional[List[int]] = None) -> Image:
    """Open a GeoTIFF as an :class:`Image`; ``bands`` are 1-based indices
    (reference geotif.py:78-106)."""
    reader = TiffReader(image_path)
    full = reader.read()  # (H, W, C) native dtype
    if bands is None:
        bands = list(range(1, reader.spp + 1))
    for b in bands:
        if not 1 <= b <= reader.spp:
            raise IndexError(
                f"band index {b} out of range: bands are 1-based, "
                f"1..{reader.spp} (band 0 would silently wrap to the "
                "last band)")
    idx = [b - 1 for b in bands]
    raw = np.ascontiguousarray(full[:, :, idx])
    data = raw.astype(np.float32)
    t = reader.transform
    affine_transformation = [t.a, t.b, t.d, t.e, t.c, t.f]
    return Image(data, reader.crs, affine_transformation, t, reader,
                 nodata=reader.nodata, raw_data=raw)


def _write_geotiff(pil_image, output_path: str, crs, transform) -> None:
    """Write a PIL image as a uint8 GeoTIFF (reference geotif.py:109-151)."""
    from_pil = not isinstance(pil_image, np.ndarray)
    data = np.array(pil_image).astype(np.uint8)
    # band-first input (the reference passes band-first raw arrays). PIL
    # images are always (H, W[, C]) — never reinterpret those — and a
    # short-and-narrow last axis (<= 4) means channels, so a legitimate
    # (2, 10, 3) RGB strip is not transposed either
    if (not from_pil and data.ndim == 3 and data.shape[0] <= 4
            and data.shape[0] < data.shape[2] and data.shape[2] > 4):
        data = np.transpose(data, (1, 2, 0))
    write_tiff(output_path, data, transform=transform, crs=crs)
    print(f"Done Writing GeoTIFF at {output_path}")


def open_binary_geotiff_as_mask(mask_path: str):
    """Read band 1 as a boolean mask; returns (mask, bbox, transform, profile)
    — the reference's 4-tuple (geotif.py:154-170)."""
    reader = TiffReader(mask_path)
    arr = reader.read()[:, :, 0]
    mask_array = arr.astype(bool)
    transform = reader.transform
    width, height = reader.width, reader.height
    left, top = transform * (0, 0)
    right, bottom = transform * (width, height)
    bbox = (left, bottom, right, top)
    profile = {
        "width": width, "height": height, "count": reader.spp,
        "dtype": reader.dtype, "crs": reader.crs, "transform": transform,
        "nodata": reader.nodata,
    }
    return mask_array, bbox, transform, profile


def image_from_array(img_data: np.ndarray, transform: Affine,
                     crs=None, nodata: Optional[float] = None) -> Image:
    """Construct an in-memory :class:`Image` (no file backing). Works in all
    downstream stages — unlike the reference, which crashes on in-memory
    Images (SURVEY.md quirk #9; reference utils/utils.py:47)."""
    if img_data.ndim == 2:
        img_data = img_data[:, :, None]
    raw = (np.ascontiguousarray(img_data)
           if np.asarray(img_data).dtype.itemsize < 4 else None)
    img_data = np.asarray(img_data, dtype=np.float32)
    crs_obj = CRS.from_user_input(crs) if crs is not None else None
    t = transform
    return Image(img_data, crs_obj, [t.a, t.b, t.d, t.e, t.c, t.f], t, None,
                 nodata=nodata, raw_data=raw)
