"""Segment boundary creation: raster → superpixel label raster → polygons.

API-parity module for reference obia/segmentation/segment_boundaries.py
(``normalize_band`` :11-16, ``create_segments`` :18-78) with the device
execution model: SLIC/quickshift run as XLA programs
(:mod:`obia_tpu.ops.slic`, :mod:`obia_tpu.ops.quickshift`), the whole label
raster is polygonised in ONE vectorised pass (the reference re-runs GDAL
``shapes`` on a full-image boolean mask per segment id — hot loop #1,
segment_boundaries.py:59-70), and the label raster is kept attached to the
returned GeoDataFrame so feature extraction never re-rasterises.

Deliberate divergences (SURVEY.md §7 quirks):
* #1  — the input image is never mutated; normalisation happens on a copy,
  with a constant-band guard.
* #12 — kwargs are validated per method (skimage ``quickshift`` has no
  ``mask`` parameter; passing one raises a clear error here).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..geometry.crs import CRS
from ..geometry.geom import affine_transform
from ..geometry.polygonize import polygonize_labels
from ..vector import GeoDataFrame

LABEL_RASTER_ATTR = "obia_label_raster"
LABEL_DEV_ATTR = "obia_label_raster_device"
LABEL_IDS_ATTR = "obia_label_ids"
GEOM_FUTURE_ATTR = "obia_geometry_future"
TRANSFORM_ATTR = "obia_transform"


class SharedArray:
    """Deepcopy-proof holder for large arrays stored in DataFrame.attrs:
    pandas deep-copies ``attrs`` on EVERY frame operation (drop/copy/loc),
    which costs seconds per op once a megapixel label raster rides along.
    ``np.asarray`` unwraps transparently."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.value)
        return arr.astype(dtype) if dtype is not None else arr

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self

    def __len__(self):
        return len(self.value)

    @property
    def shape(self):
        return np.asarray(self.value).shape


def unwrap_attr(value):
    """Unwrap a SharedArray (or pass other values through)."""
    if isinstance(value, SharedArray):
        return value.value
    return value


class _GeomFuture:
    """Deepcopy/pickle-proof holder for the async-polygonisation future
    (futures hold thread locks, and pandas deep-copies ``attrs`` on every
    frame operation — same rationale as :class:`SharedArray`)."""

    __slots__ = ("future",)

    def __init__(self, future):
        self.future = future

    def result(self):
        return self.future.result()

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self

    def __reduce__(self):  # pickling a pending future is meaningless
        return (_reduce_none, ())


def _reduce_none():
    return None

_SLIC_KWARGS = {
    "n_segments", "compactness", "max_num_iter", "sigma", "spacing",
    "convert2lab", "enforce_connectivity", "min_size_factor",
    "max_size_factor", "slic_zero", "start_label", "mask", "channel_axis",
}
_QUICKSHIFT_KWARGS = {
    "ratio", "kernel_size", "max_dist", "sigma", "convert2lab", "rng",
    "random_seed", "channel_axis",
}


_normalize_select_jit = None


def _normalize_select(dev, bands: tuple):
    # the jitted program is created ONCE at module scope — a fresh inner
    # jit per call misses the jit cache and recompiles on every run
    global _normalize_select_jit
    if _normalize_select_jit is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("bands",))
        def impl(dev, bands):
            bmin = dev.min(axis=(0, 1), keepdims=True)
            brange = dev.max(axis=(0, 1), keepdims=True) - bmin
            safe = jnp.where(brange > 0, brange, 1.0)
            norm = jnp.where(brange > 0, (dev - bmin) / safe, 0.0)
            return norm[:, :, list(bands)]

        _normalize_select_jit = impl
    return _normalize_select_jit(dev, bands)


def normalize_band(band: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1]; constant bands map to zeros (the
    reference divides by zero here — quirk #1)."""
    bmin = np.min(band)
    brange = np.max(band) - bmin
    if brange == 0:
        return np.zeros_like(band)
    return (band - bmin) / brange


def segment_label_raster(image, segmentation_bands=None, method: str = "slic",
                         **kwargs) -> np.ndarray:
    """Run the segmentation kernel and return the raw label raster
    ((H, W) int; 0 = masked out when a mask is given, ids from 1)."""
    num_bands = image.img_data.shape[2]
    if segmentation_bands is None:
        segmentation_bands = list(range(num_bands))
    for band in segmentation_bands:
        if band >= num_bands or band < 0:
            raise IndexError(
                f"Band index {band} out of range. Available bands indices: "
                f"0 to {num_bands - 1}.")

    # single cached upload; per-band min-max normalisation on device (one
    # jitted call — eager op-by-op dispatch is avoided: it is slow)
    import jax.numpy as jnp
    dev = (image.device_array() if hasattr(image, "device_array")
           else jnp.asarray(image.img_data, jnp.float32))
    img_to_segment = _normalize_select(dev, tuple(segmentation_bands))

    if method == "slic":
        unknown = set(kwargs) - _SLIC_KWARGS
        if unknown:
            raise TypeError(f"slic got unexpected arguments: {sorted(unknown)}")
        from ..ops.slic import slic
        return slic(img_to_segment, **kwargs)
    if method == "quickshift":
        unknown = set(kwargs) - _QUICKSHIFT_KWARGS
        if unknown:
            raise TypeError(
                f"quickshift got unexpected arguments: {sorted(unknown)} "
                "(note: quickshift takes no 'mask' — reference quirk #12)")
        from ..ops.quickshift import quickshift
        return quickshift(img_to_segment, **kwargs)
    raise Exception("An unknown segmentation method was requested.")


def create_segments(image, segmentation_bands=None, method: str = "slic",
                    **kwargs) -> GeoDataFrame:
    """Segment an :class:`obia_tpu.handlers.geotif.Image` and return a
    GeoDataFrame of polygons with ``segment_id`` 1..N (reference
    segment_boundaries.py:18-78). The label raster rides along in
    ``gdf.attrs`` for downstream fused statistics — both the host copy
    (for polygonisation) and the device-resident copy, so per-object
    statistics never re-upload the raster.

    Private ``_async_polygonize=True`` (used by :func:`segment.segment`)
    runs host polygonisation in a background thread — the native ring
    collector is a ctypes CDLL call, so the GIL is released and the
    device featurisation stages overlap it; the geometry column holds
    ``None`` placeholders until :func:`resolve_geometry` joins the
    thread (``create_objects`` does so before it reads geometry)."""
    from ..ops.connectivity import relabel_connected
    from .. import telemetry

    async_polygonize = bool(kwargs.pop("_async_polygonize", False))
    mp = image.img_data.shape[0] * image.img_data.shape[1] / 1e6
    mask = kwargs.get("mask", None)
    label_dev = None

    # SLIC with enforce_connectivity (its default) resolves connectivity
    # and compacts labels ON DEVICE; take the dense device labels directly
    # (one download for polygonisation, zero re-uploads for statistics)
    slic_dense_path = (
        method == "slic" and kwargs.get("enforce_connectivity", True))
    if slic_dense_path:
        unknown = set(kwargs) - _SLIC_KWARGS
        if unknown:
            raise TypeError(f"slic got unexpected arguments: {sorted(unknown)}")
        from ..ops.slic import (LazyRLERaster, download_labels,
                                download_labels_rle, slic_dense)
        num_bands = image.img_data.shape[2]
        bands = (list(range(num_bands)) if segmentation_bands is None
                 else list(segmentation_bands))
        for band in bands:
            if band >= num_bands or band < 0:
                raise IndexError(
                    f"Band index {band} out of range. Available bands "
                    f"indices: 0 to {num_bands - 1}.")
        import jax.numpy as jnp
        dev = (image.device_array() if hasattr(image, "device_array")
               else jnp.asarray(image.img_data, jnp.float32))
        img_to_segment = _normalize_select(dev, tuple(bands))
        dense_kwargs = dict(kwargs)
        dense_kwargs.pop("start_label", None)  # segment_id is 1..N anyway
        with telemetry.stage("segment.kernel", mp):
            label_dev, n_labels = slic_dense(img_to_segment, **dense_kwargs)
        with telemetry.stage("slic.download"):
            label_rle = download_labels_rle(label_dev, n_labels)
        if label_rle is not None:
            # the dense host raster materialises only if something
            # actually indexes it — polygonisation and statistics run
            # from the RLE / device copies
            label_raster = LazyRLERaster(*label_rle)
        else:
            label_raster = download_labels(label_dev, n_labels)
    else:
        with telemetry.stage("segment.kernel", mp):
            segments = segment_label_raster(image, segmentation_bands,
                                            method, **kwargs)
        if mask is not None:
            segments = np.where(np.asarray(mask) == 0, -1, segments)
            seg0 = np.where(segments > 0, segments, -1)
        else:
            seg0 = segments - segments.min()  # all pixels valid

        # guarantee one connected region per label (so segment_id == raster
        # label + 1 exactly), then renumber 1..N like the reference (:77)
        with telemetry.stage("segment.ccl", mp):
            label_raster, n_labels = relabel_connected(
                np.ascontiguousarray(seg0, dtype=np.int32))

    def _polygonize_geometries():
        with telemetry.stage("segment.polygonize", mp):
            from ..geometry.geom import MultiPolygon, affine_transform_coords
            from .. import native

            # packed native path: rings arrive as ONE coords array +
            # per-ring (label, n_pts, pixel-space signed area) columns, the
            # world affine is applied vectorised over every ring at once,
            # and the grouper fast-paths the one-ring-per-label common case
            # — the per-ring tuple marshalling + per-geometry affine
            # objects cost ~20 us/object and dominated this stage at 50k+
            # objects.
            packed = None
            if (label_dev is not None
                    and not isinstance(label_raster, np.ndarray)):
                # O(runs) native collector straight off the RLE download
                packed = native.polygonize_rings_rle_packed(
                    label_raster.values, label_raster.lengths,
                    label_raster.shape)
            elif native.available():
                packed = native.polygonize_rings_packed(
                    np.asarray(label_raster))
            if packed is not None:
                from ..geometry.polygonize import group_rings_packed
                rlabels, n_pts, areas, coords = packed
                coords = affine_transform_coords(coords,
                                                 image.affine_transformation)
                offsets = np.concatenate([[0], np.cumsum(n_pts)])
                polys_by_label = group_rings_packed(rlabels, areas, offsets,
                                                    coords)
                world = True
            else:
                polys_by_label = polygonize_labels(np.asarray(label_raster))
                world = False
            geometries = []
            for label in range(n_labels):
                plist = polys_by_label.get(label, [])
                if len(plist) == 1:
                    geom = plist[0]
                else:
                    # a 4-connected region pinched at a corner can trace as
                    # multiple rings; keep the 1:1 row<->label mapping with
                    # a MultiPolygon instead of splitting rows
                    geom = MultiPolygon(plist)
                if not world:
                    geom = affine_transform(geom,
                                            image.affine_transformation)
                geometries.append(geom)
            return geometries

    geom_future = None
    if async_polygonize:
        # one worker: polygonisation is single-stream C++; the thread
        # releases the GIL inside the native collector so the caller's
        # device dispatches proceed concurrently
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=1)
        geom_future = ex.submit(_polygonize_geometries)
        ex.shutdown(wait=False)
        geometries = [None] * int(n_labels)
    else:
        geometries = _polygonize_geometries()

    with telemetry.stage("segment.gdf"):
        gdf = GeoDataFrame(geometry=geometries)
    crs_obj = CRS.from_user_input(image.crs) if image.crs is not None else None
    object.__setattr__(gdf, "crs", crs_obj)
    gdf["segment_id"] = range(1, len(gdf) + 1)
    gdf.attrs[LABEL_RASTER_ATTR] = SharedArray(label_raster)
    if label_dev is not None:
        gdf.attrs[LABEL_DEV_ATTR] = SharedArray(label_dev)
    gdf.attrs[LABEL_IDS_ATTR] = SharedArray(np.arange(1, n_labels + 1))
    gdf.attrs[TRANSFORM_ATTR] = image.transform
    if geom_future is not None:
        gdf.attrs[GEOM_FUTURE_ATTR] = _GeomFuture(geom_future)
    return gdf


def resolve_geometry(gdf) -> None:
    """Join a pending async polygonisation (see ``_async_polygonize``) and
    fill the real geometry column in place. No-op when nothing pends."""
    fut = gdf.attrs.pop(GEOM_FUTURE_ATTR, None)
    if fut is not None:
        gdf["geometry"] = fut.result()
