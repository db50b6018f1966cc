"""Sharded multi-tile mosaic driver: mesh-parallel segmentation +
classification (BASELINE.json config 5).

The reference scales out with a sequential checkerboard tile loop and
overlap-buffer seam reconciliation (reference tiling.py:62-291). Here the
mosaic shards 2-D over a ``jax.sharding.Mesh`` and EVERY device stage is
sharded end-to-end: SLIC k-means runs with replicated centers and psum
reductions, connectivity + small-segment merging run per shard with the
cross-shard equivalences reduced from one-pixel boundary strips, and
per-object statistics (spectral moments + GLCM texture) reduce with
psum/pmin/pmax across devices (:mod:`obia_tpu.parallel.sharded`). Tile seams
**never exist during clustering** — every pixel sees the same global
centers — and the full label raster never gathers onto one device.
``seam_overhead`` quantifies the residual boundary deviation vs a
single-device run — the BASELINE 'seam-merge overhead %' metric.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.slic import _grid_shape
from .sharded import (make_mesh, shard_raster, sharded_ccl_merge,
                      sharded_glcm_props, sharded_merge_small,
                      sharded_slic_assign, sharded_spectral_moments)


def segment_mosaic_device(image_data: np.ndarray,
                          n_segments: int = 1000,
                          compactness: float = 10.0,
                          max_num_iter: int = 10,
                          mesh=None,
                          min_size_factor: float = 0.5,
                          max_size_factor: float = 3.0,
                          n_devices: Optional[int] = None):
    """Segment a large raster across all devices of a mesh, keeping the
    label raster SHARDED end-to-end (per-shard scan-CCL + strip merge +
    sharded small-segment merge — no gather to one device).

    Args:
      image_data: (H, W, C) float array (normalised bands recommended).
    Returns:
      (mesh, (Hp, Wp) sharded int32 labels 0..K-1 / -1 on pads, K,
      (H, W) crop).
    """
    if mesh is None:
        mesh = make_mesh(n_devices)
    H, W, C = image_data.shape
    # padded shape is known from the mesh alone — build the edge-extended
    # array on host FIRST so the raster crosses the host link exactly
    # once
    ty, tx = mesh.devices.shape
    Hp = ((H + ty - 1) // ty) * ty
    Wp = ((W + tx - 1) // tx) * tx
    img = np.asarray(image_data, np.float32)
    if (Hp, Wp) != (H, W):
        # edge-extend padding (pads join clustering like the single-device
        # path never sees them; they are marked invalid before CCL)
        full = np.zeros((Hp, Wp, C), np.float32)
        full[:H, :W] = img
        if Hp != H:
            full[H:, :W] = img[H - 1:H, :]
        if Wp != W:
            full[:, W:] = full[:, W - 1:W]
        img = full
    img_sharded, _ = shard_raster(mesh, img)

    labels, _ = sharded_slic_assign(mesh, img_sharded, n_segments,
                                    compactness=compactness,
                                    max_num_iter=max_num_iter)

    lab_dev, K = sharded_ccl_merge(mesh, labels, (H, W),
                                   n_segments=n_segments)
    gh, gw = _grid_shape(Hp, Wp, n_segments)
    seg_size = Hp * Wp / (gh * gw)
    min_size = max(1, int(min_size_factor * seg_size))
    max_size = max(min_size + 1, int(max_size_factor * seg_size))
    lab_dev, K = sharded_merge_small(mesh, lab_dev, K, min_size, max_size)
    return mesh, lab_dev, K, (H, W)


def segment_mosaic(image_data: np.ndarray,
                   n_segments: int = 1000,
                   compactness: float = 10.0,
                   max_num_iter: int = 10,
                   mesh=None,
                   min_size_factor: float = 0.5,
                   max_size_factor: float = 3.0,
                   n_devices: Optional[int] = None
                   ) -> Tuple[np.ndarray, int]:
    """Host-array convenience wrapper around
    :func:`segment_mosaic_device`. Returns ((H, W) int32 compact labels
    0..K-1, K)."""
    mesh, lab_dev, K, (H, W) = segment_mosaic_device(
        image_data, n_segments=n_segments, compactness=compactness,
        max_num_iter=max_num_iter, mesh=mesh,
        min_size_factor=min_size_factor, max_size_factor=max_size_factor,
        n_devices=n_devices)
    return np.asarray(lab_dev)[:H, :W], K


def mosaic_pipeline(image, n_segments: int = 1000, compactness: float = 10.0,
                    mesh=None, output_gpkg: Optional[str] = None,
                    training_classes=None, classify_kwargs: Optional[dict] = None,
                    objects_kwargs: Optional[dict] = None,
                    **mosaic_kwargs):
    """Full mesh-parallel pipeline (BASELINE config 5): sharded segmentation
    over the mesh → SHARDED fused per-object features (spectral psum +
    halo-exchange GLCM) → optional classification → GeoPackage out. The
    raster-sized arrays stay sharded for every device stage; only the RLE
    label download for host polygonisation and the K-sized feature tables
    cross to the host.

    Args:
      image: :class:`obia_tpu.handlers.geotif.Image` (or in-memory Image).
      training_classes: optional labelled objects GeoDataFrame (with
        ``feature_class``) to also classify every object.
    Returns the objects GeoDataFrame (with ``predicted_class`` columns when
    classification ran).
    """
    from ..geometry.geom import MultiPolygon, affine_transform
    from ..geometry.polygonize import polygonize_labels
    from ..ops.stats import pad_num_segments
    from ..segmentation.segment_boundaries import (LABEL_IDS_ATTR,
                                                   LABEL_RASTER_ATTR,
                                                   TRANSFORM_ATTR,
                                                   SharedArray)
    from ..segmentation.segment_statistics import create_objects
    from ..vector import GeoDataFrame
    from .. import telemetry

    if mesh is None:
        # honor an n_devices kwarg (MosaicConfig knob): building the mesh
        # over all devices here would silently override it downstream
        mesh = make_mesh(mosaic_kwargs.get("n_devices"))

    norm = image.img_data.astype(np.float32)
    lo = norm.min(axis=(0, 1), keepdims=True)
    rng_ = norm.max(axis=(0, 1), keepdims=True) - lo
    norm = np.where(rng_ > 0, (norm - lo) / np.where(rng_ > 0, rng_, 1), 0.0)

    mesh, lab_dev, n_labels, (H, W) = segment_mosaic_device(
        norm, n_segments=n_segments, compactness=compactness, mesh=mesh,
        **mosaic_kwargs)

    with telemetry.stage("mosaic.download"):
        labels = np.asarray(lab_dev)[:H, :W]
    with telemetry.stage("mosaic.polygonize"):
        polys = polygonize_labels(labels)
        geometries = []
        for label in range(n_labels):
            plist = polys.get(label, [])
            if len(plist) == 1:
                geom = plist[0]
            else:
                # a 4-connected region pinched at a corner traces as
                # multiple rings; a MultiPolygon keeps the 1:1 row<->label
                # contract that the sharded statistics backend relies on
                geom = MultiPolygon(plist)
            geometries.append(
                affine_transform(geom, image.affine_transformation))
    gdf = GeoDataFrame(geometry=geometries)
    object.__setattr__(gdf, "crs", image.crs)
    gdf["segment_id"] = range(1, len(gdf) + 1)
    gdf.attrs[LABEL_RASTER_ATTR] = SharedArray(labels)
    gdf.attrs[LABEL_IDS_ATTR] = SharedArray(np.arange(1, n_labels + 1))
    gdf.attrs[TRANSFORM_ATTR] = image.transform

    # sharded statistics backend: the ORIGINAL (unnormalised) bands shard
    # over the mesh; per-object reductions psum across devices
    img_sharded, _ = shard_raster(mesh, image.img_data.astype(np.float32))

    def spectral(K):
        K_pad = pad_num_segments(K)
        names, dev = sharded_spectral_moments(mesh, img_sharded, lab_dev,
                                              K_pad, packed=True)
        # ONE download; K-trim on host (a device [:K] per stat is an
        # eager dispatch each)
        return names, np.asarray(dev)[:, :K, :]

    def glcm(K, levels, distance, angles, compute_asm, bands):
        from ..ops.glcm import _ASM_HIST_MAX_ELEMS
        K_pad = pad_num_segments(K)
        if compute_asm and K_pad * levels * levels > _ASM_HIST_MAX_ELEMS:
            # exact-ASM joint-histogram table would overflow the fused
            # int32 key / device memory at this (K, levels); the
            # sorted-run exact ASM has no sharded reduction, so fall back
            # to the single-device sort-path kernel (memory-permitting)
            # rather than silently alias histogram rows
            from ..ops.glcm import segment_glcm_props_packed
            names, packed = segment_glcm_props_packed(
                jnp.asarray(image.img_data.astype(np.float32)),
                jnp.asarray(np.ascontiguousarray(labels, np.int32)), K,
                levels=levels, distance=distance, angles=angles,
                compute_asm=compute_asm, bands=bands)
            return names, packed
        names, dev = sharded_glcm_props(mesh, img_sharded, lab_dev, K_pad,
                                        levels=levels, distance=distance,
                                        angles=angles,
                                        compute_asm=compute_asm,
                                        bands=bands, packed=True)
        out = np.asarray(dev)  # ONE download: (B, 6, K_pad)
        return names, np.transpose(out, (1, 2, 0))[:, :K, :]

    objects = create_objects(gdf, image,
                             _exec={"spectral": spectral, "glcm": glcm},
                             **(objects_kwargs or {}))

    if training_classes is not None:
        from ..classification.classify import classify
        result = classify(objects, training_classes,
                          **(classify_kwargs or {}))
        objects = GeoDataFrame(result.classified)
        object.__setattr__(objects, "crs", image.crs)

    if output_gpkg:
        objects.to_file(output_gpkg, layer="segments")
    return objects


def boundary_map(labels: np.ndarray) -> np.ndarray:
    b = np.zeros(labels.shape, bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    return b


def seam_overhead(labels_sharded: np.ndarray,
                  labels_single: np.ndarray,
                  tolerance_px: int = 1) -> float:
    """Seam-merge overhead %: fraction of the sharded run's boundary
    pixels that have no single-device boundary within ``tolerance_px``
    (the BASELINE 'seam-merge overhead' metric; 0 = boundaries agree)."""
    from ..ops.filters import maximum_filter

    b_sh = boundary_map(labels_sharded)
    b_si = boundary_map(labels_single)
    if tolerance_px > 0:
        size = 2 * tolerance_px + 1
        dil = np.asarray(maximum_filter(
            jnp.asarray(b_si, jnp.float32), size)) > 0
    else:
        dil = b_si
    n_b = b_sh.sum()
    if n_b == 0:
        return 0.0
    unmatched = (b_sh & ~dil).sum()
    return 100.0 * float(unmatched) / float(n_b)
