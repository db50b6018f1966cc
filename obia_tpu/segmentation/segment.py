"""Segmentation façade: ``segment()`` + ``Segments``.

API-parity module for reference obia/segmentation/segment.py (``Segments``
:10-60, ``segment`` :63-93). Composes boundary creation and fused feature
extraction, returns a :class:`Segments` carrying both the polygon layer and
the per-object feature table.

Divergences (SURVEY.md §7 quirks):
* #11 — ``params`` is an instance attribute (the reference uses a
  class-level dict that leaks state across instances).
* #10 — ``calc_min`` / ``calc_max`` are exposed (the reference hardcodes
  them through ``create_objects`` defaults).
* ``to_segmented_image`` draws boundaries from the label raster (label !=
  shifted label), the XLA-friendly equivalent of skimage
  ``mark_boundaries`` (reference segment.py:49).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .segment_boundaries import (LABEL_RASTER_ATTR, create_segments)
from .segment_statistics import create_objects


def boundary_mask(labels: np.ndarray) -> np.ndarray:
    """True on pixels whose 4-neighbourhood crosses a label boundary."""
    b = np.zeros(labels.shape, bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[:, :-1] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    b[:-1, :] |= labels[1:, :] != labels[:-1, :]
    return b


class Segments:
    """Holds the polygon layer (``_segments``), the object feature table
    (``segments``), the method, and the parameters used."""

    def __init__(self, _segments, segments, method, **kwargs):
        self._segments = _segments
        self.segments = segments
        self.method = method
        self.params = dict(kwargs)  # instance attr (reference quirk #11)

    def to_segmented_image(self, image):
        """Overlay segment boundaries (yellow, like skimage
        ``mark_boundaries`` defaults) on a PIL image."""
        from PIL.Image import Image as PILImage
        from PIL.Image import fromarray
        if not isinstance(image, PILImage):
            raise TypeError("Input must be a PIL Image")
        img = np.array(image)
        from .segment_boundaries import unwrap_attr
        labels = unwrap_attr(self._segments.attrs.get(LABEL_RASTER_ATTR))
        if labels is None:
            raise ValueError("Segments carries no label raster")
        mask = boundary_mask(labels)
        out = img.astype(np.float32)
        if out.ndim == 2:
            out = np.stack([out] * 3, axis=-1)
        out[mask] = np.array([255.0, 255.0, 0.0])
        return fromarray(np.clip(out, 0, 255).astype(np.uint8))

    def write_segments(self, file_path: str) -> None:
        self.segments.to_file(file_path)

    @property
    def label_raster(self) -> Optional[np.ndarray]:
        from .segment_boundaries import unwrap_attr
        return unwrap_attr(self._segments.attrs.get(LABEL_RASTER_ATTR))


def segment(image, segmentation_bands=None, statistics_bands=None,
            method: str = "slic",
            calc_mean=True, calc_variance=True, calc_min=True, calc_max=True,
            calc_skewness=True, calc_kurtosis=True,
            calc_contrast=True, calc_dissimilarity=True,
            calc_homogeneity=True, calc_ASM=True, calc_energy=True,
            calc_correlation=True, **kwargs) -> Segments:
    """Segment + featurise in one call (reference segment.py:63-93).
    All stat flags are exposed uniformly, including calc_min/calc_max
    which the reference hardcodes (quirk #10)."""
    # host polygonisation runs in a background thread and overlaps the
    # device featurisation below; create_objects joins it before it reads
    # geometry (segment_boundaries.resolve_geometry)
    segments_gdf = create_segments(image, segmentation_bands=segmentation_bands,
                                   method=method, _async_polygonize=True,
                                   **kwargs)
    objects_gdf = create_objects(
        segments_gdf, image, spectral_bands=statistics_bands,
        calc_mean=calc_mean, calc_variance=calc_variance,
        calc_min=calc_min, calc_max=calc_max,
        calc_skewness=calc_skewness, calc_kurtosis=calc_kurtosis,
        calc_contrast=calc_contrast, calc_dissimilarity=calc_dissimilarity,
        calc_homogeneity=calc_homogeneity, calc_ASM=calc_ASM,
        calc_energy=calc_energy, calc_correlation=calc_correlation)
    return Segments(segments_gdf, objects_gdf, method, **kwargs)
