"""Whole-raster detection inference.

API-parity module for reference obia/detection/predict.py (``predict(model,
image_path, device, score_threshold)`` :14-57): reads the full N-band
raster, global min-max scales to uint8 (:30-34), one forward pass, filters
by score threshold, returns {"boxes", "scores", "labels"} numpy arrays.
Decoding + NMS replace torchvision's internal postprocessing; NMS runs
per class (torchvision ``batched_nms`` semantics — boxes of different
labels never suppress each other).
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..io.tiff import TiffReader
from .anchors import decode_boxes, nms_numpy
from .models import DetectionModel


@functools.partial(jax.jit, static_argnums=(0,))
def _forward_jit(module, variables, images):
    return module.apply(variables, images, train=False)


def infer_image_array(model: DetectionModel, hwc: np.ndarray,
                      score_threshold: float,
                      nms_threshold: float) -> Dict[str, np.ndarray]:
    """Array-level inference shared by :func:`predict` and
    ``metrics.evaluate_model`` (one pipeline to keep in sync): pad to the
    128 shape bucket, ONE jitted forward (compiled per shape — eager
    apply dispatched the ~100-layer network op-by-op per image), decode,
    score, per-class NMS, clip to the un-padded extent."""
    hwc = np.asarray(hwc, np.float32)
    H, W, C = hwc.shape
    ph = ((H + 127) // 128) * 128
    pw = ((W + 127) // 128) * 128
    padded = np.zeros((1, ph, pw, C), np.float32)
    padded[0, :H, :W] = hwc

    variables = {"params": model.params, "batch_stats": model.batch_stats}
    cls_logits, box_deltas = _forward_jit(model.module, variables,
                                          jnp.asarray(padded))
    anchors = jnp.asarray(model.anchors((ph, pw)))
    boxes = np.asarray(decode_boxes(anchors, box_deltas[0]))
    scores_all = np.asarray(jax.nn.sigmoid(cls_logits[0]))  # (N, K)

    # best non-background class per anchor (class slot 0 = background)
    cls_scores = scores_all[:, 1:] if scores_all.shape[1] > 1 else scores_all
    labels = cls_scores.argmax(axis=1) + (1 if scores_all.shape[1] > 1 else 0)
    scores = cls_scores.max(axis=1)

    keep = scores >= score_threshold
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    if len(boxes):
        # per-class NMS via the batched_nms offset trick: shift each
        # class onto a disjoint coordinate range so cross-class boxes
        # can never overlap, then run one plain NMS
        off = labels.astype(np.float64)[:, None] * (float(boxes.max()) + 1.0)
        keep_idx = nms_numpy(boxes + off, scores, nms_threshold)
        boxes, scores, labels = (boxes[keep_idx], scores[keep_idx],
                                 labels[keep_idx])
        # clip to raster extent
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
    return {"boxes": boxes, "scores": scores, "labels": labels}


def predict(model: DetectionModel, image_path: str,
            score_threshold: float = 0.5,
            nms_threshold: float = 0.5) -> Dict[str, np.ndarray]:
    """Detections on one raster (the reference's ``device`` argument is
    gone — JAX runs on its default device)."""
    image_array = TiffReader(image_path).read()

    data_min = float(image_array.min())
    data_max = float(image_array.max())
    if data_max > data_min:
        # 255.0: float arithmetic — `255 *` on an integer raster keeps
        # the integer dtype and wraps modulo the dtype (uint16 scenes
        # normalised to modular noise)
        image_array = 255.0 * (image_array.astype(np.float64) - data_min) / \
            (data_max - data_min + 1e-8)
    image_array = np.clip(image_array, 0, 255).astype(np.uint8)
    return infer_image_array(model, image_array, score_threshold,
                             nms_threshold)
