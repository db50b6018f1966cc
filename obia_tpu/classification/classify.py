"""Object classification with batched XLA inference.

API-parity module for reference obia/classification/classify.py
(``ClassifiedImage`` :12-65, ``classify`` :68-175): train/test split,
scaling, RF or MLP fit, optional confusion matrix / report / SHAP, then
per-object prediction with optional spatial class constraints and a top-2
``prediction_margin``.

Execution model: the reference's per-row ``predict_proba([x_pred[idx]])``
loop (classify.py:135-158, hot loop #3) is ONE batched device pass —
:class:`obia_tpu.classification.forest.JaxForestClassifier` (host-fit
CART forest, XLA traversal) or
:class:`obia_tpu.classification.mlp.FlaxMLPClassifier`. The
acceptable-classes spatial filter is a vectorised probability mask. The
split, scaler and metrics are small numpy equivalents of scikit-learn's
``train_test_split``, ``StandardScaler``, ``confusion_matrix`` and
``classification_report``, so no scikit-learn is needed.

Deliberate divergences (SURVEY.md §7 quirks):
* #4 — one StandardScaler is fitted on the training split and applied to
  train/test/predict (the reference fits three independent scalers; set
  ``strict_reference_scaling=True`` to reproduce that).
* #5 — batched prediction removes the positional/label indexing bug.
* #6 — ``predicted_class`` keeps the label dtype (Int64 only when labels
  are integers; strings survive).
* #17 — the input ``segments`` frame is not mutated; a copy is returned.
* #7 — CRS (and transform, when the segments carry a label raster) are
  wired into ``ClassifiedImage`` so ``write_geotiff`` works.
* All-NaN feature columns (the reference schema's point-cloud slots) are
  dropped before fitting — the reference would crash on them.
* SHAP: rf uses the built-in native TreeSHAP (exact); mlp uses the
  built-in Kernel SHAP (:mod:`.kernel_shap`). No shap package needed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..segmentation.segment_boundaries import (LABEL_RASTER_ATTR,
                                               TRANSFORM_ATTR)
from ..vector import GeoDataFrame
from .forest import JaxForestClassifier
from .mlp import FlaxMLPClassifier

_DROP_COLS = ["feature_class", "geometry", "segment_id"]


class ClassifiedImage:
    """Classified object layer + quality artefacts."""

    def __init__(self, classified, confusion_matrix, report, shap_values,
                 transform, crs, params, label_raster=None):
        self.classified = classified
        self.confusion_matrix = confusion_matrix
        self.report = report
        self.shap_values = shap_values
        self.transform = transform
        self.crs = crs
        self.params = params
        self._label_raster = label_raster

    def write_geotiff(self, output_path: str) -> None:
        """Render ``predicted_class`` per object onto the label raster and
        write a GeoTIFF (works, unlike the reference — quirk #7)."""
        if self._label_raster is None or self.transform is None:
            raise ValueError(
                "No label raster / transform available; classify() must "
                "receive segments produced by this framework's "
                "create_segments to enable raster export.")
        from ..io.tiff import write_tiff
        preds = self.classified["predicted_class"].to_numpy()
        sids = self.classified["segment_id"].to_numpy()
        codes, uniques = pd.factorize(pd.Series(preds))
        lab = np.asarray(self._label_raster)
        # LUT spans every raster label so segments NOT in the classified
        # table (e.g. rows filtered before classify) render as background
        # 0 — clipping would burn the last row's class into them
        lut = np.zeros(max(int(sids.max()), int(lab.max()) + 1) + 1,
                       np.int32)
        lut[sids] = codes + 1  # 0 = background
        out = np.where(lab >= 0, lut[lab + 1], 0)
        write_tiff(output_path, out.astype(np.int32), transform=self.transform,
                   crs=self.crs, nodata=0)


def _feature_frame(df) -> pd.DataFrame:
    x = pd.DataFrame(df).drop(columns=_DROP_COLS, errors="ignore")
    all_nan = [c for c in x.columns if x[c].isna().all()]
    if all_nan:
        x = x.drop(columns=all_nan)
    return x.astype(np.float64)


def _train_test_split(x, y, test_size: float, random_state: int):
    """scikit-learn's ``train_test_split`` for a float ``test_size``: the
    same permutation, so the same rows land in each split."""
    n = len(x)
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x.iloc[train], x.iloc[test], y.iloc[train], y.iloc[test]


class _StandardScaler:
    """Zero mean, unit (population) variance per column; constant columns
    keep scale 1."""

    def fit(self, x):
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0)
        scale = x.std(axis=0)
        self.scale_ = np.where(scale < 10 * np.finfo(np.float64).eps
                               * np.maximum(np.abs(self.mean_), 1.0),
                               1.0, scale)
        return self

    def transform(self, x):
        return (np.asarray(x, np.float64) - self.mean_) / self.scale_


def confusion_matrix(y_true, y_pred) -> np.ndarray:
    """(L, L) counts, rows true and columns predicted, over the sorted
    union of labels."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def classification_report(y_true, y_pred) -> str:
    """Per-class precision, recall, F1 and support, with accuracy and the
    macro and support-weighted averages, as a text table."""
    labels = np.unique(np.concatenate([np.asarray(y_true),
                                       np.asarray(y_pred)]))
    cm = confusion_matrix(y_true, y_pred).astype(np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.nan_to_num(tp / cm.sum(axis=0))
        recall = np.nan_to_num(tp / support)
        f1 = np.nan_to_num(2 * precision * recall / (precision + recall))
    width = max(12, max(len(str(c)) for c in labels))
    head = f"{'':>{width}} {'precision':>9} {'recall':>9} {'f1-score':>9}" \
           f" {'support':>9}"
    rows = [head, ""]
    for i, c in enumerate(labels):
        rows.append(f"{str(c):>{width}} {precision[i]:9.2f} {recall[i]:9.2f}"
                    f" {f1[i]:9.2f} {int(support[i]):9d}")
    n = support.sum()
    rows += ["", f"{'accuracy':>{width}} {'':>9} {'':>9} "
                 f"{tp.sum() / max(n, 1):9.2f} {int(n):9d}"]
    w = support / max(n, 1)
    for name, agg in (("macro avg", lambda v: v.mean()),
                      ("weighted avg", lambda v: (v * w).sum())):
        rows.append(f"{name:>{width}} {agg(precision):9.2f} "
                    f"{agg(recall):9.2f} {agg(f1):9.2f} {int(n):9d}")
    return "\n".join(rows) + "\n"


def classify(segments, training_classes, acceptable_classes_gdf=None,
             method: str = "rf", test_size: float = 0.2,
             compute_reports: bool = False, compute_shap: bool = False,
             sample_shap: bool = False,
             strict_reference_scaling: bool = False,
             **kwargs) -> ClassifiedImage:
    """Train on labelled objects, predict every object in one device pass
    (reference classify.py:68-175)."""
    from .. import telemetry

    # Ergonomic extension over the reference: accept a Segments façade
    # directly and classify its per-object feature table.
    if hasattr(segments, "segments") and not hasattr(segments, "columns"):
        segments = segments.segments

    shap_values = None
    x = _feature_frame(training_classes)
    y = training_classes["feature_class"]
    feature_cols = list(x.columns)

    x_train, x_test, y_train, y_test = _train_test_split(
        x, y, test_size=test_size, random_state=42)

    scaler = _StandardScaler().fit(x_train)
    x_train_s = scaler.transform(x_train)
    if strict_reference_scaling:
        x_test_s = _StandardScaler().fit(x_test).transform(x_test)
    else:
        x_test_s = scaler.transform(x_test)

    if method == "rf":
        classifier = JaxForestClassifier(**kwargs)
    elif method == "mlp":
        classifier = FlaxMLPClassifier(**kwargs)
    else:
        raise ValueError("An unsupported classification algorithm was requested")

    with telemetry.stage("classify.fit"):
        classifier.fit(x_train_s, np.asarray(y_train))

    if compute_shap:
        if method == "rf":
            # native path-dependent TreeSHAP (exact local accuracy; the
            # shap package is not required) — see native.tree_shap_forest.
            # Without the native library (no compiler in the install),
            # Kernel SHAP below is the pure-Python fallback.
            from .. import native
            try:
                shap_values = native.tree_shap_forest(
                    classifier.trees_, len(classifier.classes_),
                    np.asarray(x_train_s))
            except RuntimeError:
                method_for_shap = "kernel"
            else:
                method_for_shap = "tree"
        else:
            method_for_shap = "kernel"
        if method_for_shap == "kernel":
            # built-in Kernel SHAP (no shap-package dependency) — same
            # (n_samples, n_features, n_classes) convention as TreeSHAP;
            # model evals are batched device passes
            from .kernel_shap import kernel_shap
            if sample_shap and len(x_train_s) > 500:
                sel = np.random.default_rng(42).choice(
                    len(x_train_s), 500, replace=False)
                bg = np.asarray(x_train_s)[sel]
            else:
                bg = np.asarray(x_train_s)
            shap_values = kernel_shap(classifier.predict_proba,
                                      np.asarray(x_train_s), bg)

    report = None
    cm = None
    if compute_reports:
        y_pred = classifier.predict(x_test_s)
        cm = confusion_matrix(y_test, y_pred)
        report = classification_report(y_test, y_pred)

    # ---- batched prediction over every object --------------------------------
    x_pred = pd.DataFrame(segments).drop(columns=_DROP_COLS, errors="ignore")
    missing = [c for c in feature_cols if c not in x_pred.columns]
    if missing:
        # reindex would silently insert all-NaN columns, and NaN <= t is
        # always False in the tree traversal — every prediction would be
        # confidently wrong instead of failing fast
        raise ValueError(
            f"segments table is missing training feature columns "
            f"{missing}; recompute objects with the same statistics the "
            "training table was built with")
    x_pred = x_pred.reindex(columns=feature_cols).astype(np.float64)
    if strict_reference_scaling:
        x_pred_s = _StandardScaler().fit(x_pred).transform(x_pred)
    else:
        x_pred_s = scaler.transform(x_pred)

    with telemetry.stage("classify.predict"):
        proba = classifier.predict_proba(x_pred_s)      # (B, C)
    classes = np.asarray(classifier.classes_)

    allowed = np.ones_like(proba, dtype=bool)
    if acceptable_classes_gdf is not None:
        class_pos = {c: i for i, c in enumerate(classes)}
        for pos, geom in enumerate(segments.geometry):
            hits = acceptable_classes_gdf[acceptable_classes_gdf.intersects(geom)]
            if len(hits) == 0:
                continue
            acceptable = hits.iloc[0]["acceptable_classes"]
            row = np.zeros(len(classes), bool)
            for c in acceptable:
                if c in class_pos:
                    row[class_pos[c]] = True
            if row.any():
                allowed[pos] = row

    masked = np.where(allowed, proba, -np.inf)
    best_idx = masked.argmax(axis=1)
    y_pred_all = classes[best_idx]
    # top-2 margin within the allowed set (reference classify.py:151-158);
    # single-class training has no runner-up — margin is the top prob
    if proba.shape[1] < 2:
        prediction_margin = proba[:, 0]
    else:
        part = np.sort(masked, axis=1)[:, -2:]
        second = np.where(np.isfinite(part[:, 0]), part[:, 0], 0.0)
        prediction_margin = part[:, 1] - second

    out = segments.copy()  # quirk #17: don't mutate the input
    out["predicted_class"] = y_pred_all
    out["prediction_margin"] = prediction_margin.astype(float)

    # dtype coercion (reference :162-173) — integer labels become Int64,
    # other dtypes survive (quirk #6)
    geom_col = "geometry"
    for col in out.columns:
        if col != geom_col:
            if pd.api.types.is_integer_dtype(out[col].dtype):
                out[col] = out[col].astype(pd.Int64Dtype())
            elif pd.api.types.is_float_dtype(out[col].dtype):
                out[col] = out[col].astype(float)
    if np.issubdtype(np.asarray(y_pred_all).dtype, np.integer):
        out["predicted_class"] = out["predicted_class"].astype(pd.Int64Dtype())

    params = classifier.get_params()
    from ..segmentation.segment_boundaries import unwrap_attr
    crs = getattr(segments, "crs", None)
    transform = segments.attrs.get(TRANSFORM_ATTR)
    label_raster = unwrap_attr(segments.attrs.get(LABEL_RASTER_ATTR))
    return ClassifiedImage(out, cm, report, shap_values, transform, crs,
                           params, label_raster=label_raster)
