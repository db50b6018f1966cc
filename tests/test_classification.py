"""Classification tests: forest fit parity vs scikit-learn, device
traversal vs the host traversal, MLP, classify() API, label_segments,
end-to-end quickstart pipeline."""
import numpy as np
import pytest

from obia_tpu.classification.classify import ClassifiedImage, classify
from obia_tpu.classification.forest import JaxForestClassifier
from obia_tpu.classification.mlp import FlaxMLPClassifier
from obia_tpu.geometry import Affine, Point, box
from obia_tpu.handlers.geotif import image_from_array
from obia_tpu.segmentation.segment import segment
from obia_tpu.utils.utils import label_segments
from obia_tpu.vector import GeoDataFrame


def test_jax_forest_matches_sklearn(rng):
    """Without bootstrap or feature sampling and at depth 3, CART has one
    answer (no ties among splits on continuous data): the fitted forest
    must predict exactly what scikit-learn's does."""
    from sklearn.ensemble import RandomForestClassifier
    X = rng.normal(size=(300, 8)).astype(np.float64)
    y = (X[:, 0] + X[:, 1] * 2 + rng.normal(0, 0.3, 300) > 0).astype(int)
    kw = dict(n_estimators=5, max_depth=3, max_features=None,
              bootstrap=False, random_state=0)
    clf = JaxForestClassifier(**kw).fit(X[:200], y[:200])
    skl = RandomForestClassifier(**kw).fit(X[:200], y[:200])
    np.testing.assert_allclose(clf.predict_proba(X[200:]),
                               skl.predict_proba(X[200:]), atol=1e-6)
    np.testing.assert_array_equal(clf.predict(X[200:]), skl.predict(X[200:]))


def test_jax_forest_device_matches_host_traversal(rng):
    """The batched device traversal equals the plain host traversal of
    the same bootstrap forest."""
    from obia_tpu.classification.trees import predict_proba_host
    X = rng.normal(size=(400, 12))
    y = np.where(X[:, 0] + X[:, 3] > 0, "a", "b")
    y[X[:, 5] > 1.2] = "c"
    clf = JaxForestClassifier(n_estimators=40, random_state=1).fit(
        X[:250], y[:250])
    np.testing.assert_allclose(clf.predict_proba(X[250:]),
                               predict_proba_host(clf.trees_, X[250:]),
                               rtol=0, atol=1e-6)


def test_flax_mlp_learns(rng):
    X = rng.normal(size=(400, 4)).astype(np.float32)
    y = np.where(X[:, 0] + X[:, 1] > 0, "a", "b")
    clf = FlaxMLPClassifier(hidden_layer_sizes=(32,), max_iter=100,
                            random_state=0)
    clf.fit(X[:300], y[:300])
    acc = (clf.predict(X[300:]) == y[300:]).mean()
    assert acc > 0.9
    proba = clf.predict_proba(X[300:])
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)


def _toy_objects(rng, n=120):
    """Feature table shaped like create_objects output."""
    feats = rng.normal(size=(n, 4))
    classes = np.where(feats[:, 0] > 0, 1, 2)
    geoms = [box(i, 0, i + 1, 1) for i in range(n)]
    gdf = GeoDataFrame({
        "segment_id": np.arange(1, n + 1),
        "b0_mean": feats[:, 0], "b0_variance": np.abs(feats[:, 1]),
        "b1_mean": feats[:, 2], "b1_variance": np.abs(feats[:, 3]),
        "pai": np.full(n, np.nan),  # all-NaN column must be tolerated
    }, geometry=geoms, crs="EPSG:32633")
    return gdf, classes


def test_classify_rf_end_to_end(rng):
    segs, classes = _toy_objects(rng)
    training = segs.iloc[:80].copy()
    training["feature_class"] = classes[:80]
    out = classify(segs, training, method="rf", compute_reports=True,
                   n_estimators=30, random_state=0)
    assert isinstance(out, ClassifiedImage)
    df = out.classified
    assert "predicted_class" in df.columns and "prediction_margin" in df.columns
    assert len(df) == len(segs)
    acc = (df["predicted_class"].to_numpy()[:80] == classes[:80]).mean()
    assert acc > 0.9
    assert out.confusion_matrix is not None and out.report is not None
    assert (df["prediction_margin"] >= -1e-9).all()
    assert df["predicted_class"].dtype.name == "Int64"
    # input not mutated (quirk #17)
    assert "predicted_class" not in segs.columns
    assert out.crs.to_epsg() == 32633


def test_classify_mlp(rng):
    segs, classes = _toy_objects(rng)
    training = segs.iloc[:80].copy()
    training["feature_class"] = classes[:80].astype(str)  # string labels ok
    out = classify(segs, training, method="mlp", hidden_layer_sizes=(16,),
                   max_iter=60)
    assert out.classified["predicted_class"].iloc[0] in ("1", "2")


def test_classify_acceptable_classes(rng):
    segs, classes = _toy_objects(rng, n=40)
    training = segs.iloc[:30].copy()
    training["feature_class"] = classes[:30]
    # constrain the first 10 objects to class 2 only
    acc_gdf = GeoDataFrame({"acceptable_classes": [[2]]},
                           geometry=[box(0, 0, 10, 1)])
    out = classify(segs, training, acceptable_classes_gdf=acc_gdf,
                   method="rf", n_estimators=10, random_state=0)
    preds = out.classified["predicted_class"].to_numpy()
    assert (preds[:10] == 2).all()


def test_classify_bad_method(rng):
    segs, classes = _toy_objects(rng, n=30)
    training = segs.iloc[:20].copy()
    training["feature_class"] = classes[:20]
    with pytest.raises(ValueError):
        classify(segs, training, method="svm")


def test_label_segments():
    segs = GeoDataFrame({"segment_id": [1, 2, 3]},
                        geometry=[box(0, 0, 2, 2), box(2, 0, 4, 2),
                                  box(4, 0, 6, 2)])
    pts = GeoDataFrame({"class": [5, 5, 5, 7]},
                       geometry=[Point(1, 1), Point(1.5, 1.5),
                                 Point(3, 1), Point(3.5, 0.5)])
    labelled, mixed = label_segments(segs, pts)
    # segment 1: unanimous class 5; segment 2: mixed (5, 7); segment 3: none
    assert list(labelled["segment_id"]) == [1]
    assert labelled["feature_class"].iloc[0] == 5
    assert mixed == [2]


def test_label_segments_string_classes():
    """String class labels must survive the join — strict pandas refuses to
    setitem a str into a NaN-initialised float64 column (caught end-to-end;
    reference points tables routinely carry string classes)."""
    segs = GeoDataFrame({"segment_id": [1, 2]},
                        geometry=[box(0, 0, 2, 2), box(2, 0, 4, 2)])
    pts = GeoDataFrame({"class": ["water", "water", "land"]},
                       geometry=[Point(1, 1), Point(3, 1), Point(3.5, 0.5)])
    labelled, mixed = label_segments(segs, pts)
    assert list(labelled["feature_class"]) == ["water"]
    assert mixed == [2]


def test_label_segments_empty_join():
    segs = GeoDataFrame({"segment_id": [1]}, geometry=[box(0, 0, 1, 1)])
    pts = GeoDataFrame({"class": [5]}, geometry=[Point(99, 99)])
    labelled, mixed = label_segments(segs, pts)  # quirk #8: no KeyError
    assert len(labelled) == 0 and mixed == []


def test_quickstart_pipeline(small_rgb, tmp_path):
    """The reference README flow: open -> segment -> label -> classify ->
    write GPKG + classified GeoTIFF."""
    t = Affine(1.0, 0, 100.0, 0, -1.0, 500.0)
    img = image_from_array(small_rgb, t, crs="EPSG:32633")
    s = segment(img, method="slic", n_segments=40)
    objs = s.segments

    # label points: centroids of a few segments, classed by dominant band
    pts_geoms, pt_classes = [], []
    for i in range(0, len(objs), 3):
        c = objs.geometry.iloc[i].centroid
        pts_geoms.append(c)
        pt_classes.append(1 if objs["b0_mean"].iloc[i] > 0.4 else 2)
    pts = GeoDataFrame({"class": pt_classes}, geometry=pts_geoms)

    training, mixed = label_segments(objs, pts)
    assert len(training) > 5
    out = classify(objs, training, method="rf", n_estimators=20,
                   random_state=0, test_size=0.3)
    df = out.classified
    assert df["predicted_class"].notna().all()
    path = str(tmp_path / "classified.gpkg")
    GeoDataFrame(df).to_file(path)
    # classified raster export (quirk #7 fixed)
    tif = str(tmp_path / "classified.tif")
    out.write_geotiff(tif)
    from obia_tpu.io.tiff import TiffReader
    r = TiffReader(tif)
    assert r.read().shape[:2] == small_rgb.shape[:2]
    assert r.crs.to_epsg() == 32633


def test_classify_compute_shap(rng):
    """Native TreeSHAP: returned attributions satisfy local accuracy."""
    segs, classes = _toy_objects(rng, n=80)
    training = segs.iloc[:60].copy()
    training["feature_class"] = classes[:60]
    out = classify(segs, training, method="rf", compute_shap=True,
                   n_estimators=10, random_state=0, max_depth=5)
    sv = out.shap_values
    assert sv is not None
    n_train = 48  # 60 * (1 - test_size 0.2)
    assert sv.shape[0] == n_train
    assert sv.shape[2] == 2  # two classes
    # additivity: per-sample phi sums differ between classes by symmetry
    np.testing.assert_allclose(sv.sum(axis=(1, 2)), 0.0, atol=1e-8)


def test_kernel_shap_exact_linear():
    """Full-enumeration Kernel SHAP on a linear model equals the analytic
    Shapley values: phi_j = w_j * (x_j - E[bg_j])."""
    from obia_tpu.classification.kernel_shap import kernel_shap
    rng = np.random.default_rng(0)
    M = 5
    w = rng.normal(size=M)

    def predict(X):
        return (X @ w + 0.3)[:, None]  # (n, 1) single output

    X = rng.normal(size=(4, M))
    bg = rng.normal(size=(50, M))
    phi = kernel_shap(predict, X, bg)  # 2^5-2=30 coalitions, exhaustive
    expected = w[None, :] * (X - bg.mean(axis=0)[None, :])
    np.testing.assert_allclose(phi[:, :, 0], expected, atol=1e-8)


def test_kernel_shap_local_accuracy_sampled():
    """With M large enough to force sampling, base + sum(phi) == f(x)."""
    from obia_tpu.classification.kernel_shap import kernel_shap
    rng = np.random.default_rng(1)
    M = 12

    def predict(X):
        a = np.tanh(X[:, 0] * X[:, 1] + X[:, 2:].sum(axis=1))
        return np.stack([a, -a], axis=1)

    X = rng.normal(size=(3, M))
    bg = rng.normal(size=(20, M))
    phi = kernel_shap(predict, X, bg, nsamples=300, random_state=0)
    base = predict(bg).mean(axis=0)
    np.testing.assert_allclose(base[None] + phi.sum(axis=1), predict(X),
                               atol=1e-8)


def test_classify_mlp_compute_shap(rng):
    """MLP path uses built-in Kernel SHAP (no shap package)."""
    segs, classes = _toy_objects(rng, n=60)
    training = segs.iloc[:40].copy()
    training["feature_class"] = classes[:40]
    out = classify(segs, training, method="mlp", compute_shap=True,
                   sample_shap=True, hidden_layer_sizes=(8,), max_iter=30)
    sv = out.shap_values
    assert sv is not None
    assert sv.shape[0] == 32 and sv.shape[2] == 2  # 40*0.8 train rows
    # probabilities sum to 1 for every coalition, so per-sample class
    # attributions cancel
    np.testing.assert_allclose(sv.sum(axis=(1, 2)), 0.0, atol=1e-6)


def test_forest_fit_cache_hit_and_safety(rng):
    """Deterministic refits of the same table reuse the fitted forest;
    nondeterministic fits (random_state=None) are never cached."""
    import obia_tpu.classification.forest as F

    X = rng.random((60, 5))
    y = (X[:, 0] > 0.5).astype(int)
    F._FIT_CACHE.clear()
    a = F.JaxForestClassifier(n_estimators=10, random_state=3).fit(X, y)
    assert len(F._FIT_CACHE) == 1
    b = F.JaxForestClassifier(n_estimators=10, random_state=3).fit(X, y)
    assert b.trees_ is a.trees_  # cache hit reuses the fitted forest
    np.testing.assert_allclose(a.predict_proba(X), b.predict_proba(X))
    # different data -> different entry
    F.JaxForestClassifier(n_estimators=10, random_state=3).fit(X + 1, y)
    assert len(F._FIT_CACHE) == 2
    # nondeterministic: not cached
    F.JaxForestClassifier(n_estimators=10).fit(X, y)
    assert len(F._FIT_CACHE) == 2


def test_forest_fit_cache_no_aliased_refit():
    """A refit on an instance whose forest ALIASES a cache entry must not
    corrupt that entry (or sibling classifiers sharing it)."""
    from obia_tpu.classification.forest import _FIT_CACHE, JaxForestClassifier

    _FIT_CACHE.clear()
    rng = np.random.default_rng(0)
    X1 = rng.random((40, 4)).astype(np.float32)
    y1 = rng.integers(0, 2, 40)
    X2 = rng.random((40, 4)).astype(np.float32)
    y2 = rng.integers(0, 2, 40)
    a = JaxForestClassifier(n_estimators=5, random_state=0).fit(X1, y1)
    p1 = np.array(a.predict_proba(X1))
    b = JaxForestClassifier(n_estimators=5, random_state=0)
    b.fit(X1, y1)   # cache hit: b.trees_ aliases the cached forest
    b.fit(X2, y2)   # must refit a FRESH estimator, not the cached one
    c = JaxForestClassifier(n_estimators=5, random_state=0).fit(X1, y1)
    np.testing.assert_array_equal(np.array(c.predict_proba(X1)), p1)
    np.testing.assert_array_equal(np.array(a.predict_proba(X1)), p1)


def test_forest_fit_cache_key_random_state_kinds():
    """Only plain-int seeds are cacheable: None and RandomState instances
    draw differently between fits."""
    from obia_tpu.classification.forest import _fit_cache_key

    X = np.zeros((2, 2), np.float32)
    y = np.zeros(2, np.int32)
    assert _fit_cache_key({"random_state": None}, X, y) is None
    assert _fit_cache_key(
        {"random_state": np.random.RandomState(0)}, X, y) is None
    assert _fit_cache_key({"random_state": 3}, X, y) is not None


def test_mlp_fit_cache_keys_on_all_hyperparams():
    """batch_size/tol/n_iter_no_change change the trained weights, so
    they must miss the deterministic-refit cache."""
    from obia_tpu.classification.forest import _FIT_CACHE
    from obia_tpu.classification.mlp import FlaxMLPClassifier

    _FIT_CACHE.clear()
    rng = np.random.default_rng(1)
    X = rng.random((32, 3)).astype(np.float32)
    y = rng.integers(0, 2, 32)
    a = FlaxMLPClassifier(max_iter=4, random_state=0).fit(X, y)
    hit = FlaxMLPClassifier(max_iter=4, random_state=0).fit(X, y)
    assert hit._params is a._params  # identical config: cache hit
    miss = FlaxMLPClassifier(max_iter=4, random_state=0,
                             batch_size=8).fit(X, y)
    assert miss._params is not a._params
    miss2 = FlaxMLPClassifier(max_iter=4, random_state=0,
                              n_iter_no_change=2).fit(X, y)
    assert miss2._params is not a._params


def test_classify_single_class_training(rng):
    """Training that collapses to ONE class (tiny tables + unstratified
    split can do this) must classify with margin = top probability, not
    crash on the missing runner-up column."""
    segs, _ = _toy_objects(rng, n=30)
    training = segs.iloc[:10].copy()
    training["feature_class"] = "only"
    out = classify(segs, training, method="rf", n_estimators=10,
                   random_state=0)
    assert (out.classified["predicted_class"] == "only").all()
    np.testing.assert_allclose(out.classified["prediction_margin"], 1.0)


def test_geodataframe_survives_pandas_reconstruction(rng):
    """dropna/transpose-style pandas internals reconstruct the frame via
    _constructor(data, index=...) — the subclass must accept that form."""
    segs, classes = _toy_objects(rng, n=20)
    segs["feature_class"] = np.where(np.arange(20) % 2 == 0, "a", None)
    kept = segs.dropna(subset=["feature_class"])
    assert len(kept) == 10
    assert kept.geometry.iloc[0] is not None
    # reductions walk the same reconstruction path
    assert segs[["b0_mean", "b1_mean"]].mean().shape == (2,)


def test_classify_shap_falls_back_without_native(rng, monkeypatch):
    """compute_shap must not die on compiler-less installs: when native
    TreeSHAP is unavailable, Kernel SHAP takes over."""
    from obia_tpu import native as native_mod

    def boom(*a, **k):
        raise RuntimeError("native library unavailable: simulated")

    monkeypatch.setattr(native_mod, "tree_shap_forest", boom)
    segs, classes = _toy_objects(rng, n=60)
    training = segs.iloc[:40].copy()
    training["feature_class"] = classes[:40]
    out = classify(segs, training, method="rf", compute_shap=True,
                   n_estimators=10, random_state=0)
    assert out.shap_values is not None
    assert np.isfinite(np.asarray(out.shap_values)).all()


def test_mlp_save_load_roundtrip(rng, tmp_path):
    """load() must restore the ACTIVATION (and friends) — tanh weights in
    a relu graph would be silently wrong."""
    X = rng.normal(size=(60, 4)).astype(np.float32)
    y = np.where(X[:, 0] > 0, "a", "b")
    clf = FlaxMLPClassifier(hidden_layer_sizes=(16,), activation="tanh",
                            max_iter=20, random_state=0).fit(X, y)
    want = clf.predict_proba(X)
    p = str(tmp_path / "mlp.ckpt")
    clf.save(p)
    fresh = FlaxMLPClassifier().load(p)
    assert fresh.activation == "tanh"
    np.testing.assert_allclose(fresh.predict_proba(X), want, atol=1e-6)


def test_write_geotiff_filtered_rows_render_background(small_rgb, tmp_path,
                                                       rng):
    """Raster labels whose rows were dropped before classify() must render
    as nodata 0, not inherit the last classified row's class."""
    t = Affine(1.0, 0, 100.0, 0, -1.0, 500.0)
    img = image_from_array(small_rgb, t, crs="EPSG:32633")
    s = segment(img, method="slic", n_segments=30)
    objs = s.segments
    kept = objs.iloc[: len(objs) // 2].copy()  # drop the high segment_ids
    training = kept.iloc[: max(4, len(kept) // 2)].copy()
    training["feature_class"] = np.where(
        np.arange(len(training)) % 2 == 0, 1, 2)
    out = classify(kept, training, method="rf", n_estimators=10,
                   random_state=0)
    tif = str(tmp_path / "filtered.tif")
    out.write_geotiff(tif)
    from obia_tpu.io.tiff import TiffReader
    arr = TiffReader(tif).read()[:, :, 0]
    lab = np.asarray(s.label_raster)
    dropped = ~np.isin(lab + 1, kept["segment_id"].to_numpy())
    assert (arr[(lab >= 0) & dropped] == 0).all()
    assert (arr[np.isin(lab + 1, kept["segment_id"].to_numpy())] > 0).all()


def test_forest_predict_before_fit_raises_notfitted():
    """sklearn facade contract: predicting before fit raises
    NotFittedError, not an AttributeError on internal state."""
    from obia_tpu.classification.forest import (JaxForestClassifier,
                                                NotFittedError)

    clf = JaxForestClassifier(n_estimators=3)
    with pytest.raises(NotFittedError):
        clf.predict_proba(np.zeros((4, 3), np.float32))
    with pytest.raises(NotFittedError):
        clf.predict(np.zeros((4, 3), np.float32))


def test_classify_missing_feature_column_raises(rng):
    """A segments table missing a training feature column must fail fast
    (reindex used to insert all-NaN columns, and NaN <= threshold is
    always False in the traversal — confidently wrong predictions)."""
    from obia_tpu.vector import GeoDataFrame
    from obia_tpu.geometry import box

    n = 40
    cols = {f"b0_{s}": rng.random(n) for s in ("mean", "std", "min")}
    training = GeoDataFrame({**cols, "feature_class":
                             rng.integers(0, 2, n),
                             "segment_id": np.arange(1, n + 1)},
                            geometry=[box(i, 0, i + 1, 1) for i in range(n)])
    segs = GeoDataFrame({"b0_mean": rng.random(n),  # b0_std/b0_min missing
                         "segment_id": np.arange(1, n + 1)},
                        geometry=[box(i, 0, i + 1, 1) for i in range(n)])
    with pytest.raises(ValueError, match="missing training feature"):
        classify(segs, training, method="rf")
