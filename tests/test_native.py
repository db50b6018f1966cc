"""Native C++ runtime kernels + blocked CCL path."""
import numpy as np
import pytest

from obia_tpu import native
from obia_tpu.ops.connectivity import (merge_small_labels_host,
                                       relabel_connected)


def test_native_builds():
    assert native.available()


def test_resolve_components():
    comp = np.array([[10, 10, 20], [30, 20, 20]], np.int64)
    a = np.array([10, 20], np.int64)
    b = np.array([30, 10], np.int64)  # 10~30, 20~10 -> all root 10
    out = native.resolve_components(comp, a, b)
    assert (out == 10).all()


def test_relabel_compact():
    comp = np.array([[5, 5, -1], [9, 5, 2]], np.int64)
    lab, n = native.relabel_compact(comp)
    assert n == 3
    np.testing.assert_array_equal(lab, [[0, 0, -1], [1, 0, 2]])


def test_host_ccl_matches_python_oracle(rng):
    from tests.test_ops_slic import bfs_components
    lab = rng.integers(0, 4, (30, 40)).astype(np.int32)
    lab[3:6, 3:6] = -1
    got, n_got = native.host_ccl(lab)
    want, n_want = bfs_components(lab)
    assert n_got == n_want
    # same partition
    valid = lab >= 0
    remap = {}
    for g, w in zip(got[valid].ravel(), want[valid].ravel()):
        assert remap.setdefault(g, w) == w
    assert (got[~valid] == -1).all()


def test_relabel_connected_matches_host_ccl(rng):
    lab = rng.integers(0, 5, (70, 90)).astype(np.int32)
    lab[10:20, 10:15] = -1
    got, n_got = relabel_connected(lab, block=32)
    want, n_want = native.host_ccl(lab)
    assert n_got == n_want
    valid = lab >= 0
    remap = {}
    for g, w in zip(got[valid].ravel(), want[valid].ravel()):
        assert remap.setdefault(int(g), int(w)) == int(w)


def test_relabel_connected_nondivisible_shape(rng):
    lab = rng.integers(0, 3, (37, 53)).astype(np.int32)
    got, n_got = relabel_connected(lab, block=32)
    _, n_want = native.host_ccl(lab)
    assert n_got == n_want


def test_merge_small_labels_host():
    lab = np.zeros((20, 20), np.int32)
    lab[8:10, 8:10] = 1  # 4-px island inside big component
    lab2, n = merge_small_labels_host(lab, min_size=8)
    assert n == 1
    assert (lab2 == 0).all()
    # chain: tiny islands adjacent to each other then to the big one
    lab = np.zeros((10, 30), np.int32)
    lab[4:6, 10:12] = 1
    lab[4:6, 12:14] = 2
    lab2, n = merge_small_labels_host(lab, min_size=8)
    assert n == 1


def test_tree_shap_local_accuracy(rng):
    """Native TreeSHAP: phi sums + expected value reconstruct the forest
    prediction exactly (local accuracy)."""
    from obia_tpu.classification.trees import fit_forest, predict_proba_host
    X = rng.normal(size=(200, 5))
    y = ((X[:, 0] + 2 * X[:, 1] - X[:, 2]) > 0).astype(int)
    trees, classes = fit_forest(X, y, n_estimators=8, random_state=0,
                                max_depth=6)
    Xt = rng.normal(size=(15, 5))
    phi = native.tree_shap_forest(trees, len(classes), Xt)
    pred = np.mean([t.value[_leaf(t, Xt)] for t in trees], axis=0)
    np.testing.assert_allclose(pred, predict_proba_host(trees, Xt),
                               atol=1e-6)
    ev = np.zeros(2)
    for t in trees:
        w = t.weighted_n_node_samples
        leaves = t.children_left < 0
        ev += (t.value[leaves] * (w[leaves] / w[0])[:, None]).sum(axis=0)
    ev /= len(trees)
    np.testing.assert_allclose(phi.sum(axis=1) + ev, pred, atol=1e-8)


def _leaf(tree, X):
    """Leaf index of each row of X (float64 comparisons)."""
    node = np.zeros(len(X), np.int64)
    for _ in range(tree.max_depth):
        f = tree.feature[node]
        go = X[np.arange(len(X)), np.maximum(f, 0)] <= tree.threshold[node]
        node = np.where(f < 0, node, np.where(go, tree.children_left[node],
                                              tree.children_right[node]))
    return node


def test_merge_small_fragmented_stays_connected(rng):
    """Regression: heavily fragmented maps must merge into CONNECTED
    labels (partial LUT compression once split chains across ids), and
    small-only neighbourhoods must not deadlock."""
    from obia_tpu.ops.connectivity import relabel_connected
    raw = rng.integers(0, 4, (48, 64)).astype(np.int32)
    lab, _ = relabel_connected(raw)
    merged, k = merge_small_labels_host(lab, min_size=40)
    recc, k2 = native.host_ccl(merged)
    assert k == k2  # every merged label is one connected region
    sizes = np.bincount(merged[merged >= 0])
    assert (sizes[sizes > 0] >= 40).all() or k == 1


def test_merge_small_capped_corner_orphan():
    """A sub-min component in the bottom-right corner (no right/down
    neighbour of its own) must still be absorbed by the uncapped final
    pass — the sweep has to consider adjacencies from BOTH sides."""
    from obia_tpu import native

    lab = np.zeros((4, 4), np.int32)
    lab[3, 3] = 1  # 1-pixel component, only left/up neighbours
    out, k = native.merge_small_capped(lab, min_size=2, max_size=15)
    assert k == 1
    assert (out == 0).all()


def test_native_and_python_ring_order_match():
    """Pinch corners have two outgoing edges; both stitchers must pick the
    same one so ring ORDER (not just the ring set) agrees."""
    from obia_tpu.geometry.polygonize import polygonize_labels

    lab = np.array([[0, 1, 1],
                    [1, 0, 1],
                    [1, 1, 0]], np.int32)  # diagonal pinches for both labels
    a = polygonize_labels(lab, use_native=True)
    b = polygonize_labels(lab, use_native=False)
    assert a.keys() == b.keys()
    for label in a:
        assert len(a[label]) == len(b[label])
        for pa, pb in zip(a[label], b[label]):
            np.testing.assert_array_equal(pa.exterior.coords_array,
                                          pb.exterior.coords_array)


def test_relabel_fallback_first_occurrence_parity(monkeypatch):
    """The numpy fallback of relabel_compact must match the native path
    on ARBITRARY (non-root) ids — sorted-unique order diverges from
    first-occurrence order there (merge_small_labels_host feeds merged
    labels through this)."""
    import obia_tpu.native as native

    if not native.available():
        pytest.skip("native library unavailable")
    comp = np.array([[3, 3, 1], [1, 2, 2], [-1, 0, 0]], np.int64)
    want, k_want = native.relabel_compact(comp)
    monkeypatch.setattr(native, "_load", lambda: None)
    got, k_got = native.relabel_compact(comp)
    assert k_got == k_want
    np.testing.assert_array_equal(got, want)


def test_merge_small_capped_raises_without_native(monkeypatch):
    """Direct-call convention: no silent unmerged pass-through."""
    import obia_tpu.native as native

    monkeypatch.setattr(native, "_load", lambda: None)
    lab = np.array([[0, 1], [1, 1]], np.int32)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.merge_small_capped(lab, 2, 10)
