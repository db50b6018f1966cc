"""Random-forest fitting on the host: bootstrap CART trees with the Gini
criterion and exact best splits, the algorithm of scikit-learn's
``RandomForestClassifier`` (reference classify.py:96-103).

The fit is pure numpy so the classification path needs no scikit-learn.
Training tables are small (one row per labelled object), so each node's
split search is one vectorised pass over its rows and candidate features;
only the node loop runs in Python. Inference is the device pass in
:mod:`.forest`.

Split rules follow scikit-learn: features are drawn without replacement
in random order until ``max_features`` non-constant ones have been tried;
the split minimises the children's weighted Gini impurity (the first
minimum in draw order wins); a threshold lies between two adjacent
distinct values. Thresholds are float32 values, so a float32 comparison
on the device routes every row exactly as the float64 host traversal
does.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np

# scikit-learn's FEATURE_THRESHOLD: values closer than this do not split
_FEATURE_THRESHOLD = 1e-7
_PARAMS = ("n_estimators", "max_depth", "min_samples_split",
           "min_samples_leaf", "max_features", "bootstrap", "random_state")


class Tree(NamedTuple):
    """One fitted tree, in scikit-learn's ``tree_`` layout (preorder node
    ids, children -1 at leaves)."""
    feature: np.ndarray                  # (n,) int32, -1 at leaves
    threshold: np.ndarray                # (n,) float64 (float32-exact)
    children_left: np.ndarray            # (n,) int32
    children_right: np.ndarray           # (n,) int32
    value: np.ndarray                    # (n, C) float64 class fractions
    weighted_n_node_samples: np.ndarray  # (n,) float64
    max_depth: int


def forest_params(**kwargs) -> dict:
    """The supported ``RandomForestClassifier`` keywords with their
    scikit-learn defaults; an unknown keyword raises TypeError."""
    unknown = set(kwargs) - set(_PARAMS)
    if unknown:
        raise TypeError(f"unsupported random-forest arguments: "
                        f"{sorted(unknown)} (supported: {list(_PARAMS)})")
    params = {"n_estimators": 100, "max_depth": None,
              "min_samples_split": 2, "min_samples_leaf": 1,
              "max_features": "sqrt", "bootstrap": True,
              "random_state": None}
    params.update(kwargs)
    return params


def _n_features_to_try(max_features, n_features: int) -> int:
    if max_features is None:
        return n_features
    if max_features == "sqrt":
        return max(1, int(math.sqrt(n_features)))
    if max_features == "log2":
        return max(1, int(math.log2(n_features)))
    if isinstance(max_features, float):
        return max(1, int(max_features * n_features))
    return min(int(max_features), n_features)


def _best_split(Xn, Yw, cand, min_leaf: int):
    """Best (score, feature position, row position) over candidate
    columns; ``None`` when no position is valid. Score is the children's
    summed weighted Gini impurity W_side - sum_c(n_c^2) / W_side."""
    Xc = Xn[:, cand]                                   # (m, k)
    order = np.argsort(Xc, axis=0, kind="stable")
    xs = np.take_along_axis(Xc, order, axis=0)
    cum = np.cumsum(Yw[order], axis=0)[:-1]            # (m-1, k, C)
    tot = Yw.sum(axis=0)
    wl = cum.sum(axis=2)
    wr = tot.sum() - wl
    cr = tot - cum
    with np.errstate(divide="ignore", invalid="ignore"):
        score = (wl - (cum * cum).sum(axis=2) / wl
                 + wr - (cr * cr).sum(axis=2) / wr)
    m = Xc.shape[0]
    left_n = np.arange(1, m)[:, None]
    ok = ((xs[1:] > xs[:-1] + _FEATURE_THRESHOLD)
          & (left_n >= min_leaf) & (m - left_n >= min_leaf)
          & (wl > 0) & (wr > 0))
    score = np.where(ok, score, np.inf).T               # (k, m-1)
    flat = int(np.argmin(score))                        # feature-major
    j, p = divmod(flat, m - 1)
    if not np.isfinite(score[j, p]):
        return None
    a = np.float32(xs[p, j])
    b = np.float32(xs[p + 1, j])
    thr = np.float32(a / np.float32(2) + b / np.float32(2))
    if not a <= thr < b:
        thr = a
    return j, float(thr)


def fit_tree(X: np.ndarray, y: np.ndarray, weight: np.ndarray,
             n_classes: int, max_features: int, max_depth: Optional[int],
             min_samples_split: int, min_samples_leaf: int,
             rng: np.random.Generator) -> Tree:
    """Grow one tree depth first. ``X`` is float32 (n, F), ``y`` class
    indices, ``weight`` per-row sample weights (bootstrap counts)."""
    rows = np.flatnonzero(weight > 0)
    F = X.shape[1]
    Y = np.zeros((len(y), n_classes), np.float64)
    Y[np.arange(len(y)), y] = weight
    depth_cap = np.inf if max_depth is None else max_depth
    feature, threshold, left, right, value, wsum = [], [], [], [], [], []
    tree_depth = 0
    stack = [(rows, 0, -1, False)]
    while stack:
        idx, depth, parent, is_left = stack.pop()
        node = len(feature)
        if parent >= 0:
            (left if is_left else right)[parent] = node
        Yw = Y[idx]
        counts = Yw.sum(axis=0)
        W = counts.sum()
        feature.append(-1)
        threshold.append(-2.0)
        left.append(-1)
        right.append(-1)
        value.append(counts / W)
        wsum.append(W)
        tree_depth = max(tree_depth, depth)
        impurity = 1.0 - float(((counts / W) ** 2).sum())
        if (depth >= depth_cap or len(idx) < min_samples_split
                or len(idx) < 2 * min_samples_leaf
                or impurity <= np.finfo(np.float64).eps):
            continue
        Xn = X[idx]
        nonconst = Xn.max(axis=0) > Xn.min(axis=0) + _FEATURE_THRESHOLD
        perm = rng.permutation(F)
        cand = perm[nonconst[perm]][:max_features]
        if len(cand) == 0:
            continue
        split = _best_split(Xn, Yw, cand, min_samples_leaf)
        if split is None:
            continue
        j, thr = split
        f = int(cand[j])
        go_left = Xn[:, f] <= thr
        feature[node] = f
        threshold[node] = thr
        # right pushed first: the left subtree takes the next ids
        stack.append((idx[~go_left], depth + 1, node, False))
        stack.append((idx[go_left], depth + 1, node, True))
    return Tree(np.asarray(feature, np.int32),
                np.asarray(threshold, np.float64),
                np.asarray(left, np.int32), np.asarray(right, np.int32),
                np.asarray(value, np.float64).reshape(-1, n_classes),
                np.asarray(wsum, np.float64), int(tree_depth))


def fit_forest(X, y, n_estimators: int = 100, max_depth=None,
               min_samples_split: int = 2, min_samples_leaf: int = 1,
               max_features="sqrt", bootstrap: bool = True,
               random_state=None):
    """Fit ``n_estimators`` trees. Returns (trees, classes)."""
    X = np.asarray(X, np.float32)
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    n = X.shape[0]
    k = _n_features_to_try(max_features, X.shape[1])
    rng = np.random.default_rng(random_state)
    trees: List[Tree] = []
    for _ in range(int(n_estimators)):
        if bootstrap:
            weight = np.bincount(rng.integers(0, n, n), minlength=n)
        else:
            weight = np.ones(n)
        trees.append(fit_tree(X, y_idx, weight.astype(np.float64),
                              len(classes), k, max_depth,
                              int(min_samples_split),
                              int(min_samples_leaf), rng))
    return trees, classes


def predict_proba_host(trees: List[Tree], X) -> np.ndarray:
    """Plain float64 reference traversal: (n, C) mean leaf fractions."""
    X = np.asarray(X, np.float32)
    out = 0.0
    for t in trees:
        node = np.zeros(len(X), np.int64)
        while True:
            f = t.feature[node]
            inner = f >= 0
            if not inner.any():
                break
            xv = X[np.arange(len(X)), np.where(inner, f, 0)]
            nxt = np.where(xv <= t.threshold[node], t.children_left[node],
                           t.children_right[node])
            node = np.where(inner, nxt, node)
        # leaf fractions as float32, the device tables' precision
        out = out + t.value[node].astype(np.float32).astype(np.float64)
    return out / len(trees)
