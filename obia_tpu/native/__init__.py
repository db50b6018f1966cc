"""Native (C++) host-runtime kernels, bound via ctypes.

Builds ``src/obia_native.cpp`` on first use (cached as a shared object
next to the source, which git does not track). Compiler-less installs
still work: the hot-path entry points (polygonize/union-find/relabel) return None and their
callers use the numpy/JAX implementations, and ``classify()`` falls back
from TreeSHAP to the built-in Kernel SHAP; only a DIRECT call to
``tree_shap_forest``/``host_ccl`` raises a clear RuntimeError. See the
.cpp for the component list (union-find resolution, dense relabelling,
host CCL, capped merging, polygonizer, TreeSHAP).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "obia_native.cpp")
_LIB_PATH = os.path.join(_HERE, "_obia_native.so")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    # build under a temporary name and rename into place: concurrent
    # processes (test workers on a fresh checkout) may build at once, and
    # none of them may load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:  # compiler missing
        return str(e)
    if res.returncode != 0:
        return res.stderr[:2000]
    os.replace(tmp, _LIB_PATH)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        # a failed build stays failed — re-running the 120 s g++ attempt
        # on every native.available() call would tax each scene
        return None
    if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
        _build_error = _build()
        if _build_error:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _build_error = str(e)
        return None

    lib.resolve_components.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.relabel_compact.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.relabel_compact.restype = ctypes.c_int64
    lib.host_ccl.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.host_ccl.restype = ctypes.c_int64
    lib.polygonize_build_rle.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.polygonize_build_rle.restype = ctypes.c_void_p
    lib.polygonize_build.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int]
    lib.polygonize_build.restype = ctypes.c_void_p
    lib.polygonize_num_rings.argtypes = [ctypes.c_void_p]
    lib.polygonize_num_rings.restype = ctypes.c_int64
    lib.polygonize_ring_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
    lib.polygonize_ring_coords.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.polygonize_free.argtypes = [ctypes.c_void_p]
    lib.polygonize_total_pts.argtypes = [ctypes.c_void_p]
    lib.polygonize_total_pts.restype = ctypes.c_int64
    lib.polygonize_export.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.merge_small_capped.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.merge_small_capped.restype = ctypes.c_int64
    lib.tree_shap.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def resolve_components(comp: np.ndarray, pairs_a: np.ndarray,
                       pairs_b: np.ndarray) -> np.ndarray:
    """Union the (value, value) equivalence pairs and map every element of
    ``comp`` to its root (C++; numpy/python fallback)."""
    comp = np.ascontiguousarray(comp, np.int64)
    a = np.ascontiguousarray(pairs_a, np.int64)
    b = np.ascontiguousarray(pairs_b, np.int64)
    lib = _load()
    out = np.empty_like(comp)
    if lib is not None:
        lib.resolve_components(_p64(comp.reshape(-1)), comp.size,
                               _p64(a), _p64(b), a.size,
                               _p64(out.reshape(-1)))
        return out
    # fallback: python union-find
    parent = {}

    def find(x):
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(x, x) != root:
            parent[x], x = root, parent[x]
        return root

    for x, y in zip(a.tolist(), b.tolist()):
        if x < 0 or y < 0:
            continue
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)
    flat = comp.reshape(-1)
    res = np.asarray([(-1 if c < 0 else find(c)) for c in flat.tolist()],
                     np.int64)
    return res.reshape(comp.shape)


def relabel_compact(comp: np.ndarray) -> Tuple[np.ndarray, int]:
    """Dense first-occurrence relabel: returns (int32 labels, count)."""
    comp = np.ascontiguousarray(comp, np.int64)
    lib = _load()
    if lib is not None:
        out = np.empty(comp.shape, np.int32)
        n = lib.relabel_compact(_p64(comp.reshape(-1)), comp.size,
                                _p32(out.reshape(-1)))
        return out, int(n)
    flat = comp.reshape(-1)
    valid = flat >= 0
    uniq, first_idx, inv = np.unique(flat[valid], return_index=True,
                                     return_inverse=True)
    # genuine first-occurrence order: sorted-unique order only matches it
    # when the input ids are component-min roots, but this fallback also
    # runs on MERGED labels (arbitrary ids) in merge_small_labels_host,
    # where sorted order would diverge from the native path
    rank = np.empty(len(uniq), np.int32)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(uniq),
                                                           dtype=np.int32)
    out = np.full(flat.shape, -1, np.int32)
    out[valid] = rank[inv]
    return out.reshape(comp.shape), len(uniq)


def _collect_rings_packed(lib, h):
    """Batch-export every ring in TWO C calls: (labels (n,) int64,
    n_pts (n,) int64, signed_areas (n,) float64, coords (total, 2)
    float64, concatenated in ring order). The per-ring C-ABI round trips
    (3 calls + a numpy alloc each) cost ~12 us/ring — 0.8 s at 65k tiny
    objects; packed collection is two memcpy-bound calls."""
    try:
        n = lib.polygonize_num_rings(h)
        total = lib.polygonize_total_pts(h)
        labels = np.empty(n, np.int64)
        n_pts = np.empty(n, np.int64)
        areas = np.empty(n, np.float64)
        coords = np.empty((total, 2), np.float64)
        pd = ctypes.POINTER(ctypes.c_double)
        lib.polygonize_export(h, _p64(labels), _p64(n_pts),
                              areas.ctypes.data_as(pd),
                              coords.ctypes.data_as(pd))
        return labels, n_pts, areas, coords
    finally:
        lib.polygonize_free(h)


def _collect_rings(lib, h):
    labels, n_pts, areas, coords = _collect_rings_packed(lib, h)
    offs = np.concatenate([[0], np.cumsum(n_pts)])
    return [(int(labels[i]), coords[offs[i]:offs[i + 1]], float(areas[i]))
            for i in range(len(labels))]


def _build_rle_handle(lib, values, lengths, shape, simplify):
    H, W = shape
    values = np.ascontiguousarray(values, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    return lib.polygonize_build_rle(_p32(values), _p32(lengths),
                                    len(values), H, W, 1 if simplify else 0)


def polygonize_rings_rle(values: np.ndarray, lengths: np.ndarray,
                         shape, simplify: bool = True):
    """Native polygonizer over row-wise RLE input (runs break at row
    ends): O(runs + boundary pixels), no dense raster needed. Returns
    rings like :func:`polygonize_rings`, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    return _collect_rings(lib, _build_rle_handle(lib, values, lengths,
                                                 shape, simplify))


def polygonize_rings_rle_packed(values: np.ndarray, lengths: np.ndarray,
                                shape, simplify: bool = True):
    """Packed-array variant of :func:`polygonize_rings_rle`: returns
    (labels (n,), n_pts (n,), signed_areas (n,), coords (total, 2)) or
    None if unavailable. Ring order matches the tuple-list variant."""
    lib = _load()
    if lib is None:
        return None
    return _collect_rings_packed(lib, _build_rle_handle(lib, values, lengths,
                                                        shape, simplify))


def polygonize_rings(labels: np.ndarray, simplify: bool = True):
    """Native polygonizer: label raster → list of
    (label, coords (N,2) float64, signed_area) rings in pixel-corner
    coordinates. Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, np.int32)
    H, W = labels.shape
    h = lib.polygonize_build(_p32(labels.reshape(-1)), H, W,
                             1 if simplify else 0)
    return _collect_rings(lib, h)


def polygonize_rings_packed(labels: np.ndarray, simplify: bool = True):
    """Packed-array variant of :func:`polygonize_rings` (see
    :func:`polygonize_rings_rle_packed`)."""
    lib = _load()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, np.int32)
    H, W = labels.shape
    h = lib.polygonize_build(_p32(labels.reshape(-1)), H, W,
                             1 if simplify else 0)
    return _collect_rings_packed(lib, h)


def tree_shap_forest(trees, n_classes: int, X: np.ndarray) -> np.ndarray:
    """Path-dependent TreeSHAP for a fitted forest (a list of
    :class:`obia_tpu.classification.trees.Tree`; native replacement for
    shap.TreeExplainer — reference classify.py:104-115). Returns
    (n_samples, n_features, n_classes) attributions to the predicted class
    probabilities."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    X = np.ascontiguousarray(X, np.float64)
    n_samples, n_features = X.shape
    phi_total = np.zeros((n_samples, n_features + 1, n_classes), np.float64)
    phi = np.empty_like(phi_total)
    pd = ctypes.POINTER(ctypes.c_double)
    for t in trees:
        n = len(t.feature)
        feature = np.ascontiguousarray(t.feature, np.int32)
        threshold = np.ascontiguousarray(t.threshold, np.float64)
        idx = np.arange(n, dtype=np.int32)
        left = np.where(t.children_left < 0, idx,
                        t.children_left).astype(np.int32)
        right = np.where(t.children_right < 0, idx,
                         t.children_right).astype(np.int32)
        v = np.ascontiguousarray(t.value, np.float64)
        cover = np.ascontiguousarray(t.weighted_n_node_samples, np.float64)
        phi.fill(0.0)
        lib.tree_shap(_p32(feature),
                      threshold.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      _p32(left), _p32(right),
                      v.ctypes.data_as(pd), cover.ctypes.data_as(pd),
                      n, n_classes, n_features,
                      X.ctypes.data_as(pd), n_samples,
                      phi.ctypes.data_as(pd),
                      int(t.max_depth) + 1)
        phi_total += phi
    return phi_total[:, :n_features, :] / len(trees)


def merge_small_capped(labels: np.ndarray, min_size: int,
                       max_size: int) -> Tuple[np.ndarray, int]:
    """Sequential size-capped small-segment merging (C++): an adjacency
    merges iff one side is below min_size and the union stays within
    max_size; deterministic raster-order sweeps. Returns (labels, K)."""
    labels = np.ascontiguousarray(labels, np.int32)
    H, W = labels.shape
    lab_max = int(labels.max()) if labels.size else -1
    K = lab_max + 1 if lab_max >= 0 else 0
    if K == 0:
        return labels.copy(), 0
    lib = _load()
    if lib is None:
        # direct-call convention (module docstring): raise, don't return
        # the input unmerged as if the merge had happened
        raise RuntimeError(
            f"native library unavailable: {_build_error or 'not built'}; "
            "use ops.connectivity.merge_small_device or guard with "
            "native.available()")
    out = np.empty((H, W), np.int32)
    n = lib.merge_small_capped(_p32(labels.reshape(-1)), H, W, K,
                               min_size, max_size, _p32(out.reshape(-1)))
    return out, int(n)


def host_ccl(labels: np.ndarray) -> Tuple[np.ndarray, int]:
    """Two-pass union-find CCL entirely on host (C++)."""
    labels = np.ascontiguousarray(labels, np.int32)
    H, W = labels.shape
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    out = np.empty((H, W), np.int32)
    n = lib.host_ccl(_p32(labels.reshape(-1)), H, W, _p32(out.reshape(-1)))
    return out, int(n)
