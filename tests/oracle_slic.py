"""Pure-numpy SLIC test oracle mirroring skimage.segmentation.slic.

The reference delegates segmentation to skimage's Cython SLIC (reference
obia/segmentation/segment_boundaries.py:51); skimage is not installed in
this environment, so this module is an INDEPENDENT re-implementation of the
published algorithm (Achanta et al., TPAMI 2012) with skimage's
parameterisation, used only as a parity oracle in tests:

* regular-grid seeding at ``step = sqrt(H*W / n_segments)``;
* distance ``D^2 = (d_color / compactness)^2 + (d_spatial / step)^2``
  (skimage scales the image by ``1/compactness`` and spatial coordinates by
  ``1/step`` — the same argmin as the framework's
  ``d_color^2 + (compactness/step)^2 d_spatial^2``);
* ``max_num_iter`` assignment/update sweeps, each center searching its
  ``2 step`` window;
* scan-order connectivity enforcement: connected components smaller than
  ``min_size_factor * (H W / K)`` merge into the previously visited
  adjacent component, labels renumbered in raster order.

Deliberately center-loop + BFS (the shape of the Cython original) so it
shares no structure with the XLA implementation under test.
"""
from __future__ import annotations

import numpy as np


def rgb_to_lab64(rgb: np.ndarray) -> np.ndarray:
    """float64 sRGB (D65, [0, 1]) -> CIELAB, the conversion skimage's slic
    applies to 3-channel input (``convert2lab``)."""
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    white = np.array([0.95047, 1.0, 1.08883])
    rgb = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0)
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                   rgb / 12.92)
    xyz = (lin @ m.T) / white
    f = np.where(xyz > 0.008856, np.cbrt(xyz), (903.3 * xyz + 16.0) / 116.0)
    return np.stack([116.0 * f[..., 1] - 16.0,
                     500.0 * (f[..., 0] - f[..., 1]),
                     200.0 * (f[..., 1] - f[..., 2])], axis=-1)


def slic_oracle(image: np.ndarray, n_segments: int = 100,
                compactness: float = 10.0, max_num_iter: int = 10,
                min_size_factor: float = 0.5,
                max_size_factor: float = 3.0,
                start_label: int = 0) -> np.ndarray:
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    step = np.sqrt(H * W / n_segments)

    # skimage seeds via util.regular_grid: start = int(FLOAT step // 2)
    # (before rounding), stride = round(step)
    step_i = max(1, int(round(step)))
    start = int(step // 2)
    ys = np.arange(start, H, step_i, dtype=np.float64)
    xs = np.arange(start, W, step_i, dtype=np.float64)
    cyx = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    K = len(cyx)
    ci = np.clip(np.round(cyx[:, 0]).astype(int), 0, H - 1)
    cj = np.clip(np.round(cyx[:, 1]).astype(int), 0, W - 1)
    # feature space: color / compactness, coords / step
    centers = np.concatenate([img[ci, cj] / compactness, cyx / step], 1)

    yy, xx = np.mgrid[0:H, 0:W]
    feat = np.concatenate(
        [img / compactness,
         (yy / step)[..., None], (xx / step)[..., None]], -1)

    labels = np.full((H, W), -1, np.int64)
    for _ in range(max_num_iter):
        dist = np.full((H, W), np.inf)
        labels[:] = -1
        for k in range(K):
            cy = centers[k, C] * step
            cx = centers[k, C + 1] * step
            y0, y1 = max(0, int(cy - 2 * step)), min(H, int(cy + 2 * step) + 1)
            x0, x1 = max(0, int(cx - 2 * step)), min(W, int(cx + 2 * step) + 1)
            d = ((feat[y0:y1, x0:x1] - centers[k]) ** 2).sum(-1)
            win_d = dist[y0:y1, x0:x1]
            better = d < win_d
            dist[y0:y1, x0:x1] = np.where(better, d, win_d)
            lab_win = labels[y0:y1, x0:x1]
            labels[y0:y1, x0:x1] = np.where(better, k, lab_win)
        for k in range(K):
            m = labels == k
            if m.any():
                centers[k] = feat[m].mean(axis=0)

    seg_size = H * W / K
    min_size = int(round(min_size_factor * seg_size))
    return _enforce_connectivity(labels, min_size, start_label)


def _enforce_connectivity(labels: np.ndarray, min_size: int,
                          start_label: int) -> np.ndarray:
    """Scan-order BFS relabel: components < min_size adopt the previously
    visited adjacent component's NEW label (skimage
    _enforce_label_connectivity_cython semantics)."""
    H, W = labels.shape
    out = np.full((H, W), -1, np.int64)
    next_label = start_label
    adjacent = start_label
    for r0 in range(H):
        for c0 in range(W):
            if out[r0, c0] != -1:
                continue
            # BFS this component of the input labelling
            comp = [(r0, c0)]
            out[r0, c0] = next_label
            head = 0
            adj = None
            while head < len(comp):
                r, c = comp[head]
                head += 1
                for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    r2, c2 = r + dr, c + dc
                    if not (0 <= r2 < H and 0 <= c2 < W):
                        continue
                    if labels[r2, c2] == labels[r0, c0]:
                        if out[r2, c2] == -1:
                            out[r2, c2] = next_label
                            comp.append((r2, c2))
                    elif out[r2, c2] not in (-1, next_label):
                        adj = out[r2, c2]
            if len(comp) < min_size and adj is not None:
                for r, c in comp:
                    out[r, c] = adj
            else:
                next_label += 1
    return out


def adjusted_rand_index(a: np.ndarray, b: np.ndarray) -> float:
    """Hubert-Arabie adjusted Rand index of two labelings (1.0 when both
    put everything in one cluster), computed from the contingency table."""
    _, ia = np.unique(np.ravel(a), return_inverse=True)
    _, ib = np.unique(np.ravel(b), return_inverse=True)
    _, nij = np.unique(ia.astype(np.int64) * (ib.max() + 1) + ib,
                       return_counts=True)

    def pairs(counts):
        counts = counts.astype(np.float64)
        return float((counts * (counts - 1) / 2).sum())

    index = pairs(nij)
    sum_a = pairs(np.bincount(ia))
    sum_b = pairs(np.bincount(ib))
    expected = sum_a * sum_b / pairs(np.array([ia.size]))
    max_index = (sum_a + sum_b) / 2
    if max_index == expected:
        return 1.0
    return (index - expected) / (max_index - expected)


def boundary_recall(pred: np.ndarray, truth: np.ndarray,
                    tolerance_px: int = 2) -> float:
    """Fraction of oracle boundary pixels with a predicted boundary within
    ``tolerance_px`` (the standard superpixel boundary-recall metric)."""
    def bmap(lab):
        m = np.zeros(lab.shape, bool)
        m[:, 1:] |= lab[:, 1:] != lab[:, :-1]
        m[1:, :] |= lab[1:, :] != lab[:-1, :]
        return m

    bp, bt = bmap(pred), bmap(truth)
    if tolerance_px > 0:
        from scipy.ndimage import maximum_filter
        bp = maximum_filter(bp, size=2 * tolerance_px + 1)
    nt = bt.sum()
    return 1.0 if nt == 0 else float((bt & bp).sum()) / float(nt)
