"""Model-agnostic Kernel SHAP — native replacement for
``shap.KernelExplainer`` on the MLP path (reference classify.py:104-115;
the ``shap`` package is not a dependency of this framework).

Algorithm (Lundberg & Lee 2017, "A Unified Approach to Interpreting
Model Predictions"): Shapley values solve a weighted linear regression
over feature coalitions z ∈ {0,1}^M with the Shapley kernel weight

    pi(z) = (M - 1) / (C(M, |z|) * |z| * (M - |z|)).

Missing features are integrated out over a background set. Budgeting
follows the standard scheme: coalition sizes are enumerated completely
smallest-pair-first while they fit the sample budget; the remainder is
randomly sampled from the leftover size distribution. The sum-to-f(x)
constraint is enforced by eliminating the last free coefficient, so
local accuracy (base + sum(phi) == f(x)) holds exactly.

Model evaluations are batched: one ``predict`` call per coalition chunk
x background — a handful of large device passes, not the per-row loop a
naive implementation would make. The regression itself is float64 numpy
on the host.
"""
from __future__ import annotations

from math import comb
from typing import Callable, Optional

import numpy as np


def _size_masses(M: int) -> np.ndarray:
    """Total Shapley-kernel mass per coalition size s = 1..M-1:
    pi(s) * C(M, s) = (M-1) / (s * (M-s)), normalised."""
    s = np.arange(1, M, dtype=np.float64)
    w = (M - 1) / (s * (M - s))
    return w / w.sum()


def _build_coalitions(M: int, nsamples: int, rng: np.random.Generator):
    """Coalition mask matrix Z (n, M) in {0,1} and per-row weights."""
    p = _size_masses(M)  # index s-1
    masks, weights = [], []
    enumerated = np.zeros(M - 1, bool)
    remaining = nsamples

    # paired complete enumeration: sizes (1, M-1), (2, M-2), ...
    for s in range(1, M // 2 + 1):
        sizes = [s] if s * 2 == M else [s, M - s]
        count = sum(comb(M, t) for t in sizes)
        if count > remaining:
            break
        for t in sizes:
            # all C(M, t) masks of size t via lexicographic combinations
            from itertools import combinations
            idx = np.fromiter(
                (i for c in combinations(range(M), t) for i in c),
                np.int64).reshape(-1, t)
            z = np.zeros((idx.shape[0], M), np.float64)
            np.put_along_axis(z, idx, 1.0, axis=1)
            masks.append(z)
            weights.append(np.full(idx.shape[0], p[t - 1] / comb(M, t)))
            enumerated[t - 1] = True
        remaining -= count

    left = ~enumerated
    if left.any() and remaining > 0:
        p_left = p[left] / p[left].sum()
        sizes_left = np.arange(1, M)[left]
        draw = rng.choice(sizes_left, size=remaining, p=p_left)
        z = np.zeros((remaining, M), np.float64)
        for i, t in enumerate(draw):
            z[i, rng.choice(M, size=t, replace=False)] = 1.0
        masks.append(z)
        weights.append(np.full(remaining, p[left].sum() / remaining))

    Z = np.concatenate(masks, axis=0)
    w = np.concatenate(weights, axis=0)
    return Z, w


def kernel_shap(predict: Callable[[np.ndarray], np.ndarray],
                X: np.ndarray,
                background: np.ndarray,
                nsamples: Optional[int] = None,
                random_state: int = 0,
                batch_rows: int = 1 << 17) -> np.ndarray:
    """SHAP values for ``predict`` (e.g. ``predict_proba``) at each row
    of ``X`` against a ``background`` distribution.

    Returns (n_samples, n_features, n_outputs) attributions satisfying
    ``base + phi.sum(axis=1) == predict(X)`` exactly (local accuracy),
    where ``base = predict(background).mean(axis=0)``.
    """
    X = np.asarray(X, np.float64)
    bg = np.asarray(background, np.float64)
    n, M = X.shape
    base = np.asarray(predict(bg)).mean(axis=0)        # (C,)
    fx = np.asarray(predict(X))                        # (n, C)
    C = fx.shape[1]
    if M == 1:
        return (fx - base)[:, None, :]

    if nsamples is None:
        nsamples = min(2 * M + 2 ** 11, 2 ** min(M, 30) - 2)
    rng = np.random.default_rng(random_state)
    Z, w = _build_coalitions(M, int(nsamples), rng)
    S = Z.shape[0]
    B = bg.shape[0]

    # y[k, i, :] = E_bg[ f(where(Z[k], X[i], bg)) ] - base - Z[k,-1]*(fx-base)
    # evaluated in device-sized batches
    y = np.empty((S, n, C), np.float64)
    rows_per_call = max(1, batch_rows // max(B, 1))
    for i in range(n):
        xi = X[i]
        for k0 in range(0, S, rows_per_call):
            zc = Z[k0:k0 + rows_per_call]              # (kc, M)
            synth = np.where(zc[:, None, :] > 0, xi[None, None, :],
                             bg[None, :, :])           # (kc, B, M)
            out = np.asarray(predict(synth.reshape(-1, M)))
            y[k0:k0 + len(zc), i] = out.reshape(len(zc), B, C).mean(axis=1)

    # constrained weighted least squares, eliminating phi_{M-1}:
    #   sum(phi) = fx - base  =>  phi_{M-1} = (fx-base) - sum_{j<M-1} phi_j
    fxb = fx - base                                    # (n, C)
    y -= base
    y -= Z[:, -1][:, None, None] * fxb[None, :, :]
    Zp = Z[:, :-1] - Z[:, -1:]                         # (S, M-1)
    ZpW = Zp * w[:, None]
    A = ZpW.T @ Zp                                     # (M-1, M-1)
    b = ZpW.T @ y.reshape(S, n * C)                    # (M-1, n*C)
    phi_head = np.linalg.lstsq(A, b, rcond=None)[0].reshape(M - 1, n, C)
    phi_last = fxb[None] - phi_head.sum(axis=0, keepdims=True)
    phi = np.concatenate([phi_head, phi_last], axis=0)  # (M, n, C)
    return np.moveaxis(phi, 0, 1)                       # (n, M, C)
