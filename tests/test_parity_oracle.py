"""Quantitative parity vs a pure-numpy skimage-semantics SLIC oracle.

VERDICT r1 item 5: the north star requires boundaries to match reference
SLIC (reference segment_boundaries.py:51 -> skimage.segmentation.slic)
within seam tolerance; skimage itself is not installed, so
``tests/oracle_slic.py`` re-implements the published algorithm with
skimage's parameterisation and these tests report ARI + boundary recall
at several sizes. Measured numbers are recorded in PARITY.md.
"""
import numpy as np
import pytest

from obia_tpu.ops.slic import slic
from oracle_slic import (adjusted_rand_index, boundary_recall, slic_oracle)


@pytest.mark.parametrize("n_a,n_b,agree", [(20, 25, 0.8), (3, 3, 0.3),
                                           (50, 2, 0.0)])
def test_adjusted_rand_index_matches_sklearn(n_a, n_b, agree):
    """The oracle's numpy ARI (the chip smoke run has no scikit-learn)
    equals scikit-learn's adjusted_rand_score."""
    from sklearn.metrics import adjusted_rand_score
    rng = np.random.default_rng(n_a)
    a = rng.integers(0, n_a, 5000)
    b = np.where(rng.random(5000) < agree, a % n_b, rng.integers(0, n_b, 5000))
    assert adjusted_rand_index(a, b) == pytest.approx(
        adjusted_rand_score(a, b), abs=1e-12)


def scene(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([
        np.sin(yy / 23.0) + np.cos(xx / 31.0),
        np.sin((yy + xx) / 37.0),
        np.cos(yy / 17.0) * np.sin(xx / 29.0),
    ], axis=-1)
    img = base + rng.normal(0, 0.05, base.shape)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


CASES = [
    # (H, W, n_segments)
    (96, 96, 24),
    (128, 192, 60),
    (256, 256, 150),
]


@pytest.mark.parametrize("h,w,n", CASES)
def test_slic_matches_oracle(h, w, n):
    img = scene(h, w)
    got = slic(img, n_segments=n, compactness=10.0, start_label=0,
               convert2lab=False)
    want = slic_oracle(img, n_segments=n, compactness=10.0)
    ari = adjusted_rand_index(got, want)
    br = boundary_recall(got, want, tolerance_px=2)
    n_got = len(np.unique(got))
    n_want = len(np.unique(want))
    print(f"\nPARITY slic {h}x{w} n={n}: ARI={ari:.3f} "
          f"boundary_recall@2px={br:.3f} K={n_got} K_oracle={n_want}")
    # independent implementations of the same objective: require strong
    # structural agreement, not bitwise labels (measured 0.99-1.00 after
    # aligning the regular-grid seeding; see PARITY.md)
    assert ari >= 0.95, ari
    assert br >= 0.98, br
    assert abs(n_got - n_want) / max(n_want, 1) < 0.05


def test_slic_compactness_monotonic_agreement():
    """Higher compactness -> both implementations converge toward the
    regular grid, so agreement should not degrade."""
    img = scene(128, 128, seed=3)
    got = slic(img, n_segments=36, compactness=100.0, start_label=0,
               convert2lab=False)
    want = slic_oracle(img, n_segments=36, compactness=100.0)
    ari = adjusted_rand_index(got, want)
    print(f"\nPARITY slic compactness=100: ARI={ari:.3f}")
    assert ari >= 0.95, ari
