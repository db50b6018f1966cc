"""Fused per-object statistics vs scipy/numpy oracles."""
import numpy as np
import pytest
from scipy import stats as sps

from obia_tpu.ops.stats import spectral_stats_table
from obia_tpu.ops.glcm import glcm_table, angle_offsets, DEFAULT_ANGLES


def random_labels(rng, h, w, k):
    """Random blobby label map covering [0, k)."""
    seeds = rng.integers(0, k, size=(h, w))
    # smooth into blobs via mode-ish filtering: take label of block corner
    bs = 8
    lab = np.zeros((h, w), np.int32)
    for i in range(0, h, bs):
        for j in range(0, w, bs):
            lab[i:i + bs, j:j + bs] = seeds[i, j]
    return lab


def test_spectral_stats_match_scipy(rng):
    h, w, c, k = 64, 80, 3, 12
    img = rng.normal(size=(h, w, c)).astype(np.float32) * 10 + 50
    lab = random_labels(rng, h, w, k)
    lab[:4, :4] = -1  # masked pixels
    got = spectral_stats_table(img, lab, k)
    for s in range(k):
        m = lab == s
        for b in range(c):
            vals = img[:, :, b][m]
            if vals.size == 0:
                assert np.isnan(got["mean"][s, b])
                continue
            assert got["count"][s, b] == vals.size
            np.testing.assert_allclose(got["mean"][s, b], vals.mean(), rtol=1e-5)
            np.testing.assert_allclose(got["variance"][s, b], vals.var(), rtol=1e-4)
            assert got["min"][s, b] == vals.min()
            assert got["max"][s, b] == vals.max()
            np.testing.assert_allclose(got["skewness"][s, b],
                                       sps.skew(vals), rtol=1e-2, atol=2e-3)
            np.testing.assert_allclose(got["kurtosis"][s, b],
                                       sps.kurtosis(vals), rtol=1e-2, atol=5e-3)


def test_spectral_stats_empty_and_constant(rng):
    img = np.ones((16, 16, 1), np.float32) * 7
    lab = np.zeros((16, 16), np.int32)
    got = spectral_stats_table(img, lab, 3)  # segments 1,2 empty
    assert got["mean"][0, 0] == 7
    assert got["variance"][0, 0] == 0
    assert np.isnan(got["skewness"][0, 0])  # constant -> nan (scipy semantics)
    assert np.isnan(got["mean"][1, 0]) and np.isnan(got["max"][2, 0])


def test_spectral_large_raster_paths_match_one_shot(rng, monkeypatch):
    """The >16.7M-px row-range accumulation path and the chunked batched
    scatter (both restructured to chain accumulators through the scatter
    operand so XLA cannot overlap chunk temps) must agree with the
    one-shot program. Sums chain in row order either way, so mean and
    variance agree to float tolerance and min/max/count exactly."""
    import obia_tpu.ops.stats as S

    h, w, c, k = 96, 40, 3, 9
    img = (rng.normal(size=(h, w, c)).astype(np.float32) * 10 + 50)
    lab = random_labels(rng, h, w, k)
    lab[:3, :5] = -1
    want = spectral_stats_table(img, lab, k)

    monkeypatch.setattr(S, "_SPECTRAL_ONE_SHOT_MAX", 0)
    monkeypatch.setattr(S, "_row_ranges",
                        lambda H, W: [(h0, min(H, h0 + 17))
                                      for h0 in range(0, H, 17)])
    monkeypatch.setattr(S, "_SCATTER_N_CHUNK", 257)
    monkeypatch.setattr(S, "_SCATTER_ELEM_BUDGET", 257 * 24)
    S._segment_spectral_moments.clear_cache()
    try:
        got = spectral_stats_table(img, lab, k)
    finally:
        S._segment_spectral_moments.clear_cache()
    for name in ("count", "min", "max"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("mean", "variance", "skewness", "kurtosis"):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)


# --- GLCM oracle --------------------------------------------------------------

def naive_glcm_props(band, labels, k, levels=256, distance=2,
                     angles=DEFAULT_ANGLES):
    """Naive per-object GLCM with the framework's documented semantics:
    within-object pairs, per-object min-max floor quantisation, symmetric,
    normed, skimage prop formulas, averaged over angles with pairs."""
    offs = angle_offsets(distance, angles)
    h, w = band.shape
    out = {p: np.full(k, np.nan) for p in
           ("contrast", "dissimilarity", "homogeneity", "ASM", "energy",
            "correlation")}
    for s in range(k):
        m = labels == s
        if not m.any():
            continue
        vals = band[m]
        mn, mx = vals.min(), vals.max()
        if mx > mn:
            # the level q of d = x - min satisfies
            # q * range <= d * (levels-1) < (q+1) * range with float32
            # products (ops.glcm.scale_quantise), found by search over
            # the level thresholds — no division
            rng = np.float32(mx - mn)
            d = band.astype(np.float32) - np.float32(mn)
            thresholds = np.arange(levels, dtype=np.float32) * rng
            num = d * np.float32(levels - 1)
            q = np.clip(np.searchsorted(thresholds, num, side="right") - 1,
                        0, levels - 1)
        else:
            q = np.zeros_like(band, dtype=int)
        per_angle = {p: [] for p in out}
        for dr, dc in offs:
            # every in-raster pair (r, c) -> (r + dr, c + dc) with both
            # pixels in the object
            r0, r1 = max(0, -dr), min(h, h - dr)
            c0, c1 = max(0, -dc), min(w, w - dc)
            P = np.zeros((levels, levels))
            if r1 > r0 and c1 > c0:
                both = (m[r0:r1, c0:c1]
                        & m[r0 + dr:r1 + dr, c0 + dc:c1 + dc])
                np.add.at(P, (q[r0:r1, c0:c1][both],
                              q[r0 + dr:r1 + dr, c0 + dc:c1 + dc][both]), 1)
            P = P + P.T  # symmetric
            n = P.sum()
            if n == 0:
                continue
            P = P / n
            i = np.arange(levels)[:, None]
            j = np.arange(levels)[None, :]
            per_angle["contrast"].append((P * (i - j) ** 2).sum())
            per_angle["dissimilarity"].append((P * abs(i - j)).sum())
            per_angle["homogeneity"].append((P / (1 + (i - j) ** 2)).sum())
            asm = (P ** 2).sum()
            per_angle["ASM"].append(asm)
            per_angle["energy"].append(np.sqrt(asm))
            px = P.sum(1)
            mu = (np.arange(levels) * px).sum()
            var = ((np.arange(levels) - mu) ** 2 * px).sum()
            if var > 1e-12:
                corr = ((i - mu) * (j - mu) * P).sum() / var
            else:
                corr = 1.0
            per_angle["correlation"].append(corr)
        for p in out:
            if per_angle[p]:
                out[p][s] = np.mean(per_angle[p])
    return out


@pytest.mark.parametrize("levels", [8, 256])
def test_glcm_props_match_naive(rng, levels):
    h, w, k = 24, 30, 4
    band = rng.random((h, w)).astype(np.float32)
    lab = random_labels(rng, h, w, k)
    got = glcm_table(band[:, :, None], lab, k, levels=levels)
    want = naive_glcm_props(band, lab, k, levels=levels)
    for p in want:
        np.testing.assert_allclose(got[p][:, 0], want[p], rtol=2e-4, atol=2e-5,
                                   err_msg=p)


def test_glcm_tiny_segment_nan(rng):
    # single-pixel segment has no pairs at distance 2 -> NaN
    band = rng.random((10, 10)).astype(np.float32)
    lab = np.zeros((10, 10), np.int32)
    lab[5, 5] = 1
    got = glcm_table(band[:, :, None], lab, 2)
    assert np.isnan(got["contrast"][1, 0])
    assert np.isfinite(got["contrast"][0, 0])


@pytest.mark.parametrize("levels", [8, 256])
def test_glcm_histogram_path_matches_sort_path(rng, levels, monkeypatch):
    """The joint-histogram GLCM (large-scene path: one scatter per angle,
    all props + exact ASM from the (K, L^2) table) must agree with the
    sort-based small-scene path bit-for-bit in semantics."""
    import obia_tpu.ops.glcm as G

    h, w, k = 48, 52, 6
    band = rng.random((h, w)).astype(np.float32)
    lab = random_labels(rng, h, w, k)
    want = glcm_table(band[:, :, None], lab, k, levels=levels)

    monkeypatch.setattr(G, "_FUSE_BANDS_MAX_ELEMS", 0)
    monkeypatch.setattr(G, "_use_histogram", lambda *a: True)
    got = glcm_table(band[:, :, None], lab, k, levels=levels)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-6,
                                   err_msg=p)


def test_glcm_large_scene_path_multiband(rng, monkeypatch):
    """The large-scene per-band path (cross-band batched quantisation +
    hoisted validity stack) must match the fused small-scene path on a
    multi-band scene with masked pixels and a band subset."""
    import obia_tpu.ops.glcm as G

    h, w, k = 40, 44, 5
    img = rng.random((h, w, 4)).astype(np.float32)
    img[:, :, 2] = 0.37  # constant band -> quantises to 0 (has-range flag)
    lab = random_labels(rng, h, w, k)
    lab[rng.random((h, w)) < 0.15] = -1  # masked pixels
    bands = (0, 2, 3)
    want = glcm_table(img, lab, k, levels=16, bands=bands)

    monkeypatch.setattr(G, "_FUSE_BANDS_MAX_ELEMS", 0)
    got = glcm_table(img, lab, k, levels=16, bands=bands)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-6,
                                   err_msg=p)


def test_glcm_bigk_split_route_matches_fused(rng, monkeypatch):
    """K past _FUSE_BANDS_MAX_K forces the split route (per-band programs
    + per-angle sum scans — the config-2 regime where the band-fused
    program's feature-minor scatter copies OOMed compile at 36.9 GB on
    hardware). Results must match the fused route exactly."""
    import obia_tpu.ops.glcm as G

    h, w, k = 40, 44, 6
    img = rng.random((h, w, 3)).astype(np.float32)
    lab = random_labels(rng, h, w, k)
    want = glcm_table(img, lab, k, levels=16)

    monkeypatch.setattr(G, "_FUSE_BANDS_MAX_K", 0)  # big-K route
    got = glcm_table(img, lab, k, levels=16)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-6,
                                   err_msg=p)


def test_glcm_levels_out_of_range_raises(rng):
    """levels > 256 would silently wrap the uint8 quantised stacks
    (values 256.. alias to 0..); it must be a clear error instead."""
    img = rng.random((16, 16, 1)).astype(np.float32)
    lab = random_labels(rng, 16, 16, 3)
    with pytest.raises(ValueError, match="levels"):
        glcm_table(img, lab, 3, levels=300)
    with pytest.raises(ValueError, match="levels"):
        glcm_table(img, lab, 3, levels=0)


def test_glcm_integer_dtype_band(rng):
    """uint16 satellite bands must quantise like their float32 copy
    (jnp.finfo on an int dtype used to crash deep in the quantiser)."""
    img_u16 = (rng.random((20, 22, 1)) * 60000).astype(np.uint16)
    lab = random_labels(rng, 20, 22, 4)
    got = glcm_table(img_u16, lab, 4, levels=16)
    want = glcm_table(img_u16.astype(np.float32), lab, 4, levels=16)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-6,
                                   err_msg=p)


def test_strict_reference_glcm_sliver_bbox_no_crash():
    """strict_reference_glcm replicates the reference's wrong-axis slice
    arr[:, :, b]; for an object whose bbox is narrower than the band
    index the reference raises IndexError — we emit NaN for those bands
    instead of crashing the run."""
    from obia_tpu.segmentation.segment_statistics import (
        _strict_reference_textural_stats)

    flags = {"contrast": True, "ASM": True}
    crop = np.random.default_rng(0).random((4, 6, 2))  # (C, Hc, Wc=2)
    stats = _strict_reference_textural_stats(crop, [0, 1, 2, 3], flags)
    assert np.isfinite(stats["b0_contrast"]) or np.isnan(stats["b0_contrast"])
    for b in (2, 3):  # Wc=2 <= band index -> reference IndexError -> NaN
        assert np.isnan(stats[f"b{b}_contrast"])
        assert np.isnan(stats[f"b{b}_ASM"])
