"""SLIC + connectivity invariants (no skimage in the env, so the oracle is
a BFS connected-components check in numpy plus structural invariants —
SURVEY.md §4 strategy (a) adapted)."""
import numpy as np
import pytest

from obia_tpu.ops.connectivity import compact_labels, connected_components
from obia_tpu.ops.slic import slic


def bfs_components(labels):
    """Numpy/BFS 4-connected component oracle."""
    h, w = labels.shape
    comp = -np.ones((h, w), np.int64)
    nxt = 0
    for i in range(h):
        for j in range(w):
            if labels[i, j] < 0 or comp[i, j] >= 0:
                continue
            stack = [(i, j)]
            comp[i, j] = nxt
            while stack:
                r, c = stack.pop()
                for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    r2, c2 = r + dr, c + dc
                    if (0 <= r2 < h and 0 <= c2 < w and comp[r2, c2] < 0
                            and labels[r2, c2] == labels[r, c]):
                        comp[r2, c2] = nxt
                        stack.append((r2, c2))
            nxt += 1
    return comp, nxt


def test_connected_components_matches_bfs(rng):
    lab = rng.integers(0, 3, size=(40, 56)).astype(np.int32)
    lab[5:9, 5:9] = -1
    comp = np.asarray(connected_components(lab))
    want, n_want = bfs_components(lab)
    got, n_got = compact_labels(comp)
    assert n_got == n_want
    # same partition (label values may differ -> compare via pair mapping)
    valid = lab >= 0
    np.testing.assert_array_equal(got[valid] == got[valid][0],
                                  want[valid] == want[valid][0])
    # bijection check
    import collections
    fwd = {}
    for a, b in zip(got[valid].ravel(), want[valid].ravel()):
        assert fwd.setdefault(a, b) == b
    assert comp[5, 5] == -1


def test_slic_basic_invariants(small_rgb):
    labels = slic(small_rgb, n_segments=40, compactness=10.0)
    assert labels.shape == small_rgb.shape[:2]
    assert labels.min() == 1  # start_label=1
    ids = np.unique(labels)
    # roughly the requested number of segments (within 3x)
    assert 10 <= len(ids) <= 120
    # every segment 4-connected
    _, ncomp = bfs_components(labels)
    assert ncomp == len(ids)


def test_slic_respects_strong_edges(small_rgb):
    labels = slic(small_rgb, n_segments=60, compactness=1.0,
                  convert2lab=False)
    h, w = labels.shape
    # the horizontal edge at h//2: segments shouldn't straddle it much
    upper = labels[: h // 2].ravel()
    lower = labels[h // 2:].ravel()
    shared = set(np.unique(upper)) & set(np.unique(lower))
    straddle_px = sum(np.sum(labels == s) for s in shared)
    assert straddle_px < 0.12 * labels.size


def test_slic_mask(small_rgb):
    h, w = small_rgb.shape[:2]
    mask = np.ones((h, w), np.uint8)
    mask[:, : w // 4] = 0
    labels = slic(small_rgb, n_segments=30, mask=mask)
    assert (labels[:, : w // 4] == 0).all()
    assert labels[:, w // 4:].min() >= 1


def test_slic_deterministic(small_rgb):
    a = slic(small_rgb, n_segments=40)
    b = slic(small_rgb, n_segments=40)
    np.testing.assert_array_equal(a, b)


def test_slic_start_label_zero(small_rgb):
    labels = slic(small_rgb, n_segments=25, start_label=0)
    assert labels.min() == 0


def test_ccl_snake_converges():
    # worst-case: a single serpentine component threading the raster
    h, w = 24, 24
    lab = np.full((h, w), 1, np.int32)
    snake = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        snake[r, :] = True
        if r + 1 < h:
            snake[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    lab[snake] = 0
    comp = np.asarray(connected_components(lab.astype(np.int32)))
    got, n_got = compact_labels(comp)
    _, n_want = bfs_components(lab)
    assert n_got == n_want


def test_rgb_to_lab_known_values():
    import jax.numpy as jnp
    from obia_tpu.ops.color import rgb_to_lab
    rgb = jnp.asarray([[[1.0, 1.0, 1.0], [1.0, 0.0, 0.0],
                        [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    lab = np.asarray(rgb_to_lab(rgb))[0]
    np.testing.assert_allclose(lab[0], [100.0, 0.0, 0.0], atol=0.02)
    np.testing.assert_allclose(lab[1], [53.24, 80.09, 67.20], atol=0.05)
    np.testing.assert_allclose(lab[2], [87.735, -86.183, 83.179], atol=0.05)
    np.testing.assert_allclose(lab[3], [32.30, 79.19, -107.86], atol=0.05)


def test_rgb_to_lab_matches_float64_formula(rng):
    """The device conversion (per-channel sums, so no reduced-precision
    matmul can touch it) against the float64 formula over random colours,
    including both sides of the sRGB linear segment and the Lab knee.
    1e-4 absolute on L in [0, 100] is float32 rounding of the power and
    cube root; a TF32 product would be off by ~1e-2."""
    from obia_tpu.ops.color import rgb_to_lab
    from oracle_slic import rgb_to_lab64
    rgb = np.concatenate([rng.random((4096, 3)),
                          rng.random((512, 3)) * 0.05]).astype(np.float32)
    got = np.asarray(rgb_to_lab(rgb))
    np.testing.assert_allclose(got, rgb_to_lab64(rgb), rtol=0, atol=1e-4)


def test_slic_zero(small_rgb):
    labels = slic(small_rgb, n_segments=30, slic_zero=True,
                  convert2lab=False)
    assert labels.min() == 1
    n = len(np.unique(labels))
    assert 8 <= n <= 90
    # SLICO differs from plain SLIC but still respects structure
    labels2 = slic(small_rgb, n_segments=30, slic_zero=True,
                   convert2lab=False)
    np.testing.assert_array_equal(labels, labels2)  # deterministic


def test_slic_anisotropic_spacing(rng):
    """spacing=(sy, sx) scales the spatial distance per axis."""
    img = rng.random((96, 96, 3)).astype(np.float32)
    # exact identity: isotropic spacing (s, s) multiplies the spatial
    # term by s^2, which is precisely compactness * s
    lab_sp = slic(img, n_segments=25, compactness=10.0, convert2lab=False,
                  spacing=(2.0, 2.0), start_label=0)
    lab_eq = slic(img, n_segments=25, compactness=20.0, convert2lab=False,
                  start_label=0)
    np.testing.assert_array_equal(lab_sp, lab_eq)
    # anisotropic spacing is a genuinely different metric: with color
    # mattering (low compactness), labels must differ from the unspaced
    # run, and the result is still a valid partition
    lab_an = slic(img, n_segments=25, compactness=1.0, convert2lab=False,
                  spacing=(1.0, 4.0), start_label=0)
    lab_un = slic(img, n_segments=25, compactness=1.0, convert2lab=False,
                  start_label=0)
    assert (lab_an != lab_un).any()
    assert lab_an.min() == 0 and len(np.unique(lab_an)) == lab_an.max() + 1


def test_large_scale_chunked_paths_match_fused(rng, monkeypatch):
    """The >_FUSE_CCL_MAX_PIXELS path (k-means and CCL as two device
    programs) must produce the same labels as the fused program."""
    import obia_tpu.ops.slic as S

    img = rng.random((96, 128, 3)).astype(np.float32)
    want = slic(img, n_segments=24, compactness=10.0, start_label=0,
                convert2lab=False)
    monkeypatch.setattr(S, "_FUSE_CCL_MAX_PIXELS", 1)
    got = slic(img, n_segments=24, compactness=10.0, start_label=0,
               convert2lab=False)
    np.testing.assert_array_equal(got, want)


def test_structured_update_sums_match_scatter(rng):
    """The scatter-free center update (offset-masked block reductions)
    must agree with the batched-scatter update on assignment-shaped
    labels (every pixel assigned within the 3x3 grid neighbourhood of
    its home cell)."""
    import jax.numpy as jnp
    from obia_tpu.ops.slic import (_slic_update_sums_structured,
                                   slic_update_sums)

    H, W, C, gh, gw = 57, 63, 3, 5, 6
    img = rng.random((H, W, C)).astype(np.float32)
    row_cell = (np.arange(H) * gh) // H
    col_cell = (np.arange(W) * gw) // W
    ri = np.clip(row_cell[:, None] + rng.integers(-1, 2, (H, W)), 0, gh - 1)
    ci = np.clip(col_cell[None, :] + rng.integers(-1, 2, (H, W)), 0, gw - 1)
    labels = (ri * gw + ci).astype(np.int32)
    labels[rng.random((H, W)) < 0.1] = -1  # masked pixels drop out

    want_s, want_c = slic_update_sums(jnp.asarray(img), jnp.asarray(labels),
                                      0.0, 0.0, gh * gw)
    got_s, got_c = _slic_update_sums_structured(jnp.asarray(img),
                                                jnp.asarray(labels), gh, gw)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)


def test_structured_update_end_to_end(rng, monkeypatch):
    """slic() through the structured-update path (gated to large rasters
    in production) must reproduce the scatter path's labels."""
    import obia_tpu.ops.slic as S

    img = rng.random((97, 131, 3)).astype(np.float32)
    want = slic(img, n_segments=24, compactness=10.0, start_label=0,
                convert2lab=False)
    monkeypatch.setattr(S, "_STRUCTURED_UPDATE_MIN_PIXELS", 0)
    # the gate is read at TRACE time inside the jitted k-means program:
    # drop the cached traces so the structured variant actually compiles
    S._slic_iterate_resolve.clear_cache()
    S._slic_iterate.clear_cache()
    try:
        got = slic(img, n_segments=24, compactness=10.0, start_label=0,
                   convert2lab=False)
    finally:
        monkeypatch.undo()
        S._slic_iterate_resolve.clear_cache()
        S._slic_iterate.clear_cache()
    np.testing.assert_array_equal(got, want)


def test_rle_label_download_roundtrip(rng, monkeypatch):
    import jax.numpy as jnp
    import obia_tpu.ops.slic as S

    lab = np.repeat(np.repeat(rng.integers(0, 300, (16, 16)), 9, axis=0),
                    9, axis=1)[:120, :130].astype(np.int32)
    lab[0, :7] = -1  # masked pixels survive the value+1 encoding
    monkeypatch.setattr(S, "_RLE_MIN_PIXELS", 1)
    out = S.download_labels(jnp.asarray(lab), 300)
    np.testing.assert_array_equal(out, lab)


def test_merge_small_device_large_label_space():
    """K_pad beyond ~46k overflowed the old fused int32 edge key; this
    exercises the two-key path: every pixel its own label, all small."""
    import jax.numpy as jnp
    from obia_tpu.ops.connectivity import merge_small_device

    H, W = 256, 300
    lab = np.arange(H * W, dtype=np.int32).reshape(H, W)
    merged, k = merge_small_device(jnp.asarray(lab), H * W, min_size=4,
                                   max_size=64)
    m = np.asarray(merged)
    assert m.min() == 0 and m.max() == k - 1
    sizes = np.bincount(m.ravel())
    # uncapped phase leaves no sub-min orphans (all pixels have neighbours)
    assert sizes.min() >= 4, sizes.min()
    assert k < H * W // 4


@pytest.mark.parametrize("variant", ["sort", "compact", "overflow"])
def test_merge_edge_dedup_paths_bitwise_equal(rng, monkeypatch, variant):
    """Every edge-dedup path (presence table, compact-then-sort, full
    sort, and the lax.cond overflow fallback) must yield the SAME merge:
    each emits unique pair keys in ascending fused order, so the edge
    list — and the final labels — are bitwise identical."""
    import jax.numpy as jnp
    import obia_tpu.ops.connectivity as C

    blocks = rng.integers(0, 120, (24, 20)).astype(np.int32)
    lab = np.repeat(np.repeat(blocks, 5, axis=0), 6, axis=1)
    lab[:2, :3] = -1
    dense, k = C.relabel_connected(lab)

    want, k_want = C.merge_small_device(jnp.asarray(dense), k,
                                        min_size=12, max_size=400)
    monkeypatch.setattr(C, "_EDGE_TABLE_MAX", 0)  # defeat the table path
    # n2 = 28,560 on this raster; ~4-5k boundary pairs
    if variant == "compact":
        # CAP 16384 < n2, pairs fit -> lax.cond takes the compact branch
        monkeypatch.setattr(C, "_EDGE_COMPACT_MIN", 1 << 14)
    elif variant == "overflow":
        # CAP = n2 // 8 = 3570 < pair count -> cond falls back to the
        # full 2N sort
        monkeypatch.setattr(C, "_EDGE_COMPACT_MIN", 1)
    C._label_edges.clear_cache()
    C._merge_small_fused.clear_cache()
    try:
        got, k_got = C.merge_small_device(jnp.asarray(dense), k,
                                          min_size=12, max_size=400)
    finally:
        C._label_edges.clear_cache()
        C._merge_small_fused.clear_cache()
    assert k_got == k_want
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_merge_two_phase_bitwise_equals_fused(rng, monkeypatch):
    """The big-K two-phase merge (head sweeps at full buffer width ->
    external-edge compaction -> tail sweeps on the small buffer) must be
    BITWISE identical to the single fused program: internal edges never
    turn external again and the sweeps are min-reductions indifferent to
    edge order/duplicates."""
    import jax.numpy as jnp
    import obia_tpu.ops.connectivity as C

    blocks = rng.integers(0, 150, (30, 26)).astype(np.int32)
    lab = np.repeat(np.repeat(blocks, 5, axis=0), 5, axis=1)
    lab[:3, :2] = -1
    # sprinkle dust fragments (the regime the two-phase path targets)
    dust_r = rng.integers(1, 149, 60)
    dust_c = rng.integers(1, 129, 60)
    lab[dust_r, dust_c] = 10_000 + np.arange(60, dtype=np.int32)
    dense, k = C.relabel_connected(lab)

    want, k_want = C.merge_small_device(jnp.asarray(dense), k,
                                        min_size=12, max_size=400)
    monkeypatch.setattr(C, "_MERGE_TWO_PHASE_MIN_K", 1)  # force two-phase
    monkeypatch.setattr(C, "_MERGE_EDGE_BUCKET", 1 << 8)
    got, k_got = C.merge_small_device(jnp.asarray(dense), k,
                                      min_size=12, max_size=400)
    assert k_got == k_want
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # head longer than convergence: over-sweeping must stay exact
    monkeypatch.setattr(C, "_MERGE_HEAD_SWEEPS", 64)
    got2, k2 = C.merge_small_device(jnp.asarray(dense), k,
                                    min_size=12, max_size=400)
    assert k2 == k_want
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(want))


@pytest.mark.parametrize("block,shape", [(16, (96, 130)), (32, (64, 64)),
                                         (64, (50, 40)), (256, (80, 90))])
def test_tiled_ccl_bitwise_equals_scan(rng, block, shape):
    """Tiled scan-CCL (block-local scans + seam union) must be BITWISE
    identical to the global scan path: both number components by
    ascending min linear index. Shapes include non-multiples of the
    block and a single-block case."""
    import jax.numpy as jnp
    import obia_tpu.ops.connectivity as C

    H, W = shape
    blocks = rng.integers(0, 12, (H // 8 + 1, W // 8 + 1)).astype(np.int32)
    lab = np.repeat(np.repeat(blocks, 8, axis=0), 8, axis=1)[:H, :W]
    lab[:3, :2] = -1
    # dust + a long snake crossing many block lines
    dust_r = rng.integers(0, H, 40)
    dust_c = rng.integers(0, W, 40)
    lab[dust_r, dust_c] = 50 + np.arange(40, dtype=np.int32)
    lab[H // 2, :] = 99
    lab[:, W // 3] = 99

    want, k_want, conv_w = C.scan_ccl_dense_labels(jnp.asarray(lab))
    got, k_got, conv_g = C.tiled_scan_ccl_dense_labels(jnp.asarray(lab),
                                                       block=block)
    assert bool(conv_w) and bool(np.asarray(conv_g))
    assert int(k_got) == int(k_want)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_tiled_ccl_and_two_phase_merge_fuzz(rng):
    """Randomised bitwise-equality fuzz over the two new big-raster paths
    (tiled CCL vs global scan; two-phase merge vs fused) — random label
    granularity, masks, dust densities, and block sizes."""
    import jax.numpy as jnp
    import obia_tpu.ops.connectivity as C
    from unittest import mock

    for trial in range(6):
        H = int(rng.integers(40, 140))
        W = int(rng.integers(40, 140))
        g = int(rng.integers(3, 14))
        blocks = rng.integers(0, int(rng.integers(4, 60)),
                              (H // g + 1, W // g + 1)).astype(np.int32)
        lab = np.repeat(np.repeat(blocks, g, axis=0), g, axis=1)[:H, :W]
        if rng.random() < 0.5:  # random mask patch
            r0, c0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
            lab[r0:r0 + H // 4, c0:c0 + W // 4] = -1
        n_dust = int(rng.integers(0, 80))
        lab[rng.integers(0, H, n_dust), rng.integers(0, W, n_dust)] = (
            1000 + np.arange(n_dust, dtype=np.int32))
        block = int(rng.choice([8, 16, 32, 128]))

        want, k_want, cw = C.scan_ccl_dense_labels(jnp.asarray(lab))
        got, k_got, cg = C.tiled_scan_ccl_dense_labels(jnp.asarray(lab),
                                                       block=block)
        assert bool(cw) and bool(np.asarray(cg)), (trial, block)
        assert int(k_got) == int(k_want), (trial, block)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"trial {trial} block {block}")

        k = int(k_want)
        if k < 2:
            continue
        mn = int(rng.integers(2, max(3, g * g)))
        mx = mn * int(rng.integers(2, 30))
        m_want, km_want = C.merge_small_device(want, k, mn, mx)
        with mock.patch.object(C, "_MERGE_TWO_PHASE_MIN_K", 1), \
                mock.patch.object(C, "_MERGE_EDGE_BUCKET", 1 << 7), \
                mock.patch.object(C, "_MERGE_RAW_BUCKET", 1 << 9), \
                mock.patch.object(C, "_MERGE_HEAD_SWEEPS",
                                  int(rng.integers(1, 4))):
            m_got, km_got = C.merge_small_device(want, k, mn, mx)
        assert km_got == km_want, (trial, mn, mx)
        np.testing.assert_array_equal(np.asarray(m_got), np.asarray(m_want),
                                      err_msg=f"merge trial {trial}")


def test_rle_label_download_wide_values(rng, monkeypatch):
    """K beyond uint16 takes the wide-RLE path (int32 values)."""
    import jax.numpy as jnp
    import obia_tpu.ops.slic as S

    blocks = rng.integers(0, 70000, (20, 16)).astype(np.int32)
    lab = np.repeat(np.repeat(blocks, 6, axis=0), 8, axis=1)
    monkeypatch.setattr(S, "_RLE_MIN_PIXELS", 1)
    out = S.download_labels(jnp.asarray(lab), 70000)
    np.testing.assert_array_equal(out, lab)


def _hilbert_snake_labels(order=5):
    """A binary label map whose 1-component is a space-filling
    Hilbert-curve snake — needs more scan-CCL alternations than any
    shape-linear cap."""
    def hilbert(order):
        # d2xy over the full curve
        n = 1 << order
        pts = []
        for d in range(n * n):
            rx = ry = 0
            x = y = 0
            t = d
            s = 1
            while s < n:
                rx = 1 & (t // 2)
                ry = 1 & (t ^ rx)
                if ry == 0:
                    if rx == 1:
                        x, y = s - 1 - x, s - 1 - y
                    x, y = y, x
                x += s * rx
                y += s * ry
                t //= 4
                s *= 2
            pts.append((x, y))
        return pts

    pts = hilbert(order)
    H = W = (1 << order) * 2  # upsampled 2x so the path is 4-connected
    lab = np.zeros((H, W), np.int32)
    px, py = pts[0]
    for (x, y) in pts:
        # draw the connecting step then the point (2x upsampling)
        lab[2 * y, 2 * x] = 1
        lab[(py + 2 * y) // 2, (px + 2 * x) // 2] = 1  # doubled-segment mid
        px, py = 2 * x, 2 * y
    return lab


def test_scan_ccl_fallback_on_hilbert_snake():
    """A space-filling Hilbert-curve component out-snakes the scan-CCL
    alternation cap (ADVICE r2 medium): the converged flag must come back
    False and the FastSV fallback must label it as ONE component."""
    import jax.numpy as jnp

    from obia_tpu.ops.connectivity import (fastsv_dense_labels,
                                           relabel_connected,
                                           scan_ccl_dense_labels)

    lab = _hilbert_snake_labels()
    lab_dev = jnp.asarray(lab)
    _, _, conv = scan_ccl_dense_labels(lab_dev)
    assert not bool(conv)  # the cap must be hit, not silently converged
    flab, fk = fastsv_dense_labels(lab_dev)
    flab = np.asarray(flab)
    # the snake is one component under FastSV
    assert len(np.unique(flab[lab == 1])) == 1
    # and the public host entry point must return the CORRECT labelling
    got, n_got = relabel_connected(lab)
    assert len(np.unique(got[lab == 1])) == 1
    np.testing.assert_array_equal(got, flab)


def test_scan_connected_components_snake_falls_back():
    """The public roots entry must apply the on-device FastSV fallback
    when the alternation cap is hit — one root for the whole snake, no
    silent splits."""
    import jax.numpy as jnp

    from obia_tpu.ops.connectivity import scan_connected_components

    lab = _hilbert_snake_labels()
    lab[lab == 0] = -1  # keep only the snake; background is masked
    comp = np.asarray(scan_connected_components(jnp.asarray(lab)))
    assert len(np.unique(comp[lab == 1])) == 1
    assert (comp[lab == -1] == -1).all()


def test_merge_small_device_non_compact_labels_edge_overflow(rng):
    """merge_small_device on labels that were never CCL-compacted (one id
    scattered over many regions): the adjacency edge count can exceed the
    planar bound, and the overflow retry must produce the same result as
    a directly big-enough edge buffer (dropped edges would silently
    mis-merge)."""
    import jax.numpy as jnp

    import obia_tpu.ops.connectivity as C

    # 256 ids scattered over a 160x160 grid: ~20k distinct adjacency
    # pairs >> 4 * K_pad (K_pad = 512)
    k = 256
    lab = rng.integers(0, k, (160, 160)).astype(np.int32)
    lab_dev = jnp.asarray(lab)
    K_pad = 512
    n_edges = int(
        C._label_edges(lab_dev, K_pad, e_factor=128, with_count=True)[2])
    assert n_edges > 4 * K_pad  # the scenario is actually exercised

    got, k_got = C.merge_small_device(lab_dev, k, min_size=40,
                                      max_size=10**6)
    # oracle: the same fused program with a buffer sized to fit upfront
    e_fit = -(-n_edges // K_pad) + 1
    want, k_want, _ = C._merge_small_fused(
        lab_dev, jnp.float32(40), jnp.float32(10**6), K_pad, 512,
        e_factor=e_fit)
    assert k_got == int(k_want)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
