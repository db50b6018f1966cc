"""The XLA scatter GLCM (the only GLCM path) at the reference's settings —
256 levels, distance 2, four angles — against the naive per-object
oracle, and the sharded scatter GLCM on 1x4 and 2x2 meshes against the
single-device result."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from obia_tpu.ops import glcm
from obia_tpu.parallel.sharded import (make_mesh, shard_raster,
                                       sharded_glcm_props)
from test_ops_stats import naive_glcm_props, random_labels

PROPS = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy",
         "correlation")


@pytest.mark.parametrize("h,w,c,k", [
    (40, 56, 1, 6),     # single band
    (37, 53, 3, 9),     # ragged sides, multi-band
    (64, 48, 2, 14),    # multi-band, more objects than 8-px blocks cover
])
@pytest.mark.parametrize("fused", [True, False])
def test_scatter_glcm_matches_naive(h, w, c, k, fused, monkeypatch):
    """Both the band-fused program (small scenes) and the per-band
    quantise-then-scatter programs (large scenes) match the oracle."""
    if not fused:
        monkeypatch.setattr(glcm, "_FUSE_BANDS_MAX_ELEMS", 0)
    rng = np.random.default_rng(h * w + c)
    img = (rng.random((h, w, c)) * 2047).astype(np.float32)
    lab = random_labels(rng, h, w, k)
    lab[:3, :5] = -1  # masked pixels
    got = glcm.glcm_table(img, lab, k, levels=256, distance=2)
    for b in range(c):
        want = naive_glcm_props(img[:, :, b], lab, k, levels=256)
        for p in PROPS:
            np.testing.assert_allclose(got[p][:, b], want[p], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{p} band {b}")


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_scatter_glcm_matches_single_device(shape):
    """Row-strip and square meshes: the halo exchange and the hybrid
    seam-spanner ASM give the single-device props."""
    n = shape[0] * shape[1]
    mesh = (Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("ty", "tx"))
            if shape == (1, 4) else make_mesh(n))
    assert mesh.devices.shape == shape
    rng = np.random.default_rng(5)
    H, W = 32, 48
    img_np = (rng.random((H, W, 2)) * 1000).astype(np.float32)
    lab_np = random_labels(rng, H, W, 10)
    lab_np[2:5, 3:7] = -1
    want = glcm.glcm_table(img_np, lab_np, 10, levels=256)
    img, _ = shard_raster(mesh, img_np)
    lab, _ = shard_raster(mesh, lab_np, fill=-1)
    out = sharded_glcm_props(mesh, img, lab, 10, levels=256)
    for p in PROPS:
        np.testing.assert_allclose(np.asarray(out[p]), want[p], rtol=2e-4,
                                   atol=2e-5, err_msg=p)


@pytest.mark.parametrize("ulps", [-2, -1, 1, 2])
def test_levels_independent_of_inverse_rounding(ulps):
    """On integer rasters many pixels sit on exact-integer quotients
    (d * 255 a multiple of the range); their levels must not depend on
    how the division (levels-1)/range rounded, which differs between the
    CPU and the GPU."""
    import jax.numpy as jnp
    rng = np.random.default_rng(ulps + 10)
    r = rng.choice([255, 510, 765, 1020, 1785, 2047, 4080], (64, 1))
    d = np.minimum(rng.integers(0, 4096, (64, 4096)), r)
    want = d * 255 // r                       # exact integer floor
    r = r.astype(np.float32)
    inv = (np.float32(255) / r).view(np.int32) + ulps
    got = glcm._levels_from_inverse(
        jnp.asarray(d, jnp.float32), jnp.asarray(r), jnp.asarray(r > 0),
        jnp.asarray(inv.view(np.float32)), 256)
    np.testing.assert_array_equal(np.asarray(got), want)
