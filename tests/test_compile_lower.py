"""AOT-lowerability guard for the sharded production programs.

A trace-breaking host sync (a ``device_get`` inside the traced function,
like the old hybrid-ASM auto-cap retry in sharded.py) would make a
sharded program impossible to compile ahead of time. Every sharded
program must trace + lower under ``jax.jit`` on the 8-device CPU mesh.
This checks no device memory budget — only that the programs still
consist of pure traced computation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from obia_tpu.ops.stats import pad_num_segments
from obia_tpu.parallel import sharded as S

H, W, C = 64, 128, 3
N_SEG = 48


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return S.make_mesh(8)


def _structs(mesh):
    img = jax.ShapeDtypeStruct((H, W, C), jnp.float32,
                               sharding=NamedSharding(mesh, P("ty", "tx",
                                                              None)))
    lab = jax.ShapeDtypeStruct((H, W), jnp.int32,
                               sharding=NamedSharding(mesh, P("ty", "tx")))
    return img, lab


def test_lower_slic_assign(mesh):
    img, _ = _structs(mesh)
    jax.jit(lambda im: S.sharded_slic_assign(mesh, im, N_SEG)).lower(img)


def test_lower_ccl_local(mesh):
    _, lab = _structs(mesh)
    run, _ = S._local_ccl_factory(mesh, H, W, (H, W), 256)
    jax.jit(run).lower(lab)


def test_lower_merge_edges(mesh):
    _, lab = _structs(mesh)
    K_pad = pad_num_segments(N_SEG)
    jax.jit(S._merge_edges_factory(mesh, K_pad)).lower(lab)


def test_lower_dust_phase_a(mesh):
    from obia_tpu.ops.connectivity import _MERGE_HEAD_SWEEPS
    _, lab = _structs(mesh)
    K_pad = pad_num_segments(N_SEG)
    scal = jax.ShapeDtypeStruct((), jnp.float32)
    fn = S._dust_phase_a_factory(mesh, K_pad, 1 << 10, _MERGE_HEAD_SWEEPS)
    jax.jit(fn).lower(lab, scal, scal)


def test_lower_spectral_moments(mesh):
    img, lab = _structs(mesh)
    K_pad = pad_num_segments(N_SEG)
    jax.jit(lambda im, lb: S.sharded_spectral_moments(
        mesh, im, lb, K_pad, packed=True)[1]).lower(img, lab)


def test_lower_glcm_props(mesh):
    # THE regression this file exists for: an auto-cap retry did
    # int(jax.device_get(n_multi)) inside the trace, which raised
    # ConcretizationTypeError exactly here
    img, lab = _structs(mesh)
    K_pad = pad_num_segments(N_SEG)
    jax.jit(lambda im, lb: S.sharded_glcm_props(
        mesh, im, lb, K_pad, levels=16, packed=True,
        multi_cap=64)[1]).lower(img, lab)


def test_count_shard_spanning_exact(mesh):
    # the pre-pass that sizes multi_cap must agree with a host count of
    # objects whose pixels land on >1 shard
    rng = np.random.default_rng(0)
    lab = np.repeat(np.repeat(
        rng.integers(0, N_SEG, (8, 16)), H // 8, 0), W // 16, 1)
    lab_dev, _ = S.shard_raster(mesh, lab.astype(np.int32))
    n_multi, mask = S.count_shard_spanning(mesh, lab_dev, N_SEG)

    ty, tx = mesh.devices.shape
    hs, ws = H // ty, W // tx
    present = np.zeros((N_SEG,), int)
    for i in range(ty):
        for j in range(tx):
            blk = lab[i * hs:(i + 1) * hs, j * ws:(j + 1) * ws]
            present[np.unique(blk[blk >= 0])] += 1
    expect = present > 1
    assert n_multi == int(expect.sum())
    assert np.array_equal(mask[:N_SEG], expect)
