"""Flagship model: the fused OBIA pipeline as one jittable program.

``obia_forward`` is the device-resident core of what the reference does as
four separate CPU stages (skimage slic → per-object loops → sklearn
predict, reference segment.py:63-93 + classify.py:68-175): SLIC k-means
iterations, per-object moment features, feature standardisation, and MLP
class logits — all under one ``jit``. ``sharded_train_step`` is the same
pipeline over a ``Mesh`` (2-D raster sharding for segmentation/statistics,
data-parallel gradient psum for the classifier head), used by the driver's
multi-chip dry run.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.slic import (_grid_shape, initial_centers, slic_assign_block,
                        slic_update_sums)

MLP_HIDDEN = 64


def init_mlp_params(key, n_features: int, n_classes: int,
                    hidden: int = MLP_HIDDEN):
    k1, k2 = jax.random.split(key)
    scale1 = 1.0 / math.sqrt(n_features)
    scale2 = 1.0 / math.sqrt(hidden)
    return {
        "w1": jax.random.normal(k1, (n_features, hidden), jnp.float32) * scale1,
        "b1": jnp.zeros((hidden,), jnp.float32),
        "w2": jax.random.normal(k2, (hidden, n_classes), jnp.float32) * scale2,
        "b2": jnp.zeros((n_classes,), jnp.float32),
    }


def mlp_apply(params, x):
    h = jax.nn.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _object_features(image, labels, K: int):
    """(K, 2C+1) per-object features: mean, variance, log-count."""
    H, W, C = image.shape
    x = image.reshape(-1, C)
    lab = labels.reshape(-1)
    ok = lab >= 0
    safe = jnp.where(ok, lab, 0)
    w = ok.astype(jnp.float32)[:, None]
    cnt = jax.ops.segment_sum(w[:, 0], safe, num_segments=K)
    s1 = jax.ops.segment_sum(x * w, safe, num_segments=K)
    s2 = jax.ops.segment_sum(x * x * w, safe, num_segments=K)
    denom = jnp.maximum(cnt, 1.0)[:, None]
    mean = s1 / denom
    var = jnp.maximum(s2 / denom - mean ** 2, 0.0)
    return jnp.concatenate(
        [mean, var, jnp.log1p(cnt)[:, None]], axis=1), cnt


def _standardize(feats):
    mu = feats.mean(axis=0, keepdims=True)
    sd = feats.std(axis=0, keepdims=True) + 1e-6
    return (feats - mu) / sd


@functools.partial(jax.jit, static_argnames=("gh", "gw", "n_iter",
                                             "compactness"))
def obia_forward(image: jnp.ndarray, params, *, gh: int, gw: int,
                 n_iter: int = 5, compactness: float = 10.0):
    """One fused forward pass: SLIC -> object features -> class logits.

    Returns (logits (K, n_classes), labels (H, W) int32).
    """
    H, W, C = image.shape
    K = gh * gw
    step = math.sqrt(H * W / K)
    ratio = (compactness / step) ** 2
    valid = jnp.ones((H, W), bool)
    centers = initial_centers(image, gh, gw)

    def body(_, c):
        lab = slic_assign_block(image, valid, c, 0.0, 0.0, gh, gw, H, W, ratio)
        sums, cnts = slic_update_sums(image, lab, 0.0, 0.0, K)
        means = sums / jnp.maximum(cnts, 1.0)[:, None]
        means = jnp.where((cnts > 0)[:, None], means, c.reshape(K, -1))
        return means.reshape(gh, gw, -1)

    centers = jax.lax.fori_loop(0, n_iter, body, centers)
    labels = slic_assign_block(image, valid, centers, 0.0, 0.0,
                               gh, gw, H, W, ratio)
    feats, _ = _object_features(image, labels, K)
    logits = mlp_apply(params, _standardize(feats))
    return logits, labels


def make_flagship(h: int = 512, w: int = 512, c: int = 4,
                  n_segments: int = 256, n_classes: int = 8):
    """Build (jittable_fn, example_args) for the driver's single-chip
    compile check."""
    gh, gw = _grid_shape(h, w, n_segments)
    params = init_mlp_params(jax.random.PRNGKey(0), 2 * c + 1, n_classes)
    rng = np.random.default_rng(0)
    image = jnp.asarray(rng.random((h, w, c)), jnp.float32)

    def fn(image, params):
        return obia_forward(image, params, gh=gh, gw=gw)

    return fn, (image, params)


# ---------------------------------------------------------------------------
# Sharded full training step (multi-chip dry run)
# ---------------------------------------------------------------------------

def make_sharded_train_step(mesh: Mesh, H: int, W: int, C: int,
                            n_segments: int, n_classes: int,
                            compactness: float = 10.0, n_iter: int = 2,
                            lr: float = 1e-3):
    """Full training step over the mesh:

    * raster 2-D sharded over ("ty", "tx") — segmentation + object
      statistics with psum center/moment reductions (collectives only),
    * classifier head trained data-parallel: each device grads its own
      slice of the object batch, gradients psum across the mesh,
      optax SGD update applied replicated.
    """
    gh, gw = _grid_shape(H, W, n_segments)
    K = gh * gw
    step = math.sqrt(H * W / K)
    ratio = (compactness / step) ** 2
    ty, tx = mesh.devices.shape
    n_dev = ty * tx
    h_loc, w_loc = H // ty, W // tx
    F = 2 * C + 1
    Kpad = ((K + n_dev - 1) // n_dev) * n_dev
    tx_opt = optax.sgd(lr)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("ty", "tx", None),          # image
                  P(None),                       # targets (K,)
                  P(None, None, None),           # centers
                  P(None), P(None)),             # params tree, opt_state
        out_specs=(P(None), P(None), P(), P(None, None, None)),
        check_vma=False)
    def train_step(local_img, targets, centers, params, opt_state):
        iy = jax.lax.axis_index("ty")
        ix = jax.lax.axis_index("tx")
        row0 = (iy * h_loc).astype(jnp.float32)
        col0 = (ix * w_loc).astype(jnp.float32)
        valid = jnp.ones((h_loc, w_loc), bool)

        def body(_, c):
            lab = slic_assign_block(local_img, valid, c, row0, col0,
                                    gh, gw, H, W, ratio)
            sums, cnts = slic_update_sums(local_img, lab, row0, col0, K)
            sums = jax.lax.psum(sums, ("ty", "tx"))
            cnts = jax.lax.psum(cnts, ("ty", "tx"))
            means = sums / jnp.maximum(cnts, 1.0)[:, None]
            means = jnp.where((cnts > 0)[:, None], means, c.reshape(K, -1))
            return means.reshape(gh, gw, -1)

        centers_f = jax.lax.fori_loop(0, n_iter, body, centers)
        labels = slic_assign_block(local_img, valid, centers_f, row0, col0,
                                   gh, gw, H, W, ratio)

        # distributed object features: psum partial moments
        x = local_img.reshape(-1, C)
        lab = labels.reshape(-1)
        w = jnp.ones_like(lab, jnp.float32)[:, None]
        cnt = jax.lax.psum(
            jax.ops.segment_sum(w[:, 0], lab, num_segments=K), ("ty", "tx"))
        s1 = jax.lax.psum(
            jax.ops.segment_sum(x * w, lab, num_segments=K), ("ty", "tx"))
        s2 = jax.lax.psum(
            jax.ops.segment_sum(x * x * w, lab, num_segments=K), ("ty", "tx"))
        denom = jnp.maximum(cnt, 1.0)[:, None]
        mean = s1 / denom
        var = jnp.maximum(s2 / denom - mean ** 2, 0.0)
        feats = jnp.concatenate([mean, var, jnp.log1p(cnt)[:, None]], axis=1)
        feats = _standardize(feats)

        # data-parallel classifier training: each device takes its slice of
        # the padded object batch, grads psum over the whole mesh
        dev = iy * tx + ix
        per_dev = Kpad // n_dev
        pad = Kpad - K
        feats_p = jnp.pad(feats, ((0, pad), (0, 0)))
        targets_p = jnp.pad(targets, (0, pad), constant_values=-1)
        start = dev * per_dev
        fslice = jax.lax.dynamic_slice(feats_p, (start, 0), (per_dev, F))
        tslice = jax.lax.dynamic_slice(targets_p, (start,), (per_dev,))

        mask = (tslice >= 0).astype(jnp.float32)
        # global valid count: dividing per-device means by the DEVICE
        # count (pmean) would over-weight objects on partially-padded
        # devices; each device contributes sum/global_n instead, so the
        # psum'd loss/grads equal the exact global batch mean
        n_valid = jax.lax.psum(mask.sum(), ("ty", "tx"))

        def loss_fn(p):
            logits = mlp_apply(p, fslice)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.maximum(tslice, 0))
            return (ce * mask).sum() / jnp.maximum(n_valid, 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.lax.psum(grads, ("ty", "tx"))
        loss = jax.lax.psum(loss, ("ty", "tx"))
        updates, opt_state = tx_opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, centers_f

    def init():
        params = init_mlp_params(jax.random.PRNGKey(0), F, n_classes)
        opt_state = tx_opt.init(params)
        return params, opt_state

    return train_step, init, (gh, gw, K)
