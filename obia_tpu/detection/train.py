"""RetinaNet training loop.

API-parity module for reference obia/detection/train.py
(``train_model(model, train_loader, num_epochs, device)`` :11-50): Adam
lr=1e-4 (:28), epoch loop summing the loss dict, average loss printed per
epoch, model returned. Device-native differences: the step is one jitted
function (forward + focal/box loss + grad + Adam update) cached per padded
image shape; images batch-pad to a common 128-multiple; ground-truth boxes
pad to a fixed slot count for static shapes.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from tqdm import tqdm

from .models import DetectionModel, retinanet_loss

MAX_GT = 128


def _pad_batch(images, targets, multiple: int = 128):
    """Pad CHW images to a common (H, W) multiple and gt boxes to a
    MAX_GT-sized bucket covering the densest image in the batch —
    truncating at a fixed cap would train the dropped objects' anchors
    as background (systematic recall loss on dense scenes). The bucket
    keeps the jitted step's shape count low."""
    H = max(img.shape[1] for img in images)
    W = max(img.shape[2] for img in images)
    H = ((H + multiple - 1) // multiple) * multiple
    W = ((W + multiple - 1) // multiple) * multiple
    C = images[0].shape[0]
    B = len(images)
    n_max = max((len(t["boxes"]) for t in targets), default=0)
    gt_cap = max(MAX_GT, -(-n_max // MAX_GT) * MAX_GT)
    out = np.zeros((B, H, W, C), np.float32)
    boxes = np.zeros((B, gt_cap, 4), np.float32)
    labels = np.zeros((B, gt_cap), np.int32)
    valid = np.zeros((B, gt_cap), bool)
    for i, (img, tgt) in enumerate(zip(images, targets)):
        c, h, w = img.shape
        out[i, :h, :w, :] = np.transpose(img, (1, 2, 0))
        n = len(tgt["boxes"])
        if n:
            boxes[i, :n] = tgt["boxes"]
            labels[i, :n] = tgt["labels"]
            valid[i, :n] = True
    return out, boxes, labels, valid, (H, W)


def _make_train_step(model: DetectionModel, tx):
    @functools.partial(jax.jit, static_argnames=("hw",))
    def step(params, batch_stats, opt_state, images, anchors, boxes, labels,
             valid, hw):
        def loss_fn(p):
            (cls_logits, box_deltas), new_bs = model.module.apply(
                {"params": p, "batch_stats": batch_stats}, images,
                train=True, mutable=["batch_stats"])
            def per_image(cl, bd, bx, lb, vl):
                return retinanet_loss(cl, bd, anchors, bx, lb, vl)
            cls_l, box_l = jax.vmap(per_image)(cls_logits, box_deltas,
                                               boxes, labels, valid)
            return cls_l.mean() + box_l.mean(), new_bs["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_bs, opt_state, loss
    return step


def train_model(model: DetectionModel, train_loader, num_epochs: int,
                checkpoint_dir: str = None):
    """Train (reference train.py:11-50 semantics: Adam 1e-4, per-epoch
    average loss printed, trained model returned; the reference's
    ``device`` argument is gone — JAX runs on its default device).
    ``checkpoint_dir``
    saves params+batch_stats per epoch (the reference never checkpoints —
    SURVEY.md §5)."""
    tx = optax.adam(1e-4)
    opt_state = tx.init(model.params)
    step = _make_train_step(model, tx)

    for epoch in range(num_epochs):
        total_loss = 0.0
        n_batches = 0
        for images, targets in tqdm(train_loader,
                                    desc=f"Epoch {epoch + 1}/{num_epochs}"):
            imgs, boxes, labels, valid, hw = _pad_batch(list(images),
                                                        list(targets))
            anchors = jnp.asarray(model.anchors(hw))
            model.params, model.batch_stats, opt_state, loss = step(
                model.params, model.batch_stats, opt_state,
                jnp.asarray(imgs), anchors, jnp.asarray(boxes),
                jnp.asarray(labels), jnp.asarray(valid), hw)
            total_loss += float(loss)
            n_batches += 1
        avg = total_loss / max(n_batches, 1)
        print(f"Epoch {epoch + 1}/{num_epochs} - Loss: {avg:.4f}")
        if checkpoint_dir:
            import os
            from ..checkpoint import save_pytree
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_pytree(os.path.join(checkpoint_dir, f"epoch_{epoch + 1}"),
                        {"params": model.params,
                         "batch_stats": model.batch_stats})
    return model
