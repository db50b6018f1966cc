"""Detection benchmark on the GPU: jitted RetinaNet train step +
whole-raster predict at a realistic tile size.

Model: the production default — ResNet-50 backbone (stage_sizes 3/4/6/3,
width 64), FPN 256, torchvision-default anchors — on 8-band imagery
(reference detection/models.py:19-62, train.py:11-50, predict.py:14-57).
Scene: 1024x1024 x8-band tiles.

Reports: train-step wall clock (batch 2, warm best-of), images/sec,
whole-raster predict wall clock (decode + per-class NMS included), MP/s.
Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from obia_tpu import compile_cache  # noqa: E402


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    C = 8
    import jax
    import jax.numpy as jnp
    import optax

    compile_cache.enable()

    from obia_tpu.detection.models import build_detection_model
    from obia_tpu.detection.train import _make_train_step, _pad_batch
    from obia_tpu.detection.predict import infer_image_array

    rng = np.random.default_rng(0)
    model = build_detection_model(num_classes=2, in_channels=C,
                                  image_size=(size, size))

    # synthetic batch: a few boxes per tile
    images = [rng.random((C, size, size), np.float32) for _ in range(batch)]
    targets = []
    for _ in range(batch):
        n = 12
        x0 = rng.uniform(0, size - 80, n)
        y0 = rng.uniform(0, size - 80, n)
        w = rng.uniform(20, 70, n)
        h = rng.uniform(20, 70, n)
        targets.append({
            "boxes": np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32),
            "labels": np.ones(n, np.int32)})

    imgs, boxes, labels, valid, hw = _pad_batch(images, targets)
    anchors = jnp.asarray(model.anchors(hw))
    tx = optax.adam(1e-4)
    opt_state = tx.init(model.params)
    step = _make_train_step(model, tx)

    args = (jnp.asarray(imgs), anchors, jnp.asarray(boxes),
            jnp.asarray(labels), jnp.asarray(valid))

    t0 = time.time()
    params, bs, opt_state, loss = step(model.params, model.batch_stats,
                                       opt_state, *args, hw=hw)
    loss.block_until_ready()
    first_train = time.time() - t0

    best_train = float("inf")
    for _ in range(5):
        t0 = time.time()
        params, bs, opt_state, loss = step(params, bs, opt_state, *args,
                                           hw=hw)
        loss.block_until_ready()
        best_train = min(best_train, time.time() - t0)
    model.params, model.batch_stats = params, bs

    # whole-raster predict (jitted forward + decode + per-class NMS)
    scene = rng.random((size, size, C), np.float32)
    t0 = time.time()
    out = infer_image_array(model, scene, score_threshold=0.05,
                            nms_threshold=0.5)
    first_pred = time.time() - t0
    best_pred = float("inf")
    for _ in range(3):
        t0 = time.time()
        out = infer_image_array(model, scene, score_threshold=0.05,
                                nms_threshold=0.5)
        best_pred = min(best_pred, time.time() - t0)

    mp = size * size / 1e6
    print(json.dumps({
        "detection_bench": {
            "tile": f"{size}x{size}x{C}", "batch": batch,
            "backbone": "resnet50-w64-fpn256",
            "train_step_s": round(best_train, 3),
            "train_step_first_s": round(first_train, 1),
            "train_images_per_s": round(batch / best_train, 2),
            "loss": round(float(loss), 4),
            "predict_s": round(best_pred, 3),
            "predict_first_s": round(first_pred, 1),
            "predict_mp_s": round(mp / best_pred, 3),
            "n_detections": int(len(out["boxes"])),
        }}))


if __name__ == "__main__":
    main()
