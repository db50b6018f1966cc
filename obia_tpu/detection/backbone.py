"""ResNet-50 backbone + FPN in Flax.

Flax replacement for the torchvision ``retinanet_resnet50_fpn``
backbone the reference builds (reference detection/models.py:30): bottleneck
ResNet-50 emitting C3/C4/C5, and a feature pyramid P3-P7. Supports arbitrary
input channel counts (the reference performs first-conv surgery for
N-channel imagery, models.py:45-60 — here ``in_channels`` is simply a
constructor argument). bfloat16-friendly: all convs are matrix-unit
work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
from flax import linen as nn


class Bottleneck(nn.Module):
    features: int
    strides: int = 1
    expansion: int = 4

    @nn.compact
    def __call__(self, x, train: bool = False):
        residual = x
        y = nn.Conv(self.features, (1, 1), use_bias=False)(x)
        y = nn.BatchNorm(use_running_average=not train)(y)
        y = nn.relu(y)
        y = nn.Conv(self.features, (3, 3), strides=(self.strides,) * 2,
                    padding=1, use_bias=False)(y)
        y = nn.BatchNorm(use_running_average=not train)(y)
        y = nn.relu(y)
        y = nn.Conv(self.features * self.expansion, (1, 1), use_bias=False)(y)
        y = nn.BatchNorm(use_running_average=not train)(y)
        if residual.shape != y.shape:
            residual = nn.Conv(self.features * self.expansion, (1, 1),
                               strides=(self.strides,) * 2,
                               use_bias=False)(x)
            residual = nn.BatchNorm(use_running_average=not train)(residual)
        return nn.relu(y + residual)


class ResNet50(nn.Module):
    """Returns (C3, C4, C5) feature maps at strides 8/16/32. ``width``
    scales the base channel count (64 = the real ResNet-50; small values
    give a CI-sized backbone with identical topology)."""
    in_channels: int = 3
    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    width: int = 64

    @nn.compact
    def __call__(self, x, train: bool = False):
        y = nn.Conv(self.width, (7, 7), strides=(2, 2), padding=3,
                    use_bias=False, name="conv1")(x)
        y = nn.BatchNorm(use_running_average=not train)(y)
        y = nn.relu(y)
        y = nn.max_pool(y, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
        outputs = []
        for i, block_count in enumerate(self.stage_sizes):
            features = self.width * (2 ** i)
            for j in range(block_count):
                strides = 2 if (i > 0 and j == 0) else 1
                y = Bottleneck(features, strides)(y, train)
            if i >= 1:
                outputs.append(y)
        return tuple(outputs)  # C3, C4, C5


class FPN(nn.Module):
    """Feature pyramid P3-P7 (RetinaNet variant: P6/P7 from C5)."""
    out_channels: int = 256

    @nn.compact
    def __call__(self, feats: Tuple[jnp.ndarray, ...]):
        c3, c4, c5 = feats
        p5 = nn.Conv(self.out_channels, (1, 1), name="lat5")(c5)
        p4 = nn.Conv(self.out_channels, (1, 1), name="lat4")(c4) \
            + _upsample2x(p5, c4.shape)
        p3 = nn.Conv(self.out_channels, (1, 1), name="lat3")(c3) \
            + _upsample2x(p4, c3.shape)
        p3 = nn.Conv(self.out_channels, (3, 3), padding=1, name="out3")(p3)
        p4 = nn.Conv(self.out_channels, (3, 3), padding=1, name="out4")(p4)
        p5 = nn.Conv(self.out_channels, (3, 3), padding=1, name="out5")(p5)
        p6 = nn.Conv(self.out_channels, (3, 3), strides=(2, 2), padding=1,
                     name="p6")(c5)
        p7 = nn.Conv(self.out_channels, (3, 3), strides=(2, 2), padding=1,
                     name="p7")(nn.relu(p6))
        return (p3, p4, p5, p6, p7)


def _upsample2x(x, target_shape):
    b, h, w, c = x.shape
    th, tw = target_shape[1], target_shape[2]
    up = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return up[:, :th, :tw, :]
