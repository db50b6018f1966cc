"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding /
halo-exchange / seam-merge logic is exercised without an accelerator
(SURVEY.md §4 implication (c)). Tests that need a GPU carry the ``gpu``
marker and decide inside the test whether one is present."""
import os

# override the env AND the jax config before any backend init, so a
# machine with a GPU still runs the suite on the CPU mesh
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def small_rgb(rng):
    """Synthetic 96x128 3-band float image with blocky structure (so
    segmentation produces meaningful regions)."""
    h, w = 96, 128
    base = np.zeros((h, w, 3), np.float32)
    base[:h // 2, :, 0] = 0.8
    base[h // 2:, :, 1] = 0.6
    base[:, w // 2:, 2] = 0.9
    noise = rng.normal(0, 0.03, size=(h, w, 3)).astype(np.float32)
    return np.clip(base + noise, 0, 1)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running at-scale test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none")
