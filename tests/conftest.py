import os
import sys

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without accelerators (SURVEY.md section 4).  The platform
# is the one JAX_PLATFORMS names; unset, it is forced to the CPU before
# any device use.  `gpu`-marked tests need a card and skip elsewhere:
#   JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cpu_only: needs the 8-device virtual CPU mesh")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the `gpu` fixture skips "
        "the test elsewhere)")
    config.addinivalue_line(
        "markers", "slow: full-resolution / multi-minute test, skipped "
        "unless SURF_FULL_TESTS=1 (the quick suite must stay under ~10 "
        "minutes so it actually gets run before commits)")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("SURF_FULL_TESTS") != "1":
        skip_slow = pytest.mark.skip(
            reason="slow test; set SURF_FULL_TESTS=1 for the full suite")
        for item in items:
            if "slow" in item.keywords:
                item.add_marker(skip_slow)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]


# The reference stereo pair (left.pgm / right.pgm, 2739 / 3443 keypoints)
# is not part of the repository; the golden tests run once it is
# committed here.
REFERENCE_DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_image(rng):
    """Smooth synthetic test image with blob structure at several scales."""
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 96 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    for (cy, cx, s, a) in [(30, 40, 4, 90), (70, 110, 8, -70), (90, 30, 6, 80),
                           (40, 130, 5, -60), (100, 90, 10, 70)]:
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 2.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _reference_image(name):
    from cuda_surf_tpu.io import read_pgm
    path = os.path.join(REFERENCE_DATA, name)
    if not os.path.exists(path):
        pytest.skip(f"reference fixture {name} is not in tests/data")
    return read_pgm(path)


@pytest.fixture(scope="session")
def left_image():
    return _reference_image("left.pgm")


@pytest.fixture(scope="session")
def right_image():
    return _reference_image("right.pgm")
