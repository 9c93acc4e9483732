"""Test config: run everything on a simulated 8-device CPU mesh.

Multi-chip sharding is validated without accelerators via XLA's host
platform device-count override (SURVEY.md section 4.5).  Must be set
before jax is imported anywhere.

Tests marked `chip` need an NVIDIA GPU: run them on the card with
DSK_TEST_PLATFORM=gpu python -m pytest -m chip tests/
(they skip elsewhere; the `gpu` fixture decides, never import time).
"""

import os

# The CPU backend by default: the suite validates semantics and sharding
# on a virtual 8-device mesh.  DSK_TEST_PLATFORM=gpu leaves the platform
# to JAX for the `chip` tests.  XLA_FLAGS must be in the env before the
# first jax.devices() call.
PLATFORM = os.environ.get("DSK_TEST_PLATFORM", "cpu")
if PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX device is {dev.platform})")
    return dev


def load_histo_fixture(path) -> dict[int, int]:
    """Parse a reference .histo fixture: '<abundance>\\t<count>' lines."""
    out = {}
    with open(path) as f:
        for line in f:
            a, c = line.split()
            out[int(a)] = int(c)
    return out
