"""Test configuration: run on a virtual 8-device CPU mesh with x64.

Must set the environment before jax initializes its backends; pytest
imports conftest.py before any test module, so this is the first jax
touchpoint in the test process.
"""

import os
import sys

# Tests run on the virtual CPU mesh, also on a machine with a GPU —
# force it, don't setdefault.  Tests that need the card are marked
# ``gpu``; chip_smoke.py runs them with IU_TEST_DEVICE=gpu, which leaves
# JAX its default (GPU) platform.
ON_GPU = os.environ.get("IU_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: later runs reuse the XLA compiles.
from interpolate_unstructured_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The bundled VTU fixtures (written by tests/data/make_fixtures.py)
FIXTURE_NAMES = (
    "triangle.vtu", "quad.vtu", "tetra.vtu", "tetra_cell.vtu",
    "tetra_two_cell.vtu",
)
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="session")
def test_data_dir(tmp_path_factory):
    """Copy the VTU fixtures to a writable directory (binda conversion
    writes alongside the input)."""
    import shutil

    dst = tmp_path_factory.mktemp("test_data")
    for name in FIXTURE_NAMES:
        shutil.copy(os.path.join(DATA_DIR, name), dst / name)
    return dst


@pytest.fixture
def gpu():
    """Skip unless a GPU is present; the device check runs here, at test
    time, never at import.  The CPU suite pins JAX to the CPU, so these
    tests run through ``python chip_smoke.py`` on the card."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devices[0]


@pytest.fixture(scope="session")
def triangle_grid(test_data_dir):
    from interpolate_unstructured_tpu import read_grid

    return read_grid(test_data_dir / "triangle.vtu")


@pytest.fixture(scope="session")
def quad_grid(test_data_dir):
    from interpolate_unstructured_tpu import read_grid

    return read_grid(test_data_dir / "quad.vtu")


@pytest.fixture(scope="session")
def tetra_grid(test_data_dir):
    from interpolate_unstructured_tpu import read_grid

    return read_grid(test_data_dir / "tetra.vtu")


def sample_points(rng, rmin, rmax, n):
    """Uniform samples in a bounding box (test_triangle.f90:33-37)."""
    rmin = np.asarray(rmin, dtype=np.float64)
    rmax = np.asarray(rmax, dtype=np.float64)
    return rmin + rng.random((n, 3)) * (rmax - rmin)
