"""Test configuration: force CPU JAX with 8 virtual devices.

Multi-device sharding paths are validated on a virtual CPU mesh
(xla_force_host_platform_device_count) — no accelerator needed to run the
suite.  Tests marked ``gpu`` need a card: the ``gpu_device`` fixture skips
them on a host without one (decided at run time, never at import).
"""

import os
import sys

import pytest

# CPU unless the caller names platforms: the card-marked tests run with
# JAX_PLATFORMS=cpu,cuda (CPU stays the default backend)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# Build the native WFST toolkit once if it's missing (fresh checkout).
_FSTBIN = os.path.join(REPO_ROOT, "native", "build", "fst-tools")
if not os.path.exists(_FSTBIN):
    import shutil
    import subprocess
    if shutil.which("cmake") and shutil.which("ninja"):
        try:
            subprocess.run(
                ["cmake", "-B", "build", "-G", "Ninja", "."],
                cwd=os.path.join(REPO_ROOT, "native"), check=True,
                capture_output=True, timeout=300)
            subprocess.run(
                ["ninja", "-C", "build"],
                cwd=os.path.join(REPO_ROOT, "native"), check=True,
                capture_output=True, timeout=600)
        except (subprocess.SubprocessError, OSError):
            pass  # native tests will skip themselves


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none.  On a card:
    ``JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/``."""
    import jax
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU; JAX sees none")
    return devices[0]
