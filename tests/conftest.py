# Tests run on the single default CPU device. Distributed tests that need
# multiple host devices spawn SUBPROCESSES with XLA_FLAGS set (never set
# xla_force_host_platform_device_count here — smoke tests and benches must
# see 1 device, the dry-run sets its own 512).
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# The sandbox has no network: when the real hypothesis is absent, install the
# deterministic replay shim so property tests still collect and run.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _hypothesis_compat

    _hypothesis_compat.install()


def run_subprocess(code: str, devices: int = 8, timeout: int = 600):
    """Run python code in a subprocess with N fake host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{r.stdout}\n{r.stderr}")
    return r.stdout


@pytest.fixture
def subproc():
    return run_subprocess


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips without one")
