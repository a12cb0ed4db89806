import os
import sys

# The suite runs on XLA:CPU with a virtual 8-device mesh unless the caller
# chooses a platform (JAX_PLATFORMS=cuda runs the `gpu`-marked tests on a
# card: python -m pytest -m gpu tests/).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import shutil

import pytest

FIXTURES = "/root/reference/tests"


@pytest.fixture()
def fixture_dir(tmp_path):
    """Copy the reference test fixtures into a writable directory."""
    for name in os.listdir(FIXTURES):
        if name.endswith((".fa", ".bam", ".bai", ".fq")):
            shutil.copy(os.path.join(FIXTURES, name), tmp_path / name)
    return tmp_path


@pytest.fixture()
def gpu():
    """The first JAX device, for tests marked `gpu`; skips without a GPU.
    Decided here, at test time, so every xdist worker collects the same
    tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/` on "
                    "a machine with one")
    return dev
