"""chip_smoke.py rehearsed on XLA:CPU at a tiny size: the phases that run
on the CPU platform (device-only extract, mbias/perRead device backends),
and the script's refusal to run without a GPU."""
import os
import subprocess
import sys

import pytest

import chip_smoke


def test_chip_smoke_device_only_extract_cpu(tmp_path):
    note = chip_smoke.phase_device_only("cpu", 3000, 1 << 18, str(tmp_path))
    assert "device lane" in note


def test_chip_smoke_subcommands_cpu(tmp_path):
    chip_smoke.phase_subcommands("cpu", 2000, 1 << 17, str(tmp_path))


def test_chip_smoke_refuses_cpu():
    """Without a GPU the script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, chip_smoke.__file__], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_compile_phase_cpu(tmp_path):
    """The K=4 candidate-space group program over four 1 Mb windows, vs
    ops.semantics (small read count)."""
    chip_smoke.phase_compile("cpu", 20_000, str(tmp_path))


@pytest.mark.gpu
def test_chip_smoke_compile_phase_gpu(gpu, tmp_path):
    chip_smoke.phase_compile("gpu", 200_000, str(tmp_path))


def test_chip_smoke_mesh_phase_cpu4(tmp_path):
    """The --four phase (MDTPU_ENGINE=mesh over 4 devices) on 4 virtual
    CPU devices: the device count must be fixed before JAX starts, so it
    runs in its own process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = ("import sys, chip_smoke; "
            "print(chip_smoke.phase_mesh('cpu', 3000, 1 << 18, sys.argv[1]))")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                       cwd=os.path.dirname(chip_smoke.__file__),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "4-device mesh" in r.stdout
