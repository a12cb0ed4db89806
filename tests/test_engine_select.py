"""Engine selection (MDTPU_ENGINE=auto) and the compile-cache location."""
import os

import jax
import pytest

import methyldackel_tpu.parallel as par
from methyldackel_tpu.config import Config


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,want_device", [("gpu", True),
                                                  ("cpu", False)])
def test_auto_picks_device_iff_gpu(monkeypatch, platform, want_device):
    """auto runs the device backends exactly when JAX's first device is a
    GPU — for extract, mbias and perRead alike."""
    monkeypatch.delenv("MDTPU_ENGINE", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform)])
    monkeypatch.setattr(par, "enable_persistent_cache", lambda: None)
    cfg = Config()
    backends = (par.select_backend(cfg), par.select_mbias_backend(cfg),
                par.select_perread_backend(cfg))
    if want_device:
        assert all(b is not None for b in backends)
        assert hasattr(backends[0], "dispatch_group")
    else:
        assert backends == (None, None, None)


def test_unknown_engine_is_an_error(monkeypatch):
    monkeypatch.setenv("MDTPU_ENGINE", "tpu")
    with pytest.raises(ValueError):
        par.select_backend(Config())


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and the code then configures nothing
    (JAX reads the variable itself); without it the cache sits at the fixed
    in-repository .jax_cache."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert par.compile_cache_dir() == str(tmp_path)
        par.enable_persistent_cache()
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(repo, ".jax_cache")
        assert par.compile_cache_dir() == want
        par.enable_persistent_cache()
        assert calls == [("jax_compilation_cache_dir", want)]
