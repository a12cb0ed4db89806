"""Device execution backends.

MDTPU_ENGINE chooses the per-window compute implementation:
- host → exact host (numpy + native) semantics (methyldackel_tpu.ops.semantics);
- jax → the JAX device programs (methyldackel_tpu.parallel.device) on
  whatever platform JAX runs, the CPU included; they compute the same
  uint32 counters and are tested bit-equal against the host path;
- mesh → the (dp, sp) sharded extract program over all local devices;
- auto (default) → the device programs iff JAX's first device is a GPU,
  otherwise the host engine.
"""
from __future__ import annotations

import os

_ENGINES = ("auto", "host", "jax", "mesh")


def compile_cache_dir() -> str:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when the
    environment sets it, otherwise the fixed `.jax_cache` at the repository
    root (a fixed path: the directory is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_persistent_cache():
    """Persistent XLA compilation cache, so every process after the first
    skips the compiles. JAX reads JAX_COMPILATION_CACHE_DIR itself; only
    when it is unset is the in-repository directory configured here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    d = compile_cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)


def _apply_device_chunk(cfg):
    """MDTPU_DEVICE_CHUNK: device-engine window size override (bytes of
    genome per window). Bigger windows amortize per-window dispatch,
    readback and finalize overheads; output is chunk-size invariant
    (adjustBounds; tests). Only applied when the user left --chunkSize at
    its default."""
    ov = os.environ.get("MDTPU_DEVICE_CHUNK")
    if ov and int(getattr(cfg, "chunkSize", 0)) == 1_000_000:
        cfg.chunkSize = max(1, int(ov))


def _engine_mode() -> str:
    mode = os.environ.get("MDTPU_ENGINE", "auto")
    if mode not in _ENGINES:
        raise ValueError(f"MDTPU_ENGINE={mode!r}: expected one of "
                         f"{', '.join(_ENGINES)}")
    return mode


def _use_device(mode: str) -> bool:
    """host → False; jax/mesh → True; auto → True iff JAX's first device
    is a GPU. A JAX that fails to start raises here: it is never mistaken
    for a machine without an accelerator."""
    if mode == "host":
        return False
    if mode == "auto":
        import jax

        return jax.devices()[0].platform == "gpu"
    return True


def select_backend(cfg):
    """extract's per-window compute backend (None → host engine)."""
    mode = _engine_mode()
    if not _use_device(mode):
        return None
    enable_persistent_cache()
    if mode == "mesh":
        # Multi-device (dp, sp) shard_map engine: reads sharded over dp with
        # psum-merged counters, window coordinates sharded over sp.
        from .mesh import make_mesh_backend

        return make_mesh_backend(cfg)
    from .device import make_device_backend

    _apply_device_chunk(cfg)
    return make_device_backend(cfg)


def _select_device_fn(cfg, make_fn_name):
    """Shared engine-selection policy for the per-subcommand device
    backends (mesh runs the single-device backend: their counter merge is
    already an associative add across windows)."""
    if not _use_device(_engine_mode()):
        return None
    from . import device as _dev

    enable_persistent_cache()
    return getattr(_dev, make_fn_name)(cfg)


def select_mbias_backend(cfg):
    """Device compute for the mbias counter tensor (None → host numpy)."""
    return _select_device_fn(cfg, "make_mbias_backend")


def select_perread_backend(cfg):
    """Device chain walker for perRead's gapless rows (None → host numpy)."""
    return _select_device_fn(cfg, "make_perread_backend")
