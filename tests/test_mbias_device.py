"""Device mbias kernel parity (parallel.device.mbias_device vs the exact
numpy oracle sem.mbias_counters) + e2e: the mbias CLI with --txt must be
byte-identical between host and device engines."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_case(rng, n, L, glen):
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch
    from methyldackel_tpu.ops import semantics as sem

    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch(rng, ref_codes, n_pairs=n // 2, read_len=L)
    st = sem.strand(batch.flag, batch.xg)
    return ref_ascii, batch, st


@pytest.mark.parametrize("keep_ctx", [(1, 0, 0), (1, 1, 1), (0, 1, 1)])
def test_mbias_device_parity(keep_ctx):
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel.device import make_mbias_backend
    from methyldackel_tpu.config import Config

    rng = np.random.default_rng(42)
    ref_ascii, batch, st = _random_case(rng, 30, 40, 800)
    keep_base = rng.random(batch.seq.shape) < 0.9
    cfg = Config()
    cfg.chunkSize = 512
    W = 512
    wl = int(batch.l_qseq.max())
    host = sem.mbias_counters(batch.seq, batch.qual, batch.refpos, st,
                              batch.flag, keep_base, ref_ascii, 0, 0, W,
                              keep_ctx, cfg.minPhred, wl)
    dev = make_mbias_backend(cfg)(batch.seq, batch.qual, batch.refpos, st,
                                  batch.flag, keep_base, ref_ascii, 0, 0, W,
                                  keep_ctx, wl)
    assert np.array_equal(host, dev)


def test_mbias_device_window_offsets():
    """Non-zero window start/offset + truncated reference."""
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel.device import make_mbias_backend
    from methyldackel_tpu.config import Config

    rng = np.random.default_rng(7)
    ref_ascii, batch, st = _random_case(rng, 20, 32, 600)
    cfg = Config()
    cfg.chunkSize = 256
    keep_base = np.ones(batch.seq.shape, bool)
    # window [100, 356), ref fetched from 100 (mbias has no left slack)
    sub = ref_ascii[100:357]
    wl = int(batch.l_qseq.max())
    host = sem.mbias_counters(batch.seq, batch.qual, batch.refpos, st,
                              batch.flag, keep_base, sub, 100, 100, 356,
                              (1, 1, 1), cfg.minPhred, wl)
    dev = make_mbias_backend(cfg)(batch.seq, batch.qual, batch.refpos, st,
                                  batch.flag, keep_base, sub, 100, 100, 356,
                                  (1, 1, 1), wl)
    assert np.array_equal(host, dev)


def test_mbias_cli_device_byte_identical(fixture_dir):
    base_env = dict(
        os.environ,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    outs = {}
    for engine in ("host", "jax"):
        d = fixture_dir / f"mb_{engine}"
        d.mkdir()
        for name in os.listdir(fixture_dir):
            p = fixture_dir / name
            if p.is_file():
                os.link(p, d / name)
        r = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu.cli", "mbias", "--txt",
             "--CHG", "--CHH", "ct100.fa", "ct_aln.bam", "pref"],
            cwd=d, env=dict(base_env, MDTPU_ENGINE=engine),
            capture_output=True, text=True,
        )
        assert r.returncode == 0, (engine, r.stderr)
        outs[engine] = (r.stdout, sorted(os.listdir(d)))
    assert outs["host"][0] == outs["jax"][0]
    # SVG outputs byte-identical too
    for f in outs["host"][1]:
        if f.endswith(".svg"):
            a = (fixture_dir / "mb_host" / f).read_bytes()
            b = (fixture_dir / "mb_jax" / f).read_bytes()
            assert a == b, f


def test_mbias_v3_pack_path_parity():
    """The v3 mbias backend (native 2-bit pack + device reduction;
    VERDICT r3 #3) must equal the numpy oracle on a mixed batch — gapless
    rows on the packed path, indel rows on the host fallback."""
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel.device import make_mbias_backend
    from methyldackel_tpu.config import Config

    if not native.available():
        pytest.skip("native library not built")
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch

    rng = np.random.default_rng(90)
    ref_ascii, ref_codes = random_reference(rng, 1200)
    batch = simulate_batch(rng, ref_codes, n_pairs=40, read_len=50)
    st = sem.strand(batch.flag, batch.xg)
    # corrupt some rows into indel shapes (refpos gap) to force fallback
    batch.refpos[5, 20:] += 3
    batch.refpos[11, 7] = -1
    keep_base = np.ones(batch.seq.shape, bool)
    cfg = Config()
    cfg.chunkSize = 1024
    W = 1024
    wl = int(batch.l_qseq.max())
    for keep_ctx in ((1, 0, 0), (1, 1, 1)):
        host = sem.mbias_counters(batch.seq, batch.qual, batch.refpos, st,
                                  batch.flag, keep_base, ref_ascii, 0, 0, W,
                                  keep_ctx, cfg.minPhred, wl)
        dev = make_mbias_backend(cfg)(
            batch.seq, batch.qual, batch.refpos, st, batch.flag, keep_base,
            ref_ascii, 0, 0, W, keep_ctx, wl, pos=batch.pos,
            lq=batch.l_qseq)
        assert np.array_equal(host, dev), keep_ctx


def test_mbias_v3_nonzero_window_parity():
    """v3 pack path with a non-zero window start and a truncated ref."""
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel.device import make_mbias_backend
    from methyldackel_tpu.config import Config

    if not native.available():
        pytest.skip("native library not built")
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch

    rng = np.random.default_rng(91)
    ref_ascii, ref_codes = random_reference(rng, 900)
    batch = simulate_batch(rng, ref_codes, n_pairs=30, read_len=40)
    st = sem.strand(batch.flag, batch.xg)
    keep_base = np.ones(batch.seq.shape, bool)
    cfg = Config()
    cfg.chunkSize = 256
    sub = ref_ascii[150:410]
    wl = int(batch.l_qseq.max())
    host = sem.mbias_counters(batch.seq, batch.qual, batch.refpos, st,
                              batch.flag, keep_base, sub, 150, 150, 406,
                              (1, 1, 1), cfg.minPhred, wl)
    dev = make_mbias_backend(cfg)(
        batch.seq, batch.qual, batch.refpos, st, batch.flag, keep_base,
        sub, 150, 150, 406, (1, 1, 1), wl, pos=batch.pos, lq=batch.l_qseq)
    assert np.array_equal(host, dev)
