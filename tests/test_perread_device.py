"""Device perRead chain-walker parity (parallel.device.perread_device vs the
scalar processRead state machine and the vectorized host walker) + e2e CLI
byte identity between engines."""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_perread_device_parity_random():
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.engine.perread import (process_read,
                                                 process_reads_gapless)
    from methyldackel_tpu.parallel.device import make_perread_backend
    from methyldackel_tpu.config import Config

    rng = np.random.default_rng(3)
    cfg = Config()
    cfg.minPhred = 5
    cfg.chunkSize = 512
    ref_ascii, ref_codes = random_reference(rng, 1024)
    batch = simulate_batch(rng, ref_codes, n_pairs=25, read_len=44)
    # low quals so the low-qual skip quirk fires often
    batch.qual[rng.random(batch.qual.shape) < 0.3] = 2
    st = sem.strand(batch.flag, batch.xg)

    nm_h, nu_h = process_reads_gapless(cfg, batch.seq, batch.qual, batch.pos,
                                       batch.l_qseq, st, ref_ascii, 0, 1024)
    walker = make_perread_backend(cfg)
    nm_d, nu_d = walker(batch.seq, batch.qual, batch.pos, batch.l_qseq, st,
                        ref_ascii, 0, 1024)
    assert np.array_equal(nm_h, nm_d)
    assert np.array_equal(nu_h, nu_d)

    # cross-check a few rows against the exact scalar state machine
    for i in range(0, batch.n, 7):
        L = int(batch.l_qseq[i])
        cigar = np.array([(L << 4) | 0], np.uint32)
        nm_s, nu_s = process_read(cfg, batch.seq[i, :L], batch.qual[i, :L],
                                  cigar, int(batch.pos[i]), int(st[i]),
                                  ref_ascii, 0, 1024)
        assert (nm_s, nu_s) == (int(nm_d[i]), int(nu_d[i])), i


def test_perread_device_window_offset():
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.engine.perread import process_reads_gapless
    from methyldackel_tpu.parallel.device import make_perread_backend
    from methyldackel_tpu.config import Config

    rng = np.random.default_rng(4)
    cfg = Config()
    cfg.minPhred = 5
    cfg.chunkSize = 256
    ref_ascii, ref_codes = random_reference(rng, 900)
    batch = simulate_batch(rng, ref_codes, n_pairs=15, read_len=36)
    st = sem.strand(batch.flag, batch.xg)
    # truncated window with a non-zero start
    sub = ref_ascii[198:500]
    nm_h, nu_h = process_reads_gapless(cfg, batch.seq, batch.qual, batch.pos,
                                       batch.l_qseq, st, sub, 198, len(sub))
    walker = make_perread_backend(cfg)
    nm_d, nu_d = walker(batch.seq, batch.qual, batch.pos, batch.l_qseq, st,
                        sub, 198, len(sub))
    assert np.array_equal(nm_h, nm_d)
    assert np.array_equal(nu_h, nu_d)


def test_perread_cli_device_byte_identical(fixture_dir):
    env = dict(
        os.environ,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    outs = {}
    for engine in ("host", "jax"):
        r = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu.cli", "perRead",
             "ct100.fa", "ct_aln.bam"],
            cwd=fixture_dir, env=dict(env, MDTPU_ENGINE=engine),
            capture_output=True, text=True,
        )
        assert r.returncode == 0, (engine, r.stderr)
        outs[engine] = r.stdout
    assert outs["host"] == outs["jax"]
    assert len(outs["host"]) > 0


def test_perread_v3_lowq_rows_exact():
    """The v3 perRead backend routes rows containing sub-phred bases to the
    exact host walker (the low-qual skip quirk, perRead.c:59-63); a batch
    dense with low-qual bases must still match the oracle exactly."""
    import numpy as np
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel.device import make_perread_backend
    from methyldackel_tpu.engine.perread import process_reads_gapless
    from methyldackel_tpu.config import Config
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast

    if not native.available():
        import pytest
        pytest.skip("native library not built")
    rng = np.random.default_rng(77)
    ref_ascii, ref_codes = random_reference(rng, 3000)
    batch = simulate_batch_fast(rng, ref_codes, 60, 60)
    # sprinkle sub-phred quals over half the rows
    low = rng.random(batch.qual.shape) < 0.15
    low[::2] = False
    batch.qual[low] = rng.integers(0, 5, int(low.sum())).astype(np.uint8)
    st = sem.strand(batch.flag, batch.xg)
    cfg = Config()
    cfg.chunkSize = 4096
    want = process_reads_gapless(cfg, batch.seq, batch.qual, batch.pos,
                                 batch.l_qseq, st, ref_ascii, 0,
                                 len(ref_ascii))
    got = make_perread_backend(cfg)(batch.seq, batch.qual, batch.pos,
                                    batch.l_qseq, st, ref_ascii, 0,
                                    len(ref_ascii))
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])


def test_perread_long_reads_fall_back_exactly():
    """Review r4: reads wider than the pack kernel's row temp (1024) must
    take the exact fallback, not silently tally zero (the kernel now
    rejects over-wide rows with rc=-2 and the backend pre-guards)."""
    import numpy as np
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel.device import make_perread_backend
    from methyldackel_tpu.engine.perread import process_reads_gapless
    from methyldackel_tpu.config import Config

    if not native.available():
        import pytest
        pytest.skip("native library not built")
    rng = np.random.default_rng(5)
    L = 1100  # ONT/PacBio-scale
    glen = 4000
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), glen)
    n = 6
    pos = rng.integers(0, glen - L - 1, n).astype(np.int64)
    code_of = np.zeros(256, np.uint8)
    for b, c in ((65, 1), (67, 2), (71, 4), (84, 8)):
        code_of[b] = c
    seq = code_of[ref[pos[:, None] + np.arange(L)[None, :]]]
    qual = np.full((n, L), 30, np.uint8)
    lq = np.full(n, L, np.int32)
    st = np.ones(n, np.int32)
    cfg = Config()
    cfg.chunkSize = glen
    want = process_reads_gapless(cfg, seq, qual, pos, lq, st, ref, 0, glen)
    got = make_perread_backend(cfg)(seq, qual, pos, lq, st, ref, 0, glen)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    assert int(np.asarray(want[0]).sum()) > 0  # the reads DO have calls

    # and the kernel itself refuses over-wide rows instead of zero-filling
    dirv = np.zeros(glen, np.int8)
    res = native.perread_pack(seq, qual, np.arange(n, dtype=np.int64), pos,
                              lq, st, dirv, 0, glen, (L + 3) // 4, n, 5)
    assert res is None
