"""The plain device pileup (ops.pileup: integer scatter-add over
(parity, channel, start + column) and the reference-dependent epilogues)
vs exact host semantics, run as jitted programs on XLA:CPU."""
import numpy as np
import pytest
import jax.numpy as jnp

from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.ops.pileup import (channels_nch2, counts_to_channels,
                                         pileup_base_counts, pileup_counts)
from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast


def _pileup4(seq, qual, pos_rel, strand, ref_window, win_offset_rel, W,
             min_phred):
    """The 4-channel fast-path pileup for gapless reads: phred pre-gate on
    the host, then the device scatter-add + epilogue. uint32 [W, 4]."""
    gated = np.where(qual >= min_phred, seq, 0).astype(np.uint8)
    counts = pileup_base_counts(jnp.asarray(gated),
                                jnp.asarray(np.asarray(pos_rel, np.int32)),
                                jnp.asarray((strand & 1).astype(np.uint8)), W)
    return np.asarray(counts_to_channels(counts, ref_window, win_offset_rel,
                                         W)).T


def _pileup2(seq, qual, pos_rel, strand, ref_window, W, min_phred):
    """The 2-bit semantic pileup (default extract): codes 1/2 for the
    strand's methylated/unmethylated base, host-packed C/G bitmaps of a
    reference that starts at window coordinate 0. uint32 [W, 2]."""
    odd = (strand & 1).astype(bool)[:, None]
    gated = np.where(qual >= min_phred, seq, 0)
    meth = np.where(odd, gated == 2, gated == 4)     # C on odd, G on even
    unmeth = np.where(odd, gated == 8, gated == 1)   # T on odd, A on even
    codes = np.where(meth, 1, np.where(unmeth, 2, 0)).astype(np.uint8)
    rbw = np.asarray(ref_window)[:W]
    isc = np.packbits(rbw == ord("C"))
    isg = np.packbits(rbw == ord("G"))
    counts = pileup_counts(jnp.asarray(codes),
                           jnp.asarray(np.asarray(pos_rel, np.int32)),
                           jnp.asarray((strand & 1).astype(np.uint8)), W, 2)
    return np.asarray(channels_nch2(counts, jnp.asarray(isc),
                                    jnp.asarray(isg), W)).T


def test_pileup_pallas_interpret_matches_host():
    rng = np.random.default_rng(3)
    W = 2048
    ref_ascii, ref_codes = random_reference(rng, W)
    batch = simulate_batch_fast(rng, ref_codes, 150, 100)
    st = sem.strand(batch.flag, batch.xg)
    host = sem.pileup_channels(batch.seq, batch.qual, batch.refpos, st,
                               np.ones(batch.seq.shape, bool), ref_ascii,
                               0, 0, W, 5)
    out = _pileup4(batch.seq, batch.qual, batch.pos, st, ref_ascii, 0, W, 5)
    np.testing.assert_array_equal(host, out)


def test_pileup_pallas_window_offsets():
    """Window not starting at 0 and reference with a left offset."""
    rng = np.random.default_rng(9)
    glen = 3000
    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch_fast(rng, ref_codes, 120, 80)
    win_start, win_end = 512, 2560
    W = win_end - win_start
    keep = (batch.pos < win_end) & (batch.endpos > win_start)
    idx = np.nonzero(keep)[0]
    st = sem.strand(batch.flag, batch.xg)
    win_offset = win_start - 2
    ref_window = ref_ascii[win_offset:]
    host = sem.pileup_channels(batch.seq[idx], batch.qual[idx],
                               batch.refpos[idx], st[idx],
                               np.ones(batch.seq[idx].shape, bool),
                               ref_window, win_offset, win_start, win_end, 5)
    out = _pileup4(batch.seq[idx], batch.qual[idx],
                   batch.pos[idx] - win_start, st[idx], ref_window,
                   win_offset - win_start, W, 5)
    np.testing.assert_array_equal(host, out)


@pytest.mark.parametrize("nch", [2, 4])
def test_plain_pileup_megabase_window(nch):
    """150 bp reads over a 1 Mb window (the production window width):
    the scatter-add pileup equals sem.pileup_channels exactly, for the
    2-channel default program and the 4-channel --minOppositeDepth one."""
    rng = np.random.default_rng(100 + nch)
    W = 1 << 20
    ref_ascii, ref_codes = random_reference(rng, W + 64)
    batch = simulate_batch_fast(rng, ref_codes, 6000, 150)
    st = sem.strand(batch.flag, batch.xg)
    host = sem.pileup_channels(batch.seq, batch.qual, batch.refpos, st,
                               np.ones(batch.seq.shape, bool), ref_ascii,
                               0, 0, W, 5)
    if nch == 4:
        out = _pileup4(batch.seq, batch.qual, batch.pos, st, ref_ascii, 0,
                       W, 5)
        np.testing.assert_array_equal(host, out)
    else:
        out = _pileup2(batch.seq, batch.qual, batch.pos, st, ref_ascii, W, 5)
        np.testing.assert_array_equal(host[:, :2], out)


def test_counts_to_channels_formulas():
    rng = np.random.default_rng(1)
    W = 256
    # Generate consistent counts: per-parity base counts are a composition
    # of the parity total (matching what the pileup can actually produce).
    counts = np.zeros((2, 6, W), np.int32)
    for par in (0, 1):
        per_base = rng.integers(0, 4, size=(5, W)).astype(np.int32)
        counts[par, 1:6] = per_base
        counts[par, 0] = per_base.sum(axis=0) + rng.integers(0, 3, size=W)
    ref = rng.choice([ord(c) for c in "ACGTN"], size=W).astype(np.uint8)
    out = np.asarray(counts_to_channels(counts, ref, 0, W)).T
    for p in range(W):
        odd = counts[0, :, p]
        even = counts[1, :, p]
        if ref[p] == ord("C"):
            assert out[p, 0] == odd[2] and out[p, 1] == odd[4]
            assert out[p, 2] == even[0]
            assert out[p, 3] == even[0] - even[2] - even[5]
        elif ref[p] == ord("G"):
            assert out[p, 0] == even[3] and out[p, 1] == even[1]
            assert out[p, 2] == odd[0]
            assert out[p, 3] == odd[0] - odd[3] - odd[5]
        else:
            assert out[p, 0] == 0 and out[p, 1] == 0
            assert out[p, 2] == odd[0] + even[0]


def test_arbitrate_pad_does_not_zero_N():
    """An N base (qual > 0) in the non-overlapping tail of one mate must
    keep its qual: the C only rewrites SHARED positions (overlaps.c walks
    the common span)."""
    from methyldackel_tpu.parallel.device import arbitrate_device

    L = 12
    N = 2
    seq = np.zeros((N, L), np.uint8)
    qual = np.zeros((N, L), np.uint8)
    refpos = np.full((N, L), -2, np.int64)
    # mate a: 12 bases at pos 0, with an N (code 15) at col 10, qual 30
    seq[0] = [2, 8, 2, 8, 2, 8, 2, 8, 2, 8, 15, 2]
    qual[0] = 20
    qual[0, 10] = 30
    refpos[0] = np.arange(L)
    # mate b: 8 bases at pos 0 (cols 8-11 of a uncovered)
    seq[1, :8] = [2, 8, 2, 8, 2, 8, 2, 8]
    qual[1, :8] = 25
    refpos[1, :8] = np.arange(8)
    st = np.array([1, 1], np.int64)

    hq = qual.copy()
    sem.arbitrate_overlaps(seq, hq, refpos, st, np.array([0]), np.array([1]))
    assert hq[0, 10] == 30  # host oracle: untouched

    out = np.asarray(arbitrate_device(
        jnp.asarray(seq), jnp.asarray(qual),
        jnp.asarray(refpos.astype(np.int32)),
        jnp.asarray(st.astype(np.int32)), jnp.asarray(np.array([0], np.int32)),
        jnp.asarray(np.array([1], np.int32)), jnp.asarray(np.array([True])),
        128))
    np.testing.assert_array_equal(out, hq)
