"""JAX device programs for extract, mbias and perRead.

Two extract paths share this module:

- the dense path (window_pipeline, arbitrate_device, pileup_device): one
  jitted, branch-free tensor program over padded [N, L] read tensors,
  ending in a 4-channel scatter-add over window coordinates — the
  reformulation of the reference's per-column loop (extract.c:399-441) and
  overlap state machine (overlaps.c:54-119). It serves windows the fast
  path refuses (BED strand column, reads over 256 bp) and the mesh engine;
- the v3 fast path (_fused_dispatch_v3 and the K-window group programs):
  mate arbitration and the phred gate run on the host (native kernels),
  reads upload as packed base codes plus row starts, and the device runs
  the integer scatter-add pileup of ops.pileup and a narrow readback.

Bit-exactness with the host (numpy) semantics is enforced by
tests/test_device_parity.py and the fast-path parity tests. Mate-overlap
arbitration on the dense path aligns mates on a dense per-pair window of
OVERLAP_WIN columns; mates whose aligned bases sit further than
OVERLAP_WIN from the pair start (pathological deletions) fall back to
unarbitrated quals.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import semantics as sem
from ..ops.pileup import (channels_nch2, counts_to_channels,
                          pileup_base_counts, pileup_counts,
                          unpack_bits_device)

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 1, 2, 4, 8, 15
REF_C, REF_G = ord("C"), ord("G")

# Kept as numpy at module scope: a module-level jnp.asarray would
# initialize the default JAX backend at import time, before callers can
# choose the platform.
QUAL_BOOST_NP = sem.QUAL_BOOST.astype(np.int32)


# ----------------------------------------------------------------- pieces

def strand_device(flag, xg):
    """getStrand (common.c:84-116) as vector selects."""
    flag = flag.astype(jnp.uint32)
    paired = (flag & 0x1) != 0
    no_xg = jnp.select(
        [
            paired & ((flag & 0x50) == 0x50),
            paired & ((flag & 0x40) != 0),
            paired & ((flag & 0x90) == 0x90),
            paired & ((flag & 0x80) != 0),
            paired,
            (flag & 0x10) != 0,
        ],
        [2, 1, 1, 2, 0, 2],
        default=1,
    )
    xg_c = jnp.select(
        [
            (flag & 0x51) == 0x41,
            (flag & 0x51) == 0x51,
            (flag & 0x91) == 0x81,
            (flag & 0x91) == 0x91,
            (flag & 0x10) != 0,
        ],
        [1, 3, 3, 1, 3],
        default=1,
    )
    xg_g = jnp.select(
        [
            (flag & 0x51) == 0x41,
            (flag & 0x51) == 0x51,
            (flag & 0x91) == 0x81,
            (flag & 0x91) == 0x91,
            (flag & 0x10) != 0,
        ],
        [4, 2, 2, 4, 2],
        default=4,
    )
    return jnp.select([xg == 1, xg == 2], [xg_c, xg_g], default=no_xg).astype(jnp.int32)


def classify_context_device(ref):
    """isCpG/isCHG/isCHH over the window (common.c:49-82)."""
    n = ref.shape[0]
    is_c = ref == REF_C
    is_g = ref == REF_G
    nxt = jnp.concatenate([ref[1:], jnp.zeros(1, ref.dtype)])
    nxt2 = jnp.concatenate([ref[2:], jnp.zeros(2, ref.dtype)])
    prv = jnp.concatenate([jnp.zeros(1, ref.dtype), ref[:-1]])
    prv2 = jnp.concatenate([jnp.zeros(2, ref.dtype), ref[:-2]])
    idx = jnp.arange(n)
    cpg = (is_c & (idx + 1 < n) & (nxt == REF_G)) | (is_g & (idx > 0) & (prv == REF_C))
    chg = (is_c & (idx + 2 < n) & (nxt2 == REF_G)) | (is_g & (idx > 1) & (prv2 == REF_C))
    chh = is_c | is_g
    return jnp.select([cpg, chg, chh], [0, 1, 2], default=3).astype(jnp.int8)


def trim_device(seq, qual, l_qseq, strand, flag, bounds, absolute_bounds):
    """trimAlignment + trimAbsoluteAlignment (common.c:137-208), with the
    absolute right-trim keeping base l_qseq-rb (see ops.semantics)."""
    L = seq.shape[1]
    col = jnp.arange(L)[None, :]
    lq = l_qseq[:, None]
    inread = col < lq
    is_read2 = ((flag & 0x80) != 0)[:, None]
    s = (strand - 1)[:, None]

    def per_read_bounds(b16):
        b = b16.reshape(4, 4)
        lb = jnp.where(is_read2, b[s.squeeze(1), 2][:, None], b[s.squeeze(1), 0][:, None])
        rb = jnp.where(is_read2, b[s.squeeze(1), 3][:, None], b[s.squeeze(1), 1][:, None])
        return lb, rb

    # positional bounds: trim [0, lb) and [rb, L)
    lb, rb = per_read_bounds(bounds)
    lb = jnp.minimum(lb, lq)
    cut = ((lb > 0) & (col < lb)) | ((rb > 0) & (col >= rb))
    # absolute bounds: trim [0, lb) and [L-rb+1, L)
    alb, arb = per_read_bounds(absolute_bounds)
    alb = jnp.minimum(alb, lq)
    arb = jnp.minimum(arb, lq)
    cut |= ((alb > 0) & (col < alb)) | ((arb > 0) & (col >= lq - arb + 1))
    cut &= inread
    qual = jnp.where(cut, 0, qual).astype(jnp.uint8)
    seq = jnp.where(cut, BASE_N, seq).astype(jnp.uint8)
    return seq, qual


def meth_state_device(seq, qual, strand, min_phred):
    odd = (strand & 1)[:, None] == 1
    passing = qual >= min_phred
    return jnp.where(
        passing & odd & (seq == BASE_C), 1,
        jnp.where(
            passing & odd & (seq == BASE_T), -1,
            jnp.where(
                passing & ~odd & (seq == BASE_G), 1,
                jnp.where(passing & ~odd & (seq == BASE_A), -1, 0),
            ),
        ),
    ).astype(jnp.int8)


def conv_eff_device(seq, qual, refpos, strand, ctype, win_offset, seq_len, min_phred):
    """computeConversionEfficiency (common.c:361-404) per read, float32."""
    aligned = (refpos >= win_offset) & (refpos < win_offset + seq_len)
    idx = jnp.where(aligned, refpos - win_offset, 0)
    ct = jnp.where(aligned, ctype[idx], 3)
    state = meth_state_device(seq, qual, strand, min_phred)
    informative = aligned & ((ct == 1) | (ct == 2))
    n_meth = jnp.sum((state > 0) & informative, axis=1)
    n_unmeth = jnp.sum((state < 0) & informative, axis=1)
    total = n_meth + n_unmeth
    return jnp.where(
        total == 0,
        jnp.float32(1.0),
        n_unmeth.astype(jnp.float32) / total.astype(jnp.float32),
    )


def arbitrate_device(seq, qual, refpos, strand, pair_a, pair_b, pair_valid, ovw):
    """cust_tweak_overlap_quality (overlaps.c:54-119), all pairs at once.

    Each pair is aligned on a dense window of `ovw` columns anchored at the
    pair's smallest aligned coordinate. Returns the updated qual tensor.
    """
    P = pair_a.shape[0]
    L = seq.shape[1]
    pa = refpos[pair_a]  # [P, L]
    pb = refpos[pair_b]
    qa = qual[pair_a].astype(jnp.int32)
    qb = qual[pair_b].astype(jnp.int32)
    ba = seq[pair_a].astype(jnp.int32)
    bb = seq[pair_b].astype(jnp.int32)
    sa = strand[pair_a]
    sb = strand[pair_b]
    compatible = (((sa - sb) & 1) == 0) & pair_valid

    big = jnp.int32(2**31 - 1)
    base = jnp.minimum(
        jnp.min(jnp.where(pa >= 0, pa, big), axis=1),
        jnp.min(jnp.where(pb >= 0, pb, big), axis=1),
    )
    offa = pa - base[:, None]
    offb = pb - base[:, None]
    va = (pa >= 0) & (offa >= 0) & (offa < ovw)
    vb = (pb >= 0) & (offb >= 0) & (offb < ovw)
    offa_c = jnp.where(va, offa, ovw).astype(jnp.int32)
    offb_c = jnp.where(vb, offb, ovw).astype(jnp.int32)
    prow = jnp.broadcast_to(jnp.arange(P)[:, None], (P, L))

    def densify(off, vals, fill):
        d = jnp.full((P, ovw + 1), fill, dtype=jnp.int32)
        return d.at[prow, off].set(vals.astype(jnp.int32))[:, :ovw]

    dqa = densify(offa_c, qa, 0)
    dqb = densify(offb_c, qb, 0)
    dba = densify(offa_c, ba, -1)
    dbb = densify(offb_c, bb, -1)

    QUAL_BOOST = jnp.asarray(QUAL_BOOST_NP)
    has = (dba >= 0) & (dbb >= 0) & compatible[:, None]
    differ = dba != dbb
    awins_d = differ & (dqa > dqb) & (dba != BASE_N)
    bwins_d = differ & ~awins_d & (dqb > dqa) & (dbb != BASE_N)
    zero_d = differ & ~awins_d & ~bwins_d
    awins_s = ~differ & (dqa > dqb)
    bwins_s = ~differ & ~awins_s
    new_dqa = jnp.select(
        [awins_d, awins_s, bwins_d | bwins_s | zero_d],
        [dqa - dqb, QUAL_BOOST[dqa], jnp.zeros_like(dqa)],
        default=dqa,
    )
    new_dqb = jnp.select(
        [bwins_d, bwins_s, awins_d | awins_s | zero_d],
        [dqb - dqa, QUAL_BOOST[dqb], jnp.zeros_like(dqb)],
        default=dqb,
    )
    new_dqa = jnp.where(has, new_dqa, dqa)
    new_dqb = jnp.where(has, new_dqb, dqb)

    # Gather back per source base
    def gather(d, off, valid, orig):
        padded = jnp.concatenate([d, jnp.zeros((P, 1), jnp.int32)], axis=1)
        g = padded[prow, off]
        return jnp.where(valid, g, orig)

    qa_new = gather(new_dqa, offa_c, va, qa).astype(jnp.uint8)
    qb_new = gather(new_dqb, offb_c, vb, qb).astype(jnp.uint8)
    # Route the rewritten rows back with a row GATHER: scatter only the
    # 1-D source map, then take rows from concat(orig, na, nb). Pad pairs
    # may alias a row twice; they rewrite it with its own unchanged quals
    # (pair_valid=False ⇒ has=False ⇒ identity), so the duplicate writes
    # to the map are harmless.
    nrows = qual.shape[0]
    src = jnp.arange(nrows, dtype=jnp.int32)
    src = src.at[pair_a].set(nrows + jnp.arange(P, dtype=jnp.int32))
    src = src.at[pair_b].set(nrows + P + jnp.arange(P, dtype=jnp.int32))
    return jnp.take(jnp.concatenate([qual, qa_new, qb_new], axis=0), src,
                    axis=0)


def pileup_device(seq, qual, refpos, strand, keep_read, keep_base, ref,
                  win_offset, win_start, wpad, min_phred):
    """The 4-channel scatter-add (extract.c:420-441 + isVariant)."""
    in_win = (refpos >= win_start) & (refpos < win_start + wpad)
    valid = in_win & keep_read[:, None] & keep_base
    rp = jnp.where(valid, refpos - win_start, wpad).astype(jnp.int32)
    refbase = jnp.where(valid, ref[jnp.where(valid, refpos - win_offset, 0)], 0)
    odd = (strand & 1)[:, None] == 1
    calling = jnp.where(odd, refbase == REF_C, refbase == REF_G)
    passing = qual >= min_phred
    meth = valid & calling & passing & jnp.where(odd, seq == BASE_C, seq == BASE_G)
    unmeth = valid & calling & passing & jnp.where(odd, seq == BASE_T, seq == BASE_A)
    off = valid & ~calling & passing
    variant = off & jnp.where(
        odd, (seq != BASE_G) & (seq != BASE_N), (seq != BASE_C) & (seq != BASE_N)
    )
    chan = jnp.stack([meth, unmeth, off, variant], axis=-1).astype(jnp.uint32)  # [N,L,4]
    counters = jnp.zeros((wpad + 1, 4), dtype=jnp.uint32)
    counters = counters.at[rp.reshape(-1)].add(chan.reshape(-1, 4))
    return counters[:wpad]


@functools.partial(jax.jit, static_argnames=("keep_ctx", "min_phred"))
def mbias_device(seq, qual, refpos, strand, flag, keep_base, ref,
                 win_offset, win_start, win_end, *, keep_ctx, min_phred):
    """extractMBias counter loop (MBias.c:180-214) as a scatter-free device
    program: the read-cycle axis IS the column axis, so the [4 strands,
    2 reads, 2 states, L] counters are 16 masked row-reductions over the
    [N, L] call tensors — no scatter-add at all (psum-able across shards,
    the data-parallel form of the per-thread strandMeth merge,
    MBias.c:541-552).
    Bit-equal to ops.semantics.mbias_counters (tests/test_mbias_device.py).
    Deliberately no overlap arbitration (MBias.c:160)."""
    n = ref.shape[0]
    ctype = classify_context_device(ref)
    valid = (refpos >= win_start) & (refpos < win_end) & keep_base
    widx = jnp.where(valid, refpos - win_offset, 0)
    inref = valid & (widx < n)
    widx = jnp.where(inref, widx, 0)
    ct = jnp.where(inref, ctype[widx], jnp.int8(3))
    ctx_ok = jnp.zeros(ct.shape, dtype=bool)
    for t, k in ((0, keep_ctx[0]), (1, keep_ctx[1]), (2, keep_ctx[2])):
        if k:
            ctx_ok |= ct == t
    refbase = jnp.where(inref, ref[widx], 0)
    sodd = (strand.astype(jnp.int32) & 1)[:, None] == 1
    calling = jnp.where(sodd, refbase == REF_C, refbase == REF_G)
    state = meth_state_device(seq, qual, strand, min_phred)
    use = valid & ctx_ok & calling & (state != 0)
    s_idx = (strand.astype(jnp.int32) - 1)[:, None]
    r_idx = ((flag.astype(jnp.int32) & 0x80) != 0).astype(jnp.int32)[:, None]
    m_idx = (state < 0).astype(jnp.int32)
    combo = (s_idx * 2 + r_idx) * 2 + m_idx  # [N, L] in 0..15
    rows = [jnp.sum((use & (combo == c)).astype(jnp.uint32), axis=0)
            for c in range(16)]
    return jnp.stack(rows, axis=0).reshape(4, 2, 2, seq.shape[1])


@functools.partial(jax.jit, static_argnames=("min_phred",))
def perread_device(seq, qual, pos, lq, strand, ref, seq_start, seq_len, *,
                   min_phred):
    """processRead's CpG chain walk (perRead.c:37-94) for gapless reads as a
    jitted device program: every read steps its cursor in lockstep (the
    walk is branch-free per step; the low-qual quirk — a failing base
    advances the cursor and the NEXT base is tallied without a quality
    re-check — is the where() on `lowq`). L sequential steps of [N]-vector
    work; bit-equal to engine.perread.process_reads_gapless
    (tests/test_perread_device.py). Returns (n_meth[N], n_unmeth[N])."""
    N, L = seq.shape
    is_c = ref == REF_C
    is_g = ref == REF_G
    nxt_g = jnp.concatenate([is_g[1:], jnp.zeros(1, bool)])
    prv_c = jnp.concatenate([jnp.zeros(1, bool), is_c[:-1]])
    # CpG direction per reference position; positions at/after seq_len are
    # zeroed by the in-window mask below.
    dirv = jnp.where(is_c & nxt_g, jnp.int8(1),
                     jnp.where(is_g & prv_c, jnp.int8(-1), jnp.int8(0)))
    nref = ref.shape[0]
    odd = (strand.astype(jnp.int32) & 1) == 1
    lq = lq.astype(jnp.int32)
    pos = pos.astype(jnp.int32)

    def body(_, carry):
        cursor, nm, nu = carry
        active = cursor < lq
        j = jnp.clip(cursor, 0, L - 1)
        qj = jnp.take_along_axis(qual, j[:, None], axis=1)[:, 0]
        lowq = active & (qj < min_phred)
        e = jnp.where(lowq, cursor + 1, cursor)
        evaluate = active & (e < lq)
        ec = jnp.clip(e, 0, L - 1)
        widx = pos + e - seq_start
        inw = evaluate & (widx >= 0) & (widx < seq_len) & (widx < nref)
        d = jnp.where(inw, dirv[jnp.clip(widx, 0, nref - 1)], 0)
        base = jnp.take_along_axis(seq, ec[:, None], axis=1)[:, 0]
        top = (d == 1) & odd
        bot = (d == -1) & ~odd
        nm = nm + ((top & (base == BASE_C)) | (bot & (base == BASE_G)))
        nu = nu + ((top & (base == BASE_T)) | (bot & (base == BASE_A)))
        cursor = jnp.where(active, jnp.where(lowq, cursor + 2, cursor + 1),
                           cursor)
        return cursor, nm, nu

    cursor = jnp.zeros(N, jnp.int32)
    nm = jnp.zeros(N, jnp.int32)
    nu = jnp.zeros(N, jnp.int32)
    cursor, nm, nu = jax.lax.fori_loop(0, L, body, (cursor, nm, nu))
    return nm, nu


# perRead v3 device reduction: per-row tallies over host-packed 2-bit
# codes (1 = meth, 2 = unmeth; csrc mdtpu_perread_pack). The low-qual
# skip quirk (perRead.c:59-63) never reaches the device: rows containing
# any sub-phred base are recomputed by the exact host walker.
@functools.partial(jax.jit, static_argnames=("Lq",))
def _perread_reduce(codes, *, Lq):
    nm = jnp.zeros(codes.shape[0], jnp.int32)
    nu = jnp.zeros(codes.shape[0], jnp.int32)
    for s in (0, 2, 4, 6):
        c = (codes >> np.uint8(s)) & np.uint8(3)
        nm = nm + jnp.sum((c == 1).astype(jnp.int32), axis=1)
        nu = nu + jnp.sum((c == 2).astype(jnp.int32), axis=1)
    return nm, nu


_PERREAD_HWM = {"Nb": 0}

# Guards every shape-bucket high-water read-modify-write (_V3_HWM,
# _MBIAS_HWM, _PERREAD_HWM): concurrent -@N workers racing the update could
# mint redundant shape buckets, each one more compile (output stays
# correct either way).
_HWM_LOCK = threading.Lock()


def make_perread_backend(cfg):
    """perRead device backend: the host packs 2-bit tally codes (native
    kernel — dir/window/strand/base resolution on host), the device does
    the per-read reduction, and the tiny [Nb]x2 readback replaces a
    ~100 MB/window raw seq+qual+ref upload. Low-qual rows take the exact
    host chain walker.

    `.dispatch(...)` returns a finish() closure so the engine can overlap
    the next window's decode/pack with this window's device reduce +
    readback."""
    min_phred = int(cfg.minPhred)

    def dispatch(seq, qual, pos, lq, strand_arr, ref_window, seq_start,
                 seq_len):
        from ..io import native as _native

        n, L = seq.shape
        if n == 0:
            z = (np.zeros(0, np.int64), np.zeros(0, np.int64))
            return lambda: z
        rw = np.asarray(ref_window)
        Lq = (L + 3) // 4
        with _HWM_LOCK:
            Nb = max(256, _PERREAD_HWM["Nb"])
            while Nb < n:
                Nb *= 2
            _PERREAD_HWM["Nb"] = Nb
        packed = None
        # L cap = the pack kernel's row-temp width (it rejects wider rows
        # with rc=-2; long-read inputs take the exact host walker)
        if _native.available() and L <= 1020:
            is_c = rw == REF_C
            is_g = rw == REF_G
            dirv = np.zeros(len(rw), np.int8)
            dirv[:-1][is_c[:-1] & is_g[1:]] = 1
            dirv[1:][is_g[1:] & is_c[:-1]] = -1
            packed = _native.perread_pack(
                np.ascontiguousarray(seq), np.ascontiguousarray(qual),
                np.arange(n, dtype=np.int64), pos, lq,
                np.asarray(strand_arr, np.int32), dirv, seq_start,
                min(seq_len, len(rw)), Lq, Nb, min_phred)
        if packed is None:
            res = _perread_legacy(cfg, seq, qual, pos, lq, strand_arr,
                                  ref_window, seq_start, seq_len,
                                  min_phred)
            return lambda: res
        codes, haslow = packed
        nm_d, nu_d = _perread_reduce(jnp.asarray(codes), Lq=Lq)
        try:
            nm_d.copy_to_host_async()
            nu_d.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass

        def finish():
            nm = np.asarray(jax.device_get(nm_d))[:n].astype(np.int64)
            nu = np.asarray(jax.device_get(nu_d))[:n].astype(np.int64)
            dirty = np.nonzero(haslow[:n])[0]
            if len(dirty):
                from ..engine.perread import process_reads_gapless

                nm[dirty], nu[dirty] = process_reads_gapless(
                    cfg, np.ascontiguousarray(seq[dirty]),
                    np.ascontiguousarray(qual[dirty]), pos[dirty],
                    lq[dirty], strand_arr[dirty], ref_window, seq_start,
                    seq_len)
            return nm, nu

        return finish

    def compute(*args):
        return dispatch(*args)()

    compute.dispatch = dispatch
    return compute


def _perread_legacy(cfg, seq, qual, pos, lq, strand_arr, ref_window,
                    seq_start, seq_len, min_phred):
    """The full-upload device walker (fallback when the native pack
    kernel isn't built or rows exceed its width)."""
    n, L = seq.shape
    Nb = 256
    while Nb < n:
        Nb *= 2
    Lb = 32
    while Lb < L:
        Lb *= 2
    ref_static = _round_up(max(int(cfg.chunkSize) + 10064, seq_len), 4096)
    ref_p = np.zeros(ref_static, np.uint8)
    ref_p[:seq_len] = ref_window[:seq_len]

    def padr(x, fill=0):
        out = np.full((Nb, Lb) if x.ndim == 2 else (Nb,), fill, x.dtype)
        if x.ndim == 2:
            out[:n, :L] = x
        else:
            out[:n] = x
        return out

    nm, nu = perread_device(
        jnp.asarray(padr(seq)), jnp.asarray(padr(qual)),
        jnp.asarray(padr(np.asarray(pos, np.int64).astype(np.int32))),
        jnp.asarray(padr(np.asarray(lq, np.int32))),
        jnp.asarray(padr(strand_arr.astype(np.int32), 1)),
        jnp.asarray(ref_p), jnp.int32(seq_start), jnp.int32(seq_len),
        min_phred=min_phred)
    return (np.asarray(jax.device_get(nm))[:n].astype(np.int64),
            np.asarray(jax.device_get(nu))[:n].astype(np.int64))


# mbias v3 device reduction: 16 masked row-reductions over host-packed
# 2-bit codes (csrc mdtpu_mbias_pack) — the data-parallel per-thread
# strandMeth merge (MBias.c:541-552) at ~1/70th of the legacy upload.
@functools.partial(jax.jit, static_argnames=("Lq",))
def _mbias_reduce(codes, combo, *, Lq):
    L4 = Lq * 4
    cols = [(codes >> np.uint8(s)) & np.uint8(3) for s in (0, 2, 4, 6)]
    code = jnp.stack(cols, axis=-1).reshape(codes.shape[0], L4)
    meth = code == 1
    unmeth = code == 2
    rows = []
    for c in range(8):
        sel = combo[:, None] == np.uint8(c)
        rows.append(jnp.stack([
            jnp.sum((meth & sel).astype(jnp.uint32), axis=0),
            jnp.sum((unmeth & sel).astype(jnp.uint32), axis=0)]))
    return jnp.stack(rows).reshape(4, 2, 2, L4)


_MBIAS_HWM = {"Nb": 0}


def make_mbias_backend(cfg):
    """mbias device backend: the host packs 2-bit
    codes with the context/calling/window gates resolved against two
    per-position masks (native kernel), the device reduces per (strand,
    read, state, cycle), and the ~50 KB readback replaces the legacy
    ~100 MB/window raw upload. Non-gapless rows take the exact numpy
    oracle; BED windows (per-base keep masks) take the legacy path."""
    min_phred = int(cfg.minPhred)

    def compute(seq, qual, refpos, strand_arr, flag, keep_base, ref_window,
                win_offset, win_start, win_end, keep_ctx, max_len,
                pos=None, lq=None):
        from ..io import native as _native
        from ..ops import semantics as _sem

        n, L = seq.shape
        if n == 0:
            return np.zeros((4, 2, 2, max_len), dtype=np.uint32)
        plain = keep_base is None or bool(keep_base.all())
        if (pos is not None and lq is not None and plain
                and _native.available() and L <= 256):
            simple = _native.v3_flags(seq, refpos, pos, lq)
            if simple is not None:
                rw = np.asarray(ref_window)
                ctype, _cdir = _sem.classify_context(rw)
                keep_vec = np.array([keep_ctx[0], keep_ctx[1], keep_ctx[2],
                                     0], bool)
                kept = keep_vec[ctype]
                ok_odd = (kept & (rw == REF_C)).astype(np.uint8)
                ok_even = (kept & (rw == REF_G)).astype(np.uint8)
                rows = np.nonzero(simple)[0]
                Lq = (L + 3) // 4
                with _HWM_LOCK:
                    Nb = max(256, _MBIAS_HWM["Nb"])
                    while Nb < max(len(rows), 1):
                        Nb *= 2
                    _MBIAS_HWM["Nb"] = Nb
                packed = _native.mbias_pack(
                    seq, qual, rows, pos, lq,
                    np.asarray(strand_arr, np.int32),
                    np.asarray(flag, np.uint16), ok_odd, ok_even,
                    win_offset, win_start, win_end, Lq, Nb, min_phred)
                if packed is not None:
                    codes, combo = packed
                    out_d = _mbias_reduce(jnp.asarray(codes),
                                          jnp.asarray(combo), Lq=Lq)
                    try:
                        out_d.copy_to_host_async()
                    except (AttributeError, RuntimeError):
                        pass
                    out = np.asarray(jax.device_get(out_d)).astype(np.uint32)
                    hard = np.nonzero(~simple)[0]
                    if len(hard):
                        hc = _sem.mbias_counters(
                            np.ascontiguousarray(seq[hard]),
                            np.ascontiguousarray(qual[hard]),
                            refpos[hard], strand_arr[hard], flag[hard],
                            np.ones((len(hard), L), bool), ref_window,
                            win_offset, win_start, win_end, keep_ctx,
                            min_phred, L)
                        out[..., :hc.shape[3]] += hc.astype(np.uint32)
                    if out.shape[3] >= max_len:
                        return out[..., :max_len]
                    grown = np.zeros((4, 2, 2, max_len), np.uint32)
                    grown[..., : out.shape[3]] = out
                    return grown
        return _mbias_legacy(cfg, seq, qual, refpos, strand_arr, flag,
                             keep_base, ref_window, win_offset, win_start,
                             win_end, keep_ctx, max_len, min_phred)

    return compute


def _mbias_legacy(cfg, seq, qual, refpos, strand_arr, flag, keep_base,
                  ref_window, win_offset, win_start, win_end, keep_ctx,
                  max_len, min_phred):
    """The full-upload device program (BED windows and no-native
    fallback)."""
    n, L = seq.shape
    Nb = 256
    while Nb < n:
        Nb *= 2
    Lb = 32
    while Lb < L:
        Lb *= 2
    ref_static = _round_up(max(int(cfg.chunkSize) + 16, len(ref_window)),
                           4096)
    # End-padding with 0 preserves the C's truncated-context semantics:
    # byte 0 is neither C nor G, so CpG/CHG degrade to CHH exactly as a
    # short fetch would (common.c:49-82).
    ref_p = np.zeros(ref_static, np.uint8)
    ref_p[: len(ref_window)] = ref_window

    def padr(x, fill=0):
        out = np.full((Nb, Lb) if x.ndim == 2 else (Nb,), fill, x.dtype)
        if x.ndim == 2:
            out[:n, :L] = x
        else:
            out[:n] = x
        return out

    out = mbias_device(
        jnp.asarray(padr(seq)), jnp.asarray(padr(qual)),
        jnp.asarray(padr(refpos.astype(np.int32), -2)),
        jnp.asarray(padr(strand_arr.astype(np.int32), 1)),
        jnp.asarray(padr(np.asarray(flag).astype(np.uint16))),
        jnp.asarray(padr(keep_base, False)), jnp.asarray(ref_p),
        jnp.int32(win_offset), jnp.int32(win_start), jnp.int32(win_end),
        keep_ctx=tuple(bool(k) for k in keep_ctx), min_phred=min_phred)
    out = np.asarray(jax.device_get(out))
    if Lb >= max_len:
        return out[..., :max_len]
    grown = np.zeros((4, 2, 2, max_len), np.uint32)
    grown[..., :Lb] = out
    return grown


# ------------------------------------------------------------ full pipeline

@functools.partial(
    jax.jit,
    static_argnames=("wpad", "ovw", "min_phred", "min_conv_eff", "use_overlaps"),
)
def window_pipeline(seq, qual, refpos, flag, xg, l_qseq, mapq, keep_read,
                    keep_base, pair_a, pair_b, pair_valid, ref, bounds,
                    absolute_bounds, win_offset, win_start, *, wpad, ovw,
                    min_phred, min_conv_eff, use_overlaps):
    """The flagship compute graph: everything from strand inference to the
    pileup counters in one XLA program."""
    strand = strand_device(flag, xg)
    ctype = classify_context_device(ref)
    if min_conv_eff > 0.0:
        eff = conv_eff_device(seq, qual, refpos, strand, ctype, win_offset,
                              ref.shape[0], min_phred)
        keep_read = keep_read & (eff >= jnp.float32(min_conv_eff))
    seq, qual = trim_device(seq, qual, l_qseq, strand, flag, bounds, absolute_bounds)
    if use_overlaps:
        qual = arbitrate_device(seq, qual, refpos, strand, pair_a, pair_b,
                                pair_valid, ovw)
    return pileup_device(seq, qual, refpos, strand, keep_read, keep_base, ref,
                         win_offset, win_start, wpad, min_phred)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _saturate(sel, SAT_BITS):
    """Narrow readback: counters as u8/u16 plus a flag set when any value
    does not fit (the host then refetches the window through the wide
    program)."""
    top = jnp.uint32((1 << SAT_BITS) - 1)
    dt = jnp.uint8 if SAT_BITS == 8 else jnp.uint16
    return sel.astype(dt), jnp.any(sel > top)


def _hard_rows_pileup(hseq, hqual, hrefpos, hstrand, hkeep, ref_p, woff_rel,
                      W, min_phred):
    """Indel/'='-containing rows: the exact dense pileup (quals shipped;
    arbitration already ran on host). uint32 [4, W]."""
    return pileup_device(hseq, hqual, hrefpos, hstrand, hkeep,
                         jnp.ones(hseq.shape, bool), ref_p, woff_rel,
                         jnp.int32(0), W, min_phred).T


_V3_STATICS = ("Nb", "Lh", "L2", "W", "ref_static", "NCH", "HAS_HARD",
               "min_phred", "NCAND", "CTX", "SLOT", "SAT_BITS")


def _v3_core4(blob_u8, starts, woff_rel, hseq, hqual, hrefpos, hstrand,
              hkeep, *, Nb, Lh, L2, W, ref_static, NCH, HAS_HARD,
              min_phred, NCAND=0, CTX=7, SLOT=0):
    """The v3 fast-window program for PRE-GATED reads with 4-bit codes
    (the --minOppositeDepth program: all four channels). The host has
    already run mate-overlap arbitration (native kernel, bit-equal to the
    C) and zeroed the base code of every base with qual < minPhred, so
    this program needs NO quals and NO pair plumbing: unpack nibble codes
    → per-parity base-count scatter-add → channel epilogue (+ the dense
    hard-row path) → optional candidate compaction. Returns uint32
    [NCH, W or NCAND].

    Upload: one u8 blob (nibble-packed codes, one parity byte per row,
    the reference bytes) and the int32 row starts."""
    seqpack = blob_u8[: Nb * Lh].reshape(Nb, Lh)
    aux_u8 = blob_u8[Nb * Lh:]
    parity = aux_u8[:Nb]
    ref_p = aux_u8[Nb: Nb + ref_static]
    # nibble unpack: packed[:, j] = code[2j] | code[2j+1] << 4
    seq = jnp.stack([seqpack & 15, seqpack >> 4], axis=-1).reshape(Nb, L2)
    counts = pileup_base_counts(seq, starts, parity, W)
    full = counts_to_channels(counts, ref_p, woff_rel, W)  # [4, W]
    if HAS_HARD:
        full = full + _hard_rows_pileup(hseq, hqual, hrefpos, hstrand, hkeep,
                                        ref_p, woff_rel, W, min_phred)
    sel = full[:NCH]
    if NCAND:
        # candidate-compacted readback: emit only reads counters at
        # CTX-enabled context positions, and with minOppositeDepth > 0 the
        # 4-channel values are exact at exactly those positions. Indices
        # are derived on device; the host scatters back by its own
        # identical mask.
        col = jax.lax.broadcasted_iota(jnp.int32, (W,), 0) - woff_rel
        inb = (col >= 0) & (col < ref_static)
        rb = jnp.where(inb, ref_p[jnp.clip(col, 0, ref_static - 1)], 0)
        mask = _ctx_mask_jnp(rb == np.uint8(REF_C), rb == np.uint8(REF_G),
                             CTX, SLOT if SLOT else W)
        idx = jnp.nonzero(mask, size=NCAND, fill_value=0)[0]
        sel = jnp.take(sel, idx, axis=1)
    return sel


@functools.partial(jax.jit, static_argnames=_V3_STATICS)
def _fused_window_pregated(*args, SAT_BITS, **statics):
    return _saturate(_v3_core4(*args, **statics), SAT_BITS)


@functools.partial(jax.jit, static_argnames=_V3_STATICS[:-1])
def _fused_window_pregated_wide(*args, **statics):
    """Overflow refetch: the full uint32 [4, W] channels (rare; dense)."""
    return _v3_core4(*args, **{**statics, "NCH": 4, "NCAND": 0})


def _nb_bucket(need: int, floor: int = 0) -> int:
    """Row-count bucket: the pow2×{1, 1.25, 1.5, 1.75} ladder (256, 320,
    384, 448, 512, ...; consecutive ratio ≤ 1.25). Finer than pure powers
    of two — worst-case padding drops from 2x to 1.25x, and padding is
    real upload bytes and device work — while still coarse enough that a run compiles only 1-2 programs (plus
    the process-global high-water floor, which the caller passes in)."""
    need = max(need, floor, 1)
    b = 256
    while True:
        for m in (b, b + b // 4, b + b // 2, b + 3 * (b // 4)):
            if m >= need:
                return m
        b *= 2


def _ctx_code(cfg) -> int:
    """Static context selector for the candidate-compacted readback:
    bit 0 = CpG, bit 1 = CHG, bit 2 = CHH; 7 = every C/G position.
    cytosine_report reads ALL C/G positions (zero-coverage blanks included,
    extract.c:461-510), so it pins the full set."""
    if getattr(cfg, "cytosine_report", False):
        return 7
    return ((1 if cfg.keepCpG else 0) | (2 if cfg.keepCHG else 0)
            | (4 if cfg.keepCHH else 0))


def _ctx_mask_np(cb, gb, ctx: int, slot):
    """Candidate mask over window coordinates from the C/G bit vectors:
    positions whose reference context (classify_context's arithmetic,
    common.c:49-82) is one of the ctx-selected types — the only positions
    emit_window ever reads (its per-position reads are all gated by
    ctx_kept = keep_vec[ctype]; engine/extract.py emit_window).

    `slot` is an int (single window: period == data extent) or a
    (period, data) pair (grouped windows: slots repeat every `period`
    coords, each slot's bitmap data covering only its first `data`).
    Positions within 2 of a slot start or 8 of its data end keep the full
    C|G rule: their context can depend on reference bases outside the
    bitmap domain (the 2 leading bases before win_start live in
    ref_window but not in the bitmaps; the +2 lookahead of the last data
    coords can fall past the extent), so the mask stays a provable
    superset of what emit reads there.

    MUST stay semantically identical to _ctx_mask_jnp — the host scatters
    readback values by ITS mask while the device gathers by the jnp one.
    """
    cb = np.asarray(cb, bool)
    gb = np.asarray(gb, bool)
    if ctx == 7:
        return cb | gb
    period, data = slot if isinstance(slot, tuple) else (slot, slot)
    W = len(cb)
    g1 = np.zeros(W, bool)
    g1[:-1] = gb[1:]
    g2 = np.zeros(W, bool)
    g2[:-2] = gb[2:]
    c1 = np.zeros(W, bool)
    c1[1:] = cb[:-1]
    c2 = np.zeros(W, bool)
    c2[2:] = cb[:-2]
    m = np.zeros(W, bool)
    if ctx & 1:
        m |= (cb & g1) | (gb & c1)
    if ctx & 2:
        m |= (cb & ~g1 & g2) | (gb & ~c1 & c2)
    if ctx & 4:
        m |= (cb & ~g1 & ~g2) | (gb & ~c1 & ~c2)
    pos = np.arange(W, dtype=np.int64) % period
    guard = (pos < 2) | (pos >= data - 8)
    return np.where(guard, cb | gb, m)


def _ctx_mask_jnp(cb, gb, ctx: int, slot):
    """Device twin of _ctx_mask_np (ctx/slot static; traced elementwise +
    static shifts only — XLA-friendly, no dynamic shapes)."""
    if ctx == 7:
        return cb | gb
    period, data = slot if isinstance(slot, tuple) else (slot, slot)
    W = cb.shape[0]
    false1 = jnp.zeros(1, bool)
    false2 = jnp.zeros(2, bool)
    g1 = jnp.concatenate([gb[1:], false1])
    g2 = jnp.concatenate([gb[2:], false2])
    c1 = jnp.concatenate([false1, cb[:-1]])
    c2 = jnp.concatenate([false2, cb[:-2]])
    m = jnp.zeros(W, bool)
    if ctx & 1:
        m = m | (cb & g1) | (gb & c1)
    if ctx & 2:
        m = m | (cb & ~g1 & g2) | (gb & ~c1 & c2)
    if ctx & 4:
        m = m | (cb & ~g1 & ~g2) | (gb & ~c1 & ~c2)
    pos = jax.lax.broadcasted_iota(jnp.int32, (W,), 0) % period
    guard = (pos < 2) | (pos >= data - 8)
    return jnp.where(guard, cb | gb, m)


# NCAND ladder: fractions of the window total, each rounded up to 128.
# Coarse on purpose — a run's windows share GC statistics, so nearly every
# run compiles ONE bucket (prewarm seeds the floor from a reference
# sample); the 5/8 top matches the r4-era full-C|G cap.
_NCAND_FRACS = (1, 3, 6, 10)  # sixteenths


def _ncand_bucket(count: int, wtot: int, floor: int = 0) -> int:
    """Smallest ladder bucket ≥ max(count, floor); 0 = dense fallback
    (count above the 5/8 cap — extraordinary GC)."""
    need = max(count, floor, 1)
    for f in _NCAND_FRACS:
        b = _round_up(max(wtot * f // 16, 128), 128)
        if b >= need:
            return b
    return 0


_V32_STATICS = ("Nb", "Lq", "L4", "W", "nbits", "ref_static", "HAS_HARD",
                "min_phred", "NCAND", "CTX", "SLOT", "SAT_BITS")


def _v32_core(blob_u8, starts, woff_rel, hseq, hqual, hrefpos,
              hstrand, hkeep, *, Nb, Lq, L4, W, nbits, ref_static, HAS_HARD,
              min_phred, NCAND=0, CTX=7, SLOT=0):
    """The 2-bit semantic window program (the default NCH=2 extract):
    unpack 4 codes/byte (1 = the strand's methylated base, 2 = its
    unmethylated base, 0 = not counted) → 2-channel per-parity
    scatter-add → host-packed ref-mask epilogue (+ the dense hard-row
    path) → optional candidate compaction. Returns uint32 [2, W or NCAND]
    (meth, unmeth).

    Upload: one u8 blob (codes, one parity byte per row, the C and G
    bitmaps over the coordinate space, the reference bytes only when hard
    rows ride along) and the int32 row starts."""
    seqpack = blob_u8[: Nb * Lq].reshape(Nb, Lq)
    aux_u8 = blob_u8[Nb * Lq:]
    parity = aux_u8[:Nb]
    isc = aux_u8[Nb: Nb + nbits]
    isg = aux_u8[Nb + nbits: Nb + 2 * nbits]

    # 2-bit unpack: code j of a byte sits in bits 2*(j&3)
    codes = jnp.stack([(seqpack >> s) & 3 for s in (0, 2, 4, 6)],
                      axis=-1).reshape(Nb, L4)
    counts = pileup_counts(codes, starts, parity, W, 2)
    ch2 = channels_nch2(counts, isc, isg, W)  # [2, W] uint32
    if HAS_HARD:
        ref_p = aux_u8[Nb + 2 * nbits: Nb + 2 * nbits + ref_static]
        ch2 = ch2 + _hard_rows_pileup(hseq, hqual, hrefpos, hstrand, hkeep,
                                      ref_p, woff_rel, W, min_phred)[:2]
    if NCAND:
        # Candidate-compacted readback: emit only reads positions whose
        # context is CTX-enabled (default CpG-only ships ~1/8 of a random
        # window's coords vs 1/2 for full C|G). The candidate indices are
        # derived ON DEVICE from the uploaded ref bitmaps — no index
        # upload. The host scatters back by its own identical mask
        # (_ctx_mask_np / _ctx_mask_jnp must agree bit-for-bit).
        cbits = unpack_bits_device(isc, W)
        gbits = unpack_bits_device(isg, W)
        mask = _ctx_mask_jnp(cbits, gbits, CTX, SLOT if SLOT else W)
        idx = jnp.nonzero(mask, size=NCAND, fill_value=0)[0]
        ch2 = jnp.take(ch2, idx, axis=1)  # [2, NCAND]
    return ch2


@functools.partial(jax.jit, static_argnames=_V32_STATICS)
def _fused_window_pregated2(*args, SAT_BITS, **statics):
    return _saturate(_v32_core(*args, **statics), SAT_BITS)


@functools.partial(jax.jit, static_argnames=_V32_STATICS[:-1])
def _fused_window_pregated2_wide(*args, **statics):
    # overflow refetch: DENSE uint32 (rare; NCAND compaction off)
    return _v32_core(*args, **{**statics, "NCAND": 0})


# Readback width state: start with u8 (half the readback bytes); after the
# first depth>255 overflow, stay at u16 for the rest of the process so deep
# datasets don't pay a wide refetch per window.
_V3_SAT = {"bits": 8}

# Singleton device-resident dummy hard-row arrays, keyed by read length
# (see _fused_dispatch_v3's no-hard branch).
_HARD_DUMMIES: dict = {}

# Shape-bucket high-water marks (process-global). Every distinct (Nb, ...)
# bucket is a separate XLA program, so windows are padded UP to the
# largest bucket seen so far: a run converges to 1-2 compiled programs
# (the first window sets the floor; at most one escalation when a denser
# window appears) instead of one per shape. Escalations monotonically
# raise the floor.
_V3_HWM = {"Nb": 0, "NH": 0, "NCAND": {}, "NCANDG": {},
           # candidate-space group program floors (separate keys so the
           # candidate-coordinate geometry never cross-mints bigger
           # window-space shapes): NbC mirrors Nb, LC is the per-read
           # candidate-slot width bucket, CSLOT the per-window candidate
           # capacity bucket (keyed by wpad1 like NCAND)
           "NbC": 0, "LC": 0, "CSLOT": {}}

# Per-read candidate-slot width ladder (bytes*4): a 150 bp read over a
# random genome covers ~19 CpG-context candidates (mean; CpG islands push
# the window max to ~40-75), so most runs sit in the 32-64 buckets. A
# window whose densest read exceeds 128 slots falls back to the
# window-space group program.
_LC_LADDER = (16, 32, 48, 64, 96, 128)


def _lc_bucket(need: int, floor: int = 0) -> int:
    need = max(need, floor, 1)
    for b in _LC_LADDER:
        if b >= need:
            return b
    return 0


def _hard_dummies(L):
    """Device-resident 1-row placeholders for the hard-row arguments:
    passing the same arrays every window means zero per-window transfers
    for these five arguments."""
    hd = _HARD_DUMMIES.get(L)
    if hd is None:
        hd = tuple(jnp.asarray(a) for a in (
            np.zeros((1, L), np.uint8), np.zeros((1, L), np.uint8),
            np.full((1, L), -2, np.int32), np.ones(1, np.int32),
            np.zeros(1, bool)))
        _HARD_DUMMIES[L] = hd
    return hd


def _refbits(ref_p, woff_rel, wpad):
    """Packed C and G bitmaps over window coordinates: bit i is reference
    base i - woff_rel of ref_p (0 outside)."""
    from ..io import native

    rb = native.v3_refbits(ref_p, woff_rel, wpad)
    if rb is None:
        idx = np.arange(wpad, dtype=np.int64) - woff_rel
        inr = (idx >= 0) & (idx < len(ref_p))
        rbw = np.where(inr, ref_p[np.clip(idx, 0, len(ref_p) - 1)], 0)
        rb = (np.packbits(rbw == REF_C), np.packbits(rbw == REF_G))
    return rb


def _pack2_numpy(seq, qual, src, st, pos_rel, L4, min_phred, seqpack, pos_p,
                 parity_p):
    """numpy twin of native.v3_pack2: phred pre-gate + semantic 2-bit
    codes (1 = methylated base for the row's strand, 2 = unmethylated)
    packed 4 per byte into the given destination rows."""
    n = len(src)
    par = (st[src] & 1).astype(np.uint8)
    mc = np.where(par == 1, BASE_C, BASE_G).astype(np.uint8)[:, None]
    uc = np.where(par == 1, BASE_T, BASE_A).astype(np.uint8)[:, None]
    g = np.where(qual[src] >= min_phred, seq[src], 0).astype(np.uint8)
    v = np.where(g == mc, 1, np.where(g == uc, 2, 0)).astype(np.uint8)
    if L4 != v.shape[1]:
        v = np.concatenate([v, np.zeros((n, L4 - v.shape[1]), np.uint8)],
                           axis=1)
    seqpack[:n] = (v[:, 0::4] | (v[:, 1::4] << 2) | (v[:, 2::4] << 4)
                   | (v[:, 3::4] << 6))
    pos_p[:n] = pos_rel
    parity_p[:n] = par


def _fused_dispatch_v3(cfg, seq, qual, refpos, pos, st,
                       xla_rows, ref_window, win_start, woff_rel, W_fixed):
    """v3 host choreography for one window (see _v32_core / _v3_core4).
    `qual` must already be arbitrated on host; the phred pre-gate is
    applied here while packing (fused in the native kernel when built).
    Hard (indel/'=') rows ship their raw codes + quals (their dense path
    gates on qual itself). Returns finalize() -> uint32 [W_fixed, 4]."""
    from ..io import native

    rows = np.nonzero(~xla_rows)[0]
    f_pos = pos[rows] - win_start
    n = len(rows)
    L = seq.shape[1]
    Lh = (L + 1) // 2
    L2 = 2 * Lh
    Lq = (L + 3) // 4
    L4 = 4 * Lq
    wpad = W_fixed
    with _HWM_LOCK:
        Nb = _nb_bucket(n, _V3_HWM["Nb"])
        _V3_HWM["Nb"] = Nb
    NCH = 4 if cfg.minOppositeDepth > 0 else 2
    # NCH=2 (the default): the emit path reads only meth/unmeth, so codes
    # reduce to SEMANTIC 2-bit values (1=meth base, 2=unmeth base for the
    # row's strand) packed 4/byte — half the 4-bit upload again.
    if NCH == 2:
        nat = native.v3_pack2(seq, qual, rows, pos, st, Lq, Nb, win_start,
                              cfg.minPhred)
        if nat is not None:
            seqpack, pos_p, parity_p = nat
        else:
            seqpack = np.zeros((Nb, Lq), np.uint8)
            pos_p = np.zeros(Nb, np.int32)
            parity_p = np.zeros(Nb, np.uint8)
            _pack2_numpy(seq, qual, rows, st, f_pos, L4, cfg.minPhred,
                         seqpack, pos_p, parity_p)
    else:
        nat = native.v3_pack(seq, qual, rows, pos, st, Lh, Nb, win_start,
                             cfg.minPhred)
        if nat is not None:
            seqpack, pos_p, parity_p = nat
        else:
            f_seq = np.where(qual[rows] >= cfg.minPhred, seq[rows], 0).astype(
                np.uint8)
            if L2 != L:
                f_seq = np.concatenate(
                    [f_seq, np.zeros((n, L2 - L), np.uint8)], axis=1)
            seqpack = np.zeros((Nb, Lh), np.uint8)
            seqpack[:n] = f_seq[:, 0::2] | (f_seq[:, 1::2] << 4)
            pos_p = np.zeros(Nb, np.int32)
            pos_p[:n] = f_pos
            parity_p = np.zeros(Nb, np.uint8)
            parity_p[:n] = (st[rows] & 1).astype(np.uint8)

    # counts_to_channels' reference slice tolerates offsets within its
    # ±512 pad only; the offset is traced inside the program.
    assert -512 <= woff_rel <= 512, woff_rel
    ref_static = wpad + 256
    ref_p = np.zeros(ref_static, np.uint8)
    seqlen = min(len(ref_window), ref_static)
    ref_p[:seqlen] = np.asarray(ref_window[:seqlen], np.uint8)

    hrows = np.nonzero(xla_rows)[0]
    HAS_HARD = bool(len(hrows))
    if HAS_HARD:
        with _HWM_LOCK:
            NH = max(256, _V3_HWM["NH"])
            while NH < len(hrows) + 1:
                NH *= 2
            _V3_HWM["NH"] = NH
        hseq = np.zeros((NH, L), np.uint8)
        hqual = np.zeros((NH, L), np.uint8)
        hrefpos = np.full((NH, L), -2, np.int32)
        hstrand = np.ones(NH, np.int32)
        hkeep = np.zeros(NH, bool)
        nh = len(hrows)
        # hard rows ship their ORIGINAL codes + quals: '=' (code 0) bases
        # are legal there and the dense path keys on refpos validity
        hseq[:nh] = seq[hrows]
        hqual[:nh] = qual[hrows]
        hrefpos[:nh] = (refpos[hrows] - win_start).astype(np.int32)
        hstrand[:nh] = st[hrows]
        hkeep[:nh] = True
        hard = tuple(jnp.asarray(a) for a in
                     (hseq, hqual, hrefpos, hstrand, hkeep))
    else:
        hard = _hard_dummies(L)

    import os as _os
    import time as _time

    profile = _os.environ.get("MDTPU_PROFILE_DISPATCH") == "1"
    t0 = _time.perf_counter() if profile else 0.0
    sat_bits = _V3_SAT["bits"]
    ctx = _ctx_code(cfg)
    if NCH == 2:
        nbits = wpad // 8
        # the window/ref frame shift is applied HERE, so the device needs
        # no ref bytes at all unless hard rows ride along
        rb = _refbits(ref_p, woff_rel, wpad)
        parts = [parity_p, rb[0], rb[1]]
        rs2 = 0
        if HAS_HARD:
            parts.append(ref_p)
            rs2 = ref_static
        aux_u8 = np.concatenate(parts)
        statics = dict(Nb=Nb, Lq=Lq, L4=L4, W=wpad, nbits=nbits,
                       ref_static=rs2, HAS_HARD=HAS_HARD,
                       min_phred=cfg.minPhred, CTX=ctx, SLOT=wpad)
        program, program_wide = _fused_window_pregated2, \
            _fused_window_pregated2_wide
    else:
        aux_u8 = np.concatenate([parity_p, ref_p])
        rb = _refbits(ref_p, woff_rel, wpad)
        statics = dict(Nb=Nb, Lh=Lh, L2=L2, W=wpad, ref_static=ref_static,
                       NCH=NCH, HAS_HARD=HAS_HARD, min_phred=cfg.minPhred,
                       CTX=ctx, SLOT=wpad)
        program, program_wide = _fused_window_pregated, \
            _fused_window_pregated_wide
    # candidate-compacted readback: gather only the positions emit reads
    # (CTX-enabled context positions; default CpG-only ships ~1/8 of a
    # random window's coords vs 1/2 for full C|G). NCAND is a coarse
    # ladder bucket with a process-global high-water floor so a run
    # compiles ONE program; a window above the 5/8 cap falls back to the
    # dense readback.
    cand_idx = np.nonzero(_ctx_mask_np(
        np.unpackbits(rb[0])[:wpad] != 0,
        np.unpackbits(rb[1])[:wpad] != 0, ctx, wpad))[0].astype(np.int64)
    with _HWM_LOCK:
        floor = _V3_HWM["NCAND"].get(wpad, 0)
        NCAND = _ncand_bucket(len(cand_idx), wpad, floor)
        if NCAND:
            _V3_HWM["NCAND"][wpad] = max(floor, NCAND)
    compact_idx = cand_idx if NCAND else None
    statics["NCAND"] = NCAND
    blob_u8 = np.concatenate([seqpack.reshape(-1), aux_u8])
    args = (jnp.asarray(blob_u8), jnp.asarray(pos_p), jnp.int32(woff_rel),
            *hard)
    sel, overflow = program(*args, SAT_BITS=sat_bits, **statics)
    sel.copy_to_host_async()
    overflow.copy_to_host_async()
    if profile:
        t1 = _time.perf_counter()

    def finalize():
        if profile:
            tf0 = _time.perf_counter()
        sel_h, ovf_h = jax.device_get((sel, overflow))
        if profile:
            import sys as _sys

            _sys.stderr.write(
                f"[v3{'b' if NCH == 2 else ''}] n={n} Nb={Nb} "
                f"dispatch={t1 - t0:.3f}s "
                f"get={_time.perf_counter() - tf0:.3f}s "
                f"up={blob_u8.nbytes + pos_p.nbytes} "
                f"down={np.asarray(sel_h).nbytes}\n")
        if bool(ovf_h):
            # saturation hit: refetch this window wide, and widen the
            # readback for the rest of the process
            if sat_bits == 8:
                _V3_SAT["bits"] = 16
            out = np.asarray(jax.device_get(
                program_wide(*args, **statics))).T  # [W, 2 or 4]
            counters = np.zeros((wpad, 4), np.uint32)
            counters[:, : out.shape[1]] = out
            return counters[:W_fixed]
        # channel-major storage: the cast writes NCH contiguous rows and
        # emit's column reads become contiguous too; the [W, 4] view is
        # transpose-strided (no copy)
        cmaj = np.zeros((4, wpad), np.uint32)
        sel_np = np.asarray(sel_h)
        if compact_idx is not None:
            # compacted readback: scatter candidate counters back to their
            # window positions (non-candidates stay 0 — never read)
            cmaj[:NCH, compact_idx] = sel_np[:, : len(compact_idx)]
        else:
            cmaj[:NCH] = sel_np
        return cmaj.T[:W_fixed]

    return finalize


def _rows_gapless(refpos, pos, l_qseq):
    """Rows whose aligned positions are exactly pos+j for j<l_qseq (single-M
    CIGAR) — eligible for the v3 fast path.

    Valid aligned positions are strictly increasing, so "first == pos, last
    == pos+lq-1, and no -1/-2 inside the read" implies the whole row is
    consecutive — two [N, L] passes instead of five."""
    N, L = refpos.shape
    lq = np.asarray(l_qseq, np.int64)
    rows = np.arange(N)
    first_ok = refpos[:, 0] == pos
    last_ok = refpos[rows, np.clip(lq - 1, 0, L - 1)] == pos + lq - 1
    col = np.arange(L, dtype=np.int64)[None, :]
    any_gap = ((refpos < 0) & (col < lq[:, None])).any(axis=1)
    return np.where(lq > 0, first_ok & last_ok & ~any_gap, True)


def _rows_no_eq_base(seq, l_qseq):
    """Rows free of base code 0 ('=', match-to-reference). The v3 fast
    path uses base code 0 for "not counted", so '=' rows (legal BAM,
    though no bisulfite aligner emits them) ride the exact dense subpath
    instead, which keys on refpos validity."""
    L = seq.shape[1]
    col = np.arange(L, dtype=np.int64)[None, :]
    lq = np.asarray(l_qseq, np.int64)[:, None]
    return ~((seq == 0) & (col < lq)).any(axis=1)


class WindowHandle:
    """Deferred window counters: the device program has been dispatched;
    .get() performs the (blocking) readback and returns uint32 [W, 4].
    Dispatches return before the device finishes, so the engine can keep
    several windows in flight and hide device time behind host prep of
    later windows."""

    __slots__ = ("_fn", "_val")

    def __init__(self, fn=None, value=None):
        self._fn = fn
        self._val = value

    def get(self):
        if self._fn is not None:
            self._val = self._fn()
            self._fn = None
        return self._val


# Row-count bucket floor for the K-window batched program (its own key:
# group row counts are ~K x the single-window ones, and sharing the single
# program's floor would oversize every unbatched window).
_V3M_HWM = {"Nb": 0}


class _GroupResult:
    """Shared deferred result of one K-window batched dispatch: the first
    .get(k) runs the group finalize (ONE readback for all K windows) and
    caches the per-window counter list; later gets just slice it.
    Thread-safe — concurrent drain getters may race the first get."""

    __slots__ = ("_fn", "_vals", "_lock")

    def __init__(self, fn):
        self._fn = fn
        self._vals = None
        self._lock = threading.Lock()

    def get(self, k):
        with self._lock:
            if self._fn is not None:
                self._vals = self._fn()
                self._fn = None
        return self._vals[k]


def dispatch_window_group(cfg, items, pad_to=0):
    """K-window batched dispatch: concatenate K prepared windows along the
    genome-coordinate axis — each in its own guard-separated slot — and
    run ONE v3 2-bit program over the group, so fixed per-dispatch costs
    (launch, transfers, readback round trips) amortize over K windows.

    items: list of (batch, strand_arr, keep, ref_window, win_offset,
    win_start, win_end, rstrand) tuples — the dispatch() signature.
    `pad_to`: pad the group with empty slots to exactly this many windows
    so partial tail groups reuse the same compiled program shape.
    Returns a list of per-window WindowHandles (shared deferred readback),
    or None when the group preconditions fail (caller dispatches singles).

    Preconditions: NCH == 2 (cfg.minOppositeDepth == 0; the 4-channel
    epilogue needs per-window reference bytes on device), no BED strand
    column, L <= 256 and equal across windows (the engine pads batches to
    the file-global max), window width <= chunkSize (same group slot).
    Hard rows (indels / '=' bases / pairs containing one) do NOT ride the
    batched program: they are folded in per window with the exact host
    oracle at finalize — they are rare, and this removes the dense
    hard-row upload entirely."""
    if cfg.minOppositeDepth > 0 or not items:
        return None
    Ls = set()
    for it in items:
        if it[7] is not None:  # rstrand
            return None
        if it[0].n:
            Ls.add(it[0].seq.shape[1])
    if Ls and max(Ls) > 256:
        return None
    if len(Ls) > 1:
        return None
    W_fixed = _round_up(int(cfg.chunkSize) + 16, 512)
    wins = []
    for it in items:
        (batch, strand_arr, keep, ref_window, win_offset, win_start,
         win_end, _rs) = it
        W = win_end - win_start
        if _round_up(max(int(cfg.chunkSize) + 16, W), 512) > W_fixed:
            return None  # window wider than the group slot
        kidx = np.nonzero(keep)[0]
        if batch.n == 0 or len(kidx) == 0:
            wins.append({"empty": True, "W": W})
            continue
        seq, qual, refpos, pos, _lq, st, xla_rows = _prep_v3_rows(
            cfg, batch, strand_arr, keep, kidx)
        wins.append({"empty": False, "W": W, "seq": seq, "qual": qual,
                     "refpos": refpos, "pos": pos, "st": st,
                     "xla_rows": xla_rows, "ref_window": ref_window,
                     "win_start": win_start,
                     "woff_rel": win_offset - win_start})
    n_real = len(wins)
    while len(wins) < pad_to:
        wins.append({"empty": True, "W": 0})
    g = _GroupResult(_fused_dispatch_v3_multi(cfg, wins, W_fixed))
    return [WindowHandle(fn=functools.partial(g.get, k))
            for k in range(n_real)]


def _dispatch_group_program(Kw, n_tot, Nb, statics, blob_u8, starts,
                            compact_idx, W_tot, finalize_common, tag):
    """Launch the 2-bit group program over a packed group and return its
    finalize(): ONE readback for all K windows, widened on saturation."""
    import os as _os
    import time as _time

    profile = _os.environ.get("MDTPU_PROFILE_DISPATCH") == "1"
    t0 = _time.perf_counter() if profile else 0.0
    sat_bits = _V3_SAT["bits"]
    args = (jnp.asarray(blob_u8), jnp.asarray(starts), jnp.int32(0),
            *_hard_dummies(statics["L"]))
    statics = {k: v for k, v in statics.items() if k != "L"}
    sel, overflow = _fused_window_pregated2(*args, SAT_BITS=sat_bits,
                                            **statics)
    sel.copy_to_host_async()
    overflow.copy_to_host_async()
    if profile:
        t1 = _time.perf_counter()

    def finalize():
        if profile:
            tf0 = _time.perf_counter()
        sel_h, ovf_h = jax.device_get((sel, overflow))
        if profile:
            import sys as _sys

            _sys.stderr.write(
                f"[{tag}] Kw={Kw} n={n_tot} Nb={Nb} W={W_tot} "
                f"dispatch={t1 - t0:.3f}s "
                f"get={_time.perf_counter() - tf0:.3f}s "
                f"up={blob_u8.nbytes + starts.nbytes} "
                f"down={np.asarray(sel_h).nbytes}\n")
        if bool(ovf_h):
            if sat_bits == 8:
                _V3_SAT["bits"] = 16
            cm = np.asarray(jax.device_get(
                _fused_window_pregated2_wide(*args, **statics)))
            return finalize_common(cm.astype(np.uint32))
        sel_np = np.asarray(sel_h)
        if compact_idx is None:
            return finalize_common(sel_np.astype(np.uint32))
        cm = np.zeros((2, W_tot), np.uint32)
        cm[:, compact_idx] = sel_np[:, : len(compact_idx)]
        return finalize_common(cm)

    return finalize


def _fused_dispatch_v3_multi_cand(cfg, wins, W_fixed):
    """Candidate-SPACE variant of the group choreography: every window's
    reads are re-coordinated on the host from window positions to
    CANDIDATE SLOTS — the ~1/8-dense (CpG-only default) CTX-enabled
    context positions that are the only coordinates the emit path ever
    reads (the same _ctx_mask_np set the compacted readback uses). A
    150 bp read covering ~19 candidates packs into 8-16 bytes instead of
    38, and the group's coordinate space shrinks from Kw*(W+512) to
    Kw*CSLOT, so the upload and the device program both shrink while the
    SAME _fused_window_pregated2 program runs unchanged over the
    transformed inputs (slot-space bitmaps carry each candidate's
    C/G-ness). The readback is dense over the slot space, and finalize
    scatters slots back to window coordinates with the host-side
    candidate index.

    Cross-slot writes cannot happen: a read's row only carries non-zero
    codes at its own window's candidates (csum bounds), and zero codes
    are never counted.

    Returns finalize() like _fused_dispatch_v3_multi, or None (without
    mutating `wins`) when ineligible — caller continues with the
    window-space group path. Eligibility: every live window's candidate
    count fits the CSLOT ladder (<= 5/8 of the window; extraordinary GC
    falls back) and its densest read covers <= 128 candidate slots."""
    from ..io import native

    live = [w for w in wins if not w["empty"]]
    if not live:
        return None
    L = live[0]["seq"].shape[1]
    wpad1 = W_fixed
    ref_static1 = wpad1 + 256
    ctx = _ctx_code(cfg)
    min_phred = int(cfg.minPhred)
    Kw = len(wins)

    # --- phase A: per-window candidate geometry (no mutation yet)
    geo = [None] * Kw
    maxC = 0
    for k, w in enumerate(wins):
        if w["empty"]:
            continue
        woff = int(w["woff_rel"])
        if not (-512 <= woff <= 512):
            return None
        ref_p = np.zeros(ref_static1, np.uint8)
        rw = np.asarray(w["ref_window"], np.uint8)
        seqlen = min(len(rw), ref_static1)
        ref_p[:seqlen] = rw[:seqlen]
        rb = _refbits(ref_p, woff, wpad1)
        nat_cand = native.v3_candidates(rb[0], rb[1], wpad1, ctx)
        if nat_cand is not None:
            cand, csum = nat_cand
        else:
            cb = np.unpackbits(rb[0])[:wpad1] != 0
            gb = np.unpackbits(rb[1])[:wpad1] != 0
            mask = _ctx_mask_np(cb, gb, ctx, wpad1)
            cand = np.nonzero(mask)[0].astype(np.int64)
            csum = np.zeros(wpad1 + 1, np.int32)
            np.cumsum(mask, dtype=np.int32, out=csum[1:])
        geo[k] = {"ref_p": ref_p, "rb": rb, "cand": cand,
                  "csum": csum, "woff": woff}
        maxC = max(maxC, len(cand))

    with _HWM_LOCK:
        cfloor = _V3_HWM["CSLOT"].get(wpad1, 0)
    CSLOT = _ncand_bucket(maxC, wpad1, cfloor)
    if CSLOT == 0:
        return None  # extraordinary GC: dense window-space path

    # --- phase B: per-window slot-space row geometry + Lc bucket
    per = [None] * Kw
    n_tot = 0
    maxcnt = 0
    for k, w in enumerate(wins):
        if w["empty"]:
            continue
        g = geo[k]
        rows = np.nonzero(~w["xla_rows"])[0]
        f_pos = (w["pos"][rows] - w["win_start"]).astype(np.int64)
        fp0 = np.clip(f_pos, 0, wpad1)
        fp1 = np.clip(f_pos + L, 0, wpad1)
        s0 = g["csum"][fp0].astype(np.int64)
        cnt = g["csum"][fp1].astype(np.int64) - s0
        if len(cnt):
            maxcnt = max(maxcnt, int(cnt.max()))
        per[k] = {"src": rows, "f_pos": f_pos, "s0": s0, "cnt": cnt,
                  "row0": n_tot}
        n_tot += len(rows)
    with _HWM_LOCK:
        lfloor = _V3_HWM["LC"]
    Lc4 = _lc_bucket(maxcnt, lfloor)
    if Lc4 == 0:
        return None  # a read denser than 128 candidate slots

    # --- group geometry in candidate-slot coordinates: slot k covers
    # [k*P, (k+1)*P), P a multiple of 128 (byte-aligned bitmaps)
    Lq = Lc4 // 4
    L4 = Lc4
    P = CSLOT
    W_tot = Kw * P
    nbits_tot = W_tot // 8
    with _HWM_LOCK:
        Nb = _nb_bucket(n_tot, _V3_HWM["NbC"])
        _V3_HWM["NbC"] = Nb
        _V3_HWM["CSLOT"][wpad1] = max(cfloor, CSLOT)
        _V3_HWM["LC"] = max(lfloor, Lc4)

    # --- phase C: pack rows into candidate space + slot bitmaps
    # (mutating from here on: no fallback past this point)
    seqpack = np.zeros((Nb, Lq), np.uint8)
    pos_p = np.zeros(Nb, np.int32)
    parity_p = np.zeros(Nb, np.uint8)
    isc_all = np.zeros(nbits_tot, np.uint8)
    isg_all = np.zeros(nbits_tot, np.uint8)
    hard = [None] * Kw
    cands = [None] * Kw
    Ws = [w["W"] for w in wins]
    for k, (w, p) in enumerate(zip(wins, per)):
        if p is None:
            continue
        g = geo[k]
        cand = g["cand"]
        C = len(cand)
        cands[k] = cand
        n_k = len(p["src"])
        r0 = p["row0"]
        if n_k:
            nat = native.v3_pack2_cand(
                w["seq"], w["qual"], p["src"], w["pos"], w["st"], Lq,
                w["win_start"], min_phred, cand, g["csum"], wpad1, k * P,
                out=(seqpack[r0:r0 + n_k], pos_p[r0:r0 + n_k],
                     parity_p[r0:r0 + n_k]))
            if nat is None:
                par = (w["st"][p["src"]] & 1).astype(np.uint8)
                mc = np.where(par == 1, BASE_C, BASE_G).astype(
                    np.uint8)[:, None]
                uc = np.where(par == 1, BASE_T, BASE_A).astype(
                    np.uint8)[:, None]
                gq = np.where(w["qual"][p["src"]] >= min_phred,
                              w["seq"][p["src"]], 0).astype(np.uint8)
                v = np.where(gq == mc, 1,
                             np.where(gq == uc, 2, 0)).astype(np.uint8)
                vv = np.zeros((n_k, L4), np.uint8)
                if C:
                    j = np.arange(L4, dtype=np.int64)[None, :]
                    slotpos = p["s0"][:, None] + j
                    valid = j < p["cnt"][:, None]
                    coff = (cand[np.minimum(slotpos, C - 1)]
                            - p["f_pos"][:, None])
                    coff = np.clip(coff, 0, L - 1)
                    vv = np.where(
                        valid,
                        v[np.arange(n_k)[:, None], coff], 0).astype(
                            np.uint8)
                seqpack[r0:r0 + n_k] = (vv[:, 0::4] | (vv[:, 1::4] << 2)
                                        | (vv[:, 2::4] << 4)
                                        | (vv[:, 3::4] << 6))
                pos_p[r0:r0 + n_k] = (p["s0"] + k * P).astype(np.int32)
                parity_p[r0:r0 + n_k] = par
        # slot-space bitmaps: slot j of window k is a C-site or G-site
        # (bit-extract at the C candidate coords only — no full unpack)
        if C:
            rb0, rb1 = g["rb"]
            sh7 = (7 - (cand & 7)).astype(np.int64)
            sC = np.zeros(P, bool)
            sG = np.zeros(P, bool)
            sC[:C] = ((rb0[cand >> 3] >> sh7) & 1) != 0
            sG[:C] = ((rb1[cand >> 3] >> sh7) & 1) != 0
            isc_all[k * P // 8 : (k + 1) * P // 8] = np.packbits(sC)
            isg_all[k * P // 8 : (k + 1) * P // 8] = np.packbits(sG)
        hrows = np.nonzero(w["xla_rows"])[0]
        if len(hrows):
            hard[k] = (w["seq"][hrows].copy(), w["qual"][hrows].copy(),
                       (w["refpos"][hrows] - w["win_start"]).astype(
                           np.int64),
                       w["st"][hrows].copy(), g["ref_p"], g["woff"])
        w.clear()
    del wins, live, per, geo

    def finalize_common(cm):
        """cm: uint32 [2, W_tot] slot-space counters → per-window [W,4]
        via the host candidate index (channels 2-3 stay zero: the NCH=2
        readback contract), + host-oracle hard rows."""
        outs = []
        for k in range(Kw):
            out = np.zeros((Ws[k], 4), np.uint32)
            cand = cands[k]
            if cand is not None and len(cand):
                m = cand < Ws[k]
                cw = cand[m]
                out[cw, 0] = cm[0, k * P : k * P + len(cand)][m]
                out[cw, 1] = cm[1, k * P : k * P + len(cand)][m]
            if hard[k] is not None:
                hseq, hqual, hrp, hst, ref_p, woff = hard[k]
                hc = sem.pileup_channels(
                    hseq, hqual, hrp, hst, np.ones(hseq.shape, bool),
                    ref_p, woff, 0, wpad1, min_phred)
                out[:, :2] += hc[: Ws[k], :2].astype(np.uint32)
            outs.append(out)
        return outs

    blob_u8 = np.concatenate([seqpack.reshape(-1), parity_p, isc_all,
                              isg_all])
    statics = dict(L=L, Nb=Nb, Lq=Lq, L4=L4, W=W_tot, nbits=nbits_tot,
                   ref_static=0, HAS_HARD=False, min_phred=min_phred,
                   NCAND=0, CTX=0, SLOT=0)
    return _dispatch_group_program(Kw, n_tot, Nb, statics, blob_u8, pos_p,
                                   None, W_tot, finalize_common, "v3c")


def _fused_dispatch_v3_multi(cfg, wins, W_fixed):
    """Group choreography for dispatch_window_group: one v3 2-bit program
    (_fused_window_pregated2) over K window slots. The candidate-space
    layout (_fused_dispatch_v3_multi_cand) is tried first; when it
    declines, windows sit side by side in window coordinates, each in a
    slot of S = wpad1 + 512 coordinates. Returns finalize() -> list of
    uint32 [W_k, 4] per window."""
    from ..io import native

    live = [w for w in wins if not w["empty"]]
    if not live:
        Ws = [w["W"] for w in wins]
        return lambda: [np.zeros((W, 4), np.uint32) for W in Ws]
    import os as _os

    if _os.environ.get("MDTPU_CANDSPACE", "1") != "0":
        fin = _fused_dispatch_v3_multi_cand(cfg, wins, W_fixed)
        if fin is not None:
            return fin
        # ineligible (extraordinary GC / >128-candidate read): continue
        # into the window-space group path below
    L = live[0]["seq"].shape[1]
    Lq = (L + 3) // 4
    L4 = 4 * Lq
    wpad1 = W_fixed
    # Guard between slots: reads near a slot's right edge write up to L-1
    # (< 512) bases past wpad1; reads entering a window from the left
    # start at most L-1 before its slot. Both land in the guard, which has
    # no candidate bits — exactly the bases the single-window program
    # drops past wpad / slices off past W.
    S = wpad1 + 512
    Kw = len(wins)
    W_tot = Kw * S
    nbits1 = wpad1 // 8
    nbits_tot = W_tot // 8
    min_phred = int(cfg.minPhred)

    per = []
    n_tot = 0
    for w in wins:
        if w["empty"]:
            per.append(None)
            continue
        rows = np.nonzero(~w["xla_rows"])[0]
        f_pos = (w["pos"][rows] - w["win_start"]).astype(np.int64)
        per.append({"src": rows, "f_pos": f_pos, "row0": n_tot})
        n_tot += len(rows)
    with _HWM_LOCK:
        Nb = _nb_bucket(n_tot, _V3M_HWM["Nb"])
        _V3M_HWM["Nb"] = Nb

    # --- pack rows + per-window ref bitmaps + hard-row slices
    seqpack = np.zeros((Nb, Lq), np.uint8)
    pos_p = np.zeros(Nb, np.int32)
    parity_p = np.zeros(Nb, np.uint8)
    isc_all = np.zeros(nbits_tot, np.uint8)
    isg_all = np.zeros(nbits_tot, np.uint8)
    hard = [None] * Kw
    Ws = [w["W"] for w in wins]
    ref_static1 = wpad1 + 256
    for k, (w, p) in enumerate(zip(wins, per)):
        if p is None:
            continue
        n_k = len(p["src"])
        r0 = p["row0"]
        if n_k:
            out = (seqpack[r0:r0 + n_k], pos_p[r0:r0 + n_k],
                   parity_p[r0:r0 + n_k])
            nat = native.v3_pack2(
                w["seq"], w["qual"], p["src"], w["pos"], w["st"], Lq,
                n_k, w["win_start"], min_phred, out=out)
            if nat is None:
                _pack2_numpy(w["seq"], w["qual"], p["src"], w["st"],
                             p["f_pos"], L4, min_phred, *out)
            pos_p[r0:r0 + n_k] += k * S  # slot offset
        ref_p = np.zeros(ref_static1, np.uint8)
        rw = np.asarray(w["ref_window"], np.uint8)
        seqlen = min(len(rw), ref_static1)
        ref_p[:seqlen] = rw[:seqlen]
        woff = int(w["woff_rel"])
        assert -512 <= woff <= 512, woff
        rb = _refbits(ref_p, woff, wpad1)
        isc_all[k * S // 8 : k * S // 8 + nbits1] = rb[0]
        isg_all[k * S // 8 : k * S // 8 + nbits1] = rb[1]
        hrows = np.nonzero(w["xla_rows"])[0]
        if len(hrows):
            hard[k] = (w["seq"][hrows].copy(), w["qual"][hrows].copy(),
                       (w["refpos"][hrows] - w["win_start"]).astype(
                           np.int64),
                       w["st"][hrows].copy(), ref_p, woff)
        # finalize must not pin the window's big arrays until readback
        w.clear()
    del wins, live, per

    # Per-slot context mask (period S, data extent wpad1: the guard bands
    # sit at each window's own bitmap boundaries and shifts never bleed
    # useful bits across slots — guard positions use the full C|G rule,
    # and the inter-slot guards carry no bits at all).
    ctx = _ctx_code(cfg)
    cand_idx = np.nonzero(_ctx_mask_np(
        np.unpackbits(isc_all)[:W_tot] != 0,
        np.unpackbits(isg_all)[:W_tot] != 0, ctx,
        (S, wpad1)))[0].astype(np.int64)
    with _HWM_LOCK:
        floor = _V3_HWM["NCANDG"].get(W_tot, 0)
        NCAND = _ncand_bucket(len(cand_idx), W_tot, floor)
        if NCAND:
            _V3_HWM["NCANDG"][W_tot] = max(floor, NCAND)
    compact_idx = cand_idx if NCAND else None

    def finalize_common(cm):
        """cm: uint32 [2, W_tot] dense group counters → per-window [W,4]
        with the host-oracle hard rows folded in (channels 2-3 stay zero:
        the NCH=2 readback contract)."""
        outs = []
        for k in range(Kw):
            out = np.zeros((Ws[k], 4), np.uint32)
            out[:, :2] = cm[:, k * S : k * S + Ws[k]].T
            if hard[k] is not None:
                hseq, hqual, hrp, hst, ref_p, woff = hard[k]
                hc = sem.pileup_channels(
                    hseq, hqual, hrp, hst, np.ones(hseq.shape, bool),
                    ref_p, woff, 0, wpad1, min_phred)
                out[:, :2] += hc[: Ws[k], :2].astype(np.uint32)
            outs.append(out)
        return outs

    blob_u8 = np.concatenate([seqpack.reshape(-1), parity_p, isc_all,
                              isg_all])
    statics = dict(L=L, Nb=Nb, Lq=Lq, L4=L4, W=W_tot, nbits=nbits_tot,
                   ref_static=0, HAS_HARD=False, min_phred=min_phred,
                   NCAND=NCAND, CTX=ctx, SLOT=(S, wpad1))
    return _dispatch_group_program(Kw, n_tot, Nb, statics, blob_u8, pos_p,
                                   compact_idx, W_tot, finalize_common, "v3g")


def _prep_v3_rows(cfg, batch, strand_arr, keep, kidx):
    """Shared host prep for the v3 device programs: kidx row selection,
    gapless classification, mate pairing and host overlap arbitration
    (overlaps.c:54-119 via the native kernels). Returns
    (seq, qual, refpos, pos, lq, st, xla_rows) with `qual` already
    arbitrated — seq/refpos/pos are views when every row is kept, so the
    caller's batch is never mutated (only qual is copied)."""
    from ..io import native

    if len(kidx) == batch.n:
        seq = batch.seq
        qual = batch.qual.copy()
        refpos = batch.refpos
        pos = batch.pos
        lq = batch.l_qseq
    else:
        seq = batch.seq[kidx]
        qual = batch.qual[kidx]
        refpos = batch.refpos[kidx]
        pos = batch.pos[kidx]
        lq = batch.l_qseq[kidx]
    st = strand_arr[kidx].astype(np.int32)

    simple = native.v3_flags(seq, refpos, pos, lq)
    if simple is None:
        simple = _rows_gapless(refpos, pos, lq) & _rows_no_eq_base(seq, lq)
    a_np, b_np = sem.pair_mates_batch(batch, kidx)
    pair_simple = np.ones(len(a_np), bool)
    if len(a_np):
        pair_simple = simple[a_np] & simple[b_np]
    xla_rows = np.zeros(len(kidx), bool)
    xla_rows |= ~simple
    if len(a_np):
        xla_rows[a_np[~pair_simple]] = True
        xla_rows[b_np[~pair_simple]] = True

    a_t, b_t = sem.touching_pairs(batch.pos[kidx], batch.endpos[kidx],
                                  a_np, b_np)
    if len(a_t):
        fb = native.arbitrate2(seq, qual, refpos, st, lq, simple, a_t, b_t)
        if fb is None:
            fb = native.arbitrate(seq, qual, refpos, st, a_t, b_t)
        if fb is None:
            sem.arbitrate_overlaps(seq, qual, refpos, st, a_t, b_t)
        elif len(fb):
            sem._arbitrate_pairs_loop(seq, qual, refpos, st,
                                      np.asarray(a_t)[fb],
                                      np.asarray(b_t)[fb])
    return seq, qual, refpos, pos, lq, st, xla_rows


def compute_window_counters_fast(cfg, batch, strand_arr, keep, ref_window,
                                 win_offset, win_start, win_end, rstrand=None):
    """Synchronous wrapper over dispatch_window_counters_fast (kept for the
    tests and the threaded engine path)."""
    h = dispatch_window_counters_fast(cfg, batch, strand_arr, keep,
                                      ref_window, win_offset, win_start,
                                      win_end, rstrand)
    if h is None:
        return None
    return h.get()


def dispatch_window_counters_fast(cfg, batch, strand_arr, keep, ref_window,
                                  win_offset, win_start, win_end,
                                  rstrand=None):
    """Single-window fast path: mate arbitration and the phred pre-gate on
    HOST (native kernels, exact), then the pre-gated v3 program for the
    gapless rows; reads with indels (or any pair containing one) take the
    exact dense subpath inside the same program. Returns a WindowHandle
    (readback deferred to .get()), or None when the caller must fall back
    to the dense path (BED strand column, reads longer than 256 bp).

    Channel contract: with cfg.minOppositeDepth == 0 the packed readback
    ships only channels [meth, unmeth] — channels 2-3 (opposite coverage /
    variants) return ZERO because the emit path never reads them; with
    minOppositeDepth > 0 all 4 channels come back exact."""
    W = win_end - win_start
    kidx = np.nonzero(keep)[0]
    if len(kidx) == 0:
        return WindowHandle(value=np.zeros((W, 4), dtype=np.uint32))
    L = batch.seq.shape[1]
    if rstrand is not None or L > 256:
        return None
    # Compute over a fixed-size window (chunkSize-derived) and slice, so the
    # final clamped window of each contig reuses the compiled program.
    W_fixed = _round_up(max(int(cfg.chunkSize) + 16, W), 512)
    # seq/qual here are kidx copies, so the in-place host arbitration never
    # touches the caller's batch.
    seq, qual, refpos, pos, _lq, st, xla_rows = _prep_v3_rows(
        cfg, batch, strand_arr, keep, kidx)
    fin = _fused_dispatch_v3(cfg, seq, qual, refpos, pos, st, xla_rows,
                             ref_window, win_start, win_offset - win_start,
                             W_fixed)
    return WindowHandle(fn=lambda: fin()[:W])


def make_device_backend(cfg):
    """Adapter with the host-backend signature (engine.extract). The
    flag-gate / NH / BED / mappability read filters, conv-eff and trimming
    stay on the host (cheap, data-dependent); the pileup runs on device.
    Exactness vs the host path is covered by the parity tests."""
    import os

    on_cpu = jax.devices()[0].platform == "cpu"

    def dispatch(cfg, batch, strand_arr, keep, ref_window, win_offset,
                 win_start, win_end, rstrand=None):
        W = win_end - win_start
        if batch.n == 0:
            return WindowHandle(value=np.zeros((W, 4), dtype=np.uint32))
        fast = dispatch_window_counters_fast(
            cfg, batch, strand_arr, keep, ref_window, win_offset,
            win_start, win_end, rstrand)
        if fast is not None:
            return fast
        # Dense path (BED strand column, reads > 256 bp): arbitration and
        # the pileup scatter-add on device over the raw read tensors.
        kidx = np.nonzero(keep)[0]
        if len(kidx) == 0:
            return WindowHandle(value=np.zeros((W, 4), dtype=np.uint32))
        sub = batch
        seq = jnp.asarray(sub.seq[kidx])
        qual = jnp.asarray(sub.qual[kidx])
        refpos = jnp.asarray(sub.refpos[kidx].astype(np.int32))
        st = jnp.asarray(strand_arr[kidx].astype(np.int32))
        L = sub.seq.shape[1]
        a_np, b_np = sem.pair_mates_batch(sub, kidx)
        P = max(len(a_np), 1)
        pair_a = np.zeros(P, np.int32)
        pair_b = np.zeros(P, np.int32)
        pair_valid = np.zeros(P, bool)
        pair_a[: len(a_np)] = a_np
        pair_b[: len(b_np)] = b_np
        pair_valid[: len(a_np)] = True
        ovw = _round_up(max(2 * L, 1), 128)

        if rstrand is not None:
            safe = np.clip(sub.refpos[kidx] - win_start, 0, W - 1)
            rs = rstrand[safe]
            odd = (strand_arr[kidx].astype(np.int64) & 1)[:, None] == 1
            keep_base = (rs == 0) | ((rs == 1) & odd) | ((rs == 2) & ~odd)
        else:
            keep_base = np.ones(sub.seq[kidx].shape, dtype=bool)

        qual2 = arbitrate_device(seq, qual, refpos, st, jnp.asarray(pair_a),
                                 jnp.asarray(pair_b), jnp.asarray(pair_valid),
                                 ovw)
        counters = pileup_device(
            seq, qual2, refpos, st, jnp.ones(len(kidx), bool),
            jnp.asarray(keep_base), jnp.asarray(ref_window),
            win_offset, win_start, W, cfg.minPhred,
        )
        return WindowHandle(fn=lambda: np.asarray(jax.device_get(counters)))

    def compute(cfg, batch, strand_arr, keep, ref_window, win_offset,
                win_start, win_end, rstrand=None):
        return dispatch(cfg, batch, strand_arr, keep, ref_window, win_offset,
                        win_start, win_end, rstrand).get()

    def dispatch_group(cfg, items, pad_to=0):
        """K-window batched dispatch; falls back to per-window dispatch
        when the group preconditions fail (see dispatch_window_group).
        A single window still rides the group program when pad_to pads it
        to the standard group shape, so a run compiles one program."""
        if len(items) > 1 or pad_to > len(items):
            hs = dispatch_window_group(cfg, items, pad_to=pad_to)
            if hs is not None:
                return hs
        return [dispatch(cfg, *it) for it in items]

    def prewarm(read_len: int, est_rows: int | None = None,
                ref_sample=None):
        """Compile the canonical v3 group program off the critical path:
        seeds the shape-bucket floors to the production bucket — sized
        from the input's expected reads-per-window when known — and fires
        one dummy dispatch so the compile overlaps BAM decode and early
        window prep instead of stalling the first readback. No-op on the
        CPU platform (tests would pay a pointless six-figure-row
        compile)."""
        if on_cpu or read_len > 256:
            return  # L > 256 windows bypass the v3 fast path entirely
        env_floor = os.environ.get("MDTPU_NB_FLOOR")
        if env_floor is not None:
            floor_nb = int(env_floor)
        elif est_rows:
            floor_nb = _nb_bucket(est_rows)
        else:
            floor_nb = 131072
        group_k = int(os.environ.get("MDTPU_BATCH_WINDOWS", "4") or 1)
        L = max(int(read_len), 1)
        n = 2
        seq = np.full((n, L), 2, np.uint8)
        qual = np.full((n, L), 30, np.uint8)
        pos = np.arange(n, dtype=np.int64) * 200
        refpos = pos[:, None] + np.arange(L, dtype=np.int64)[None, :]
        st = np.ones(n, np.int32)
        W_fixed = _round_up(max(int(cfg.chunkSize) + 16, 1), 512)
        ref_p = np.zeros(256, np.uint8)
        # Seed the NCAND shape-bucket floor from a reference sample: the
        # candidate-compacted readback's size depends on the genome's
        # context density (default CpG-only ships ~1/8 of a random
        # window, ~1/32 of a CpG-depleted mammalian one), and the dummy
        # dispatch below has a zero reference — without the floor it
        # would warm the smallest bucket instead of the production one.
        if ref_sample is not None and len(ref_sample) >= 4096:
            rs = np.asarray(ref_sample, np.uint8)
            m = _ctx_mask_np(rs == REF_C, rs == REF_G, _ctx_code(cfg),
                             len(rs))
            frac = float(np.count_nonzero(m)) / len(rs)
            wpad1 = W_fixed
            b1 = _ncand_bucket(int(frac * wpad1 * 1.05) + 256, wpad1)
            S = wpad1 + 512
            W_tot = max(group_k, 1) * S
            bg = _ncand_bucket(
                max(group_k, 1) * int(frac * wpad1 * 1.05) + 256, W_tot)
            # Candidate-space floors: CSLOT is the same density-derived
            # bucket as the single-window readback; LC comes from the
            # densest read-length span in the sample (with margin — CpG
            # islands cluster, and a mid-run Lc escalation costs one
            # compile on the producer thread).
            mcs = np.zeros(len(rs) + 1, np.int64)
            np.cumsum(m, out=mcs[1:])
            lc_seed = 0
            if len(rs) > L:
                cnt_max = int((mcs[L:] - mcs[:-L]).max())
                lc_seed = _lc_bucket(int(cnt_max * 1.25) + 2)
            with _HWM_LOCK:
                if b1:
                    _V3_HWM["NCAND"][wpad1] = max(
                        _V3_HWM["NCAND"].get(wpad1, 0), b1)
                    _V3_HWM["CSLOT"][wpad1] = max(
                        _V3_HWM["CSLOT"].get(wpad1, 0), b1)
                if bg:
                    _V3_HWM["NCANDG"][W_tot] = max(
                        _V3_HWM["NCANDG"].get(W_tot, 0), bg)
                if lc_seed:
                    _V3_HWM["LC"] = max(_V3_HWM["LC"], lc_seed)
        # Fire-and-forget: the dispatch alone triggers the compile;
        # run_extract joins this thread before exiting.
        if group_k > 1 and cfg.minOppositeDepth == 0:
            # the run's windows go through the K-batched program; warm
            # THAT shape (the single program only serves rare fallbacks)
            if env_floor is not None:
                gfloor = int(env_floor)
            elif est_rows:
                gfloor = _nb_bucket(group_k * est_rows)
            else:
                gfloor = _nb_bucket(group_k * 131072)
            with _HWM_LOCK:
                _V3M_HWM["Nb"] = max(_V3M_HWM["Nb"], gfloor)
                # Seed NbC so the dummy dispatch below warms the
                # production candidate-space shape.
                if est_rows:
                    _V3_HWM["NbC"] = max(_V3_HWM["NbC"],
                                         _nb_bucket(group_k * est_rows))
                # seed the SINGLE-window floor too: group-precondition
                # fallbacks and the -@N worker path still dispatch
                # singles, and an unseeded floor would put them on a
                # never-compiled shape
                _V3_HWM["Nb"] = max(_V3_HWM["Nb"], floor_nb)
            wins = []
            for k in range(group_k):
                wins.append({"empty": False, "W": int(cfg.chunkSize),
                             "seq": seq.copy(), "qual": qual.copy(),
                             "refpos": refpos.copy(), "pos": pos.copy(),
                             "st": st.copy(),
                             "xla_rows": np.zeros(n, bool),
                             "ref_window": ref_p, "win_start": 0,
                             "woff_rel": -2})
            _fused_dispatch_v3_multi(cfg, wins, W_fixed)
            return
        with _HWM_LOCK:
            _V3_HWM["Nb"] = max(_V3_HWM["Nb"], floor_nb)
        _fused_dispatch_v3(cfg, seq, qual, refpos, pos, st,
                           np.zeros(n, bool), ref_p, 0, -2, W_fixed)

    compute.dispatch = dispatch
    compute.dispatch_group = dispatch_group
    compute.prewarm = prewarm
    return compute
