"""Candidate-space group dispatch (_fused_dispatch_v3_multi_cand): the
round-5 wire shrink that re-coordinates reads from window positions to
candidate slots on the host and runs the unchanged 2-bit group program
over the ~8x smaller slot space.

The generic group contract (window-straddling reads, hard rows, empty
windows, partial groups, ctx combos) is exercised by
tests/test_group_dispatch.py and tests/test_ctx_compact.py, which now
route through this path by default. This file covers the candspace-only
risks: the native pack kernel vs its numpy twin, the Lc/CSLOT ladder
fallbacks into the window-space path, dense-CpG (high-Lc) inputs, and the
MDTPU_CANDSPACE=0 off switch."""
import copy

import numpy as np
import pytest

from methyldackel_tpu.config import Config
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.utils.simulate import random_reference
from methyldackel_tpu.engine.extract import compute_window_counters_host
from methyldackel_tpu.parallel import device as dev
from methyldackel_tpu.parallel.device import dispatch_window_group
from methyldackel_tpu.io import native

from test_fused_v3 import _mix_batch
from test_group_dispatch import (_window_items, _host_per_window,
                                 _emit_read_positions, W, GLEN)


def _assert_group_matches_host(cfg, items, handles):
    host = _host_per_window(cfg, items)
    for k, h in enumerate(handles):
        got = h.get()
        cand = _emit_read_positions(cfg, items[k])
        np.testing.assert_array_equal(got[cand, :2], host[k][cand, :2],
                                      err_msg=f"window {k}")


def test_native_pack_matches_numpy_twin():
    """mdtpu_v3_pack2_cand vs the in-dispatch numpy fallback, including
    negative f_pos (window-straddling reads) and reads past the window
    end."""
    if native._load() is None or not getattr(native._load(), "_has_v3c",
                                             False):
        pytest.skip("native library not built")
    rng = np.random.default_rng(7)
    n, L, wpad = 300, 100, 5632
    seq = rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=(n, L))
    qual = rng.integers(0, 42, size=(n, L)).astype(np.uint8)
    pos = rng.integers(-L + 5, wpad - 5, size=n).astype(np.int64)
    strand = rng.integers(1, 5, size=n).astype(np.int32)
    mask = rng.random(wpad) < 0.2
    cand = np.nonzero(mask)[0].astype(np.int64)
    csum = np.zeros(wpad + 1, np.int32)
    np.cumsum(mask, dtype=np.int32, out=csum[1:])
    min_phred = 5
    Lq = 16  # 64 candidate slots per row; max cnt here ~ 0.2*100+eps
    slot0 = 1024
    src = np.argsort(pos, kind="stable").astype(np.int64)

    out_n = (np.zeros((n, Lq), np.uint8), np.zeros(n, np.int32),
             np.zeros(n, np.uint8))
    ok = native.v3_pack2_cand(seq, qual, src, pos, strand, Lq, 0,
                              min_phred, cand, csum, wpad, slot0, out_n)
    assert ok

    # numpy twin (the in-dispatch fallback logic)
    f_pos = pos[src]
    fp0 = np.clip(f_pos, 0, wpad)
    fp1 = np.clip(f_pos + L, 0, wpad)
    s0 = csum[fp0].astype(np.int64)
    cnt = csum[fp1].astype(np.int64) - s0
    assert int(cnt.max()) <= 4 * Lq
    par = (strand[src] & 1).astype(np.uint8)
    mc = np.where(par == 1, 2, 4).astype(np.uint8)[:, None]
    uc = np.where(par == 1, 8, 1).astype(np.uint8)[:, None]
    gq = np.where(qual[src] >= min_phred, seq[src], 0).astype(np.uint8)
    v = np.where(gq == mc, 1, np.where(gq == uc, 2, 0)).astype(np.uint8)
    L4 = 4 * Lq
    j = np.arange(L4, dtype=np.int64)[None, :]
    slotpos = s0[:, None] + j
    valid = j < cnt[:, None]
    coff = np.clip(cand[np.minimum(slotpos, len(cand) - 1)]
                   - f_pos[:, None], 0, L - 1)
    vv = np.where(valid, v[np.arange(n)[:, None], coff], 0).astype(np.uint8)
    packed = (vv[:, 0::4] | (vv[:, 1::4] << 2) | (vv[:, 2::4] << 4)
              | (vv[:, 3::4] << 6))
    np.testing.assert_array_equal(out_n[0], packed)
    np.testing.assert_array_equal(out_n[1], (s0 + slot0).astype(np.int32))
    np.testing.assert_array_equal(out_n[2], par)


def test_dense_cpg_island_high_lc(monkeypatch):
    """A CpG-saturated reference (CGCGCG...) pushes every read to ~L/2
    candidate slots — the top usable Lc buckets — and must still match
    the host oracle exactly (via candspace or its fallback)."""
    rng = np.random.default_rng(11)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    # overwrite a stretch with CG repeats (island)
    isl = np.tile(np.array([ord("C"), ord("G")], np.uint8), 1200)
    ref_ascii = np.asarray(ref_ascii, np.uint8).copy()
    ref_ascii[100:100 + len(isl)] = isl
    ref_codes = np.asarray(ref_codes).copy()
    code = {ord("C"): 1, ord("G"): 2}  # simulate's 0-3 base indices
    ref_codes[100:100 + len(isl)] = [code[b] for b in isl]
    batch = _mix_batch(rng, ref_codes, n_fast=120, n_slow=10)
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W], ref_ascii)
    handles = dispatch_window_group(cfg, items, pad_to=2)
    assert handles is not None
    _assert_group_matches_host(cfg, items, handles)


def test_lc_overflow_falls_back_to_window_space(monkeypatch):
    """With every C/G a candidate (cytosine_report ctx=7) over a CG-repeat
    reference, a 150 bp read covers ~150 candidates > the 128-slot Lc
    cap: the candspace attempt must decline and the window-space group
    must still produce exact counters."""
    rng = np.random.default_rng(13)
    glen = 2 * W + 600
    isl = np.tile(np.array([ord("C"), ord("G")], np.uint8), glen // 2)
    ref_ascii = isl[:glen]
    code = np.zeros(256, np.uint8)
    code[ord("C")], code[ord("G")] = 1, 2  # simulate's 0-3 base indices
    ref_codes = code[ref_ascii]
    from methyldackel_tpu.utils.simulate import simulate_batch_fast

    batch = simulate_batch_fast(rng, ref_codes, 60, 150)
    cfg = Config()
    cfg.chunkSize = W
    cfg.cytosine_report = True  # ctx=7: every C/G is a candidate
    items = _window_items(batch, [0, W], ref_ascii)
    # candspace must decline (Lc > 128) without mutating the windows...
    wins_probe = []
    for it in items:
        (b, st, keep, ref_win, lpos2, s, e, _rs) = it
        kidx = np.nonzero(keep)[0]
        seq, qual, refpos, pos, _lq, stp, xla_rows = dev._prep_v3_rows(
            cfg, b, st, keep, kidx)
        wins_probe.append({"empty": False, "W": e - s, "seq": seq,
                          "qual": qual, "refpos": refpos, "pos": pos,
                          "st": stp, "xla_rows": xla_rows,
                          "ref_window": ref_win, "win_start": s,
                          "woff_rel": lpos2 - s})
    fin = dev._fused_dispatch_v3_multi_cand(cfg, wins_probe, W)
    assert fin is None
    assert wins_probe[0]["seq"] is not None  # not cleared on decline
    # ...and the full group entry point still matches the host oracle
    handles = dispatch_window_group(cfg, items, pad_to=2)
    assert handles is not None
    host = _host_per_window(cfg, items)
    for k, h in enumerate(handles):
        got = h.get()
        ref_np = np.asarray(items[k][3], np.uint8)
        s, lpos2 = items[k][5], items[k][4]
        w = items[k][6] - s
        idx = np.arange(w) + (s - lpos2)
        idx = idx[idx < len(ref_np)]
        cand = np.nonzero(np.isin(ref_np[idx], [ord("C"), ord("G")]))[0]
        np.testing.assert_array_equal(got[cand, :2], host[k][cand, :2])


def test_candspace_off_switch_matches(monkeypatch):
    """MDTPU_CANDSPACE=0 restores the window-space group; outputs at the
    emit-read positions are identical either way."""
    rng = np.random.default_rng(17)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=140, n_slow=20)
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W, 2 * W], ref_ascii)

    hs_on = dispatch_window_group(cfg, items, pad_to=4)
    on = [h.get() for h in hs_on]
    monkeypatch.setenv("MDTPU_CANDSPACE", "0")
    items2 = _window_items(batch, [0, W, 2 * W], ref_ascii)
    hs_off = dispatch_window_group(cfg, items2, pad_to=4)
    off = [h.get() for h in hs_off]
    for k in range(3):
        cand = _emit_read_positions(cfg, items2[k])
        np.testing.assert_array_equal(on[k][cand, :2], off[k][cand, :2])


def test_native_candidates_matches_ctx_mask_np():
    """mdtpu_v3_candidates must be bit-for-bit _ctx_mask_np (single-window
    period == data case) for every ctx value over adversarial bitmaps."""
    lib = native._load()
    if lib is None or not getattr(lib, "_has_v3c", False):
        pytest.skip("native library not built")
    rng = np.random.default_rng(23)
    wpad = 5632
    for density in (0.0, 0.05, 0.5, 1.0):
        cb = rng.random(wpad) < density
        gb = (rng.random(wpad) < density) & ~cb
        isc = np.packbits(cb)
        isg = np.packbits(gb)
        for ctx in range(8):
            got = native.v3_candidates(isc, isg, wpad, ctx)
            assert got is not None
            cand_n, csum_n = got
            mask = dev._ctx_mask_np(cb, gb, ctx, wpad)
            cand_p = np.nonzero(mask)[0]
            np.testing.assert_array_equal(
                cand_n, cand_p, err_msg=f"ctx={ctx} density={density}")
            csum_p = np.zeros(wpad + 1, np.int32)
            np.cumsum(mask, dtype=np.int32, out=csum_p[1:])
            np.testing.assert_array_equal(csum_n, csum_p)
