"""K-window batched dispatch (dispatch_window_group): the group program
concatenates K windows into guard-separated slots of one coordinate space
and must reproduce the host oracle per window exactly — including
window-straddling reads (counted once per window, as the per-window
scheduler does), indel/'='-code hard rows (folded in via the host oracle
at finalize), empty windows, and partial tail groups (padded with empty
slots so the compiled shape is reused)."""
import copy

import numpy as np
import pytest

from methyldackel_tpu.config import Config
from methyldackel_tpu.io.bam import ReadBatch
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.utils.simulate import random_reference
from methyldackel_tpu.engine.extract import compute_window_counters_host
from methyldackel_tpu.parallel.device import dispatch_window_group

from test_fused_v3 import _mix_batch

W = 5632
GLEN = 3 * W + 600


def _window_items(batch, starts, ref_ascii, width=W):
    """Mimic the engine's per-window batch materialization."""
    items = []
    for s in starts:
        e = s + width
        idx = np.nonzero((batch.pos < e) & (batch.endpos > s))[0]
        idx = idx[np.argsort(batch.pos[idx], kind="stable")]
        fields = {}
        for f in ("flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
                  "mpos", "xg", "nh", "seq", "qual", "refpos"):
            fields[f] = getattr(batch, f)[idx].copy()
        fields["qname"] = [batch.qname[i] for i in idx]
        b = ReadBatch(**fields)
        st = sem.strand(b.flag, b.xg)
        lpos2 = s - 2 if s > 1 else 0
        ref_win = ref_ascii[lpos2 : e + 10]
        items.append((b, st, np.ones(b.n, bool), ref_win, lpos2, s, e, None))
    return items


def _host_per_window(cfg, items):
    outs = []
    for (b, st, keep, ref_win, lpos2, s, e, _rs) in items:
        outs.append(compute_window_counters_host(
            cfg, copy.deepcopy(b), st, keep, ref_win, lpos2, s, e))
    return outs


def _emit_read_positions(cfg, item):
    """The positions emit_window reads for this window/config: window
    coords whose reference context is CTX-enabled (exactly emit's
    ctx_kept gate). The compacted readback contract guarantees exact
    counters at these positions (round 5: the shipped set shrank from
    all ref-C/G to the CTX-enabled subset plus boundary guards)."""
    (_b, _st, _keep, ref_win, lpos2, s, e, _rs) = item
    ct, _cd = sem.classify_context(np.asarray(ref_win, np.uint8))
    w = e - s
    idx = np.arange(w) + (s - lpos2)
    idx = idx[idx < len(ct)]
    keep_vec = np.array([cfg.keepCpG, cfg.keepCHG, cfg.keepCHH, 0],
                        dtype=bool)
    return np.nonzero(keep_vec[ct[idx]])[0]


def test_group_matches_host_oracle(monkeypatch):
    rng = np.random.default_rng(41)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=160, n_slow=30)
    batch.seq[5, 8:12] = 0  # '=' codes -> hard path rows
    cfg = Config()
    cfg.chunkSize = W

    items = _window_items(batch, [0, W, 2 * W], ref_ascii)
    handles = dispatch_window_group(cfg, items, pad_to=4)
    assert handles is not None and len(handles) == 3
    host = _host_per_window(cfg, items)
    for k, h in enumerate(handles):
        got = h.get()
        cand = _emit_read_positions(cfg, items[k])
        assert len(cand) > 50  # the scenario must actually cover CpGs
        np.testing.assert_array_equal(got[cand, :2], host[k][cand, :2],
                                      err_msg=f"window {k}")
        assert not got[:, 2:].any()  # NCH=2 readback contract
        # non-candidate coords are never read by emit; the compacted
        # readback leaves them zero
        other = np.setdiff1d(np.arange(got.shape[0]), cand)
        ref_np = np.asarray(items[k][3], np.uint8)
        s, lpos2 = items[k][5], items[k][4]
        ridx = other + (s - lpos2)
        in_ref = ridx < len(ref_np)
        non_cg = other[in_ref] [~np.isin(
            ref_np[ridx[in_ref]], [ord("C"), ord("G")])]
        assert not got[non_cg, :2].any()


def test_group_empty_and_single_windows(monkeypatch):
    rng = np.random.default_rng(43)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=60, n_slow=0)
    # confine reads to the first window: windows 2/3 are empty
    keepers = batch.pos < W - 200
    fields = {f: getattr(batch, f)[keepers].copy() for f in (
        "flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid", "mpos",
        "xg", "nh", "seq", "qual", "refpos")}
    fields["qname"] = [q for q, k in zip(batch.qname, keepers) if k]
    batch = ReadBatch(**fields)
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W, 2 * W], ref_ascii)
    assert items[1][0].n == 0 and items[2][0].n == 0
    handles = dispatch_window_group(cfg, items, pad_to=4)
    assert handles is not None
    host = _host_per_window(cfg, items)
    for k, h in enumerate(handles):
        cand = _emit_read_positions(cfg, items[k])
        np.testing.assert_array_equal(h.get()[cand, :2],
                                      host[k][cand, :2])


def test_group_preconditions_fall_back(monkeypatch):
    rng = np.random.default_rng(47)
    ref_ascii, ref_codes = random_reference(rng, GLEN)
    batch = _mix_batch(rng, ref_codes, n_fast=20, n_slow=0)
    cfg = Config()
    cfg.chunkSize = W
    items = _window_items(batch, [0, W], ref_ascii)
    cfg.minOppositeDepth = 3  # NCH=4: group path must decline
    assert dispatch_window_group(cfg, items) is None
    cfg.minOppositeDepth = 0
    rs = np.zeros(W, np.int8)
    items_rs = [it[:7] + (rs,) for it in items]
    assert dispatch_window_group(cfg, items_rs) is None
