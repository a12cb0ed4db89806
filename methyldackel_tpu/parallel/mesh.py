"""Multi-device execution: jax.sharding Mesh over (dp, sp).

The reference's only parallelism is pthreads over a mutex-guarded genome
cursor with ticket-ordered output (main.c:7-15, extract.c:326-350,
:514-535). The multi-device replacement is a 2-D mesh. It follows the
algorithm, not the interconnect: every device reaches every other at the
same rate.

- dp ("data parallel"): read batches are sharded across devices; each
  device scatter-adds its shard's contributions and the partial counters
  are merged with a psum — the psum IS the communication backend,
  replacing the ordered-output mutex. Mate pairs are co-sharded via the
  adjacent-mate layout (mates occupy rows 2i and 2i+1), the analogue of
  the chunk-local overlap hash (overlaps.c:12-14).
- sp ("sequence/position parallel"): the genome-coordinate axis of the
  counter tensor is sharded, so each device owns a position slice and only
  its slice's counters are materialized — the analogue of the reference's
  1 Mb genome chunks, but across devices instead of threads.

Determinism comes from the fixed reduction structure of the sharded
program, not from output tickets: integer counters make every schedule
bit-identical.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from . import device as dev
from ..ops import semantics as sem


def make_mesh(n_devices: int | None = None, sp: int | None = None):
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    devices = devices[:n]
    # Prefer a 2-D (dp, sp) layout when the device count allows it, so both
    # parallel axes are exercised; fall back to pure data parallelism.
    # An explicit `sp` overrides (the dryrun's sp-invariance sweep).
    if sp is None:
        sp = 1
        for cand in (4, 2):
            if n % cand == 0 and n // cand >= 2:
                sp = cand
                break
    assert n % sp == 0, (n, sp)
    dp = n // sp
    return Mesh(np.array(devices).reshape(dp, sp), ("dp", "sp"))


def sharded_window_pipeline(mesh: Mesh, *, wpad: int, ovw: int, min_phred: int,
                            min_conv_eff: float, use_overlaps: bool):
    """Build the jitted multi-device window step.

    Read tensors are sharded over dp with the adjacent-mate layout (mates at
    rows 2i/2i+1, so every pair is shard-local); the reference window is
    replicated; output counters are sharded over sp. Requires
    N % (2*dp) == 0 and wpad % sp == 0.
    """
    sp_size = mesh.shape["sp"]
    wshard = wpad // sp_size

    def local_step(seq, qual, refpos, flag, xg, l_qseq, keep_read, ref,
                   bounds, absolute_bounds, win_offset, win_start):
        strand = dev.strand_device(flag, xg)
        if min_conv_eff > 0.0:
            ctype = dev.classify_context_device(ref)
            eff = dev.conv_eff_device(seq, qual, refpos, strand, ctype,
                                      win_offset, ref.shape[0], min_phred)
            keep_read = keep_read & (eff >= jnp.float32(min_conv_eff))
        seq, qual = dev.trim_device(seq, qual, l_qseq, strand, flag, bounds,
                                    absolute_bounds)
        if use_overlaps:
            rows = seq.shape[0]
            pair_a = jnp.arange(0, rows, 2, dtype=jnp.int32)
            pair_b = pair_a + 1
            pair_valid = (
                ((flag[pair_a] & 0x1) != 0) & ((flag[pair_a] & 12) == 0)
                & ((flag[pair_b] & 0x1) != 0) & ((flag[pair_b] & 12) == 0)
            )
            qual = dev.arbitrate_device(seq, qual, refpos, strand, pair_a,
                                        pair_b, pair_valid, ovw)
        # Each device owns one sp slice of the window; contributions outside
        # the slice are masked by the pileup's window bounds.
        sp_idx = jax.lax.axis_index("sp")
        slice_start = win_start + sp_idx * wshard
        keep_base = jnp.ones(seq.shape, dtype=bool)
        local = dev.pileup_device(seq, qual, refpos, strand, keep_read,
                                  keep_base, ref, win_offset, slice_start,
                                  wshard, min_phred)
        # Merge the read shards' partial counters.
        return jax.lax.psum(local, "dp")

    spec_reads = P("dp", None)
    spec_read1 = P("dp")
    spec_rep = P()
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec_reads, spec_reads, spec_reads, spec_read1, spec_read1,
                  spec_read1, spec_read1, spec_rep, spec_rep, spec_rep,
                  spec_rep, spec_rep),
        out_specs=P("sp", None),
        check_vma=False,
    )
    return jax.jit(fn)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def make_mesh_backend(cfg, n_devices=None, sp=None):
    """Production extract compute backend over the (dp, sp) mesh —
    the multi-device replacement for the reference's `-@ N` pthread pool
    (extract.c:1479-1484) selected with MDTPU_ENGINE=mesh.

    Signature-compatible with engine.extract.compute_window_counters_host.
    The host has already run the read filter, conversion-efficiency gate and
    trimming (engine.extract.prepare_window_reads); this backend does the
    rest of the hot path sharded:

    - reads are packed into the adjacent-mate layout from the exact qname
      pairing (sem.pair_mates_batch) — pairs at rows (2i, 2i+1), singles
      after — and sharded over dp, so every pair is shard-local (the
      analogue of the chunk-local overlap khash, overlaps.c:12-14);
    - per-base BED strand masks (keep_base) ride with the rows;
    - each dp shard arbitrates its pairs and scatter-adds its 4-channel
      counters; dp partials merge with a psum, and the window
      coordinate axis is sharded over sp (each device materializes only
      its counter slice).

    Shapes are bucketed (rows/read-length to powers of two, window to the
    chunkSize-derived fixed size) so every window reuses one compiled
    program. Output is bit-identical to the host path (uint32 counters;
    fixed reduction structure), enforced by tests/test_mesh_engine.py and
    __graft_entry__.dryrun_multichip."""
    n_avail = (n_devices if n_devices is not None
               else len(jax.devices()))
    if n_avail == 1 and os.environ.get("MDTPU_MESH_FORCE") != "1":
        # A (1,1) mesh is a degenerate sharding: every psum is an identity
        # and the dense sharded program only adds work over the single-
        # device fast path. Delegate to the single-device engine; the
        # sharded path stays selected on real multi-device meshes and is
        # validated on the virtual CPU mesh (tests/test_mesh_engine.py,
        # dryrun). MDTPU_MESH_FORCE=1 keeps the shard_map path.
        from .device import make_device_backend

        return make_device_backend(cfg)
    mesh = make_mesh(n_devices, sp=sp)
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    min_phred = int(cfg.minPhred)
    cache: dict = {}

    def build(n_pad, L_pad, wpad):
        key = (n_pad, L_pad, wpad)
        fn = cache.get(key)
        if fn is not None:
            return fn
        wshard = wpad // sp
        ovw = _round_up(2 * L_pad, 128)

        def local_step(seq, qual, refpos, strand, keep_read, keep_base,
                       pair_valid, ref, win_offset, win_start):
            rows = seq.shape[0]
            pair_a = jnp.arange(0, rows, 2, dtype=jnp.int32)
            pair_b = pair_a + 1
            qual = dev.arbitrate_device(seq, qual, refpos, strand, pair_a,
                                        pair_b, pair_valid, ovw)
            sp_idx = jax.lax.axis_index("sp")
            slice_start = win_start + sp_idx * wshard
            local = dev.pileup_device(seq, qual, refpos, strand, keep_read,
                                      keep_base, ref, win_offset, slice_start,
                                      wshard, min_phred)
            return jax.lax.psum(local, "dp")

        fn = jax.jit(jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P("dp", None), P("dp", None), P("dp", None), P("dp"),
                      P("dp"), P("dp", None), P("dp"), P(), P(), P()),
            out_specs=P("sp", None),
            check_vma=False,
        ))
        cache[key] = fn
        return fn

    def compute(cfg, batch, strand_arr, keep, ref_window, win_offset,
                win_start, win_end, rstrand=None):
        W = win_end - win_start
        kidx = np.nonzero(keep)[0]
        if len(kidx) == 0:
            return np.zeros((W, 4), dtype=np.uint32)
        seq = batch.seq[kidx]
        qual = batch.qual[kidx]
        refpos = batch.refpos[kidx].astype(np.int32)
        st = strand_arr[kidx].astype(np.int32)
        n = len(kidx)
        L = seq.shape[1]

        # Adjacent-mate packing from the exact khash pairing
        a_idx, b_idx = sem.pair_mates_batch(batch, kidx)
        P_pairs = len(a_idx)
        paired = np.zeros(n, dtype=bool)
        paired[a_idx] = True
        paired[b_idx] = True
        perm = np.empty(n, dtype=np.int64)
        perm[0 : 2 * P_pairs : 2] = a_idx
        perm[1 : 2 * P_pairs : 2] = b_idx
        perm[2 * P_pairs :] = np.nonzero(~paired)[0]

        if rstrand is not None:
            # BED strand column (readStrandOverlapsBED, bed.c:56-64) — same
            # formula as the host path.
            safe = np.clip(batch.refpos[kidx] - win_start, 0, W - 1)
            rs = rstrand[safe]
            odd = (strand_arr[kidx].astype(np.int64) & 1)[:, None] == 1
            keep_base = (rs == 0) | ((rs == 1) & odd) | ((rs == 2) & ~odd)
        else:
            keep_base = np.ones(seq.shape, dtype=bool)

        # Shape buckets (powers of two; rows also rounded to divide 2*dp)
        L_pad = 32
        while L_pad < L:
            L_pad *= 2
        n_bucket = 2 * dp
        while n_bucket < n:
            n_bucket *= 2
        n_pad = _round_up(n_bucket, 2 * dp)
        wpad = _round_up(max(int(cfg.chunkSize) + 16, W), 512)
        assert wpad % sp == 0, (wpad, sp)

        def pad_rows(x, fill=0):
            out = np.full((n_pad, L_pad) if x.ndim == 2 else (n_pad,), fill,
                          dtype=x.dtype)
            if x.ndim == 2:
                out[:n, :L] = x[perm]
            else:
                out[:n] = x[perm]
            return out

        seq_p = pad_rows(seq)
        qual_p = pad_rows(qual)
        refpos_p = pad_rows(refpos, -2)
        st_p = pad_rows(st, 1)
        keep_read = np.zeros(n_pad, dtype=bool)
        keep_read[:n] = True
        kb_p = pad_rows(keep_base, False)
        pair_valid = np.zeros(n_pad // 2, dtype=bool)
        pair_valid[:P_pairs] = True

        ref_static = wpad + 640
        ref_p = np.zeros(ref_static, np.uint8)
        m = min(len(ref_window), ref_static)
        ref_p[:m] = np.asarray(ref_window[:m], np.uint8)

        fn = build(n_pad, L_pad, wpad)
        out = fn(jnp.asarray(seq_p), jnp.asarray(qual_p),
                 jnp.asarray(refpos_p), jnp.asarray(st_p),
                 jnp.asarray(keep_read), jnp.asarray(kb_p),
                 jnp.asarray(pair_valid), jnp.asarray(ref_p),
                 jnp.int32(win_offset), jnp.int32(win_start))
        return np.asarray(jax.device_get(out))[:W]

    return compute


def run_sharded_window(mesh, batch, ref, win_offset, win_start, wpad,
                       min_phred=5, min_conv_eff=0.0, use_overlaps=True,
                       bounds=None, absolute_bounds=None):
    """Pad/shard a ReadBatch-style struct (adjacent-mate layout) and execute
    one multi-device window step. Returns uint32 [wpad, 4]."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert wpad % sp == 0, "window must divide over the sp axis"
    n = batch.seq.shape[0]
    L = batch.seq.shape[1]
    unit = 2 * dp
    n_pad = ((n + unit - 1) // unit) * unit

    def pad(x, fill=0):
        out = np.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    ovw = ((2 * L + 127) // 128) * 128
    fn = sharded_window_pipeline(mesh, wpad=wpad, ovw=ovw, min_phred=min_phred,
                                 min_conv_eff=min_conv_eff,
                                 use_overlaps=use_overlaps)
    keep = np.ones(n, dtype=bool)
    out = fn(
        pad(batch.seq), pad(batch.qual),
        pad(batch.refpos.astype(np.int32), -2),
        pad(batch.flag.astype(np.uint16)), pad(batch.xg),
        pad(batch.l_qseq), pad(keep),
        jnp.asarray(ref),
        jnp.asarray(np.zeros(16, np.int32) if bounds is None else np.asarray(bounds, np.int32)),
        jnp.asarray(np.zeros(16, np.int32) if absolute_bounds is None
                    else np.asarray(absolute_bounds, np.int32)),
        jnp.int32(win_offset), jnp.int32(win_start),
    )
    return np.asarray(jax.device_get(out))
