#!/usr/bin/env python
"""Benchmark: extract hot-path throughput on one GPU.

Measures the device hot path of `extract` on simulated WGBS reads (the
workload of the reference's extractCalls loop, extract.c:399-441) and the
real CLI end to end. Modes (MDTPU_BENCH_MODE):
- e2e (default): the production window step — host prep (arbitration,
  pre-gate, packing), upload, the K-window group program, readback;
- xla: the dense pipeline (parallel/device.py window_pipeline);
- trace: a jax.profiler trace of the steady K-window group program,
  reduced to device busy time and the time of each device operation
  (the pileup scatter-add among them).

The reference publishes no numbers (BASELINE.md), so vs_baseline is the
speedup over this repo's exact host engine on the same machine. Every
result names the device it ran on; the benchmark refuses to run without
a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def host_baseline(batch, ref_ascii, W, reps=3):
    """The PRODUCTION host window step — compute_window_counters_host with
    the native csrc kernels over the full window — i.e. exactly what
    `MDTPU_ENGINE=host` runs per window and what engine `auto` chooses
    against (the honest vs_baseline denominator)."""
    import copy as _copy

    from methyldackel_tpu.config import Config
    from methyldackel_tpu.engine.extract import compute_window_counters_host
    from methyldackel_tpu.ops import semantics as sem

    cfg = Config()
    cfg.chunkSize = W
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, dtype=bool)
    best = 1e18
    for _ in range(reps):
        b = _copy.deepcopy(batch)  # the window step mutates qual
        t0 = time.perf_counter()
        compute_window_counters_host(cfg, b, st, keep, ref_ascii, 0, 0, W)
        best = min(best, time.perf_counter() - t0)
    return batch.n / best


def oracle_baseline(batch, ref_ascii, W, n_sub=20_000):
    """Secondary reference point: the pure-numpy oracle on a subsample (the
    round-1..3 denominator, kept for cross-round comparability)."""
    from methyldackel_tpu.ops import semantics as sem

    m = min(batch.n, n_sub)
    sub_seq = batch.seq[:m].copy()
    sub_qual = batch.qual[:m].copy()
    sub_rp = batch.refpos[:m]
    st = sem.strand(batch.flag[:m], batch.xg[:m])
    t0 = time.perf_counter()
    a_idx = np.arange(0, m, 2)
    b_idx = a_idx + 1
    sem.arbitrate_overlaps(sub_seq, sub_qual, sub_rp, st, a_idx, b_idx)
    sem.pileup_channels(sub_seq, sub_qual, sub_rp, st,
                        np.ones(sub_seq.shape, bool), ref_ascii, 0, 0, W, 5)
    dt = time.perf_counter() - t0
    return m / dt


def bench_xla(batch, ref_ascii, W, iters):
    import jax
    import jax.numpy as jnp
    from methyldackel_tpu.parallel.device import window_pipeline

    n = batch.n
    L = batch.seq.shape[1]
    ovw = ((2 * L + 127) // 128) * 128
    pair_a = np.arange(0, n, 2, dtype=np.int32)
    zeros16 = np.zeros(16, np.int32)
    args = [
        jnp.asarray(batch.seq), jnp.asarray(batch.qual),
        jnp.asarray(batch.refpos.astype(np.int32)),
        jnp.asarray(batch.flag.astype(np.uint16)), jnp.asarray(batch.xg),
        jnp.asarray(batch.l_qseq), jnp.asarray(batch.mapq),
        jnp.ones(n, bool), jnp.ones((n, L), bool),
        jnp.asarray(pair_a), jnp.asarray(pair_a + 1),
        jnp.ones(len(pair_a), bool),
        jnp.asarray(ref_ascii), jnp.asarray(zeros16), jnp.asarray(zeros16),
        jnp.int32(0), jnp.int32(0),
    ]

    def run():
        return window_pipeline(*args, wpad=W, ovw=ovw, min_phred=5,
                               min_conv_eff=0.0, use_overlaps=True)

    run().block_until_ready()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = run()
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def blobify_qnames(b):
    """Back the simulated batch's read names with the decoder's blob
    layout (QnameView + vectorized hashes). The CLI's BAM decoder always
    produces blob-backed names, so mate pairing runs the native
    open-addressing kernel; a plain list of Python strings instead routes
    pair_mates through string materialization (~50 ms per 100k-read
    window, paid identically by BOTH engines here) — a cost the product
    never pays. Blobifying keeps the step bench faithful to the
    production hot path."""
    from methyldackel_tpu.io.bam import QnameView, QnameSubset

    names = list(b.qname)
    blob = b"".join(q.encode() + b"\0" for q in names)
    off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(q) + 1 for q in names], out=off[1:])
    view = QnameView(blob, off)
    b.qname = QnameSubset(view, np.arange(len(names), dtype=np.int64))
    b.qname_hash = view.hashes()
    return b


def bench_e2e_fused(batch, ref_ascii, W, iters, batches=None, group_k=None):
    """The production window step in its production shape: everything the
    CLI pays per 1 Mb window — host prep (arbitration, phred pre-gate,
    nibble pack, sorting, group tables), the consolidated upload, the fused
    pre-gated device program, and the dense readback — measured as the
    PIPELINED steady state (MDTPU_PIPELINE windows in flight, exactly like
    run_extract at -@ 1). Distinct batches rotate per iteration."""
    import jax
    from collections import deque
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel import device as dev
    from methyldackel_tpu.config import Config

    cfg = Config()
    cfg.chunkSize = W
    keep = np.ones(batch.n, dtype=bool)
    pool = [batch] + list(batches or [])
    sts = [sem.strand(b.flag, b.xg) for b in pool]
    st = sts[0]
    # Production shape: K windows batched per dispatch (dispatch_group —
    # one program + one readback per K windows). MDTPU_BATCH_WINDOWS=1
    # restores the per-window dispatch for comparison/sweeps.
    if group_k is None:
        group_k = max(1, int(os.environ.get("MDTPU_BATCH_WINDOWS", "4")))
    # keep several dispatch units in flight
    depth = max(int(os.environ.get("MDTPU_PIPELINE", "3")), 2 * group_k, 6)

    def dispatch(i):
        b = pool[i % len(pool)]
        h = dev.dispatch_window_counters_fast(cfg, b, sts[i % len(pool)],
                                              keep, ref_ascii, 0, 0, W)
        assert h is not None
        return h

    def dispatch_group(i):
        items = []
        for k in range(group_k):
            j = (i * group_k + k) % len(pool)
            items.append((pool[j], sts[j], keep, ref_ascii, 0, 0, W, None))
        hs = dev.dispatch_window_group(cfg, items, pad_to=group_k)
        assert hs is not None and len(hs) == group_k
        return hs

    # group_k == 1 still rides the group program (1-window group) unless
    # MDTPU_BENCH_SINGLES=1: the production scheduler routes EVERY flush
    # through the padded group program (candidate-space since round 5),
    # so the bare-step number should measure that path.
    use_group = (group_k > 1
                 or os.environ.get("MDTPU_BENCH_SINGLES", "0") != "1")
    for i in range(len(pool)):  # compile + warm every shape bucket once
        dispatch(i).get()
    if use_group:
        for h in dispatch_group(0):  # warm the grouped program
            h.get()
    # Same structure as run_extract at -@ 1: the main thread preps +
    # dispatches windows; ONE ordered drain thread performs the readbacks,
    # so each window's readback wall overlaps host prep of later windows.
    import queue as _queue
    import threading as _threading

    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    done = []

    def drain_loop():
        while True:
            h = q.get()
            if h is None:
                return
            done.append(h.get())

    t0 = time.perf_counter()
    th = _threading.Thread(target=drain_loop)
    th.start()
    if use_group:
        n_groups = (iters + group_k - 1) // group_k
        for i in range(n_groups):
            for h in dispatch_group(i):
                q.put(h)
        q.put(None)
        th.join()
        dt = (time.perf_counter() - t0) / (n_groups * group_k)
        assert len(done) == n_groups * group_k
    else:
        for i in range(iters):
            q.put(dispatch(i))
        q.put(None)
        th.join()
        dt = (time.perf_counter() - t0) / iters
        assert len(done) == iters

    out = dispatch(0).get()  # exactness check against the first batch
    hq = batch.qual.copy()
    a_idx = np.arange(0, batch.n, 2)
    sem.arbitrate_overlaps(batch.seq, hq, batch.refpos, st, a_idx, a_idx + 1)
    host = sem.pileup_channels(batch.seq, hq, batch.refpos, st,
                               np.ones(batch.seq.shape, bool), ref_ascii,
                               0, 0, W, 5)
    # The packed readback ships counters at the positions emit reads:
    # CTX-enabled context positions (default config = CpG only since
    # round 5; previously all ref-C/G). Channels 2-3 are read by the emit
    # path only under --minOppositeDepth, which flips the readback to
    # NCH=4.
    # Mask positions use the dispatch's own geometry (wpad, guards) so the
    # comparison set matches what the compacted readback actually ships.
    wpad = ((W + 16 + 511) // 512) * 512
    refp = np.zeros(wpad, np.uint8)
    n0 = min(len(ref_ascii), wpad)
    refp[:n0] = np.asarray(ref_ascii)[:n0]
    def cand_for(c):
        m = dev._ctx_mask_np(refp == ord("C"), refp == ord("G"),
                             dev._ctx_code(c), wpad)
        return np.nonzero(m[:W])[0]
    cand = cand_for(cfg)
    if not np.array_equal(np.asarray(out)[cand, :2], host[cand, :2]):
        raise AssertionError("fused e2e pipeline diverges from host semantics")
    cfg4 = Config()
    cfg4.chunkSize = W
    cfg4.minOppositeDepth = 3
    out4 = dev.compute_window_counters_fast(cfg4, batch, st, keep,
                                            ref_ascii, 0, 0, W)
    cand4 = cand_for(cfg4)
    if not np.array_equal(np.asarray(out4)[cand4], host[cand4]):
        raise AssertionError("fused e2e 4-channel path diverges from host semantics")
    return dt


_CLI_INPUT = {}


def make_cli_input(n_pairs, read_len, glen):
    """Build (once per shape) the synthetic coordinate-sorted BAM + FASTA
    the CLI benchmark runs over."""
    import tempfile

    from methyldackel_tpu.utils.simulate import write_synthetic_input
    from methyldackel_tpu.io.bam import BamFile
    from methyldackel_tpu.io.bai import build_bai

    key = (n_pairs, read_len, glen)
    if key not in _CLI_INPUT:
        d = tempfile.mkdtemp(prefix="mdtpu_bench_")
        fa, bam = write_synthetic_input(d, n_pairs, read_len, glen, seed=0)
        build_bai(BamFile(bam), bam + ".bai")  # steady state: index present
        _CLI_INPUT[key] = (d, fa, bam)
    return _CLI_INPUT[key]


def run_cli(fa, bam, engine, threads=1):
    """One timed extract CLI run (in-process), ingest → bytes-out."""
    import tempfile

    from methyldackel_tpu import cli as mdcli

    outdir = tempfile.mkdtemp(prefix="mdtpu_bench_out_")
    old = os.environ.get("MDTPU_ENGINE")
    os.environ["MDTPU_ENGINE"] = engine
    targs = ["-@", str(threads)] if threads > 1 else []
    try:
        t0 = time.perf_counter()
        rc = mdcli.main(["extract", *targs, fa, bam,
                         "-o", os.path.join(outdir, "out")])
        dt = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("MDTPU_ENGINE", None)
        else:
            os.environ["MDTPU_ENGINE"] = old
    assert rc == 0
    out = os.path.join(outdir, "out_CpG.bedGraph")
    assert os.path.getsize(out) > 0
    import shutil

    shutil.rmtree(outdir, ignore_errors=True)
    return dt


def run_sub(cmd, fa, bam, engine):
    """One timed mbias/perRead CLI run (in-process), ingest → bytes-out."""
    import contextlib
    import tempfile

    from methyldackel_tpu import cli as mdcli

    outdir = tempfile.mkdtemp(prefix="mdtpu_bench_sub_")
    old = os.environ.get("MDTPU_ENGINE")
    os.environ["MDTPU_ENGINE"] = engine
    try:
        t0 = time.perf_counter()
        if cmd == "mbias":
            out = os.path.join(outdir, "mb.txt")
            with open(out, "w") as fh, contextlib.redirect_stdout(fh):
                rc = mdcli.main(["mbias", "--txt", fa, bam,
                                 os.path.join(outdir, "mb")])
        else:
            out = os.path.join(outdir, "pr.tsv")
            rc = mdcli.main(["perRead", fa, bam, "-o", out])
        dt = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("MDTPU_ENGINE", None)
        else:
            os.environ["MDTPU_ENGINE"] = old
    assert rc == 0
    assert os.path.getsize(out) > 0
    import shutil

    shutil.rmtree(outdir, ignore_errors=True)
    return dt


def bench_subcommands(n_pairs, read_len, reps):
    """Interleaved device-vs-host medians for mbias and perRead."""
    _d, fa, bam = make_cli_input(n_pairs, read_len, 1 << 22)
    n = 2 * n_pairs
    out = {}
    for cmd, key in (("mbias", "mbias"), ("perRead", "perread")):
        run_sub(cmd, fa, bam, "jax")  # warm device programs
        times = {"jax": [], "host": []}
        for rep in range(reps):
            pair = ("jax", "host") if rep % 2 == 0 else ("host", "jax")
            for eng in pair:
                times[eng].append(run_sub(cmd, fa, bam, eng))
        out[f"{key}_reads_per_s"] = round(n / float(np.median(times["jax"])), 1)
        out[f"{key}_host_reads_per_s"] = round(
            n / float(np.median(times["host"])), 1)
    return out


def bench_cli(n_pairs, read_len, glen, engine="jax", threads=1):
    """Full-product benchmark: the real `extract` CLI over a synthetic BAM.
    Returns (reads_per_s, n_reads). This is what a user actually gets."""
    _d, fa, bam = make_cli_input(n_pairs, read_len, glen)
    dt = run_cli(fa, bam, engine, threads)
    return 2 * n_pairs / dt, 2 * n_pairs


def reduce_trace(xplane_path, scatter_key="scatter"):
    """Device time from a jax.profiler trace: per GPU, the busy time (the
    union of kernel intervals on its stream lines), the window it spans,
    and the summed kernel time per name — the pileup scatter-add's kernels
    are those whose name contains `scatter_key`."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        spans, per_name, lines = [], {}, []
        for line in plane.lines:
            lines.append(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_name[ev.name] = per_name.get(ev.name, 0.0) + ev.duration_ns
        spans.sort()
        busy, cur_s, cur_e = 0.0, None, None
        for a, b in spans:
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        if cur_e is not None:
            busy += cur_e - cur_s
        scatter = sum(v for k, v in per_name.items() if scatter_key in k)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:20]
        out[plane.name] = {
            "lines": lines,
            "busy_ns": busy,
            "window_ns": (spans[-1][1] - spans[0][0]) if spans else 0.0,
            "kernel_ns": sum(per_name.values()),
            "scatter_ns": scatter,
            "scatter_share_of_busy": scatter / busy if busy else None,
            "top_kernels_ns": top,
        }
    return out


def bench_trace(batch, ref_ascii, W, group_k, n_groups, trace_dir):
    """Steady K-window group program under jax.profiler: warm once, then
    trace n_groups dispatch+readback rounds. Returns (wall seconds per
    group, reduce_trace(...))."""
    import glob
    import jax
    from methyldackel_tpu.config import Config
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel import device as dev

    cfg = Config()
    cfg.chunkSize = W
    st = sem.strand(batch.flag, batch.xg)
    keep = np.ones(batch.n, dtype=bool)
    items = [(batch, st, keep, ref_ascii, 0, 0, W, None)] * group_k

    def one_group():
        for h in dev.dispatch_window_group(cfg, items, pad_to=group_k):
            h.get()

    one_group()
    one_group()
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for _ in range(n_groups):
            one_group()
    dt = (time.perf_counter() - t0) / n_groups
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    return dt, reduce_trace(path)


def device_info():
    """(platform, device_kind, count) of the JAX devices; exits without a
    GPU — a CPU number is never reported as a device number."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is "
                         f"{devs[0].platform!r}")
    return devs[0].platform, devs[0].device_kind, len(devs)


def main():
    from methyldackel_tpu.utils.simulate import random_reference, simulate_batch_fast
    from methyldackel_tpu.parallel import enable_persistent_cache

    platform, kind, count = device_info()
    print(f"device: platform={platform} kind={kind} count={count}",
          file=sys.stderr)
    enable_persistent_cache()
    rng = np.random.default_rng(0)
    W = 1 << 20
    n_pairs = int(os.environ.get("MDTPU_BENCH_PAIRS", 50_000))
    L = int(os.environ.get("MDTPU_BENCH_READLEN", 150))
    iters = int(os.environ.get("MDTPU_BENCH_ITERS", 10))
    # Headline = the e2e window step (everything the CLI pays per window:
    # host prep + one transfer + the device program + packed readback).
    mode = os.environ.get("MDTPU_BENCH_MODE", "e2e")
    ref_ascii, ref_codes = random_reference(rng, W + 64)
    batch = blobify_qnames(simulate_batch_fast(rng, ref_codes, n_pairs, L))

    if mode == "xla":
        dt = bench_xla(batch, ref_ascii, W, iters)
        reads_per_s = batch.n / dt
        host_rps = host_baseline(batch, ref_ascii, W)
    elif mode == "trace":
        wk = int(os.environ.get("MDTPU_BENCH_WINDOW_K", "4"))
        trace_dir = os.environ.get("MDTPU_BENCH_TRACE_DIR",
                                   ".bench_trace")
        dt, planes = bench_trace(batch, ref_ascii, W, wk, iters, trace_dir)
        print(json.dumps({"metric": "extract_group_trace",
                          "seconds_per_group": dt, "group_k": wk,
                          "reads_per_window": batch.n, "planes": planes,
                          "device": {"platform": platform, "kind": kind,
                                     "count": count}}))
        return
    else:
        extra = [blobify_qnames(simulate_batch_fast(
            np.random.default_rng(s), ref_codes, n_pairs, L))
            for s in (1, 2, 3)]
        # INTERLEAVED device/host chunks with medians: a device measurement
        # and a host baseline taken minutes apart are not comparable
        # The step bench runs the device hot path in the CLI's production
        # dispatch shape: K windows (MDTPU_BATCH_WINDOWS default 4)
        # through the candidate-space group program.
        wk = int(os.environ.get("MDTPU_BENCH_WINDOW_K", "4"))
        dev_rates, host_rates = [], []
        for _chunk in range(4):
            dt = bench_e2e_fused(batch, ref_ascii, W, max(4, iters // 2),
                                 batches=extra, group_k=wk)
            dev_rates.append(batch.n / dt)
            host_rates.append(host_baseline(batch, ref_ascii, W, reps=1))
        reads_per_s = float(np.median(dev_rates))
        host_rps = float(np.median(host_rates))
    oracle_rps = oracle_baseline(batch, ref_ascii, W)

    result = {
        "metric": f"extract_{mode}_throughput",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        # vs_baseline denominator = the production host window step (native
        # kernels, full window) — what MDTPU_ENGINE=host actually runs.
        "vs_baseline": round(reads_per_s / host_rps, 3),
        "host_window_reads_per_s": round(host_rps, 1),
        "vs_numpy_oracle": round(reads_per_s / oracle_rps, 3),
        "device": {"platform": platform, "kind": kind, "count": count},
    }
    # Full-CLI number (ingest → bytes-out through the real product), unless
    # explicitly disabled. ~1M reads by default. Engines are INTERLEAVED
    # over several repetitions (medians reported). One untimed jax pass
    # first absorbs the one-time compiles (a production run amortizes
    # these over a whole genome).
    if os.environ.get("MDTPU_BENCH_CLI", "1") != "0":
        # 1M pairs (2M reads, ~9 windows): long enough that the pipeline's
        # steady state outweighs the first-group fill and last-group drain
        # (real WGBS inputs are 100M+ reads)
        cli_pairs = int(os.environ.get("MDTPU_BENCH_CLI_PAIRS", 1_000_000))
        reps = int(os.environ.get("MDTPU_BENCH_CLI_REPS", 5))
        _d, fa, bam = make_cli_input(cli_pairs, L, 1 << 23)
        dev_engine = os.environ.get("MDTPU_BENCH_CLI_ENGINE", "jax")
        engines = [dev_engine, "host"]
        # mesh single-device overhead is a first-class number
        if os.environ.get("MDTPU_BENCH_MESH", "1") != "0" \
                and "mesh" not in engines:
            engines.insert(1, "mesh")
        for eng in engines:
            if eng != "host":
                run_cli(fa, bam, eng)  # warm: compiles/executable loads
        times = {e: [] for e in engines}
        for rep in range(reps):
            # rotate the order each rep so no engine always runs right
            # after the host engine's all-core burn
            order = engines[rep % len(engines):] + engines[: rep % len(engines)]
            for eng in order:
                times[eng].append(run_cli(fa, bam, eng))
        cli_n = 2 * cli_pairs
        result["cli_reads_per_s"] = round(cli_n / float(np.median(times[dev_engine])), 1)
        result["cli_n_reads"] = cli_n
        # The exact host engine is the other production path (auto picks it
        # without a GPU); report both so the engine tradeoff is visible.
        result["cli_host_reads_per_s"] = round(cli_n / float(np.median(times["host"])), 1)
        if "mesh" in times:
            result["cli_mesh_reads_per_s"] = round(
                cli_n / float(np.median(times["mesh"])), 1)

    # -@ scaling table: the same CLI input
    # at -@ 2 and -@ 4 for jax vs host, ≥4 passes, order rotated per
    # (pass, thread-count), medians + per-pass pairwise ratios. The -@1
    # cells are the cli_* numbers above (5 reps, same protocol).
    if os.environ.get("MDTPU_BENCH_CLI", "1") != "0" \
            and os.environ.get("MDTPU_BENCH_AT", "1") != "0":
        at_reps = int(os.environ.get("MDTPU_BENCH_AT_REPS", 4))
        at_counts = tuple(int(x) for x in
                          os.environ.get("MDTPU_BENCH_AT_COUNTS",
                                         "2,4").split(","))
        cli_pairs = int(os.environ.get("MDTPU_BENCH_CLI_PAIRS", 1_000_000))
        _d, fa, bam = make_cli_input(cli_pairs, L, 1 << 23)
        at_n = 2 * cli_pairs
        for ti, threads in enumerate(at_counts):
            tj, th = [], []
            for rep in range(at_reps):
                order = (("jax", "host") if (rep + ti) % 2 == 0
                         else ("host", "jax"))
                for eng in order:
                    (tj if eng == "jax" else th).append(
                        run_cli(fa, bam, eng, threads=threads))
            jm = at_n / float(np.median(tj))
            hm = at_n / float(np.median(th))
            result[f"cli_at{threads}_reads_per_s"] = round(jm, 1)
            result[f"cli_at{threads}_host_reads_per_s"] = round(hm, 1)
            result[f"cli_at{threads}_ratio"] = round(jm / hm, 3)

    # Subcommand device-backend rates: mbias and perRead,
    # device vs host, interleaved medians on a smaller input.
    if os.environ.get("MDTPU_BENCH_SUBCMDS", "1") != "0":
        sub_rates = bench_subcommands(
            int(os.environ.get("MDTPU_BENCH_SUB_PAIRS", 100_000)), L,
            int(os.environ.get("MDTPU_BENCH_SUB_REPS", 3)))
        result.update(sub_rates)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
