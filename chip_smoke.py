#!/usr/bin/env python3
"""Smoke test of the device path on an NVIDIA GPU.

Runs extract, mbias and perRead through the CLI entry point
(methyldackel_tpu.cli.main), all in this one process, on synthetic WGBS
data made from a seed: 1M pairs of 2x150 bp over an 8 Mb genome (~250k
reads per 1 Mb window, about the density of 30x human WGBS) and a 200k-pair
input for the flag surface. Every output is compared byte for byte with
the exact host engine (MDTPU_ENGINE=host).

    python chip_smoke.py          # one GPU: every phase
    python chip_smoke.py --four   # only the mesh engine over 4 GPUs

Each phase prints one line (name, PASS/FAIL, seconds, card). The last line
is one JSON object naming the device; it is printed only when every phase
passed. Without a GPU the script exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

MAIN_PAIRS, MAIN_GLEN = 1_000_000, 8 << 20
FLAG_PAIRS, FLAG_GLEN = 200_000, 2 << 20
READ_LEN = 150


# ------------------------------------------------------------------ helpers

def _require_platform(platform: str, count: int | None = None):
    import jax

    devs = jax.devices()
    if devs[0].platform != platform:
        raise SystemExit(f"chip_smoke: JAX's first device is "
                         f"{devs[0].platform!r}, not {platform!r}")
    if count is not None and len(devs) < count:
        raise SystemExit(f"chip_smoke: {count} {platform} devices needed, "
                         f"JAX has {len(devs)}")
    return devs


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _write_fasta(path, chrom, ref_ascii):
    with open(path, "wb") as fh:
        fh.write(b">" + chrom.encode() + b"\n")
        for i in range(0, len(ref_ascii), 60):
            fh.write(ref_ascii[i:i + 60].tobytes() + b"\n")


def make_input(workdir, n_pairs, glen, seed=0, indel_rate=0.0):
    """(fasta, bam) of simulated coordinate-sorted WGBS reads, made once per
    (size, seed, indel_rate) under `workdir`. indel_rate > 0 adds reads
    with deletions, insertions and soft clips (rows the fast path hands to
    the exact dense path)."""
    from methyldackel_tpu.io.bai import build_bai
    from methyldackel_tpu.io.bam import BamFile
    from methyldackel_tpu.utils import simulate
    from methyldackel_tpu.utils.bam_writer import batch_records, write_bam

    d = os.path.join(workdir, f"in_{n_pairs}_{glen}_{seed}_{indel_rate}")
    fa, bam = os.path.join(d, "sim.fa"), os.path.join(d, "sim.bam")
    if os.path.exists(bam + ".bai"):
        return fa, bam
    os.makedirs(d, exist_ok=True)
    if indel_rate == 0:
        fa, bam = simulate.write_synthetic_input(d, n_pairs, READ_LEN, glen,
                                                 seed=seed)
    else:
        rng = np.random.default_rng(seed)
        ref_ascii, ref_codes = simulate.random_reference(rng, glen)
        batch = simulate.simulate_batch(rng, ref_codes, n_pairs, READ_LEN,
                                        indel_rate=indel_rate)
        _write_fasta(fa, "chrSim", ref_ascii)
        order = np.argsort(batch.pos, kind="stable")
        write_bam(bam, [("chrSim", glen)], batch_records(batch, order))
    build_bai(BamFile(bam), bam + ".bai")
    return fa, bam


def run_cli(rundir, args, engine, stdout_name=None, **env):
    """One in-process CLI run with outputs under `rundir` (the prefix in
    `args` stays relative, so bedGraph track headers match across runs)."""
    from methyldackel_tpu import cli

    os.makedirs(rundir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(rundir)
    try:
        with _env(MDTPU_ENGINE=engine, **env):
            if stdout_name:
                with open(stdout_name, "w") as fh, \
                        contextlib.redirect_stdout(fh):
                    rc = cli.main(list(args))
            else:
                rc = cli.main(list(args))
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"{args[0]} under {engine} exited {rc}")


def assert_same_outputs(dir_a, dir_b):
    """Every file of two run directories, byte for byte."""
    a, b = sorted(os.listdir(dir_a)), sorted(os.listdir(dir_b))
    if a != b or not a:
        raise AssertionError(f"output files differ: {a} vs {b}")
    for name in a:
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if not filecmp.cmp(pa, pb, shallow=False):
            raise AssertionError(f"{name}: device output differs from host")
        if os.path.getsize(pa) == 0:
            raise AssertionError(f"{name}: empty output")


@contextlib.contextmanager
def lane_counts():
    """The extract scheduler's own lane counters (windows each lane took),
    for the runs inside the block."""
    from methyldackel_tpu.utils.profiling import STATS

    keys = ("windows", "windows_device_lane", "windows_host_lane")
    was = STATS.enabled
    STATS.enabled = True
    before = {k: STATS.n[k] for k in keys}
    out = {}
    try:
        yield out
    finally:
        STATS.enabled = was
        out.update({k: STATS.n[k] - before[k] for k in keys})


# ------------------------------------------------------------------- phases

def phase_compile(platform, n_pairs, workdir, k=4, window=1 << 20):
    """Compile the K-window candidate-space group program at these widths,
    print its memory_analysis(), and compare one group's counters with
    ops.semantics (host arbitration + pileup_channels) exactly, at every
    position emit reads."""
    del workdir
    _require_platform(platform)
    from methyldackel_tpu.config import Config
    from methyldackel_tpu.io.bam import ReadBatch
    from methyldackel_tpu.ops import semantics as sem
    from methyldackel_tpu.parallel import device as dev
    from methyldackel_tpu.utils.simulate import (random_reference,
                                                 simulate_batch_fast)

    rng = np.random.default_rng(1)
    glen = k * window + 4 * READ_LEN
    ref_ascii, ref_codes = random_reference(rng, glen)
    batch = simulate_batch_fast(rng, ref_codes, n_pairs, READ_LEN)
    cfg = Config()
    cfg.chunkSize = window
    items = []
    for w in range(k):
        s, e = w * window, (w + 1) * window
        idx = np.nonzero((batch.pos < e) & (batch.endpos > s))[0]
        fields = {f: getattr(batch, f)[idx] for f in (
            "flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid",
            "mpos", "xg", "nh", "seq", "qual", "refpos")}
        fields["qname"] = [batch.qname[i] for i in idx]
        b = ReadBatch(**fields)
        lpos2 = s - 2 if s > 1 else 0
        items.append((b, sem.strand(b.flag, b.xg), np.ones(b.n, bool),
                      ref_ascii[lpos2:e + 10], lpos2, s, e, None))

    calls = []
    program = dev._fused_window_pregated2

    def spy(*args, **kw):
        calls.append((args, kw))
        return program(*args, **kw)

    dev._fused_window_pregated2 = spy
    try:
        handles = dev.dispatch_window_group(cfg, items, pad_to=k)
        got = [h.get() for h in handles]
    finally:
        dev._fused_window_pregated2 = program
    args, kw = calls[0]
    statics = {key: v for key, v in kw.items() if key != "SAT_BITS"}
    print(f"  group program: K={k} statics={statics}")
    if statics["SLOT"] != 0:  # the window-space layout compacts by slot
        raise AssertionError("the group left candidate space")
    mem = program.lower(*args, **kw).compile().memory_analysis()
    print(f"  memory_analysis: {mem}")

    for w, (b, st, keep, ref_win, lpos2, s, e, _rs) in enumerate(items):
        qual = b.qual.copy()
        pa, pb = sem.pair_mates(b.qname, b.flag)
        sem.arbitrate_overlaps(b.seq, qual, b.refpos, st, pa, pb)
        want = sem.pileup_channels(b.seq, qual, b.refpos, st,
                                   np.ones(b.seq.shape, bool), ref_win,
                                   lpos2, s, e, cfg.minPhred)
        ct, _cd = sem.classify_context(np.asarray(ref_win, np.uint8))
        read = np.nonzero(ct[np.arange(e - s) + (s - lpos2)] == 0)[0]
        if not np.array_equal(got[w][read, :2], want[read, :2]):
            raise AssertionError(f"window {w}: group counters differ from "
                                 f"ops.semantics")
    return f"{k} windows, {batch.n} reads"


def phase_device_only(platform, n_pairs, glen, workdir):
    """extract with the device lane taking every window (MDTPU_STEAL=0),
    byte-identical to the host engine."""
    _require_platform(platform)
    fa, bam = make_input(workdir, n_pairs, glen)
    host = os.path.join(workdir, f"x_host_{n_pairs}")
    dev = os.path.join(workdir, f"x_dev_{n_pairs}")
    args = ["extract", fa, bam, "-o", "out"]
    if not os.path.isdir(host):
        run_cli(host, args, "host")
    with lane_counts() as lanes:
        run_cli(dev, args, "jax", MDTPU_STEAL="0")
    if not (lanes["windows"] > 0 and lanes["windows_host_lane"] == 0
            and lanes["windows_device_lane"] >= lanes["windows"]):
        raise AssertionError(f"device lane did not take every window: "
                             f"{lanes}")
    assert_same_outputs(host, dev)
    return f"{lanes['windows_device_lane']} windows on the device lane"


def phase_auto(platform, n_pairs, glen, workdir):
    """The default engine (auto) picks the device backend here and its
    output is byte-identical to the host engine."""
    _require_platform(platform)
    from methyldackel_tpu.config import Config
    from methyldackel_tpu.parallel import select_backend

    with _env(MDTPU_ENGINE=None):
        backend = select_backend(Config())
    if backend is None or not hasattr(backend, "dispatch_group"):
        raise AssertionError("auto did not choose the device backend")
    fa, bam = make_input(workdir, n_pairs, glen)
    host = os.path.join(workdir, f"x_host_{n_pairs}")
    auto = os.path.join(workdir, f"x_auto_{n_pairs}")
    args = ["extract", fa, bam, "-o", "out"]
    if not os.path.isdir(host):
        run_cli(host, args, "host")
    with lane_counts() as lanes:
        run_cli(auto, args, None)
    if lanes["windows_device_lane"] == 0:
        raise AssertionError(f"auto sent no window to the device: {lanes}")
    assert_same_outputs(host, auto)
    return (f"{lanes['windows_device_lane']} device / "
            f"{lanes['windows_host_lane']} host-lane windows")


FLAG_SETS = {
    "opposite": ["--minOppositeDepth", "3", "--maxVariantFrac", "0.25"],
    "allctx_report": ["--CHG", "--CHH", "--cytosine_report"],
    "merge": ["--mergeContext"],
    "methylkit": ["--methylKit"],
}


def phase_flags(platform, n_pairs, glen, workdir):
    """The extract flag surface through the device lane, each run
    byte-identical to the host engine: the 4-channel program, the full C|G
    readback, mergeContext, methylKit, and an input with indels and soft
    clips."""
    _require_platform(platform)
    fa, bam = make_input(workdir, n_pairs, glen)
    cases = [(name, fa, bam, flags) for name, flags in FLAG_SETS.items()]
    hfa, hbam = make_input(workdir, n_pairs, glen, seed=2, indel_rate=0.2)
    cases.append(("indels_clips", hfa, hbam, []))
    for name, f, b, flags in cases:
        args = ["extract", *flags, f, b, "-o", "out"]
        host = os.path.join(workdir, f"f_host_{name}")
        dev = os.path.join(workdir, f"f_dev_{name}")
        run_cli(host, args, "host")
        run_cli(dev, args, "jax", MDTPU_STEAL="0")
        assert_same_outputs(host, dev)
    return ", ".join(c[0] for c in cases)


def phase_subcommands(platform, n_pairs, glen, workdir):
    """mbias --txt and perRead through their device backends,
    byte-identical to the host engine."""
    _require_platform(platform)
    from methyldackel_tpu.config import Config
    from methyldackel_tpu.parallel import (select_mbias_backend,
                                           select_perread_backend)

    with _env(MDTPU_ENGINE="jax"):
        if (select_mbias_backend(Config()) is None
                or select_perread_backend(Config()) is None):
            raise AssertionError("no device backend for mbias/perRead")
    fa, bam = make_input(workdir, n_pairs, glen)
    for name, args, stdout in (
            ("mbias", ["mbias", "--txt", fa, bam, "mb"], "mbias.txt"),
            ("perRead", ["perRead", fa, bam, "-o", "perread.tsv"], None)):
        host = os.path.join(workdir, f"s_host_{name}")
        dev = os.path.join(workdir, f"s_dev_{name}")
        run_cli(host, args, "host", stdout_name=stdout)
        run_cli(dev, args, "jax", stdout_name=stdout)
        assert_same_outputs(host, dev)
    return "mbias --txt, perRead"


def phase_mesh(platform, n_pairs, glen, workdir, n_devices=4):
    """extract through MDTPU_ENGINE=mesh over n_devices devices,
    byte-identical to the host engine."""
    devs = _require_platform(platform, n_devices)
    from methyldackel_tpu.config import Config
    from methyldackel_tpu.parallel.mesh import make_mesh_backend

    if len(devs) != n_devices:
        raise AssertionError(f"want exactly {n_devices} devices, JAX has "
                             f"{len(devs)}")
    backend = make_mesh_backend(Config())
    if hasattr(backend, "dispatch_group"):
        raise AssertionError("mesh engine delegated to the one-device path")
    fa, bam = make_input(workdir, n_pairs, glen)
    host = os.path.join(workdir, f"x_host_{n_pairs}")
    mesh = os.path.join(workdir, f"x_mesh_{n_pairs}")
    args = ["extract", fa, bam, "-o", "out"]
    if not os.path.isdir(host):
        run_cli(host, args, "host")
    run_cli(mesh, args, "mesh")
    assert_same_outputs(host, mesh)
    return f"{n_devices}-device mesh"


# --------------------------------------------------------------------- main

def _card_lines():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh engine over 4 GPUs")
    opts = ap.parse_args(argv)

    devs = _require_platform("gpu", 4 if opts.four else None)
    from methyldackel_tpu.io import native

    if not native.available():
        raise SystemExit("chip_smoke: the native library did not load")
    cards = _card_lines()
    for ln in cards:
        print(f"card: {ln}")
    card = cards[0]
    print(f"jax: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}")

    workdir = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    if opts.four:
        phases = [("mesh4", phase_mesh, ("gpu", MAIN_PAIRS, MAIN_GLEN))]
    else:
        phases = [
            ("compile", phase_compile, ("gpu", MAIN_PAIRS // 2)),
            ("device_only_extract", phase_device_only,
             ("gpu", MAIN_PAIRS, MAIN_GLEN)),
            ("auto_extract", phase_auto, ("gpu", MAIN_PAIRS, MAIN_GLEN)),
            ("flag_surface", phase_flags, ("gpu", FLAG_PAIRS, FLAG_GLEN)),
            ("mbias_perread", phase_subcommands,
             ("gpu", FLAG_PAIRS, FLAG_GLEN)),
        ]
    failed = []
    try:
        for name, fn, args in phases:
            t0 = time.perf_counter()
            try:
                note = fn(*args, workdir)
                status = "PASS"
            except Exception as exc:  # report every phase, then fail
                import traceback

                traceback.print_exc()
                note, status = f"{type(exc).__name__}: {exc}", "FAIL"
                failed.append(name)
            dt = time.perf_counter() - t0
            print(f"phase {name} {status} {dt}s on {card} ({note})",
                  flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        raise SystemExit(f"chip_smoke: failed phases: {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
