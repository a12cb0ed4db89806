"""CRAM 3.0 reader/writer tests.

The environment has no htslib/samtools, so fixtures are produced by this
framework's own writer (io/cram.bam_to_cram) from the reference BAMs and
from synthetic BAMs — the roundtrip asserts bit-equality of the full decoded
SoA against BamFile, and the e2e tests assert byte-identical extract output
on CRAM vs BAM input (the reference treats the two interchangeably,
MethylDackel.h:80).

Core bit-codecs (HUFFMAN/BETA/GAMMA) and the rANS4x8 entropy codec get
direct unit tests since the writer itself only emits EXTERNAL/
BYTE_ARRAY_STOP/BYTE_ARRAY_LEN encodings.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from methyldackel_tpu.utils.bam_writer import write_bam

from methyldackel_tpu.io.bam import BamFile
from methyldackel_tpu.io.cram import (
    CramFile, bam_to_cram, open_alignment, _Codec, _BitReader, _BitWriter,
    _Ext, read_itf8, write_itf8, read_ltf8, write_ltf8, E_HUFFMAN, E_BETA,
    E_GAMMA, _write_array_itf8,
)
from methyldackel_tpu.io import rans4x8
from methyldackel_tpu.io.fasta import FastaFile

REF = "/root/reference/tests"
ENV = dict(os.environ,
           PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
           MDTPU_ENGINE=os.environ.get("MDTPU_ENGINE", "host"))

SOA_ATTRS = ["flag", "tid", "pos", "mapq", "l_qseq", "endpos", "mtid", "mpos",
             "xg", "nh", "offsets", "seq_flat", "qual_flat", "refpos_flat",
             "cigar_flat", "cigar_offsets", "order"]


def md(args, cwd, env_extra=None):
    env = ENV if not env_extra else {**ENV, **env_extra}
    return subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.cli"] + args,
        cwd=cwd, env=env, capture_output=True, text=True,
    )


def assert_soa_equal(bam, cram, tag):
    assert cram.n_reads == bam.n_reads
    for attr in SOA_ATTRS:
        a, b = getattr(bam, attr), getattr(cram, attr)
        assert np.array_equal(a, b), f"{tag}: {attr} differs"
    assert [bam.qname[i] for i in range(bam.n_reads)] == list(cram.qname)


# ------------------------------------------------------------------ varints

def test_itf8_ltf8_roundtrip():
    for v in [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000,
              0xFFFFFFF, 0x10000000, 0x7FFFFFFF]:
        buf = write_itf8(v)
        got, p = read_itf8(buf, 0)
        assert got == v and p == len(buf), v
    for v in [0, 1, 0x7F, 0x80, 0x3FFF, 1 << 20, 1 << 30, 1 << 40, 1 << 50,
              (1 << 62) - 3]:
        buf = write_ltf8(v)
        got, p = read_ltf8(buf, 0)
        assert got == v and p == len(buf), v


# -------------------------------------------------------------------- rANS

def test_rans4x8_roundtrip():
    rng = np.random.default_rng(7)
    cases = [b"", b"x", b"xy", b"xyz", b"xyzw", b"A" * 1000,
             bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
             bytes(rng.integers(33, 43, 4099, dtype=np.uint8)),
             bytes(np.repeat(np.arange(256, dtype=np.uint8), 5)),
             b"\x00" * 300, bytes([255, 0, 255, 0, 255])]
    for c in cases:
        for order in (0, 1):
            assert rans4x8.uncompress(rans4x8.compress(c, order)) == c


def test_rans4x8_compresses_skewed_data():
    rng = np.random.default_rng(1)
    skew = bytes(rng.choice(list(b"ACGT"), 50000, p=[.7, .1, .1, .1])
                 .astype(np.uint8))
    assert len(rans4x8.compress(skew, 0)) < len(skew) // 4


# -------------------------------------------------------------- core codecs

def test_huffman_codec_multi_symbol():
    # canonical codes for lengths [1, 2, 2]: a=0, b=10, c=11
    alphabet, lengths = [5, 9, 200], [1, 2, 2]
    params = _write_array_itf8(alphabet) + _write_array_itf8(lengths)
    w = _BitWriter()
    seq = [5, 9, 200, 5, 200, 9, 5]
    codes = {5: (0, 1), 9: (0b10, 2), 200: (0b11, 2)}
    for s in seq:
        w.write_bits(*codes[s])
    dec = _Codec((E_HUFFMAN, params), "int", {}, _BitReader(w.getvalue()))
    assert [dec.get() for _ in seq] == seq


def test_huffman_codec_constant():
    params = _write_array_itf8([42]) + _write_array_itf8([0])
    dec = _Codec((E_HUFFMAN, params), "int", {}, _BitReader(b""))
    assert [dec.get() for _ in range(5)] == [42] * 5


def test_beta_codec():
    # offset 2, 5 bits: stored value = v + offset
    params = write_itf8(2) + write_itf8(5)
    vals = [0, 1, 7, 29, 13]
    w = _BitWriter()
    for v in vals:
        w.write_bits(v + 2, 5)
    dec = _Codec((E_BETA, params), "int", {}, _BitReader(w.getvalue()))
    assert [dec.get() for _ in vals] == vals


def test_gamma_codec():
    params = write_itf8(1)  # offset 1 → values ≥ 0
    vals = [0, 1, 2, 6, 14, 30]
    w = _BitWriter()
    for v in vals:
        x = v + 1
        n = x.bit_length() - 1
        w.write_bits(1, n + 1)          # n zeros then the leading 1
        if n:
            w.write_bits(x & ((1 << n) - 1), n)
    dec = _Codec((E_GAMMA, params), "int", {}, _BitReader(w.getvalue()))
    assert [dec.get() for _ in vals] == vals


# --------------------------------------------------------------- roundtrips

@pytest.mark.parametrize("bamname,faname", [
    ("cg_aln.bam", "cg100.fa"),
    ("ct_aln.bam", "ct100.fa"),
    ("chgchh_aln.bam", "chgchh.fa"),
    ("cg_with_variants.bam", "cg100.fa"),
    ("NH.bam", "cg100.fa"),
])
def test_fixture_roundtrip(tmp_path, bamname, faname):
    bam = BamFile(f"{REF}/{bamname}")
    fa = FastaFile(f"{REF}/{faname}")
    out = str(tmp_path / (bamname + ".cram"))
    bam_to_cram(bam, fa, out)
    cram = CramFile(out, fasta=fa)
    assert_soa_equal(bam, cram, bamname)
    assert os.path.exists(out + ".crai")


def _write_fa(path, seqs):
    with open(path, "w") as fh:
        for name, seq in seqs:
            fh.write(f">{name}\n{seq}\n")


def test_synthetic_hard_roundtrip(tmp_path):
    """Indels, soft/hard clips, skips, mismatches, multi-contig, unmapped
    mate, small slices (multi-container), N bases."""
    _write_fa(tmp_path / "g.fa", [("chrA", "ACGTACGTACGTACGTACGT"),
                                  ("chrB", "TTTTCGCGTTTTCGCGTTTT")])
    recs = [
        dict(qname="p1", flag=0x63, tid=0, pos=0, seq="ACGTTCGT",
             cigar="4M2I2M", mtid=0, mpos=8, qual=list(range(30, 38))),
        dict(qname="p1", flag=0x93, tid=0, pos=8, seq="ACGTACGT",
             cigar="3M4D5M", mtid=0, mpos=0, qual=25),
        dict(qname="s1", flag=0, tid=0, pos=2, seq="NNGTACGTAC",
             cigar="2S8M", mtid=-1, mpos=-1),
        dict(qname="s2", flag=0x10, tid=1, pos=0, seq="TTTTCGCG",
             cigar="4M100N4M", mtid=-1, mpos=-1),
        dict(qname="s3", flag=0, tid=1, pos=4, seq="CGCGTTTT",
             cigar="8M4H", mtid=-1, mpos=-1),
        # mismatches incl. a non-ACGT read base (falls back to a 'B' feature)
        dict(qname="s4", flag=0, tid=1, pos=8, seq="TTNTCGCG",
             cigar="8M", mtid=-1, mpos=-1),
        # unmapped, unplaced
        dict(qname="u1", flag=0x4, tid=-1, pos=-1, seq="ACGTNACG",
             cigar="", mtid=-1, mpos=-1, mapq=0),
    ]
    write_bam(tmp_path / "r.bam", [("chrA", 20), ("chrB", 120)], recs)
    bam = BamFile(str(tmp_path / "r.bam"))
    fa = FastaFile(str(tmp_path / "g.fa"))
    for slice_size in (1024, 2):  # multi-container split included
        out = str(tmp_path / f"r{slice_size}.cram")
        bam_to_cram(bam, fa, out, slice_size=slice_size)
        cram = CramFile(out, fasta=fa)
        assert_soa_equal(bam, cram, f"slice={slice_size}")


def test_open_alignment_dispatch(tmp_path):
    bam = BamFile(f"{REF}/cg_aln.bam")
    fa = FastaFile(f"{REF}/cg100.fa")
    out = str(tmp_path / "x.cram")
    bam_to_cram(bam, fa, out)
    assert isinstance(open_alignment(out, fa), CramFile)
    assert isinstance(open_alignment(f"{REF}/cg_aln.bam", fa), BamFile)


def test_open_alignment_uncompressed_bam(tmp_path):
    """A raw 'BAM\\x01' stream (no BGZF framing) — hts_open accepts these,
    so open_alignment must decode it rather than mis-route to the SAM
    parser (ADVICE r4)."""
    from methyldackel_tpu.io.bgzf import BGZFReader

    raw = str(tmp_path / "raw.bam")
    with open(raw, "wb") as fh:
        fh.write(bytes(BGZFReader(f"{REF}/cg_aln.bam").data))
    got = open_alignment(raw, FastaFile(f"{REF}/cg100.fa"))
    assert isinstance(got, BamFile)
    ref = BamFile(f"{REF}/cg_aln.bam")
    assert got.n_reads == ref.n_reads
    import numpy as np

    assert np.array_equal(got.pos, ref.pos)
    assert np.array_equal(got.seq_flat, ref.seq_flat)


# ---------------------------------------------------------------------- e2e

def _prep(tmp_path, bamname, faname):
    import shutil

    fa_src = f"{REF}/{faname}"
    shutil.copy(fa_src, tmp_path / faname)
    if os.path.exists(fa_src + ".fai"):
        shutil.copy(fa_src + ".fai", tmp_path / (faname + ".fai"))
    shutil.copy(f"{REF}/{bamname}", tmp_path / bamname)
    if os.path.exists(f"{REF}/{bamname}.bai"):
        shutil.copy(f"{REF}/{bamname}.bai", tmp_path / (bamname + ".bai"))
    bam = BamFile(f"{REF}/{bamname}")
    bam_to_cram(bam, FastaFile(fa_src), str(tmp_path / (bamname + ".cram")))


def test_extract_cram_matches_bam(tmp_path):
    _prep(tmp_path, "cg_aln.bam", "cg100.fa")
    # same -o prefix in both runs: the bedGraph track header embeds it
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    r = md(["extract", "../cg100.fa", "../cg_aln.bam", "-o", "out"],
           tmp_path / "a")
    assert r.returncode == 0, r.stderr
    r = md(["extract", "../cg100.fa", "../cg_aln.bam.cram", "-o", "out"],
           tmp_path / "b")
    assert r.returncode == 0, r.stderr
    a = (tmp_path / "a" / "out_CpG.bedGraph").read_bytes()
    b = (tmp_path / "b" / "out_CpG.bedGraph").read_bytes()
    assert a == b and len(a) > 0


def test_perread_and_mbias_cram_match_bam(tmp_path):
    _prep(tmp_path, "ct_aln.bam", "ct100.fa")
    a = md(["perRead", "ct100.fa", "ct_aln.bam"], tmp_path)
    b = md(["perRead", "ct100.fa", "ct_aln.bam.cram"], tmp_path)
    assert a.returncode == 0 and b.returncode == 0, a.stderr + b.stderr
    assert a.stdout == b.stdout and a.stdout

    a = md(["mbias", "--txt", "ct100.fa", "ct_aln.bam", "mb_bam"], tmp_path)
    b = md(["mbias", "--txt", "ct100.fa", "ct_aln.bam.cram", "mb_cram"], tmp_path)
    assert a.returncode == 0 and b.returncode == 0, a.stderr + b.stderr
    assert a.stdout == b.stdout


# --------------------------------------------------------- streaming CRAM

def test_streaming_cram_window_soa_matches_inmemory(tmp_path):
    """StreamingCramFile (crai-guided container-at-a-time decode) serves
    the same reads per window as the whole-file decode, with and without
    the .crai (container-header scan fallback), and containers outside the
    window are never decoded (O(window) memory)."""
    from methyldackel_tpu.io.cram import StreamingCramFile
    from methyldackel_tpu.utils.simulate import write_synthetic_input
    import numpy as np

    fa_path, bam_path = write_synthetic_input(str(tmp_path), 2000, 100,
                                              1 << 18, seed=5)
    fa = FastaFile(fa_path)
    bam = BamFile(bam_path)
    cram_path = str(tmp_path / "s.cram")
    bam_to_cram(bam, fa, cram_path, slice_size=256)
    full = CramFile(cram_path, fasta=fa)

    for use_crai in (True, False):
        if not use_crai:
            os.rename(cram_path + ".crai", cram_path + ".crai.off")
        try:
            sc = StreamingCramFile(cram_path, fasta=fa, cache_containers=3)
            for (start, end) in ((0, 65536), (65536, 131072),
                                 (200000, 262144), (0, 1 << 18)):
                view = sc.window_soa(0, start, end)
                want = full.overlapping(0, start, end)
                got = view.overlapping(0, start, end)
                assert len(want) == len(got), (use_crai, start, end)
                wb = full.batch(want)
                gb = view.batch(got)
                for f in ("flag", "pos", "l_qseq", "seq", "qual", "refpos"):
                    np.testing.assert_array_equal(
                        getattr(wb, f), getattr(gb, f), err_msg=f)
                # decoded containers stay bounded by the window span
                assert len(sc._cache) <= 3
        finally:
            if not use_crai:
                os.rename(cram_path + ".crai.off", cram_path + ".crai")


def test_streaming_cram_extract_byte_invariant(tmp_path):
    """MDTPU_STREAM=1 on CRAM input must produce byte-identical extract
    output to the in-memory mode (the BAM streaming invariant, extended)."""
    from methyldackel_tpu.utils.simulate import write_synthetic_input

    fa_path, bam_path = write_synthetic_input(str(tmp_path), 1500, 100,
                                              1 << 18, seed=6)
    bam = BamFile(bam_path)
    fa = FastaFile(fa_path)
    cram_path = str(tmp_path / "t.cram")
    bam_to_cram(bam, fa, cram_path, slice_size=300)
    (tmp_path / "mem").mkdir()
    (tmp_path / "str").mkdir()
    fa_rel = "../" + os.path.basename(fa_path)
    r = md(["extract", "--chunkSize", "65536", fa_rel,
            "../t.cram", "-o", "out"], tmp_path / "mem")
    assert r.returncode == 0, r.stderr
    r = md(["extract", "--chunkSize", "65536", fa_rel,
            "../t.cram", "-o", "out"], tmp_path / "str",
           env_extra={"MDTPU_STREAM": "1"})
    assert r.returncode == 0, r.stderr
    a = (tmp_path / "mem" / "out_CpG.bedGraph").read_bytes()
    b = (tmp_path / "str" / "out_CpG.bedGraph").read_bytes()
    assert a == b and len(a) > 0
