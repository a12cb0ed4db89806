"""Host ingest layer unit tests: BGZF, BAM decode, faidx FASTA, BBM codec."""
import numpy as np
import pytest

from methyldackel_tpu.io.bam import BamFile
from methyldackel_tpu.io.bgzf import BGZFReader
from methyldackel_tpu.io.fasta import FastaFile
from methyldackel_tpu.io.bbm import read_bbm, write_bbm, quantize

FIX = "/root/reference/tests"


def test_bgzf_roundtrip():
    r = BGZFReader(f"{FIX}/cg_aln.bam")
    assert r.data[:4] == b"BAM\x01"
    # first block's virtual offset 0 maps to flat 0
    assert r.voffset_to_flat(0) == 0


def test_bam_decode():
    b = BamFile(f"{FIX}/cg_aln.bam")
    assert b.header.names == ["chrCG"]
    assert b.header.lengths == [100]
    assert b.n_reads == 4
    assert list(b.flag) == [0x63, 0x93, 0x263, 0x293]
    assert list(b.l_qseq) == [100] * 4
    assert list(b.xg) == [1, 1, 1, 1]  # XG:Z:CT → 'C'
    assert list(b.endpos) == [100] * 4
    batch = b.batch(b.overlapping(0, 0, 100))
    assert batch.n == 4
    assert batch.refpos[0, 0] == 0 and batch.refpos[0, 99] == 99


def test_bam_nh_tag():
    b = BamFile(f"{FIX}/NH.bam")
    assert (b.nh > 1).any() or (b.nh == -1).all() or True
    # NH.bam's reads carry NH tags; at least one must be >1 (multimapper test)
    assert (b.nh > 1).any()


def test_cigar_expansion_indels():
    from methyldackel_tpu.io.bam import _expand_cigar

    # 5S10M2D3M1I4M: read length 5+10+3+1+4=23
    ops = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4}
    cigar = np.array(
        [(5 << 4) | ops["S"], (10 << 4) | ops["M"], (2 << 4) | ops["D"],
         (3 << 4) | ops["M"], (1 << 4) | ops["I"], (4 << 4) | ops["M"]],
        dtype=np.uint32,
    )
    refpos, endpos = _expand_cigar(cigar, 100, 23)
    assert list(refpos[:5]) == [-1] * 5
    assert list(refpos[5:15]) == list(range(100, 110))
    assert list(refpos[15:18]) == [112, 113, 114]  # after 2D
    assert refpos[18] == -1  # insertion
    assert list(refpos[19:23]) == [115, 116, 117, 118]
    assert endpos == 100 + 10 + 2 + 3 + 4


def test_fasta_fetch():
    f = FastaFile(f"{FIX}/cg100.fa")
    assert f.seq_len("chrCG") == 100
    s = f.fetch("chrCG", 0, 3)
    assert bytes(s) == b"CGCG"[:4][:len(s)]
    # closed-interval, clamped at contig end
    tail = f.fetch("chrCG", 98, 200)
    assert len(tail) == 2
    assert f.fetch("nope", 0, 10) is None
    assert f.fetch("chrCG", 150, 200).size == 0


def test_bbm_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    # mixture of runs and singles, including a >155 run and a >65535 run
    vals = np.concatenate([
        np.full(200, 7, np.uint8),
        rng.randint(0, 101, 50).astype(np.uint8),
        np.full(70000, 100, np.uint8),
        np.full(3, 55, np.uint8),
    ])
    path = tmp_path / "t.bbm"
    write_bbm(str(path), ["chr1"], [len(vals)], [vals])
    names, lengths, out = read_bbm(str(path))
    assert names == ["chr1"] and lengths == [len(vals)]
    np.testing.assert_array_equal(out[0], vals)


def test_bbm_quantize_matches_c():
    raw = np.array([0.0, 0.004, 0.005, 0.5, 1.0, np.nan])
    q = quantize(raw)
    # (char)((v*100)+0.5): 0, 0(0.9 trunc→0)... 0.004*100+0.5=0.9→0;
    # 0.005*100+0.5=1.0→1; 50.5→50; 100.5→100; NaN→0
    assert list(q) == [0, 0, 1, 50, 100, 0]


def test_bai_builder_matches_htslib(tmp_path):
    """bam_index_build parity: byte-identical to the shipped .bai for the
    fixtures whose indexes use the modern EOF-tell convention (the shipped
    chgchh/NH indexes were written by an older htslib whose final chunk end
    stops at the EOF block start; the two conventions are mutually
    exclusive, so those two are compared semantically)."""
    import shutil
    from methyldackel_tpu.io.bai import build_bai, BaiFile

    for name, exact in (("cg_aln", True), ("ct_aln", True),
                        ("cg_with_variants", True), ("chgchh_aln", False),
                        ("NH", False)):
        shutil.copy(f"{FIX}/{name}.bam", tmp_path / f"{name}.bam")
        b = BamFile(str(tmp_path / f"{name}.bam"))
        build_bai(b, str(tmp_path / f"{name}.bam.bai"))
        mine = open(tmp_path / f"{name}.bam.bai", "rb").read()
        ref = open(f"{FIX}/{name}.bam.bai", "rb").read()
        if exact:
            assert mine == ref, name
        else:
            m = BaiFile(str(tmp_path / f"{name}.bam.bai"))
            r = BaiFile(f"{FIX}/{name}.bam.bai")
            assert set(m.refs[0].bins) == set(r.refs[0].bins)
            assert m.refs[0].intervals == r.refs[0].intervals


def test_missing_index_autobuild(tmp_path):
    """Missing .bai → announce + build (extract.c:1048-1057 parity)."""
    import shutil
    import subprocess
    import sys
    import os

    shutil.copy(f"{FIX}/cg100.fa", tmp_path / "cg100.fa")
    shutil.copy(f"{FIX}/cg_aln.bam", tmp_path / "noidx.bam")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MDTPU_ENGINE="host")
    r = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.cli", "extract", "cg100.fa",
         "noidx.bam", "-q", "2", "-o", "out"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    assert "will attempt to build it" in r.stderr
    assert (tmp_path / "noidx.bam.bai").exists()


def test_bgzf_block_index_random_ranges():
    """BGZFBlockIndex (header-only scan) must serve arbitrary flat ranges
    identical to the full-inflate reader."""
    from methyldackel_tpu.io.bgzf import BGZFReader, BGZFBlockIndex

    path = f"{FIX}/cg_aln.bam"
    full = BGZFReader(path).data
    bi = BGZFBlockIndex(path)
    assert bi.usize == len(full)
    rng = np.random.default_rng(3)
    for _ in range(40):
        a = int(rng.integers(0, len(full)))
        b = int(rng.integers(a, len(full) + 1))
        assert bi.read_flat_range(a, b) == full[a:b]


def test_streaming_bai_builder_matches_inmemory():
    """build_bai_streaming (chunked, O(chunk) memory) must emit the same
    bytes as the in-memory builder (itself byte-identical to htslib on
    modern-convention fixtures)."""
    import tempfile, os
    from methyldackel_tpu.io.bai import build_bai, build_bai_streaming

    for name in ("cg_aln.bam", "ct_aln.bam", "NH.bam"):
        path = f"{FIX}/{name}"
        with tempfile.TemporaryDirectory() as d:
            mem = os.path.join(d, "mem.bai")
            strm = os.path.join(d, "strm.bai")
            build_bai(BamFile(path), mem)
            build_bai_streaming(path, strm)
            assert open(mem, "rb").read() == open(strm, "rb").read(), name


def test_native_pileup_parity():
    """mdtpu_pileup vs the numpy oracle (ops/semantics.pileup_channels) on
    randomized windows: sentinels, out-of-window spans, strand mix, phred
    gate, and a BED-strand keep_base mask."""
    import numpy as np
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem

    if not native.available():
        import pytest

        pytest.skip("native library not built")
    rng = np.random.default_rng(7)
    for trial in range(6):
        n, L, W = 300, 40, 512
        win_start = 100
        win_offset = 98
        ref = rng.choice(np.frombuffer(b"ACGTN", np.uint8), W + 60)
        seq = rng.integers(0, 16, (n, L)).astype(np.uint8)  # BAM nibble codes
        qual = rng.integers(0, 42, (n, L)).astype(np.uint8)
        start = rng.integers(win_start - L - 4, win_start + W + 4, n)
        refpos = (start[:, None] + np.arange(L)[None, :]).astype(np.int32)
        # sprinkle deletion/pad sentinels
        refpos[rng.random((n, L)) < 0.05] = -1
        strand = rng.integers(1, 5, n).astype(np.int32)
        if trial % 2:
            keep_base = rng.random((n, L)) < 0.8
        else:
            keep_base = np.ones((n, L), bool)
        want = sem.pileup_channels(seq, qual, refpos, strand, keep_base,
                                   ref, win_offset, win_start, win_start + W, 13)
        got = native.pileup_channels(seq, qual, refpos, strand, keep_base,
                                     ref, win_offset, win_start, win_start + W, 13)
        assert got is not None
        assert np.array_equal(got, want)


def test_native_arbitrate_parity():
    """mdtpu_arbitrate vs the oracle (ops/semantics.arbitrate_overlaps) on
    randomized gapless + indel + clipped + strand-incompatible pairs."""
    import numpy as np
    from methyldackel_tpu.io import native
    from methyldackel_tpu.ops import semantics as sem

    if not native.available():
        import pytest

        pytest.skip("native library not built")
    rng = np.random.default_rng(23)
    for trial in range(8):
        n, L = 120, 50
        seq = rng.integers(0, 16, (n, L)).astype(np.uint8)
        qual = rng.integers(0, 64, (n, L)).astype(np.uint8)
        start = rng.integers(0, 60, n).astype(np.int32)
        refpos = start[:, None] + np.arange(L, dtype=np.int32)[None, :]
        # soft-clip tails (valid prefix shorter than L)
        nv = rng.integers(L // 2, L + 1, n)
        refpos[np.arange(L)[None, :] >= nv[:, None]] = -1
        # sprinkle mid-read deletions/skips into some rows (non-gapless)
        gappy = rng.random(n) < 0.3
        for i in np.nonzero(gappy)[0]:
            j = rng.integers(2, L // 2)
            refpos[i, j:] += rng.integers(1, 5)
            refpos[i, np.arange(L) >= nv[i]] = -1
        strand = rng.integers(1, 5, n).astype(np.int32)
        a_idx = np.arange(0, n, 2, dtype=np.int64)
        b_idx = a_idx + 1
        q_want = qual.copy()
        sem.arbitrate_overlaps(seq, q_want, refpos, strand, a_idx, b_idx)
        q_got = qual.copy()
        fb = native.arbitrate(seq, q_got, refpos, strand, a_idx, b_idx)
        assert fb is not None
        if len(fb):
            sem._arbitrate_pairs_loop(seq, q_got, refpos, strand,
                                      a_idx[fb], b_idx[fb])
        assert np.array_equal(q_got, q_want)


def test_native_format_parity_float_methylkit():
    """Batched native fraction/logit/methylKit rows vs the per-row
    write_call oracle across edge fractions (0, 1, ties, big counts)."""
    import numpy as np
    from methyldackel_tpu.io import native
    from methyldackel_tpu.engine import formats
    from methyldackel_tpu.config import Config

    if not native.available():
        import pytest

        pytest.skip("native library not built")
    nm = np.array([0, 1, 1, 2, 999999, 3, 7], np.int64)
    nu = np.array([5, 0, 1, 3, 1, 999999, 13], np.int64)
    pos = np.array([0, 9, 99, 999, 123456789, 54, 7], np.int64)
    chrom = "chr_test.1"
    for mode in ("fraction", "logit", "methylKit"):
        cfg = Config()
        setattr(cfg, "fraction" if mode == "fraction" else
                "logit" if mode == "logit" else "methylKit", True)
        want = "".join(
            formats.write_call(cfg, chrom, int(p), 1, int(m), int(u),
                               ord("C") if i % 2 else ord("G"), None, None)
            for i, (p, m, u) in enumerate(zip(pos, nm, nu)))
        if mode == "methylKit":
            strand_f = np.array([i % 2 == 1 for i in range(len(pos))])
            got = native.format_methylkit(chrom, pos + 1, strand_f, nm, nu)
        else:
            p = nm / (nm + nu)
            if mode == "logit":
                with np.errstate(divide="ignore"):
                    val = (np.where(p <= 0.0, -np.inf, np.log(p))
                           - np.where(p >= 1.0, -np.inf, np.log(1.0 - p)))
            else:
                val = p
            got = native.format_float_rows(chrom, pos, pos + 1, val)
        assert got == want, f"{mode}:\n{got!r}\n{want!r}"


# ----------------------------------------------------- malformed-input BAM

def test_truncated_bam_raises_cleanly(tmp_path):
    """Truncations at every structural layer (mid BGZF block, mid record,
    mid header) must raise a clean exception — never return silently
    truncated records (htslib's corresponding failure is a hard error)."""
    import pytest
    from methyldackel_tpu.io.bam import BamFile
    from methyldackel_tpu.utils.bam_writer import write_bam

    recs = [dict(qname=f"r{i}", flag=0, tid=0, pos=i * 5,
                 seq="ACGTACGTAC", cigar="10M", mtid=-1, mpos=-1)
            for i in range(50)]
    path = tmp_path / "t.bam"
    write_bam(path, [("chrT", 400)], recs)
    data = path.read_bytes()
    full = BamFile(str(path)).n_reads
    assert full == 50
    for frac in (0.3, 0.7, 0.95):
        cut = tmp_path / f"cut{frac}.bam"
        cut.write_bytes(data[: int(len(data) * frac)])
        with pytest.raises(Exception):
            BamFile(str(cut))


def test_corrupt_bgzf_crc_raises(tmp_path):
    """A flipped byte inside a BGZF block payload must surface as an
    error from the inflater (both the native and pure-Python paths),
    not as silently wrong records."""
    import pytest
    import zlib
    from methyldackel_tpu.io.bam import BamFile
    from methyldackel_tpu.utils.bam_writer import write_bam

    recs = [dict(qname=f"r{i}", flag=0, tid=0, pos=i * 3,
                 seq="ACGTACGTAC", cigar="10M", mtid=-1, mpos=-1)
            for i in range(200)]
    path = tmp_path / "c.bam"
    write_bam(path, [("chrT", 800)], recs)
    data = bytearray(path.read_bytes())
    # flip a byte inside the deflate payload of the first block (skip the
    # 18-byte header so the BSIZE field stays parseable)
    data[40] ^= 0xFF
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    with pytest.raises(Exception):
        BamFile(str(bad))
