"""CSI index support (VERDICT r4 #4): read + build parity with BAI on
normal inputs, generalized (min_shift, depth) binning, and the real
reason CSI exists — contigs past BAI's 2^29 coordinate ceiling, driven
through extract end-to-end on a >2^29 synthetic contig."""
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from methyldackel_tpu.utils.bam_writer import write_bam
from methyldackel_tpu.io.bai import BaiFile, build_bai, reg2bin
from methyldackel_tpu.io.csi import (BAI_MAX_POS, CsiFile, build_csi,
                                     depth_for_length, reg2bin_depth)
from methyldackel_tpu.io.bam import BamFile, StreamingBamFile

REF = "/root/reference/tests"
ENV = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))) + os.pathsep + os.environ.get("PYTHONPATH", ""),
    MDTPU_ENGINE="host")


def test_reg2bin_depth_matches_bai_scheme():
    rng = np.random.default_rng(7)
    for _ in range(500):
        beg = int(rng.integers(0, (1 << 29) - 200))
        end = beg + int(rng.integers(1, 3000))
        assert reg2bin_depth(beg, end, 14, 5) == reg2bin(beg, end)
    assert depth_for_length(1 << 29) == 5
    assert depth_for_length((1 << 29) + 1) == 6
    # depth-6 bins address the extended coordinate space
    assert reg2bin_depth(1 << 29, (1 << 29) + 100, 14, 6) > 0


def test_csi_build_parse_min_voffset(tmp_path):
    """A .csi built for a reference fixture must resolve min_voffset to a
    seek point at/before the BAI's for every query position (the BAI's
    linear index is the tight bound; CSI's bin walk may be looser but
    never later — later would skip reads)."""
    import shutil

    shutil.copy(f"{REF}/cg_aln.bam", tmp_path / "a.bam")
    bam = BamFile(str(tmp_path / "a.bam"))
    build_bai(bam, str(tmp_path / "a.bam.bai"))
    build_csi(bam, str(tmp_path / "a.bam.csi"))
    bai = BaiFile(str(tmp_path / "a.bam.bai"))
    csi = CsiFile(str(tmp_path / "a.bam.csi"))
    assert csi.min_shift == 14 and csi.depth == 5
    for start in (0, 10, 50, 90, 100):
        b = bai.min_voffset(0, start)
        c = csi.min_voffset(0, start)
        assert c <= b or b == 0, (start, b, c)


def test_streaming_with_csi_only(tmp_path):
    """StreamingBamFile must accept a .csi when no .bai exists, and the
    windowed decode must match the in-memory decode."""
    import shutil

    shutil.copy(f"{REF}/cg_aln.bam", tmp_path / "a.bam")
    mem = BamFile(str(tmp_path / "a.bam"))
    build_csi(mem, str(tmp_path / "a.bam.csi"))
    sf = StreamingBamFile(str(tmp_path / "a.bam"))
    view = sf.window_soa(0, 0, 101)
    idx = view.overlapping(0, 0, 101)
    midx = mem.overlapping(0, 0, 101)
    assert len(idx) == len(midx)
    np.testing.assert_array_equal(view.pos[idx], mem.pos[midx])


def _write_big_fa(path, clen, island_at, island):
    """A `clen`-base contig, 'A' filler with a known island, written in
    large chunks (no per-base python)."""
    line = 1 << 20
    with open(path, "w") as fh:
        fh.write(">big\n")
        written = 0
        while written < clen:
            n = min(line, clen - written)
            if written <= island_at < written + n:
                off = island_at - written
                chunk = "A" * off + island
                chunk += "A" * (n - len(chunk))
                chunk = chunk[:n]
            else:
                chunk = "A" * n
            fh.write(chunk + "\n")
            written += n


@pytest.mark.slow
def test_extract_beyond_2pow29_contig(tmp_path):
    """The headline CSI scenario: a contig longer than 2^29 with reads at
    coordinates BAI cannot index. ensure_bam_index must auto-build a .csi
    (not a .bai), and extract -r over the high region must produce the
    hand-computed calls."""
    clen = (1 << 29) + 2_000_000
    island_at = (1 << 29) + 1_000_000
    island = "ACGTACGTAC"
    fa = tmp_path / "big.fa"
    _write_big_fa(fa, clen, island_at, island)
    # one OT read exactly on the island (flag 0 → OT; C at +1 and +5 kept)
    write_bam(tmp_path / "r.bam", [("big", clen)], [
        dict(qname="r1", flag=0, tid=0, pos=island_at, seq=island,
             mtid=-1, mpos=-1),
    ])
    r = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.cli", "extract",
         "-r", f"big:{island_at - 1000}-{island_at + 2000}",
         "big.fa", "r.bam", "-o", "o"],
        cwd=tmp_path, env=ENV, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "r.bam.csi").exists(), "expected auto-built CSI"
    assert not (tmp_path / "r.bam.bai").exists()
    got = [l.split("\t") for l in
           open(tmp_path / "o_CpG.bedGraph").read().splitlines()[1:]]
    assert got == [
        ["big", str(island_at + 1), str(island_at + 2), "100", "1", "0"],
        ["big", str(island_at + 5), str(island_at + 6), "100", "1", "0"],
    ]
    # the built CSI must really index the high coordinates: stream a
    # window over the island via the .csi
    sf = StreamingBamFile(str(tmp_path / "r.bam"))
    view = sf.window_soa(0, island_at - 10, island_at + 50)
    assert len(view.overlapping(0, island_at - 10, island_at + 50)) == 1
