"""Feature-surface e2e tests: BED regions (-l/--keepStrand), region strings
(-r), mappability filtering (-M bigWig / -B BBM, -O/-N BBM output)."""
import os
import subprocess
import sys

import numpy as np

from util_bigwig import write_bigwig

ENV = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
           MDTPU_ENGINE=os.environ.get("MDTPU_ENGINE", "host"))
REF = "/root/reference/tests"


def md(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.cli"] + args,
        cwd=cwd, env=ENV, capture_output=True, text=True,
    )


def positions(path):
    return [int(l.split("\t")[1]) for l in open(path) if not l.startswith("track")]


def test_region_option(fixture_dir):
    r = md(["extract", "-r", "chrCG:11-40", "cg100.fa", "cg_aln.bam", "-q", "2",
            "-o", "tr1"], fixture_dir)
    assert r.returncode == 0, r.stderr
    pos = positions(fixture_dir / "tr1_CpG.bedGraph")
    assert pos and all(10 <= p < 41 for p in pos)
    # region bounds: 1-based 11 → 0-based 10; end nudged by adjustBounds if
    # a CpG straddles (ref is cgcg…, so 0-based 39 is g → extended to 40)
    assert min(pos) == 10


def test_bed_option(fixture_dir):
    bed = fixture_dir / "regions.bed"
    bed.write_text("chrCG\t10\t21\nchrCG\t50\t61\n")
    r = md(["extract", "-l", "regions.bed", "cg100.fa", "cg_aln.bam", "-q", "2",
            "-o", "tb1"], fixture_dir)
    assert r.returncode == 0, r.stderr
    assert "Parsed 2 regions" in r.stderr
    pos = positions(fixture_dir / "tb1_CpG.bedGraph")
    assert pos
    for p in pos:
        assert (10 <= p < 21) or (50 <= p < 61), p


def test_bed_keep_strand(fixture_dir):
    bed = fixture_dir / "stranded.bed"
    # '-' region: only OB-strand reads counted; fixture reads are all OT
    bed.write_text("chrCG\t10\t21\tx\t0\t-\n")
    r = md(["extract", "-l", "stranded.bed", "--keepStrand", "cg100.fa",
            "cg_aln.bam", "-q", "2", "-o", "tb2"], fixture_dir)
    assert r.returncode == 0, r.stderr
    assert positions(fixture_dir / "tb2_CpG.bedGraph") == []
    # without --keepStrand the strand column is ignored
    r = md(["extract", "-l", "stranded.bed", "cg100.fa", "cg_aln.bam",
            "-q", "2", "-o", "tb3"], fixture_dir)
    assert positions(fixture_dir / "tb3_CpG.bedGraph") != []


def test_bigwig_mappability_filters_all(fixture_dir):
    # all-zero mappability → every read filtered → header only
    write_bigwig(fixture_dir / "map0.bw", "chrCG", np.zeros(100))
    r = md(["extract", "-M", "map0.bw", "cg100.fa", "cg_aln.bam", "-q", "2",
            "-o", "tm0"], fixture_dir)
    assert r.returncode == 0, r.stderr
    assert positions(fixture_dir / "tm0_CpG.bedGraph") == []


def test_bigwig_mappability_passes(fixture_dir):
    write_bigwig(fixture_dir / "map1.bw", "chrCG", np.ones(100))
    r = md(["extract", "-M", "map1.bw", "cg100.fa", "cg_aln.bam", "-q", "2",
            "-o", "tm1"], fixture_dir)
    assert r.returncode == 0, r.stderr
    assert len(positions(fixture_dir / "tm1_CpG.bedGraph")) == 48


def test_bbm_write_and_read(fixture_dir):
    vals = np.zeros(100)
    vals[40:60] = 1.0  # only the middle is mappable
    write_bigwig(fixture_dir / "mid.bw", "chrCG", vals)
    # write BBM alongside (-N name)
    r = md(["extract", "-M", "mid.bw", "-N", "mid", "cg100.fa", "cg_aln.bam",
            "-q", "2", "-o", "tmbw"], fixture_dir)
    assert r.returncode == 0, r.stderr
    assert os.path.exists(fixture_dir / "mid.bbm")
    n_bw = len(positions(fixture_dir / "tmbw_CpG.bedGraph"))
    # reads span the whole contig; 20 mappable bases >= default 15 → kept
    assert n_bw == 48

    # now -B: read the BBM back, same result
    r = md(["extract", "-B", "mid.bbm", "cg100.fa", "cg_aln.bam", "-q", "2",
            "-o", "tmbbm"], fixture_dir)
    assert r.returncode == 0, r.stderr
    assert len(positions(fixture_dir / "tmbbm_CpG.bedGraph")) == n_bw

    # raise the required mappable bases above the window → all filtered
    r = md(["extract", "-B", "mid.bbm", "-b", "30", "cg100.fa", "cg_aln.bam",
            "-q", "2", "-o", "tmb30"], fixture_dir)
    assert positions(fixture_dir / "tmb30_CpG.bedGraph") == []


def test_nobam_bbm_conversion(fixture_dir):
    """-O with only a bigWig converts to BBM and exits (extract.c:983-994)."""
    write_bigwig(fixture_dir / "conv.bw", "chrCG", np.ones(100) * 0.5)
    r = md(["extract", "-M", "conv.bw", "-N", "conv"], fixture_dir)
    assert r.returncode == 0, r.stderr
    from methyldackel_tpu.io.bbm import read_bbm
    names, lengths, values = read_bbm(str(fixture_dir / "conv.bbm"))
    assert names == ["chrCG"] and lengths == [100]
    assert (values[0] == 50).all()


# ------------------------------------------------------- bgzipped FASTA

def _bgzip_file(src, dst, block=4096):
    from methyldackel_tpu.utils.bam_writer import _bgzf_block, _EOF

    data = open(src, "rb").read()
    with open(dst, "wb") as fh:
        for i in range(0, len(data), block):
            fh.write(_bgzf_block(data[i : i + block]))
        fh.write(_EOF)


def test_bgzf_fasta_fetch_matches_plaintext(tmp_path):
    """FastaFile reads bgzip-compressed FASTA transparently (htslib faidx
    behavior, extract.c:381): same fetches, same .fai geometry."""
    from methyldackel_tpu.io.fasta import FastaFile

    src = os.path.join(REF, "cg100.fa")
    gz = str(tmp_path / "cg100.fa.gz")
    _bgzip_file(src, gz, block=37)  # tiny blocks: many-block ranges
    a = FastaFile(src)
    b = FastaFile(gz)
    assert a.names == b.names
    for name in a.names:
        assert a.seq_len(name) == b.seq_len(name)
        n = a.seq_len(name)
        for s, e in ((0, n - 1), (5, 20), (n - 3, n + 10), (0, 0)):
            np.testing.assert_array_equal(a.fetch(name, s, e),
                                          b.fetch(name, s, e))


def test_bgzf_fasta_extract_byte_identical(tmp_path):
    """extract on a bgzipped reference equals the plaintext run byte for
    byte."""
    import shutil

    for f in ("cg_aln.bam", "cg_aln.bam.bai"):
        if os.path.exists(os.path.join(REF, f)):
            shutil.copy(os.path.join(REF, f), tmp_path / f)
    _bgzip_file(os.path.join(REF, "cg100.fa"), str(tmp_path / "cg100.fa.gz"))
    shutil.copy(os.path.join(REF, "cg100.fa"), tmp_path / "cg100.fa")
    (tmp_path / "p").mkdir()
    (tmp_path / "z").mkdir()
    r = md(["extract", "-q", "2", "../cg100.fa", "../cg_aln.bam", "-o", "out"],
           tmp_path / "p")
    assert r.returncode == 0, r.stderr
    r = md(["extract", "-q", "2", "../cg100.fa.gz", "../cg_aln.bam", "-o",
            "out"], tmp_path / "z")
    assert r.returncode == 0, r.stderr
    a = (tmp_path / "p" / "out_CpG.bedGraph").read_bytes()
    b = (tmp_path / "z" / "out_CpG.bedGraph").read_bytes()
    assert a == b and len(a) > 0
