"""Edge-case hardening: inputs that crash sloppy implementations."""
import os
import subprocess
import sys

from methyldackel_tpu.utils.bam_writer import write_bam

ENV = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
           MDTPU_ENGINE=os.environ.get("MDTPU_ENGINE", "host"))


def md(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.cli"] + args,
        cwd=cwd, env=ENV, capture_output=True, text=True,
    )


def write_fa(path, seqs):
    with open(path, "w") as fh:
        for name, seq in seqs:
            fh.write(f">{name}\n{seq}\n")


def rows(path):
    return [l.rstrip("\n").split("\t") for l in open(path) if not l.startswith("track")]


def test_empty_bam(tmp_path):
    write_fa(tmp_path / "g.fa", [("c", "ACGTACGT")])
    write_bam(tmp_path / "r.bam", [("c", 8)], [])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == []


def test_unmapped_and_negative_tid(tmp_path):
    write_fa(tmp_path / "g.fa", [("c", "TTCGTTTT")])
    write_bam(tmp_path / "r.bam", [("c", 8)], [
        dict(qname="u", flag=0x4, tid=-1, pos=-1, seq="TTTT", mtid=-1, mpos=-1),
        dict(qname="m", flag=0, tid=0, pos=0, seq="TTCGTTTT", mtid=-1, mpos=-1),
    ])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == [["c", "2", "3", "100", "1", "0"]]


def test_n_bases_in_reference(tmp_path):
    # N counts as H (README.md:34): C-N-G is CHG, C-N-N is CHH, no CpGs.
    write_fa(tmp_path / "g.fa", [("c", "TTCNGTCNNT")])
    write_bam(tmp_path / "r.bam", [("c", 10)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="TTCNGTCNNT", mtid=-1, mpos=-1),
    ])
    r = md(["extract", "--CHG", "--CHH", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == []
    assert rows(tmp_path / "o_CHG.bedGraph") == [["c", "2", "3", "100", "1", "0"]]
    assert rows(tmp_path / "o_CHH.bedGraph") == [["c", "6", "7", "100", "1", "0"]]


def test_read_at_contig_end(tmp_path):
    # CpG at the very last two bases; C at final base is CHH (truncated)
    write_fa(tmp_path / "g.fa", [("c", "TTTTTTCG")])
    write_bam(tmp_path / "r.bam", [("c", 8)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="TTTTTTCG", mtid=-1, mpos=-1),
    ])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == [["c", "6", "7", "100", "1", "0"]]


def test_read_overhanging_contig_end(tmp_path):
    """Alignment claims bases beyond the contig (malformed but seen in the
    wild): out-of-reference positions must not crash or count."""
    write_fa(tmp_path / "g.fa", [("c", "TTCGTT")])
    write_bam(tmp_path / "r.bam", [("c", 6)], [
        dict(qname="r", flag=0, tid=0, pos=2, seq="CGTTTTTT", mtid=-1, mpos=-1),
    ])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == [["c", "2", "3", "100", "1", "0"]]


def test_all_n_read(tmp_path):
    write_fa(tmp_path / "g.fa", [("c", "TTCGTTTT")])
    write_bam(tmp_path / "r.bam", [("c", 8)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="NNNNNNNN", mtid=-1, mpos=-1),
    ])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == []


def test_mapq_255_and_phred_extremes(tmp_path):
    write_fa(tmp_path / "g.fa", [("c", "TTCGTTTT")])
    write_bam(tmp_path / "r.bam", [("c", 8)], [
        dict(qname="r", flag=0, tid=0, pos=0, seq="TTCGTTTT", mapq=255,
             qual=[0] * 8, mtid=-1, mpos=-1),
    ])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    # phred 0 < minPhred → no calls
    assert rows(tmp_path / "o_CpG.bedGraph") == []


def test_hard_clips_and_pad(tmp_path):
    write_fa(tmp_path / "g.fa", [("c", "TTCGTTTT")])
    write_bam(tmp_path / "r.bam", [("c", 8)], [
        dict(qname="r", flag=0, tid=0, pos=0, cigar="2H8M3H", seq="TTCGTTTT",
             mtid=-1, mpos=-1),
    ])
    r = md(["extract", "g.fa", "r.bam", "-o", "o"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert rows(tmp_path / "o_CpG.bedGraph") == [["c", "2", "3", "100", "1", "0"]]


def test_missing_files(tmp_path):
    r = md(["extract", "nope.fa", "nope.bam", "-o", "o"], tmp_path)
    assert r.returncode != 0


def test_perread_region_and_output_file(tmp_path):
    write_fa(tmp_path / "g.fa", [("c", "CG" * 20)])
    write_bam(tmp_path / "r.bam", [("c", 40)], [
        dict(qname="a", flag=0, tid=0, pos=0, seq="CG" * 5, mtid=-1, mpos=-1),
        dict(qname="b", flag=0, tid=0, pos=20, seq="CG" * 5, mtid=-1, mpos=-1),
    ])
    r = md(["perRead", "-r", "c:21-40", "-o", "out.tsv", "g.fa", "r.bam"], tmp_path)
    assert r.returncode == 0, r.stderr
    lines = open(tmp_path / "out.tsv").read().splitlines()
    assert len(lines) == 1 and lines[0].startswith("b\tc\t20\t100.000000")
