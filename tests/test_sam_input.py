"""SAM text input parity (VERDICT r3 missing #3): htslib's hts_open
auto-detects SAM, so the reference binary accepts `.sam` even though its
docs say BAM/CRAM (main.c:31). extract over a SAM must be byte-identical
to the same alignments as BAM, for every subcommand surface we route
through open_alignment."""
import os
import subprocess
import sys

import numpy as np

from methyldackel_tpu.utils.bam_writer import write_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           MDTPU_ENGINE="host")


def md(args, cwd):
    return subprocess.run([sys.executable, "-m", "methyldackel_tpu.cli"]
                         + args, cwd=cwd, env=ENV, capture_output=True,
                         text=True)


def _mk_inputs(tmp_path):
    rng = np.random.default_rng(21)
    glen = 500
    ref = "".join(rng.choice(list("ACGT"), glen))
    (tmp_path / "g.fa").write_text(f">c\n{ref}\n")
    recs = []
    for k in range(40):
        p = int(rng.integers(0, glen - 60))
        seq = ref[p : p + 50]
        if k % 2:
            seq = seq.replace("C", "T")
        recs.append(dict(qname=f"r{k}", flag=0 if k % 3 else 0x10, tid=0,
                         pos=p, seq=seq, mtid=-1, mpos=-1))
    recs.sort(key=lambda r: r["pos"])
    write_bam(tmp_path / "r.bam", [("c", glen)], recs)
    # the same alignments as SAM text
    lines = ["@HD\tVN:1.6\tSO:coordinate", f"@SQ\tSN:c\tLN:{glen}"]
    for r in recs:
        qual = "I" * len(r["seq"])
        lines.append("\t".join([
            r["qname"], str(r["flag"]), "c", str(r["pos"] + 1), "40",
            f"{len(r['seq'])}M", "*", "0", "0", r["seq"], qual]))
    (tmp_path / "r.sam").write_text("\n".join(lines) + "\n")


def rows(path):
    return [l for l in open(path) if not l.startswith("track")]


def test_sam_extract_matches_bam(tmp_path):
    _mk_inputs(tmp_path)
    r1 = md(["extract", "--CHH", "--CHG", "g.fa", "r.bam", "-o", "b"],
            tmp_path)
    assert r1.returncode == 0, r1.stderr
    r2 = md(["extract", "--CHH", "--CHG", "g.fa", "r.sam", "-o", "s"],
            tmp_path)
    assert r2.returncode == 0, r2.stderr
    for ctx in ("CpG", "CHG", "CHH"):
        assert rows(tmp_path / f"b_{ctx}.bedGraph") == \
            rows(tmp_path / f"s_{ctx}.bedGraph"), ctx
    assert len(rows(tmp_path / "b_CpG.bedGraph")) > 0


def test_sam_perread_matches_bam(tmp_path):
    _mk_inputs(tmp_path)
    r1 = md(["perRead", "g.fa", "r.bam", "-o", "pb.tsv"], tmp_path)
    assert r1.returncode == 0, r1.stderr
    r2 = md(["perRead", "g.fa", "r.sam", "-o", "ps.tsv"], tmp_path)
    assert r2.returncode == 0, r2.stderr
    assert (tmp_path / "pb.tsv").read_text() == \
        (tmp_path / "ps.tsv").read_text()


def test_sam_gz_input(tmp_path):
    import gzip

    _mk_inputs(tmp_path)
    with open(tmp_path / "r.sam", "rb") as fh:
        data = fh.read()
    with gzip.open(tmp_path / "r.sam.gz", "wb") as fh:
        fh.write(data)
    r1 = md(["extract", "g.fa", "r.sam", "-o", "a"], tmp_path)
    r2 = md(["extract", "g.fa", "r.sam.gz", "-o", "z"], tmp_path)
    assert r1.returncode == 0 and r2.returncode == 0, (r1.stderr, r2.stderr)
    assert rows(tmp_path / "a_CpG.bedGraph") == rows(tmp_path / "z_CpG.bedGraph")


def test_sam_indel_cigar_matches_bam(tmp_path):
    """SAM rows with I/D/S CIGARs expand refpos identically to BAM."""
    rng = np.random.default_rng(8)
    glen = 300
    ref = "".join(rng.choice(list("ACGT"), glen))
    (tmp_path / "g.fa").write_text(f">c\n{ref}\n")
    recs = [
        dict(qname="del", flag=0, tid=0, pos=10, seq=ref[10:30] + ref[32:42],
             cigar="20M2D10M", mtid=-1, mpos=-1),
        dict(qname="ins", flag=0, tid=0, pos=60,
             seq=ref[60:70] + "GGGG" + ref[70:80],
             cigar="10M4I10M", mtid=-1, mpos=-1),
        dict(qname="clip", flag=0, tid=0, pos=120, seq="TTTT" + ref[120:140],
             cigar="4S20M", mtid=-1, mpos=-1),
    ]
    write_bam(tmp_path / "r.bam", [("c", glen)], recs)
    lines = ["@HD\tVN:1.6\tSO:coordinate", f"@SQ\tSN:c\tLN:{glen}"]
    for r in recs:
        lines.append("\t".join([r["qname"], "0", "c", str(r["pos"] + 1),
                                "40", r["cigar"], "*", "0", "0", r["seq"],
                                "I" * len(r["seq"])]))
    (tmp_path / "r.sam").write_text("\n".join(lines) + "\n")
    r1 = md(["extract", "--CHH", "--CHG", "-q", "0", "g.fa", "r.bam",
             "-o", "b"], tmp_path)
    r2 = md(["extract", "--CHH", "--CHG", "-q", "0", "g.fa", "r.sam",
             "-o", "s"], tmp_path)
    assert r1.returncode == 0 and r2.returncode == 0, (r1.stderr, r2.stderr)
    for ctx in ("CpG", "CHG", "CHH"):
        assert rows(tmp_path / f"b_{ctx}.bedGraph") == \
            rows(tmp_path / f"s_{ctx}.bedGraph"), ctx
