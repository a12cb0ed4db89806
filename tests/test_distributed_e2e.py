"""Multi-host end-to-end determinism: the extract output must be
byte-invariant to the host count (the DCN analogue of the reference's
thread-count invariance; SURVEY §5). Hosts are simulated as independent
processes via MDTPU_NUM_HOSTS/MDTPU_HOST_ID, each owning the window residue
class w % n_hosts == h, writing per-window shards that merge-shards
reassembles in window order."""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from methyldackel_tpu.utils.bam_writer import write_bam

ENV = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
           MDTPU_ENGINE=os.environ.get("MDTPU_ENGINE", "host"))


def md(args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.cli"] + args,
        cwd=cwd, env=dict(ENV, **env), capture_output=True, text=True,
    )


def _make_input(root):
    """Two contigs, reads spread over many 50 bp windows."""
    rng = np.random.default_rng(7)
    glen = 400
    bases = np.array(list("ACGT"))
    contigs = {}
    for name in ("chrA", "chrB"):
        contigs[name] = "".join(rng.choice(bases, glen))
    with open(root / "g.fa", "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name}\n{seq}\n")
    recs = []
    for tid, (name, seq) in enumerate(contigs.items()):
        for i in range(0, glen - 60, 7):
            # fully methylated top-strand read pair over [i, i+40)
            s = seq[i:i + 40]
            recs.append(dict(qname=f"r{tid}_{i}", flag=99, tid=tid, pos=i,
                             cigar="40M", seq=s, qual=30,
                             mpos=i + 20, tlen=60))
            s2 = seq[i + 20:i + 60]
            recs.append(dict(qname=f"r{tid}_{i}", flag=147, tid=tid,
                             pos=i + 20, cigar="40M", seq=s2, qual=30,
                             mpos=i, tlen=-60))
    refs = [(n, glen) for n in contigs]
    write_bam(root / "r.bam", refs, recs)


def _run_single(root, outdir, extra=()):
    outdir.mkdir(exist_ok=True)
    r = md(["extract", "--chunkSize", "50", "-q", "0", "-p", "1",
            *extra, "-o", "out", "../g.fa", "../r.bam"], outdir)
    assert r.returncode == 0, r.stderr


def _run_hosts(root, outdir, n_hosts, extra=()):
    outdir.mkdir(exist_ok=True)
    for h in range(n_hosts):
        r = md(["extract", "--chunkSize", "50", "-q", "0", "-p", "1",
                *extra, "-o", "out", "../g.fa", "../r.bam"], outdir,
               MDTPU_NUM_HOSTS=str(n_hosts), MDTPU_HOST_ID=str(h))
        assert r.returncode == 0, r.stderr
    paths = [str(p) for p in outdir.iterdir() if p.suffix == ".bedGraph"
             or p.name.endswith(".methylKit")
             or p.name.endswith("cytosine_report.txt")]
    r = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.parallel.distributed",
         "merge-shards", *paths], cwd=outdir, env=ENV,
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    # every shard consumed
    leftovers = [p.name for p in outdir.iterdir() if ".w" in p.name]
    assert not leftovers, leftovers


def test_multihost_byte_invariance(tmp_path):
    _make_input(tmp_path)
    _run_single(tmp_path, tmp_path / "single")
    for n_hosts in (2, 3):
        d = tmp_path / f"hosts{n_hosts}"
        _run_hosts(tmp_path, d, n_hosts)
        a = (tmp_path / "single" / "out_CpG.bedGraph").read_bytes()
        b = (d / "out_CpG.bedGraph").read_bytes()
        assert a == b, f"n_hosts={n_hosts} output differs"


def test_multihost_all_contexts_and_merge(tmp_path):
    _make_input(tmp_path)
    extra = ("--CHG", "--CHH", "--mergeContext")
    _run_single(tmp_path, tmp_path / "single", extra)
    d = tmp_path / "hosts3"
    _run_hosts(tmp_path, d, 3, extra)
    for ctx in ("CpG", "CHG", "CHH"):
        a = (tmp_path / "single" / f"out_{ctx}.bedGraph").read_bytes()
        b = (d / f"out_{ctx}.bedGraph").read_bytes()
        assert a == b, ctx


def test_multihost_cytosine_report(tmp_path):
    _make_input(tmp_path)
    extra = ("--cytosine_report",)
    _run_single(tmp_path, tmp_path / "single", extra)
    d = tmp_path / "hosts2"
    _run_hosts(tmp_path, d, 2, extra)
    a = (tmp_path / "single" / "out.cytosine_report.txt").read_bytes()
    b = (d / "out.cytosine_report.txt").read_bytes()
    assert a == b


def test_multihost_perread(tmp_path):
    _make_input(tmp_path)
    single = tmp_path / "single"
    single.mkdir()
    r = md(["perRead", "--chunkSize", "50", "-q", "0", "-p", "1",
            "-o", "pr.txt", "../g.fa", "../r.bam"], single)
    assert r.returncode == 0, r.stderr
    d = tmp_path / "hosts3"
    d.mkdir()
    for h in range(3):
        r = md(["perRead", "--chunkSize", "50", "-q", "0", "-p", "1",
                "-o", "pr.txt", "../g.fa", "../r.bam"], d,
               MDTPU_NUM_HOSTS="3", MDTPU_HOST_ID=str(h))
        assert r.returncode == 0, r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "methyldackel_tpu.parallel.distributed",
         "merge-shards", "pr.txt"], cwd=d, env=ENV,
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    a = (single / "pr.txt").read_bytes()
    assert a and a == (d / "pr.txt").read_bytes()


def test_multihost_perread_requires_o(tmp_path):
    _make_input(tmp_path)
    r = md(["perRead", "../g.fa", "../r.bam"], tmp_path,
           MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID="0")
    assert r.returncode != 0
    assert "requires -o" in r.stderr


def test_multihost_mbias(tmp_path):
    _make_input(tmp_path)
    single = tmp_path / "single"
    single.mkdir()
    r = md(["mbias", "--txt", "--noSVG", "--chunkSize", "50", "-q", "0",
            "-p", "1", "../g.fa", "../r.bam"], single)
    assert r.returncode == 0, r.stderr
    d = tmp_path / "hosts2"
    d.mkdir()
    for h in range(2):
        rh = md(["mbias", "--txt", "--noSVG", "--chunkSize", "50", "-q", "0",
                 "-p", "1", "../g.fa", "../r.bam"], d,
                MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID=str(h))
        assert rh.returncode == 0, rh.stderr
        assert rh.stdout == ""  # no rendering until finalize
    rf = md(["mbias", "--txt", "--noSVG", "--chunkSize", "50", "-q", "0",
             "-p", "1", "../g.fa", "../r.bam"], d, MDTPU_MBIAS_FINALIZE="1")
    assert rf.returncode == 0, rf.stderr
    assert rf.stdout == r.stdout
    assert not list(d.glob("*.npy"))


def test_multihost_nonzero_host_writes_no_final_files(tmp_path):
    _make_input(tmp_path)
    d = tmp_path / "h1only"
    d.mkdir()
    r = md(["extract", "--chunkSize", "50", "-q", "0", "-p", "1",
            "-o", "out", "../g.fa", "../r.bam"], d,
           MDTPU_NUM_HOSTS="2", MDTPU_HOST_ID="1")
    assert r.returncode == 0, r.stderr
    assert not (d / "out_CpG.bedGraph").exists()
    assert any(".w" in p.name for p in d.iterdir())
