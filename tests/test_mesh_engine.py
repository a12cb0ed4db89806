"""Mesh-engine e2e: the production extract CLI over the (dp, sp) shard_map
backend (MDTPU_ENGINE=mesh) must be byte-identical to the host engine on
every reference CI scenario — the multi-device analogue of the
reference's thread-count invariance (extract.c:514-535's ordered flush).

Runs on the virtual 8-device CPU mesh (conftest XLA_FLAGS)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_ENV = dict(
    os.environ,
    PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    JAX_PLATFORMS="cpu",
    XLA_FLAGS="--xla_force_host_platform_device_count=8",
)


def run_both(fixture_dir, args, outputs):
    """Run `extract args` under host and mesh engines in sibling dirs with
    the SAME -o prefix, and byte-compare every output file."""
    for engine in ("host", "mesh"):
        d = fixture_dir / engine
        d.mkdir(exist_ok=True)
        for name in os.listdir(fixture_dir):
            p = fixture_dir / name
            if p.is_file():
                os.link(p, d / name)
        env = dict(BASE_ENV, MDTPU_ENGINE=engine)
        r = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu.cli", "extract"] + args,
            cwd=d, env=env, capture_output=True, text=True,
        )
        assert r.returncode == 0, (engine, r.stderr)
    for out in outputs:
        a = (fixture_dir / "host" / out).read_bytes()
        b = (fixture_dir / "mesh" / out).read_bytes()
        assert a == b, f"{out}: mesh output diverges from host"
        assert len(a) > 0 or out.endswith(".bedGraph")


def test_mesh_cg_basic(fixture_dir):
    run_both(fixture_dir, ["cg100.fa", "cg_aln.bam", "-q", "2", "-o", "m1"],
             ["m1_CpG.bedGraph"])


def test_mesh_ct_paired_overlaps(fixture_dir):
    run_both(fixture_dir, ["ct100.fa", "ct_aln.bam", "-q", "2", "-o", "m2"],
             ["m2_CpG.bedGraph"])


def test_mesh_all_contexts_counts(fixture_dir):
    run_both(fixture_dir,
             ["--CHG", "--CHH", "--counts", "chgchh.fa", "chgchh_aln.bam",
              "-o", "m3"],
             ["m3_CpG.counts.bedGraph", "m3_CHG.counts.bedGraph",
              "m3_CHH.counts.bedGraph"])


def test_mesh_variant_filtering(fixture_dir):
    run_both(fixture_dir,
             ["--minOppositeDepth", "3", "--maxVariantFrac", "0.25",
              "cg100.fa", "cg_with_variants.bam", "-q", "2", "-o", "m4"],
             ["m4_CpG.bedGraph"])


def test_mesh_trimming_and_merge(fixture_dir):
    run_both(fixture_dir,
             ["--nOT", "50,50,40,40", "--mergeContext", "cg100.fa",
              "cg_aln.bam", "-q", "2", "-o", "m5"],
             ["m5_CpG.bedGraph"])


def test_mesh_bed_keep_strand(fixture_dir):
    bed = fixture_dir / "stranded.bed"
    bed.write_text("chrCG\t2\t21\tx\t0\t-\nchrCG\t40\t81\ty\t0\t+\n")
    run_both(fixture_dir,
             ["-l", "stranded.bed", "--keepStrand", "cg100.fa", "cg_aln.bam",
              "-q", "2", "-o", "m6"],
             ["m6_CpG.bedGraph"])


def test_mesh_conversion_efficiency(fixture_dir):
    run_both(fixture_dir,
             ["--minConversionEfficiency", "0.9", "--CHH", "--CHG",
              "chgchh.fa", "chgchh_aln.bam", "-o", "m7"],
             ["m7_CpG.bedGraph", "m7_CHG.bedGraph", "m7_CHH.bedGraph"])


def test_mesh_threaded_byte_identical(fixture_dir):
    """-@ 4 over the mesh backend (concurrent device dispatch, ordered
    drain) must not change a byte vs the single-threaded host run."""
    run_both(fixture_dir,
             ["-@", "4", "--chunkSize", "40", "cg100.fa", "cg_aln.bam",
              "-q", "2", "-o", "m9"],
             ["m9_CpG.bedGraph"])


def test_mesh_cytosine_report(fixture_dir):
    run_both(fixture_dir,
             ["--cytosine_report", "--CHH", "--CHG", "cg100.fa", "cg_aln.bam",
              "-q", "2", "-o", "m8"],
             ["m8.cytosine_report.txt"])
