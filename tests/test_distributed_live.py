"""LIVE jax.distributed multi-host extract (no mocks): two real processes
initialize jax.distributed over loopback (CPU backend), split the genome
windows by residue class, barrier via multihost_utils, and host 0 merges
the shards — the full production DCN path (parallel/distributed.py),
byte-identical to a single-host run."""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_live_two_process_extract_byte_identical(tmp_path):
    from methyldackel_tpu.utils.simulate import write_synthetic_input
    from methyldackel_tpu.io.bam import BamFile
    from methyldackel_tpu.io.bai import build_bai

    fa, bam = write_synthetic_input(str(tmp_path), 1500, 100, 1 << 18,
                                    seed=9)
    build_bai(BamFile(bam), bam + ".bai")

    def run(outdir, extra_env):
        outdir.mkdir(exist_ok=True)
        env = dict(
            os.environ,
            PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            MDTPU_ENGINE="host",
            JAX_PLATFORMS="cpu",
            **extra_env,
        )
        # same -o prefix in every run (the bedGraph track header embeds it)
        return subprocess.Popen(
            [sys.executable, "-m", "methyldackel_tpu.cli", "extract",
             "--chunkSize", "32768", fa, bam, "-o", "out"],
            cwd=outdir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )

    # single-host truth
    p = run(tmp_path / "single", {})
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0, err

    # live 2-process jax.distributed job over loopback
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    procs = [
        run(tmp_path / "multi", {
            "JAX_COORDINATOR_ADDRESS": coord,
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
        })
        for pid in (0, 1)
    ]
    errs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, errs):
        assert p.returncode == 0, err

    a = (tmp_path / "single" / "out_CpG.bedGraph").read_bytes()
    b = (tmp_path / "multi" / "out_CpG.bedGraph").read_bytes()
    assert a == b and len(a) > 0
