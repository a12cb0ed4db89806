"""Long-CIGAR CG:B,I fallback (VERDICT r4 #7): BAM records whose real
CIGAR exceeds the 16-bit n_cigar field carry a kSmN sentinel
(l_seq"S" refspan"N") with the true ops in a CG:B,I aux tag (SAM spec
§4.2.2; htslib decodes it behind /root/reference/extract.c:399's pileup).
Both the native and the python decoders must substitute the real ops —
silent wrong answers otherwise (the sentinel makes every base soft-
clipped)."""
import struct
import subprocess
import sys
import os

import numpy as np

from methyldackel_tpu.utils.bam_writer import write_bam
from methyldackel_tpu.io.bam import BamFile

ENV = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))) + os.pathsep + os.environ.get("PYTHONPATH", ""),
    MDTPU_ENGINE="host")


def _cg_tag(cigar_ops):
    """CG:B,I aux bytes from [(length, op_char)] pairs."""
    opmap = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
             "=": 7, "X": 8}
    words = [(ln << 4) | opmap[op] for ln, op in cigar_ops]
    return (b"CGBI" + struct.pack("<i", len(words))
            + b"".join(struct.pack("<I", w) for w in words))


def _write_pair(tmp_path, use_native):
    seq = "ACGTACGTACGTACGTACGT"  # 20 bp
    real = [(8, "M"), (2, "D"), (12, "M")]  # 20 read bases, 22 ref span
    refspan = 22
    # plain record with the real CIGAR
    write_bam(tmp_path / "plain.bam", [("c", 100)], [
        dict(qname="p", flag=0, tid=0, pos=5, seq=seq, cigar="8M2D12M",
             mtid=-1, mpos=-1),
    ])
    # sentinel record: cigar = 20S 22N, real ops in CG:B,I
    write_bam(tmp_path / "cg.bam", [("c", 100)], [
        dict(qname="p", flag=0, tid=0, pos=5, seq=seq,
             cigar=f"{len(seq)}S{refspan}N", mtid=-1, mpos=-1,
             tags=_cg_tag(real)),
    ])
    env = {} if use_native else {"MDTPU_NO_NATIVE": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return BamFile(str(tmp_path / "plain.bam")), \
            BamFile(str(tmp_path / "cg.bam"))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _assert_equal_decode(plain, cg):
    np.testing.assert_array_equal(plain.refpos_flat, cg.refpos_flat)
    np.testing.assert_array_equal(plain.endpos, cg.endpos)
    np.testing.assert_array_equal(plain.cigar_flat, cg.cigar_flat)
    np.testing.assert_array_equal(plain.seq_flat, cg.seq_flat)


def test_cg_fallback_native(tmp_path):
    from methyldackel_tpu.io import native

    if not native.available():
        import pytest

        pytest.skip("native library not built")
    plain, cg = _write_pair(tmp_path, use_native=True)
    _assert_equal_decode(plain, cg)


def test_cg_fallback_python(tmp_path, monkeypatch):
    import methyldackel_tpu.io.bam as bam_mod

    # force the python decode path
    monkeypatch.setattr("methyldackel_tpu.io.native.bam_decode",
                        lambda *a, **k: None)
    plain, cg = _write_pair(tmp_path, use_native=False)
    _assert_equal_decode(plain, cg)


def test_cg_extract_e2e(tmp_path):
    """A CG-tagged BAM must pile up identically to the equivalent
    short-CIGAR BAM through the extract CLI."""
    ref = "TTTTTACGTACGTACGTACGTACGTACGTTTTTTTTTTTT"
    with open(tmp_path / "g.fa", "w") as fh:
        fh.write(f">c\n{ref}\n")
    _write_pair(tmp_path, use_native=True)
    outs = {}
    for name in ("plain", "cg"):
        r = subprocess.run(
            [sys.executable, "-m", "methyldackel_tpu.cli", "extract",
             "g.fa", f"{name}.bam", "-o", name],
            cwd=tmp_path, env=ENV, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        outs[name] = [l.split("\t") for l in open(
            tmp_path / f"{name}_CpG.bedGraph").read().splitlines()[1:]]
    assert outs["plain"] == outs["cg"]
    assert len(outs["plain"]) > 0
