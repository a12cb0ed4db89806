"""CRAM 3.1 support (VERDICT r3 missing #1): the rANS Nx16 block codec
(io/ransnx16.py) with its PACK/RLE/CAT/STRIPE/X32 transforms, the 3.1
version gate, and actionable errors for the 3.1 codecs this reader does
not implement (arith/fqzcomp/name-tokeniser).

The integration gate is the foreign-dialect fixture from
test_cram_foreign.py re-emitted as a 3.1 container whose core/external
blocks are Nx16-compressed under a spread of transform flags; every
decoded field must equal the hand-computed truth.
"""
import struct
import zlib

import numpy as np
import pytest

from methyldackel_tpu.io import ransnx16 as rx
from methyldackel_tpu.io.cram import (CramFile, RANSNX16, TOK3,
                                      EXTERNAL_DATA, _decompress)
from test_cram_foreign import _build_foreign_cram


FLAGSETS = [0, rx.ORDER1, rx.PACK, rx.RLE, rx.PACK | rx.RLE,
            rx.ORDER1 | rx.RLE, rx.X32, rx.X32 | rx.ORDER1, rx.CAT,
            rx.STRIPE, rx.STRIPE | rx.ORDER1, rx.NOSZ,
            rx.NOSZ | rx.ORDER1, rx.PACK | rx.ORDER1,
            rx.X32 | rx.PACK | rx.RLE]


def _cases(rng):
    return [
        b"", b"A", b"ACGT" * 200,
        bytes(rng.integers(0, 4, 4096, dtype=np.uint8) + 65),
        bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
        b"A" * 900 + b"B" * 3 + b"C" * 400,
        bytes(np.repeat(rng.integers(0, 10, 200),
                        rng.integers(1, 40, 200)).astype(np.uint8)),
        bytes([0]) * 511,  # single symbol, odd length
    ]


@pytest.mark.parametrize("flags", FLAGSETS)
def test_ransnx16_roundtrip(flags):
    rng = np.random.default_rng(3)
    for raw in _cases(rng):
        enc = rx.compress(raw, flags)
        ulen = len(raw) if flags & rx.NOSZ else None
        assert rx.uncompress(enc, ulen) == raw


def test_ransnx16_fuzz_roundtrip():
    rng = np.random.default_rng(17)
    for _ in range(40):
        n = int(rng.integers(0, 5000))
        nsym = int(rng.integers(1, 257))
        raw = bytes(rng.integers(0, nsym, n, dtype=np.uint8))
        flags = int(rng.choice(FLAGSETS))
        enc = rx.compress(raw, flags)
        ulen = n if flags & rx.NOSZ else None
        assert rx.uncompress(enc, ulen) == raw, (n, nsym, hex(flags))


def test_cram31_foreign_fixture_decodes_exactly(tmp_path):
    """The 3.1 container (Nx16 blocks, varied transforms) decodes
    field-exactly — same truth table as the 3.0 foreign-dialect test."""
    path, fa = _build_foreign_cram(tmp_path, v31=True)
    cf = CramFile(path, fasta=fa)
    assert cf.n_reads == 4
    assert list(cf.qname) == ["pairA", "pairA", "single", "unm"]
    np.testing.assert_array_equal(cf.flag, [0x63, 0x93, 0x11 | 0x20, 0x4])
    np.testing.assert_array_equal(cf.pos, [0, 4, 12, 13])
    np.testing.assert_array_equal(cf.mapq, [30, 31, 42, 0])
    np.testing.assert_array_equal(cf.mtid, [0, 0, 0, -1])
    np.testing.assert_array_equal(cf.mpos, [4, 0, 19, -1])

    from methyldackel_tpu.io.cram import _CODE2ASCII

    def seq_str(i):
        o0, o1 = cf.offsets[i], cf.offsets[i + 1]
        return bytes(_CODE2ASCII[cf.seq_flat[o0:o1]]).decode()

    assert [seq_str(i) for i in range(4)] == [
        "ACGCACGT", "ACGTGTAC", "ACGGGTTT", "ACGTNN"]
    np.testing.assert_array_equal(
        cf.qual_flat[cf.offsets[0] : cf.offsets[1]], np.arange(30, 38))


def test_cram31_extract_cli(tmp_path):
    """extract runs end-to-end over a 3.1 container."""
    import os
    import subprocess
    import sys

    path, fa = _build_foreign_cram(tmp_path, v31=True)
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


def test_cram_version_gate(tmp_path):
    path, fa = _build_foreign_cram(tmp_path, v31=True)
    raw = bytearray(open(path, "rb").read())
    raw[5] = 2  # 3.2
    bad = tmp_path / "v32.cram"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="3.0 and 3.1"):
        CramFile(str(bad), fasta=fa)


def test_genuinely_unknown_codec_rejected():
    """Methods 5-8 now all decode (io/ransnx16, io/arith, io/fqzcomp,
    io/tok3 — tests/test_cram31_codecs.py); only methods outside the
    spec's table stay hard errors."""
    with pytest.raises(ValueError, match="unsupported block compression"):
        _decompress(9, b"\x00\x01\x02", 3)
    # malformed method-6/7/8 payloads fail loudly, not with silent output
    with pytest.raises(ValueError):
        _decompress(TOK3, b"\x03\x01\x07", 3)
    with pytest.raises(ValueError):
        _decompress(7, b"\x00", 1)


def test_ransnx16_corrupt_streams_raise_valueerror():
    """Truncated/corrupted streams must raise ValueError (never IndexError,
    hangs, or huge allocations) — the CRAM block CRC normally rejects them
    first, but the codec's own failure mode should be clean."""
    rng = np.random.default_rng(0)
    raw = bytes(rng.integers(0, 64, 3000, dtype=np.uint8))
    for fl in (0, rx.ORDER1, rx.PACK, rx.RLE, rx.STRIPE):
        enc = bytearray(rx.compress(raw, fl))
        for trial in range(40):
            e = bytearray(enc)
            op = trial % 3
            if op == 0 and len(e) > 4:
                del e[int(rng.integers(1, len(e))):]
            elif op == 1:
                e[int(rng.integers(0, len(e)))] ^= 0xFF
            else:
                e[int(rng.integers(0, len(e)))] = int(rng.integers(0, 256))
            try:
                rx.uncompress(bytes(e))
            except ValueError:
                pass  # the only acceptable failure mode
