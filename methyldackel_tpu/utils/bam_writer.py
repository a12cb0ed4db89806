"""Minimal BAM writer for synthetic inputs (tests, chip_smoke.py)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
_CODE = {"=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6, "V": 7,
         "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13, "B": 14, "N": 15}
_CODE_LUT = np.zeros(256, np.uint8)
for _ch, _c in _CODE.items():
    _CODE_LUT[ord(_ch)] = _CODE_LUT[ord(_ch.lower())] = _c


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compress(payload, 6)[2:-4]
    out = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
    out += struct.pack("<H", len(comp) + 25)
    out += comp
    out += struct.pack("<I", zlib.crc32(payload))
    out += struct.pack("<I", len(payload))
    return out


_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def parse_cigar(cig: str):
    out = []
    n = ""
    for ch in cig:
        if ch.isdigit():
            n += ch
        else:
            out.append((int(n) << 4) | _OPS[ch])
            n = ""
    return out


def write_bam(path, refs, records):
    """refs: [(name, length)]; records: dicts with qname, flag, tid, pos,
    mapq, cigar (string), seq (string, or uint8 array of 4-bit base codes),
    qual (list[int], bytes, uint8 array or int), tags (optional bytes)."""
    hdr = b"BAM\x01"
    text = ("".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs) + "\x00").encode()
    hdr += struct.pack("<i", len(text)) + text
    hdr += struct.pack("<i", len(refs))
    for n, l in refs:
        nb = n.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)

    body = bytearray(hdr)
    for r in records:
        qname = r["qname"].encode() + b"\x00"
        seq = r["seq"]
        codes = (_CODE_LUT[np.frombuffer(seq.encode(), np.uint8)]
                 if isinstance(seq, str) else np.asarray(seq, np.uint8))
        l_seq = len(codes)
        cig = parse_cigar(r.get("cigar", f"{l_seq}M"))
        q = r.get("qual", 40)
        quals = bytes([q] * l_seq) if isinstance(q, int) else bytes(q)
        if l_seq % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        packed = ((codes[0::2] << 4) | codes[1::2]).tobytes()
        rec = struct.pack(
            "<iiBBHHHiiii", r.get("tid", 0), r["pos"], len(qname),
            r.get("mapq", 40), 4681, len(cig), r["flag"], l_seq,
            r.get("mtid", r.get("tid", 0)), r.get("mpos", r["pos"]),
            r.get("tlen", 0),
        )
        rec += qname + b"".join(struct.pack("<I", c) for c in cig)
        rec += packed + quals + r.get("tags", b"")
        body += struct.pack("<i", len(rec)) + rec

    blocks = bytearray()
    for i in range(0, len(body), 60000):
        blocks += _bgzf_block(bytes(body[i : i + 60000]))
    blocks += _EOF
    with open(path, "wb") as fh:
        fh.write(bytes(blocks))


def cigar_from_refpos(rp) -> str:
    """CIGAR of one read from its per-base reference positions (-1 = an
    inserted or soft-clipped base, -2 = past the read): leading/trailing
    unaligned bases are soft clips, interior ones insertions, and a jump in
    reference position between aligned bases a deletion."""
    rp = [int(x) for x in rp if x != -2]
    aligned = [j for j, x in enumerate(rp) if x >= 0]
    if not aligned:
        return f"{len(rp)}S" if rp else ""
    first, last = aligned[0], aligned[-1]
    ops = []

    def put(op, n):
        if n:
            if ops and ops[-1][0] == op:
                ops[-1][1] += n
            else:
                ops.append([op, n])

    put("S", first)
    prev = None
    for j in range(first, last + 1):
        x = rp[j]
        if x < 0:
            put("I", 1)
            continue
        if prev is not None and x > prev + 1:
            put("D", x - prev - 1)
        put("M", 1)
        prev = x
    put("S", len(rp) - 1 - last)
    return "".join(f"{n}{op}" for op, n in ops)


def batch_records(batch, order=None):
    """BAM records (write_bam dicts) for the rows of a ReadBatch, in
    `order` (default: as stored). CIGARs come from the rows' reference
    positions; pos is the first aligned base."""
    n, L = batch.seq.shape
    order = np.arange(n) if order is None else order
    recs = []
    for i in order:
        lq = int(batch.l_qseq[i])
        rp = batch.refpos[i, :lq]
        simple = (lq > 0 and bool((rp >= 0).all())
                  and rp[-1] == rp[0] + lq - 1)
        recs.append({
            "qname": str(batch.qname[i]), "flag": int(batch.flag[i]),
            "tid": int(batch.tid[i]), "pos": int(batch.pos[i]),
            "mapq": int(batch.mapq[i]),
            "cigar": f"{lq}M" if simple else cigar_from_refpos(rp),
            "seq": batch.seq[i, :lq], "qual": batch.qual[i, :lq].tobytes(),
            "mtid": int(batch.mtid[i]), "mpos": int(batch.mpos[i]),
        })
    return recs
