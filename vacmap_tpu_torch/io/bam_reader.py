"""Minimal BAM input reader (BGZF + record decode), fully streaming.

The reference accepts .bam read files via pysam (vacmap:439-471),
re-reverse-complementing reverse-strand records.  This native reader
yields (name, seq, qual) in original read orientation the same way.

Both layers stream: BGZF blocks are read and inflated one at a time,
and records are decoded from a bounded rolling buffer — memory stays
O(block), so a 170 GB BAM input (the reference's own workload scale)
never lands in RAM.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Optional, Tuple

from ..seq import revcomp

_SEQ_CHARS = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"


def _bgzf_blocks(path: str) -> Iterator[bytes]:
    """Inflate BGZF blocks one at a time (constant memory)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if head[:2] != b"\x1f\x8b":
                raise ValueError("not a BGZF stream")
            xlen = struct.unpack("<H", head[10:12])[0]
            extra = f.read(xlen)
            bsize = None
            e = 0
            while e < len(extra):
                si1, si2, slen = extra[e], extra[e + 1], struct.unpack(
                    "<H", extra[e + 2 : e + 4]
                )[0]
                if si1 == 66 and si2 == 67:
                    bsize = struct.unpack("<H", extra[e + 4 : e + 6])[0] + 1
                e += 4 + slen
            if bsize is None:
                raise ValueError("missing BC subfield (not BGZF)")
            body = f.read(bsize - 12 - xlen)
            cdata = body[: len(body) - 8]
            out = zlib.decompress(cdata, -15)
            if out:
                yield out


class _StreamBuf:
    """Bounded rolling buffer over an iterator of byte blocks."""

    def __init__(self, blocks: Iterator[bytes]):
        self._blocks = blocks
        self._buf = bytearray()
        self._off = 0
        self.eof = False

    def _fill(self, need: int) -> bool:
        while len(self._buf) - self._off < need:
            try:
                self._buf += next(self._blocks)
            except StopIteration:
                self.eof = True
                return False
            # drop consumed prefix occasionally to bound memory
            if self._off > (1 << 20):
                del self._buf[: self._off]
                self._off = 0
        return True

    def read(self, n: int) -> Optional[bytes]:
        if not self._fill(n):
            return None
        out = bytes(self._buf[self._off : self._off + n])
        self._off += n
        return out


def read_bam(
    path: str, keep_secondary: bool = False
) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (name, seq, qual) per primary record, reverse-complemented
    back to original read orientation when the record is reverse-strand."""
    buf = _StreamBuf(_bgzf_blocks(path))
    magic = buf.read(4)
    if magic != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack("<i", buf.read(4))[0]
    buf.read(l_text)
    n_ref = struct.unpack("<i", buf.read(4))[0]
    for _ in range(n_ref):
        l_name = struct.unpack("<i", buf.read(4))[0]
        buf.read(l_name + 4)
    while True:
        head = buf.read(4)
        if head is None:
            break
        block_size = struct.unpack("<i", head)[0]
        rec = buf.read(block_size)
        if rec is None or len(rec) < 32:
            break
        (
            _refid, _pos, l_read_name, _mapq, _bin, n_cigar, flag, l_seq,
            _nref2, _npos, _tlen,
        ) = struct.unpack("<iiBBHHHiiii", rec[:32])
        p = 32
        name = rec[p : p + l_read_name - 1].decode()
        p += l_read_name
        p += 4 * n_cigar
        if flag & 0x100 or flag & 0x800:
            if not keep_secondary:
                continue
        if l_seq == 0:
            continue
        nbytes = (l_seq + 1) // 2
        seq_packed = rec[p : p + nbytes]
        p += nbytes
        qual_raw = rec[p : p + l_seq]
        chars = []
        for b in seq_packed:
            chars.append(_SEQ_CHARS[b >> 4])
            chars.append(_SEQ_CHARS[b & 0xF])
        seq = "".join(chars[:l_seq])
        qual = None
        if qual_raw and qual_raw[0] != 0xFF:
            qual = "".join(chr(q + 33) for q in qual_raw)
        if flag & 0x10:  # reverse strand: restore original orientation
            seq = revcomp(seq)
            if qual is not None:
                qual = qual[::-1]
        yield name, seq, qual
