"""Output writers: SAM text, BAM (native BGZF, no samtools dependency),
and coordinate-sorted BAM.

The reference pipes SAM text into external ``samtools view/sort``
subprocesses (output_functions.py:172-293).  This environment has no
samtools, so BAM encoding (BGZF blocks + binary records) is implemented
natively; when samtools IS present it is still preferred for .sorted.bam
(streaming external sort).
"""

from __future__ import annotations

import os
import re
import shutil
import struct
import subprocess
import sys
import zlib
from typing import Dict, List, Optional, TextIO

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_CIGAR_OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def bgzf_block(data: bytes) -> bytes:
    """One BGZF block (gzip member with BC extra field)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<HBBHH", 6, 66, 67, 2, bsize - 1)
    )
    return header + cdata + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))


class BgzfWriter:
    def __init__(self, fh):
        self.fh = fh
        self.buf = bytearray()
        self.coffset = 0  # file offset of the block the buffer starts in

    def tell_virtual(self) -> int:
        """BAM virtual file offset of the next byte written."""
        return (self.coffset << 16) | len(self.buf)

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 60000:
            block = bgzf_block(bytes(self.buf[:60000]))
            self.fh.write(block)
            self.coffset += len(block)
            del self.buf[:60000]

    def close(self):
        if self.buf:
            block = bgzf_block(bytes(self.buf))
            self.fh.write(block)
            self.coffset += len(block)
            self.buf = bytearray()
        self.fh.write(BGZF_EOF)
        self.fh.flush()


class BaiIndex:
    """BAI index accumulation: records must arrive coordinate-sorted."""

    def __init__(self, n_ref: int):
        self.bins = [dict() for _ in range(n_ref)]  # bin -> [chunks]
        self.linear = [dict() for _ in range(n_ref)]  # 16kb window -> min voffset

    def add(self, refid: int, beg: int, end: int, v_start: int, v_end: int):
        if refid < 0:
            return
        b = _reg2bin(beg, end)
        chunks = self.bins[refid].setdefault(b, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        for win in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
            cur = self.linear[refid].get(win)
            if cur is None or v_start < cur:
                self.linear[refid][win] = v_start

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(b"BAI\x01")
            f.write(struct.pack("<i", len(self.bins)))
            for refid in range(len(self.bins)):
                bins = self.bins[refid]
                f.write(struct.pack("<i", len(bins)))
                for b, chunks in bins.items():
                    f.write(struct.pack("<Ii", b, len(chunks)))
                    for cs, ce in chunks:
                        f.write(struct.pack("<QQ", cs, ce))
                lin = self.linear[refid]
                n_intv = (max(lin) + 1) if lin else 0
                f.write(struct.pack("<i", n_intv))
                prev = 0
                for w in range(n_intv):
                    v = lin.get(w, prev)
                    prev = v
                    f.write(struct.pack("<Q", v))


def encode_bam_record(fields: List[str], ref_ids: Dict[str, int]) -> bytes:
    """Encode one SAM text line's fields into a BAM alignment record."""
    qname, flag, rname, pos, mapq, cigar = fields[:6]
    seq, qual = fields[9], fields[10]
    flag = int(flag)
    refid = ref_ids.get(rname, -1)
    pos0 = int(pos) - 1
    cig = []
    if cigar != "*":
        for m in _CIGAR_RE.finditer(cigar):
            cig.append((int(m.group(1)) << 4) | _CIGAR_OP[m.group(2)])
    l_seq = 0 if seq == "*" else len(seq)
    name_b = qname.encode() + b"\x00"
    # bin: use reg2bin of the alignment interval
    end = pos0
    for m in _CIGAR_RE.finditer(cigar if cigar != "*" else ""):
        if m.group(2) in "MDN=X":
            end += int(m.group(1))
    end = max(end, pos0 + 1)
    bin_ = _reg2bin(pos0, end)
    rec = struct.pack(
        "<iiBBHHHiiii",
        refid,
        pos0,
        len(name_b),
        int(mapq),
        bin_,
        len(cig),
        flag,
        l_seq,
        -1,
        -1,
        0,
    )
    rec += name_b
    rec += struct.pack(f"<{len(cig)}I", *cig)
    if l_seq:
        nib = bytearray()
        for i in range(0, l_seq, 2):
            hi = _SEQ_NIBBLE.get(seq[i], 15) << 4
            lo = _SEQ_NIBBLE.get(seq[i + 1], 15) if i + 1 < l_seq else 0
            nib.append(hi | lo)
        rec += bytes(nib)
        if qual == "*":
            rec += b"\xff" * l_seq
        else:
            rec += bytes((ord(c) - 33) & 0xFF for c in qual)
    rec += _encode_tags(fields[11:])
    return struct.pack("<i", len(rec)) + rec


def _encode_tags(tags: List[str]) -> bytes:
    out = bytearray()
    for t in tags:
        parts = t.split(":", 2)
        if len(parts) != 3:
            continue
        tag, code, val = parts
        out += tag.encode()[:2]
        if code == "i":
            out += b"i" + struct.pack("<i", int(val))
        elif code == "f":
            out += b"f" + struct.pack("<f", float(val))
        else:
            out += b"Z" + val.encode() + b"\x00"
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class OutputWriter:
    """Unified writer: '-' / .sam = text; .bam = native BGZF BAM;
    .sorted.bam = coordinate-sorted BAM (samtools when available,
    otherwise a native external merge sort: sorted runs spill to temp
    files past ``spill_bytes``, k-way merged at close — constant memory
    like the reference's ``samtools sort`` pipe,
    output_functions.py:202-208)."""

    def __init__(self, path: str, header_lines: List[str],
                 spill_bytes: int = 256 << 20):
        self.path = path
        self.header_lines = header_lines
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for h in header_lines:
            if h.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in h.split("\t")[1:])
                self.ref_names.append(d["SN"])
                self.ref_lens.append(int(d["LN"]))
        self.ref_ids = {n: i for i, n in enumerate(self.ref_names)}
        self.mode = self._mode(path)
        self._pending: List[str] = []
        self._pending_bytes = 0
        self.spill_bytes = spill_bytes
        self._runs: List[str] = []
        self._proc = None
        self._fh = None
        self._bgzf = None
        self._open()

    @staticmethod
    def _mode(path: str) -> str:
        if path == "-" or path.endswith(".sam"):
            return "sam"
        if path.endswith(".sorted.bam"):
            return "sorted.bam"
        if path.endswith(".bam"):
            return "bam"
        raise ValueError(
            "Output path must end with .sam, .bam, .sorted.bam, or be '-'"
        )

    def _open(self):
        htext = "\n".join(self.header_lines) + "\n"
        if self.mode == "sam":
            self._fh = sys.stdout if self.path == "-" else open(self.path, "w")
            self._fh.write(htext)
        elif self.mode == "sorted.bam" and shutil.which("samtools"):
            self._proc = subprocess.Popen(
                ["samtools", "sort", "-@", "4", "--write-index", "-o", self.path, "-"],
                stdin=subprocess.PIPE,
                encoding="utf-8",
            )
            self._proc.stdin.write(htext)
        else:  # native bam / native sorted bam
            self._fh = open(self.path, "wb")
            self._bgzf = BgzfWriter(self._fh)
            if self.mode == "bam":
                self._write_bam_header(htext)

    def _write_bam_header(self, htext: str):
        b = self._bgzf
        b.write(b"BAM\x01")
        hb = htext.encode()
        b.write(struct.pack("<i", len(hb)) + hb)
        b.write(struct.pack("<i", len(self.ref_names)))
        for n, l in zip(self.ref_names, self.ref_lens):
            nb = n.encode() + b"\x00"
            b.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", l))

    def write_lines(self, lines: List[str]):
        if self.mode == "sam":
            self._fh.write("\n".join(lines) + "\n")
        elif self._proc is not None:
            self._proc.stdin.write("\n".join(lines) + "\n")
        elif self.mode == "bam":
            for line in lines:
                self._bgzf.write(
                    encode_bam_record(line.rstrip("\n").split("\t"), self.ref_ids)
                )
        else:  # native sorted: buffer; spill sorted runs past the cap
            self._pending.extend(lines)
            self._pending_bytes += sum(len(l) for l in lines)
            if self._pending_bytes > self.spill_bytes:
                self._spill_run()

    # ---- native external sort ----------------------------------------
    def _sort_key(self, line: str):
        f = line.split("\t", 4)
        rid = self.ref_ids.get(f[2], 1 << 30)
        return (rid, int(f[3]))

    def _spill_run(self):
        import tempfile

        self._pending.sort(key=self._sort_key)
        fd, p = tempfile.mkstemp(prefix="vacmap_sortrun_", suffix=".sam")
        with os.fdopen(fd, "w") as f:
            f.write("\n".join(self._pending))
            f.write("\n")
        self._runs.append(p)
        self._pending = []
        self._pending_bytes = 0

    def _sorted_stream(self):
        """All records in coordinate order: k-way merge of spilled runs
        plus the in-memory tail."""
        import heapq

        self._pending.sort(key=self._sort_key)
        streams = []
        fhs = []
        for p in self._runs:
            fh = open(p)
            fhs.append(fh)
            streams.append(l.rstrip("\n") for l in fh)
        streams.append(iter(self._pending))
        try:
            yield from heapq.merge(*streams, key=self._sort_key)
        finally:
            for fh in fhs:
                fh.close()
            for p in self._runs:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            self._runs = []
            self._pending = []

    def close(self):
        if self.mode == "sam":
            if self.path != "-":
                self._fh.close()
            return
        if self._proc is not None:
            self._proc.stdin.close()
            rc = self._proc.wait()
            if rc != 0:
                print(f"Error: samtools exited with code {rc}", file=sys.stderr)
            return
        if self.mode == "sorted.bam":
            htext = "\n".join(self.header_lines) + "\n"
            self._write_bam_header(htext)
            bai = BaiIndex(len(self.ref_names))
            for line in self._sorted_stream():
                fields = line.rstrip("\n").split("\t")
                v0 = self._bgzf.tell_virtual()
                self._bgzf.write(encode_bam_record(fields, self.ref_ids))
                v1 = self._bgzf.tell_virtual()
                refid = self.ref_ids.get(fields[2], -1)
                beg = int(fields[3]) - 1
                end = beg
                for m in _CIGAR_RE.finditer(fields[5] if fields[5] != "*" else ""):
                    if m.group(2) in "MDN=X":
                        end += int(m.group(1))
                bai.add(refid, beg, max(end, beg + 1), v0, v1)
            self._bgzf.close()
            self._fh.close()
            bai.write(self.path + ".bai")
            return
        self._bgzf.close()
        self._fh.close()
