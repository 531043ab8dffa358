"""FASTA/FASTQ(.gz) reading.

Replacement for the reference's kseq-style ``mp.fastx_read``
(``vacmap:445``): yields (name, seq[, qual[, comment]]) tuples.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Optional, Tuple


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def fastx_read(
    path: str, read_comment: bool = False
) -> Iterator[Tuple]:
    """Yield (name, seq, qual) or (name, seq, qual, comment) per record.

    qual is None for FASTA.  Auto-detects FASTA vs FASTQ from the first
    non-blank character.  Uses the native (C, zlib) kseq-style reader
    when available — the counterpart of the reference's ``mp.fastx_read``
    (vacmap:445) — with this pure-Python parser as the fallback.
    """
    from .. import native

    if native.available():
        try:
            yield from native.fastx_read_native(path, read_comment)
            return
        except (RuntimeError, AttributeError):
            pass
    with _open(path) as fh:
        first = fh.read(1)
        while first in ("\n", "\r", " "):
            first = fh.read(1)
        if not first:
            return
        if first == ">":
            yield from _read_fasta(fh, read_comment)
        elif first == "@":
            yield from _read_fastq(fh, read_comment)
        else:
            raise ValueError(f"unrecognized FASTX file: {path}")


def _split_header(line: str):
    line = line.rstrip("\n").rstrip("\r")
    if " " in line or "\t" in line:
        i = min(
            [j for j in (line.find(" "), line.find("\t")) if j >= 0]
        )
        return line[:i], line[i + 1 :]
    return line, None


def _read_fasta(fh, read_comment: bool):
    name, comment, parts = None, None, []
    # first '>' already consumed by the sniffer
    header = fh.readline()
    name, comment = _split_header(header)
    for line in fh:
        if line.startswith(">"):
            rec = _emit(name, "".join(parts), None, comment, read_comment)
            if rec:
                yield rec
            name, comment = _split_header(line[1:])
            parts = []
        else:
            parts.append(line.strip())
    rec = _emit(name, "".join(parts), None, comment, read_comment)
    if rec:
        yield rec


def _read_fastq(fh, read_comment: bool):
    header = fh.readline()
    while True:
        if not header:
            return
        name, comment = _split_header(header)
        seq = fh.readline().strip()
        plus = fh.readline()
        qual = fh.readline().strip()
        rec = _emit(name, seq, qual, comment, read_comment)
        if rec:
            yield rec
        header = fh.readline()
        if header.strip():
            if not header.startswith("@"):
                raise ValueError("malformed FASTQ record near " + header[:40])
            header = header[1:]


def _emit(name, seq, qual, comment, read_comment):
    if not name or not seq:
        return None
    if read_comment:
        return (name, seq, qual, comment)
    if qual is None:
        return (name, seq)
    return (name, seq, qual)
