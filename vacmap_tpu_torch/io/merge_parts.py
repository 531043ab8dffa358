"""Merge multi-host per-process outputs into the single file the
reference produces.

The multi-host deployment writes ``<out>.partI`` per process plus a
``<out>.partI.done`` sentinel when that process finishes.  Process 0
waits for all sentinels and merges:

  .sam         — part 0 verbatim, later parts minus their headers
  .bam         — one header, then every part's raw records re-streamed
                 through a fresh BGZF writer (no SAM round-trip)
  .sorted.bam  — coordinate heap-merge of the (already sorted) parts'
                 raw records

Counterpart of the reference's single writer process + samtools sort
pipe (vacmap:390-420, output_functions.py:202-208), which never needs a
merge because all workers live on one host.
"""

from __future__ import annotations

import heapq
import os
import struct
import time
from typing import Iterator, List, Tuple

from .bam_reader import _bgzf_blocks
from .sam_writer import BgzfWriter


def raw_bam_records(path: str) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (ref_id, pos, raw_record_bytes incl. block_size prefix) for
    every alignment record, skipping the header."""
    buf = bytearray()
    blocks = _bgzf_blocks(path)

    def need(n: int) -> bool:
        while len(buf) < n:
            try:
                buf.extend(next(blocks))
            except StopIteration:
                return False
        return True

    if not need(12) or bytes(buf[:4]) != b"BAM\x01":
        raise ValueError(f"not a BAM file: {path}")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    if not need(8 + l_text + 4):
        raise ValueError(f"truncated BAM header: {path}")
    n_ref = struct.unpack_from("<i", buf, 8 + l_text)[0]
    off = 12 + l_text
    for _ in range(n_ref):
        if not need(off + 4):
            raise ValueError(f"truncated BAM refs: {path}")
        l_name = struct.unpack_from("<i", buf, off)[0]
        off += 4 + l_name + 4
    if not need(off):
        raise ValueError(f"truncated BAM refs: {path}")
    del buf[:off]
    while True:
        if not need(4):
            return
        block_size = struct.unpack_from("<i", buf, 0)[0]
        if not need(4 + block_size):
            raise ValueError(f"truncated BAM record: {path}")
        raw = bytes(buf[: 4 + block_size])
        ref_id, pos = struct.unpack_from("<ii", raw, 4)
        del buf[: 4 + block_size]
        yield ref_id, pos, raw


def _bam_header_bytes(part0: str) -> bytes:
    """The uncompressed header section (magic..refs) of a BAM file."""
    buf = bytearray()
    blocks = _bgzf_blocks(part0)

    def need(n: int) -> bool:
        while len(buf) < n:
            try:
                buf.extend(next(blocks))
            except StopIteration:
                return False
        return True

    if not need(12):
        raise ValueError(f"not a BAM file: {part0}")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    need(8 + l_text + 4)
    n_ref = struct.unpack_from("<i", buf, 8 + l_text)[0]
    off = 12 + l_text
    for _ in range(n_ref):
        need(off + 4)
        l_name = struct.unpack_from("<i", buf, off)[0]
        off += 4 + l_name + 4
    need(off)
    return bytes(buf[:off])


def merge_parts(final_out: str, part_paths: List[str]) -> None:
    """Merge ``part_paths`` (same format as ``final_out``) into
    ``final_out``."""
    if final_out.endswith(".sam") or final_out == "-":
        import sys

        out = sys.stdout if final_out == "-" else open(final_out, "w")
        try:
            for i, p in enumerate(part_paths):
                with open(p) as fh:
                    for line in fh:
                        if i > 0 and line.startswith("@"):
                            continue
                        out.write(line)
        finally:
            if final_out != "-":
                out.close()
        return
    sorted_out = final_out.endswith(".sorted.bam")
    with open(final_out, "wb") as fh:
        w = BgzfWriter(fh)
        w.write(_bam_header_bytes(part_paths[0]))
        if sorted_out:
            streams = (
                ((rid if rid >= 0 else 1 << 30, pos, i, raw)
                 for rid, pos, raw in raw_bam_records(p))
                for i, p in enumerate(part_paths)
            )
            for _rid, _pos, _i, raw in heapq.merge(*streams):
                w.write(raw)
        else:
            for p in part_paths:
                for _rid, _pos, raw in raw_bam_records(p):
                    w.write(raw)
        w.close()


def finish_multihost(final_out: str, part_path: str, proc_id: int,
                     n_proc: int, timeout: float = 86400.0) -> None:
    """Multi-host epilogue: mark this process's part done; process 0
    waits for every part and merges them into ``final_out`` (the parts
    must live on a shared filesystem, like the reference's shared output
    directory)."""
    open(part_path + ".done", "w").close()
    if proc_id != 0:
        return
    base, ext = _split(final_out)
    parts = [f"{base}.part{i}{ext}" for i in range(n_proc)]
    deadline = time.time() + timeout
    for p in parts:
        while not os.path.exists(p + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"multi-host merge: {p} never finished")
            time.sleep(1.0)
    merge_parts(final_out, parts)
    for p in parts:
        os.unlink(p)
        os.unlink(p + ".done")
        for aux in (".csi", ".bai"):  # per-part samtools indexes
            if os.path.exists(p + aux):
                os.unlink(p + aux)


def _split(path: str) -> Tuple[str, str]:
    for ext in (".sorted.bam", ".bam", ".sam"):
        if path.endswith(ext):
            return path[: -len(ext)], ext
    return path, ""
