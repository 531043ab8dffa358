"""Native (C++) host kernels, bound via ctypes.

The library is compiled on demand with g++ from this package's own
source into the build directory of the CUDA kernels (``_build.BUILD_DIR``:
``build/vacmap_tpu_torch/`` in a checkout); all callers degrade
gracefully to the numpy implementations when neither a built .so nor a
compiler is available.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

log = logging.getLogger(__name__)

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "vacmap_native.cpp")
# VACMAP_TPU_NATIVE_SO points at an alternative build (the sanitizer
# runs use an ASan+UBSan .so with LD_PRELOAD=libasan)
_SO = os.environ.get(
    "VACMAP_TPU_NATIVE_SO", str(BUILD_DIR / "libvacmap_native.so")
)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # compiled under a per-process name and moved into place, so a
    # concurrent process never loads a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-funroll-loops", "-fno-math-errno", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp, "-lz"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # no compiler / failure -> numpy fallback
        log.debug("native build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.myers_edit_distance.restype = ctypes.c_int64
    lib.myers_edit_distance.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.align2p_native.restype = ctypes.c_int
    lib.align2p_native.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def edit_distance_native(a: np.ndarray, b: np.ndarray, cap: int = -1) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    return int(
        lib.myers_edit_distance(
            a.ctypes.data, len(a), b.ctypes.data, len(b), cap
        )
    )


_OPCHARS = "MID=X"


def align2p_native(
    target: np.ndarray,
    query: np.ndarray,
    match=2, mismatch=-4, o1=4, e1=2, o2=24, e2=1,
    bw=-1, zdrop=-1, eqx=False,
):
    """Returns (ops ndarray (n,2) of (opcode, len), q_end, t_end, score,
    zdropped) or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(target, np.uint8)
    q = np.ascontiguousarray(query, np.uint8)
    max_ops = 2 * (len(t) + len(q)) + 16
    out = np.zeros((max_ops, 2), np.int32)
    n_ops = ctypes.c_int64()
    q_end = ctypes.c_int64()
    t_end = ctypes.c_int64()
    score = ctypes.c_int64()
    zdropped = ctypes.c_int()
    glob = 1 if bw < 0 else 0
    if not hasattr(lib, "_eqx_bound"):
        lib.align2p_native_eqx.restype = ctypes.c_int
        lib.align2p_native_eqx.argtypes = (
            lib.align2p_native.argtypes[:13] + [ctypes.c_int]
            + lib.align2p_native.argtypes[13:]
        )
        lib._eqx_bound = True
    rc = lib.align2p_native_eqx(
        t.ctypes.data, len(t), q.ctypes.data, len(q),
        match, mismatch, o1, e1, o2, e2, bw, zdrop, glob, 1 if eqx else 0,
        out.ctypes.data, max_ops, ctypes.byref(n_ops),
        ctypes.byref(q_end), ctypes.byref(t_end), ctypes.byref(score),
        ctypes.byref(zdropped),
    )
    if rc != 0:
        return None
    return (
        out[: n_ops.value],
        int(q_end.value),
        int(t_end.value),
        int(score.value),
        bool(zdropped.value),
    )


def ops_to_cigar(ops: np.ndarray) -> str:
    lib = get_lib()
    if lib is not None and len(ops):
        if not hasattr(lib, "_cig_bound"):
            _bind_cigar(lib)
        o = np.ascontiguousarray(ops, np.int32)
        cap = 24 * len(o)
        buf = ctypes.create_string_buffer(cap)
        n = lib.ops_to_cigar_ascii(o.ctypes.data, len(o), buf, cap)
        if n >= 0:
            return buf.raw[:n].decode("ascii")
    ol = ops.tolist()
    return "".join(str(l) + _OPCHARS[o] for o, l in ol)


def ops_to_cigars_many(ops_list) -> Optional[list]:
    """ASCII cigars for many (n,2) op arrays with one shared buffer (the
    per-call create_string_buffer dominates at ~2k tiny calls per read)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_cig_bound"):
        _bind_cigar(lib)
    cap = 24 * max((len(o) for o in ops_list), default=1) + 16
    buf = ctypes.create_string_buffer(cap)
    fn = lib.ops_to_cigar_ascii
    addr = ctypes.addressof(buf)
    out = []
    for o in ops_list:
        o = np.ascontiguousarray(o, np.int32)
        n = fn(o.ctypes.data, len(o), buf, cap)
        if n < 0:
            return None
        out.append(ctypes.string_at(addr, n).decode("ascii"))
    return out


def ops_to_cigars_plane(plane: np.ndarray, meta: np.ndarray) -> Optional[list]:
    """ASCII cigars for all items of one align2p_batch ops plane in a
    single C++ call (meta rows = (row_offset, n_ops)); returns a list of
    str or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_cig_bound"):
        _bind_cigar(lib)
    n = len(meta)
    cap = int(24 * meta[:, 1].sum()) + 16
    buf = ctypes.create_string_buffer(cap)
    ends = np.empty(n, np.int64)
    total = lib.ops_to_cigar_ascii_batch(
        plane.ctypes.data, np.ascontiguousarray(meta, np.int64).ctypes.data,
        n, buf, cap, ends.ctypes.data,
    )
    if total < 0:
        return None
    s = buf.raw[:total].decode("ascii")
    out = []
    st = 0
    for en in ends.tolist():
        out.append(s[st:en])
        st = en
    return out


def _bind_cigar(lib):
    lib.ops_to_cigar_ascii.restype = ctypes.c_int64
    lib.ops_to_cigar_ascii.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.ops_to_cigar_ascii_batch.restype = ctypes.c_int64
    lib.ops_to_cigar_ascii_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.cigar_finish.restype = ctypes.c_int
    lib.cigar_finish.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.cigar_qspan.restype = ctypes.c_int64
    lib.cigar_qspan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ]
    lib._cig_bound = True


def cigar_finish_native(cigar: str, collapse_eqx: bool):
    """(merged, n_ops, nm_or_None, collapsed) like sam.merge_nm_collapse,
    or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_cig_bound"):
        _bind_cigar(lib)
    raw = cigar.encode("ascii")
    cap = len(raw) + 32
    merged = ctypes.create_string_buffer(cap)
    collapsed = ctypes.create_string_buffer(cap)
    ml = ctypes.c_int64()
    cl = ctypes.c_int64()
    nrm = ctypes.c_int64()
    nrc = ctypes.c_int64()
    nm = ctypes.c_int64()
    rc = lib.cigar_finish(
        raw, len(raw), 1 if collapse_eqx else 0,
        merged, cap, ctypes.byref(ml),
        collapsed, cap, ctypes.byref(cl),
        ctypes.byref(nrm), ctypes.byref(nrc), ctypes.byref(nm),
    )
    if rc != 0:
        return None
    m = merged.raw[: ml.value].decode("ascii")
    nm_v = None if nm.value < 0 else int(nm.value)
    if collapse_eqx:
        return m, int(nrc.value), nm_v, collapsed.raw[: cl.value].decode("ascii")
    return m, int(nrm.value), nm_v, m


def backtrack_follow_native(P: np.ndarray, start: int):
    """Predecessor-chain follow: int64 index array [start, P[start], ...]
    up to the -1 root, or None (lib unavailable / bad chain)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_follow_bound"):
        lib.backtrack_follow.restype = ctypes.c_int64
        lib.backtrack_follow.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._follow_bound = True
    P = np.ascontiguousarray(P, np.int64)
    out = np.empty(len(P), np.int64)
    m = lib.backtrack_follow(P.ctypes.data, len(P), int(start),
                             out.ctypes.data)
    if m < 0:
        return None
    return out[:m]


def backtrack_all_native(S: np.ndarray, P: np.ndarray, g_max: int,
                         order: np.ndarray, min_score: float):
    """(list of index arrays, scores, best_s_arr) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_bta_bound"):
        lib.backtrack_all_native.restype = ctypes.c_int64
        lib.backtrack_all_native.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._bta_bound = True
    S = np.ascontiguousarray(S, np.float64)
    P = np.ascontiguousarray(P, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    n = len(S)
    max_paths = n + 1
    out_idx = np.empty(n, np.int64)
    out_off = np.empty(max_paths + 1, np.int64)
    out_scores = np.empty(max_paths, np.float64)
    out_sarr = np.empty(n, np.float64)
    n_paths = lib.backtrack_all_native(
        S.ctypes.data, P.ctypes.data, n, g_max,
        order.ctypes.data, len(order), float(min_score),
        out_idx.ctypes.data, out_off.ctypes.data, out_scores.ctypes.data,
        out_sarr.ctypes.data, max_paths,
    )
    if n_paths == 0:
        return [], [], []
    paths = [out_idx[out_off[i] : out_off[i + 1]] for i in range(n_paths)]
    best_len = int(out_off[1])
    return paths, out_scores[:n_paths].tolist(), out_sarr[:best_len].tolist()


def rebuild_chain_break_native(path_arr: np.ndarray, starts: np.ndarray,
                               large_cost: int, small_alignment: int = 50,
                               allow_dup_overlap: bool = True):
    """Per-anchor segment ids (-1 = dropped) and the segment count, or
    None when the lib is unavailable.  allow_dup_overlap=False is the asm
    module's plain refgap>=0 accept rule."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_rcb_bound"):
        lib.rebuild_chain_break_native.restype = ctypes.c_int64
        lib.rebuild_chain_break_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib._rcb_bound = True
    A = np.ascontiguousarray(path_arr, np.int64)
    st = np.ascontiguousarray(starts, np.int64)
    seg_id = np.empty(len(A), np.int32)
    n_segs = lib.rebuild_chain_break_native(
        A.ctypes.data, len(A), st.ctypes.data, len(st),
        large_cost, small_alignment, 1 if allow_dup_overlap else 0,
        seg_id.ctypes.data,
    )
    return seg_id, int(n_segs)


def fastx_read_native(path: str, read_comment: bool = False,
                      chunk_bytes: int = 8 << 20, chunk_recs: int = 512):
    """Streaming FASTA/FASTQ(.gz) records via the C reader (zlib gzFile
    handles plain and gzip transparently).  Yields the same tuples as
    io.fastx.fastx_read; raises RuntimeError when the lib is missing
    (callers check available() first)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not hasattr(lib, "_fx_bound"):
        lib.fastx_open.restype = ctypes.c_void_p
        lib.fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fastx_close.restype = None
        lib.fastx_close.argtypes = [ctypes.c_void_p]
        lib.fastx_read_chunk.restype = ctypes.c_int64
        lib.fastx_read_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._fx_bound = True
    h = lib.fastx_open(path.encode(), 1 << 20)
    if not h:
        raise FileNotFoundError(path)
    try:
        cap = chunk_bytes
        while True:
            chars = np.empty(cap, np.uint8)
            offs = np.empty((chunk_recs, 5), np.int64)
            n = lib.fastx_read_chunk(
                h, chars.ctypes.data, cap, offs.ctypes.data, chunk_recs
            )
            if n == -1:
                raise ValueError(f"malformed FASTA/FASTQ: {path}")
            if n == -2:  # single record larger than the buffer: grow
                cap *= 4
                continue
            if n == 0:
                return
            used = int(offs[n - 1, 4])
            blob = chars[:used].tobytes().decode("latin-1")
            ol = offs[:n].tolist()
            for r in range(n):
                o = ol[r]
                name = blob[o[0] : o[1]]
                comment = blob[o[1] : o[2]]
                seq = blob[o[2] : o[3]]
                qual = blob[o[3] : o[4]]
                if not name or not seq:
                    continue
                # record shapes identical to io.fastx._emit
                if read_comment:
                    yield (name, seq, qual or None, comment or None)
                elif qual:
                    yield (name, seq, qual)
                else:
                    yield (name, seq)
    finally:
        lib.fastx_close(h)


def hash_lookup_ranges(table: np.ndarray, pstarts: np.ndarray, shift: int,
                       queries: np.ndarray):
    """(lo, hi) occurrence ranges of each query hash in the sorted table,
    via the 16-bit prefix bucket index; None when lib unavailable."""
    lib = get_lib()
    if lib is None or len(queries) == 0:
        return None
    if not hasattr(lib, "_hlr_bound"):
        for fn in (lib.hash_lookup_ranges_u32, lib.hash_lookup_ranges_i64):
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
        lib._hlr_bound = True
    m = len(queries)
    lo = np.empty(m, np.int64)
    hi = np.empty(m, np.int64)
    q = np.ascontiguousarray(queries)
    ps = np.ascontiguousarray(pstarts, np.int64)
    if table.dtype == np.uint32:
        lib.hash_lookup_ranges_u32(
            table.ctypes.data, ps.ctypes.data, shift,
            q.ctypes.data, m, lo.ctypes.data, hi.ctypes.data,
        )
    elif table.dtype == np.int64:
        lib.hash_lookup_ranges_i64(
            table.ctypes.data, ps.ctypes.data, shift,
            q.ctypes.data, m, lo.ctypes.data, hi.ctypes.data,
        )
    else:
        return None
    return lo, hi


def decode_tb_ops(packed: np.ndarray, pairs, eqx: bool = False):
    """Decode device traceback streams (ops/affine_pallas.py) into merged
    (op, len) int32 arrays, one per job; None when lib unavailable."""
    lib = get_lib()
    if lib is None or not len(pairs):
        return None
    if not hasattr(lib, "_tb_bound"):
        lib.decode_tb_ops_batch.restype = ctypes.c_int
        lib.decode_tb_ops_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._tb_bound = True
    packed = np.ascontiguousarray(packed, np.uint8)
    S4, B = packed.shape
    n = len(pairs)
    flat = [a for tq in pairs for a in tq]
    lens = np.fromiter((len(a) for a in flat), np.int64, count=2 * n)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    t_off = np.ascontiguousarray(offs[0::2])
    t_len = np.ascontiguousarray(lens[0::2])
    q_off = np.ascontiguousarray(offs[1::2])
    q_len = np.ascontiguousarray(lens[1::2])
    total = int(lens.sum())
    seqs = (np.concatenate(flat).astype(np.uint8, copy=False)
            if total else np.empty(1, np.uint8))
    ops_cap = 2 * total + 32 * n
    out_ops = np.empty((ops_cap, 2), np.int32)
    meta = np.empty((n, 2), np.int64)
    rc = lib.decode_tb_ops_batch(
        packed.ctypes.data, S4, B, n,
        seqs.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        q_off.ctypes.data, q_len.ctypes.data, 1 if eqx else 0,
        out_ops.ctypes.data, ops_cap, meta.ctypes.data,
    )
    if rc != 0:
        return None
    return [out_ops[meta[i, 0] : meta[i, 0] + meta[i, 1]] for i in range(n)]


def decode_rowruns(lo: np.ndarray, ex: np.ndarray, pairs, eqx: bool = False):
    """Decode the device fill kernel's row-run traceback planes (two
    (n, N) uint8 rows per job, ops/affine_pallas._fill_tb_kernel) straight
    into merged (op, len) int32 arrays — skipping the packed-stream
    re-expansion entirely.  None when lib unavailable."""
    lib = get_lib()
    if lib is None or not len(pairs):
        return None
    if not hasattr(lib, "_rr_bound"):
        lib.decode_rowruns_batch.restype = ctypes.c_int
        lib.decode_rowruns_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._rr_bound = True
    lo = np.ascontiguousarray(lo, np.uint8)
    ex = np.ascontiguousarray(ex, np.uint8)
    n, N = lo.shape
    if n != len(pairs):
        return None
    flat = [a for tq in pairs for a in tq]
    lens = np.fromiter((len(a) for a in flat), np.int64, count=2 * n)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    t_off = np.ascontiguousarray(offs[0::2])
    t_len = np.ascontiguousarray(lens[0::2])
    q_off = np.ascontiguousarray(offs[1::2])
    q_len = np.ascontiguousarray(lens[1::2])
    total = int(lens.sum())
    seqs = (np.concatenate(flat).astype(np.uint8, copy=False)
            if total else np.empty(1, np.uint8))
    ops_cap = 2 * total + 32 * n
    out_ops = np.empty((ops_cap, 2), np.int32)
    meta = np.empty((n, 2), np.int64)
    rc = lib.decode_rowruns_batch(
        lo.ctypes.data, ex.ctypes.data, N, n,
        seqs.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        q_off.ctypes.data, q_len.ctypes.data, 1 if eqx else 0,
        out_ops.ctypes.data, ops_cap, meta.ctypes.data,
    )
    if rc != 0:
        return None
    return [out_ops[meta[i, 0] : meta[i, 0] + meta[i, 1]] for i in range(n)]


def cigar_qspan_native(cigar: str, with_clips: bool):
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_cig_bound"):
        _bind_cigar(lib)
    raw = cigar.encode("ascii")
    n = lib.cigar_qspan(raw, len(raw), 1 if with_clips else 0)
    return None if n < 0 else int(n)


def _bind_chain(lib):
    lib.chain_dp_native.restype = ctypes.c_int
    lib.chain_dp_native.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]


_VARIANT_CODE = {"global": 0, "refund": 1, "fine": 2, "mismatch": 3,
                 "global_nocov": 4, "scar": 5, "asm_fine": 6}

_EXTRA_F32 = None


def _extra_f32() -> np.ndarray:
    """The chain surcharge table as a cached contiguous float32 array
    (rebuilding it per DP call shows up at 6k calls/read-corpus)."""
    global _EXTRA_F32
    if _EXTRA_F32 is None:
        from ..ops.chain_ref import EXTRA

        _EXTRA_F32 = np.ascontiguousarray(EXTRA, np.float32)
    return _EXTRA_F32


def chain_dp_native(anchors: np.ndarray, kmersize: int, skipcost: float,
                    maxdiff: int, maxgap: int, variant: str,
                    max_ops_per_anchor: int = 1000):
    """Exact chaining DP in C++; returns (S, P, aborted) or None when the
    native lib is unavailable.  anchors must be barrier-sorted int64."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_bound"):
        _bind_chain(lib)
        lib._chain_bound = True
    A = np.ascontiguousarray(anchors, np.int64)
    n = len(A)
    # S/P fully written by the kernel on success (aborted results are
    # discarded by the caller) -> no zero-fill needed
    S = np.empty(n, np.float64)
    P = np.empty(n, np.int64)
    extra = _extra_f32()
    rc = lib.chain_dp_native(
        A.ctypes.data, n, kmersize, float(skipcost), maxdiff, maxgap,
        _VARIANT_CODE[variant], extra.ctypes.data, len(extra) - 1,
        S.ctypes.data, P.ctypes.data, max_ops_per_anchor,
    )
    return S, P, rc == 1


def chain_dp_native_warm(anchors, kmersize, skipcost, maxdiff, maxgap,
                         variant, warm_S, warm_P,
                         max_ops_per_anchor: int = 1000):
    """Streaming (frontier-carry) chaining: the first len(warm_S) anchor
    rows are carried frontier anchors with fixed scores and pass-through
    predecessor codes.  Returns (S, P, aborted) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_warm_bound"):
        lib.chain_dp_native_warm.restype = ctypes.c_int
        lib.chain_dp_native_warm.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._chain_warm_bound = True
    A = np.ascontiguousarray(anchors, np.int64)
    n = len(A)
    S = np.empty(n, np.float64)
    P = np.empty(n, np.int64)
    wS = np.ascontiguousarray(warm_S, np.float64)
    wP = np.ascontiguousarray(warm_P, np.int64)
    extra = _extra_f32()
    rc = lib.chain_dp_native_warm(
        A.ctypes.data, n, kmersize, float(skipcost), maxdiff, maxgap,
        _VARIANT_CODE[variant], extra.ctypes.data, len(extra) - 1,
        S.ctypes.data, P.ctypes.data, max_ops_per_anchor,
        len(wS), wS.ctypes.data, wP.ctypes.data,
    )
    return S, P, rc == 1


def merge_diag_runs_native(rpos, refloc, diag, strand: int, k: int):
    """C++ per-diagonal run merge; returns (m, 4) anchor array or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_merge_bound"):
        lib.merge_diag_runs.restype = ctypes.c_int64
        lib.merge_diag_runs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._merge_bound = True
    r = np.ascontiguousarray(rpos, np.int64)
    y = np.ascontiguousarray(refloc, np.int64)
    d = np.ascontiguousarray(diag, np.int64)
    out = np.zeros((2 * len(r) + 2, 4), np.int64)
    m = lib.merge_diag_runs(
        r.ctypes.data, y.ctypes.data, d.ctypes.data, len(r), strand, k,
        out.ctypes.data,
    )
    return out[:m]


def minimizer_sketch_native(codes: np.ndarray, k: int, w: int):
    """C++ minimizer sketch; returns (hashes, positions, strands) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_sketch_bound"):
        lib.minimizer_sketch.restype = ctypes.c_int64
        lib.minimizer_sketch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._sketch_bound = True
    c = np.ascontiguousarray(codes, np.uint8)
    cap = max(len(c), 1)
    oh = np.empty(cap, np.int64)
    op = np.empty(cap, np.int64)
    os_ = np.empty(cap, np.int8)
    m = lib.minimizer_sketch(
        c.ctypes.data, len(c), k, w, oh.ctypes.data, op.ctypes.data,
        os_.ctypes.data,
    )
    return oh[:m], op[:m], os_[:m]


def minimizer_sketch_mt_native(codes: np.ndarray, k: int, w: int,
                               nthreads: int = 0):
    """Multithreaded C++ minimizer sketch (segmented, selection identical
    to minimizer_sketch — see vacmap_native.cpp); returns (hashes,
    positions, strands) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_sketch_mt_bound"):
        lib.minimizer_sketch_mt.restype = ctypes.c_int64
        lib.minimizer_sketch_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._sketch_mt_bound = True
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    c = np.ascontiguousarray(codes, np.uint8)
    cap = max(len(c), 1)
    oh = np.empty(cap, np.int64)
    op = np.empty(cap, np.int64)
    os_ = np.empty(cap, np.int8)
    m = lib.minimizer_sketch_mt(
        c.ctypes.data, len(c), k, w, nthreads, oh.ctypes.data,
        op.ctypes.data, os_.ctypes.data,
    )
    return oh[:m], op[:m], os_[:m]


def index_build_sorted_native(codes: np.ndarray, ctg_starts, ctg_lens,
                              k: int, w: int, nthreads: int = 0,
                              out=None):
    """Fully-native sorted minimizer table: MT per-contig sketch +
    256-bucket hash scatter + per-bucket stable sort -> (hash asc,
    pos asc), identical to the numpy argsort path in
    index/index.py::build.  Returns (hashes, positions, strands)
    int64/int64/int8 or None.

    With ``out=(oh, op, os_)`` (preallocated int64/int64/int8 arrays,
    e.g. disk-backed memmaps for genome-scale external builds) the table
    is written in place and the COUNT is returned (or None when the
    capacity is insufficient / the lib is unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_idx_sorted_bound"):
        lib.index_build_sorted.restype = ctypes.c_int64
        lib.index_build_sorted.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._idx_sorted_bound = True
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    c = np.ascontiguousarray(codes, np.uint8)
    cs = np.ascontiguousarray(ctg_starts, np.int64)
    cl = np.ascontiguousarray(ctg_lens, np.int64)
    if out is not None:
        oh, op, os_ = out
        assert oh.dtype == np.int64 and op.dtype == np.int64
        assert os_.dtype == np.int8
        m = lib.index_build_sorted(
            c.ctypes.data, len(c), k, w, nthreads, len(oh),
            len(cs), cs.ctypes.data, cl.ctypes.data,
            oh.ctypes.data, op.ctypes.data, os_.ctypes.data,
        )
        return None if m < 0 else m
    # minimizer density is 2/(w+1); 1/2 is a safe cap for any w >= 3
    cap = max(len(c) // 2 + 64, 64)
    oh = np.empty(cap, np.int64)
    op = np.empty(cap, np.int64)
    os_ = np.empty(cap, np.int8)
    m = lib.index_build_sorted(
        c.ctypes.data, len(c), k, w, nthreads, cap,
        len(cs), cs.ctypes.data, cl.ctypes.data,
        oh.ctypes.data, op.ctypes.data, os_.ctypes.data,
    )
    if m < 0:  # cap overflow (w < 3): retry with the exact size
        oh = np.empty(-m, np.int64)
        op = np.empty(-m, np.int64)
        os_ = np.empty(-m, np.int8)
        m = lib.index_build_sorted(
            c.ctypes.data, len(c), k, w, nthreads, -m,
            len(cs), cs.ctypes.data, cl.ctypes.data,
            oh.ctypes.data, op.ctypes.data, os_.ctypes.data,
        )
    return oh[:m], op[:m], os_[:m]


def harvest_join_native(ref_codes, windows, read_codes, readstart, readend,
                        g_rp, g_ref, k: int):
    """Full C++ harvest (table + scan + proximity + merge); returns an
    (m, 4) anchor array or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_harvest_bound"):
        lib.harvest_join.restype = ctypes.c_int64
        lib.harvest_join.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._harvest_bound = True
    rc = np.ascontiguousarray(ref_codes, np.uint8)
    qc = np.ascontiguousarray(read_codes, np.uint8)
    wlo = np.ascontiguousarray([w[0] for w in windows], np.int64)
    whi = np.ascontiguousarray([w[1] for w in windows], np.int64)
    grp = np.ascontiguousarray(g_rp, np.int64)
    gref = np.ascontiguousarray(g_ref, np.int64)
    cap = 4 * max(readend - readstart, 64) + 1024
    out = np.empty((cap, 4), np.int64)
    m = lib.harvest_join(
        rc.ctypes.data, wlo.ctypes.data, whi.ctypes.data, len(wlo),
        qc.ctypes.data, len(qc), readstart, readend,
        grp.ctypes.data, gref.ctypes.data, len(grp),
        k, out.ctypes.data, cap,
    )
    if m < 0:
        return None  # capacity overflow: caller falls back to numpy
    return out[:m]


def chain_dp_fast_native(anchors, kmersize, skipcost, maxdiff, maxgap,
                         variant, fast_t: int = 5):
    """Bucketed-prune chaining DP in C++; returns (S, P) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_fast_bound"):
        lib.chain_dp_fast_native.restype = ctypes.c_int
        lib.chain_dp_fast_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._chain_fast_bound = True
    from ..ops.chain_ref import EXTRA

    A = np.ascontiguousarray(anchors, np.int64)
    n = len(A)
    S = np.zeros(n, np.float64)
    P = np.zeros(n, np.int64)
    extra = np.ascontiguousarray(EXTRA, np.float32)
    lib.chain_dp_fast_native(
        A.ctypes.data, n, kmersize, float(skipcost), maxdiff, maxgap,
        _VARIANT_CODE[variant], extra.ctypes.data, len(extra) - 1, fast_t,
        S.ctypes.data, P.ctypes.data,
    )
    return S, P


def chain_dp_fast_native_warm(anchors, kmersize, skipcost, maxdiff, maxgap,
                              variant, warm_S, warm_P, fast_t: int = 5):
    """Streaming warm-start bucketed DP (reference linked_..._d_fast_all,
    mammap_asm.py:21872): the asm routine's fallback when the exact linked
    DP hits the density abort.  Returns (S, P) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_fast_warm_bound"):
        lib.chain_dp_fast_native_warm.restype = ctypes.c_int
        lib.chain_dp_fast_native_warm.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._chain_fast_warm_bound = True
    from ..ops.chain_ref import EXTRA

    A = np.ascontiguousarray(anchors, np.int64)
    n = len(A)
    S = np.zeros(n, np.float64)
    P = np.zeros(n, np.int64)
    wS = np.ascontiguousarray(warm_S, np.float64)
    wP = np.ascontiguousarray(warm_P, np.int64)
    extra = np.ascontiguousarray(EXTRA, np.float32)
    lib.chain_dp_fast_native_warm(
        A.ctypes.data, n, kmersize, float(skipcost), maxdiff, maxgap,
        _VARIANT_CODE[variant], extra.ctypes.data, len(extra) - 1, fast_t,
        S.ctypes.data, P.ctypes.data,
        len(wS), wS.ctypes.data, wP.ctypes.data,
    )
    return S, P


def align2p_batch_native(pairs, match=2, mismatch=-4, o1=4, e1=2, o2=24,
                         e2=1, eqx=False, return_plane=False):
    """All pairs in one C++ call (global mode).  Returns a list of
    per-pair ops views, or with ``return_plane`` the raw (ops_plane,
    meta) pair for batched downstream formatting; None if unavailable."""
    lib = get_lib()
    if lib is None or not pairs:
        return None
    if not hasattr(lib, "_batch_bound"):
        lib.align2p_batch_native.restype = ctypes.c_int
        lib.align2p_batch_native.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._batch_bound = True
    n = len(pairs)
    # one vectorized layout pass (cross-read window flushes reach ~1k
    # jobs: per-pair python slice stores and multi-MB np.zeros were the
    # wrapper's cost)
    flat = [a for tq in pairs for a in tq]
    lens = np.fromiter((len(a) for a in flat), np.int64, count=2 * n)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    t_off = np.ascontiguousarray(offs[0::2])
    t_len = np.ascontiguousarray(lens[0::2])
    q_off = np.ascontiguousarray(offs[1::2])
    q_len = np.ascontiguousarray(lens[1::2])
    total = int(lens.sum())
    seqs = (np.concatenate(flat).astype(np.uint8, copy=False)
            if total else np.empty(0, np.uint8))
    ops_cap = 2 * total + 32 * n
    out_ops = np.empty((ops_cap, 2), np.int32)
    meta = np.empty((n, 2), np.int64)
    rc = lib.align2p_batch_native(
        seqs.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        q_off.ctypes.data, q_len.ctypes.data, n,
        match, mismatch, o1, e1, o2, e2, 1 if eqx else 0,
        out_ops.ctypes.data, ops_cap, meta.ctypes.data,
    )
    if rc != 0:
        return None
    if return_plane:
        return out_ops, meta
    return [out_ops[meta[i, 0] : meta[i, 0] + meta[i, 1]] for i in range(n)]


def seeds_core_native(mm_hash, mm_pos, mm_strand, pstarts, shift,
                      qh, qp, qs, cutoff, check_num, k,
                      merge_max_len: int = 250):
    """Whole seeding tail (lookup + expand + cluster cap + colinear merge
    + final sort) in one C++ call; returns an (n, 4) int64 anchor array
    or None (lib unavailable / unsupported dtypes).  Bit-identical to
    index/index.py::seeds' numpy path (tested)."""
    lib = get_lib()
    if lib is None:
        return None
    if mm_hash.dtype != np.uint32 or mm_pos.dtype != np.uint32:
        return None
    if not hasattr(lib, "_seeds_core_bound"):
        lib.seeds_core_u32.restype = ctypes.c_int64
        lib.seeds_core_u32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._seeds_core_bound = True
    qh = np.ascontiguousarray(qh, np.int64)
    qp = np.ascontiguousarray(qp, np.int64)
    qs = np.ascontiguousarray(qs, np.int8)
    ps = np.ascontiguousarray(pstarts, np.int64)
    cap = 4 * len(qh) + 1024
    for _ in range(2):
        out = np.empty((cap, 4), np.int64)
        n = lib.seeds_core_u32(
            mm_hash.ctypes.data if mm_hash.flags.c_contiguous
            else np.ascontiguousarray(mm_hash).ctypes.data,
            mm_pos.ctypes.data if mm_pos.flags.c_contiguous
            else np.ascontiguousarray(mm_pos).ctypes.data,
            mm_strand.ctypes.data if mm_strand.flags.c_contiguous
            else np.ascontiguousarray(mm_strand).ctypes.data,
            ps.ctypes.data, int(shift),
            qh.ctypes.data, qp.ctypes.data, qs.ctypes.data, len(qh),
            int(cutoff), int(check_num), int(k), int(merge_max_len),
            out.ctypes.data, cap,
        )
        if n >= 0:
            return out[:n]
        cap = -n + 16
    return None


def segment_walk_keep_native(walk_arr: np.ndarray, minus: bool,
                             force_gap: int, min_gap: int):
    """Kept-anchor indices for segment_cigar_jobs' decision walk, or
    None (lib unavailable).  Returns an int64 index array (>= 2 entries)
    or an empty array when the walk yields no pairs."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_segwalk_bound"):
        lib.segment_walk_keep.restype = ctypes.c_int64
        lib.segment_walk_keep.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._segwalk_bound = True
    A = np.ascontiguousarray(walk_arr, np.int64)
    out = np.empty(len(A), np.int64)
    n = lib.segment_walk_keep(
        A.ctypes.data, len(A), 1 if minus else 0, force_gap, min_gap,
        out.ctypes.data,
    )
    if n < 0:
        return np.empty(0, np.int64)
    return out[:n]
