"""Reference minimizer index: build, save/load (.vmi), anchor lookup.

TPU-native replacement for the reference's ``mp.Aligner`` C extension
(reference usage at ``vacmap:344,358-364`` and
``mammap_clrnano.py:23985``).  The coordinate space is the same as the
reference: all contigs concatenated, with ``contig2start`` giving each
contig's global offset — this is what lets one chain jump across contigs
(translocations).

Anchors are rows ``(readpos, refpos_global, strand, length)`` (int64),
read interval ``[readpos, readpos+len)``, ref interval
``[refpos, refpos+len)`` with refpos the *leftmost* matched reference
base on either strand — the convention the chaining recurrences assume
(``mammap_clrnano.py:24955-24996``).
"""

from __future__ import annotations

import dataclasses
import io
import logging
from typing import Dict, List, Optional

import numpy as np

from ..seq import encode, revcomp
from .minimizer import minimizers

log = logging.getLogger(__name__)

VMI_MAGIC = "VACMAP_TPU_VMI_v1"


@dataclasses.dataclass
class ReferenceIndex:
    k: int
    w: int
    contig_names: List[str]
    contig_starts: np.ndarray  # int64, global offset per contig (sorted asc)
    contig_lens: np.ndarray  # int64
    seq_codes: np.ndarray  # uint8, concatenated 2-bit-able codes of ALL contigs
    # minimizer table, sorted by hash then position
    mm_hash: np.ndarray  # int64
    mm_pos: np.ndarray  # int64 global position
    mm_strand: np.ndarray  # int8
    occ_cutoff: int  # auto occurrence filter (minimap2 mid_occ analogue)

    # ---- construction ----------------------------------------------------
    @staticmethod
    def _occ_cutoff_sorted(mm_hash: np.ndarray, occ_frac: float) -> int:
        """Occurrence cutoff (minimap2 mid_occ analogue) from the
        hash-sorted table: quantile over per-hash run lengths."""
        if not len(mm_hash):
            return 2**30
        boundaries = np.flatnonzero(mm_hash[1:] != mm_hash[:-1])
        counts = np.diff(np.concatenate(([0], boundaries + 1,
                                         [len(mm_hash)])))
        if not len(counts):
            return 2**30
        q = np.quantile(counts, 1.0 - occ_frac)
        return int(max(10, q))

    @staticmethod
    def _build_table_native(seq_codes, starts, lens, k, w):
        """Sorted minimizer table via the C++ build routine (MT sketch +
        bucket sort — vacmap_native.cpp::index_build_sorted); None when
        the native lib is unavailable.  Output order and selection are
        bit-identical to the numpy path below (tested)."""
        from .. import native

        if 2 * k > 32 or not native.available():
            return None
        res = native.index_build_sorted_native(seq_codes, starts, lens, k, w)
        if res is None:
            return None
        oh, op, os_ = res
        hash_dt = np.uint32 if 2 * k <= 32 else np.int64
        pos_dt = np.uint32 if len(seq_codes) < 2**32 else np.int64
        return oh.astype(hash_dt), op.astype(pos_dt), os_

    @classmethod
    def build(cls, contigs: Dict[str, str], k: int = 15, w: int = 10,
              occ_frac: float = 2e-4) -> "ReferenceIndex":
        names, starts, lens = [], [], []
        off = 0
        for name, s in contigs.items():
            names.append(name)
            starts.append(off)
            lens.append(len(s))
            off += len(s)
        # single preallocated code array; contig strings encoded in place
        # (no second whole-genome copy)
        seq_codes = np.empty(off, np.uint8)
        for name, st, ln in zip(names, starts, lens):
            seq_codes[st : st + ln] = encode(contigs[name])
        built = cls._build_table_native(seq_codes, starts, lens, k, w)
        if built is not None:
            mm_hash, mm_pos, mm_strand = built
            return cls(
                k=k, w=w, contig_names=names,
                contig_starts=np.asarray(starts, np.int64),
                contig_lens=np.asarray(lens, np.int64),
                seq_codes=seq_codes,
                mm_hash=mm_hash, mm_pos=mm_pos, mm_strand=mm_strand,
                occ_cutoff=cls._occ_cutoff_sorted(mm_hash, occ_frac),
            )
        hs, ps, ss = [], [], []
        # sketch in bounded chunks (k+w-2 overlap) so peak memory stays
        # ~10x chunk size regardless of genome size
        CHUNK = 16 << 20
        for i, name in enumerate(names):
            st, ln = starts[i], lens[i]
            hash_dt0 = np.uint32 if 2 * k <= 32 else np.int64
            pos_dt0 = np.uint32 if off < 2**32 else np.int64
            if ln <= CHUNK:
                h, p, sd = minimizers(seq_codes[st : st + ln], k, w)
                hs.append(h.astype(hash_dt0))
                ps.append((p + st).astype(pos_dt0))
                ss.append(sd)
                continue
            # chunks overlap by w-1 windows (k+w-2 bases); a position is a
            # minimizer iff SOME window selects it, so the union of per-chunk
            # selections is exact — duplicates near boundaries are removed by
            # the position dedup below
            overlap = k + 2 * w - 3
            pos0 = 0
            while pos0 < ln:
                end = min(pos0 + CHUNK, ln)
                h, p, sd = minimizers(seq_codes[st + pos0 : st + end], k, w)
                hs.append(h.astype(hash_dt0))
                ps.append((p + st + pos0).astype(pos_dt0))
                ss.append(sd)
                if end == ln:
                    break
                pos0 = end - overlap
        # compact dtypes: the hash fits 2k bits and positions fit the
        # genome length — uint32 halves index memory for k <= 16 and
        # genomes < 4 Gb (human genome: ~5 GB total index)
        hash_dt = np.uint32 if 2 * k <= 32 else np.int64
        pos_dt = np.uint32 if off < 2**32 else np.int64
        mm_hash = np.concatenate(hs) if hs else np.empty(0, hash_dt)
        mm_pos = np.concatenate(ps) if ps else np.empty(0, pos_dt)
        mm_strand = np.concatenate(ss) if ss else np.empty(0, np.int8)
        del hs, ps, ss
        if len(mm_pos):
            # dedup chunk-boundary repeats by position
            o = np.argsort(mm_pos, kind="stable")
            mm_hash, mm_pos, mm_strand = mm_hash[o], mm_pos[o], mm_strand[o]
            uniq = np.empty(len(mm_pos), bool)
            uniq[0] = True
            uniq[1:] = mm_pos[1:] != mm_pos[:-1]
            mm_hash, mm_pos, mm_strand = mm_hash[uniq], mm_pos[uniq], mm_strand[uniq]
        # positions are already ascending, so a stable sort by hash gives
        # (hash asc, pos asc) without materializing a second sort key
        order = np.argsort(mm_hash, kind="stable")
        mm_hash, mm_pos, mm_strand = mm_hash[order], mm_pos[order], mm_strand[order]
        # occurrence cutoff: ignore the top occ_frac most frequent
        # minimizers.  mm_hash is already sorted: run lengths come from
        # boundary positions (no np.unique copy of the whole table).
        occ_cutoff = 2**30
        if len(mm_hash):
            boundaries = np.flatnonzero(mm_hash[1:] != mm_hash[:-1])
            counts = np.diff(
                np.concatenate(([0], boundaries + 1, [len(mm_hash)]))
            )
            if len(counts):
                q = np.quantile(counts, 1.0 - occ_frac)
                occ_cutoff = int(max(10, q))
            del boundaries, counts
        return cls(
            k=k,
            w=w,
            contig_names=names,
            contig_starts=np.asarray(starts, np.int64),
            contig_lens=np.asarray(lens, np.int64),
            seq_codes=seq_codes,
            mm_hash=mm_hash,
            mm_pos=mm_pos,
            mm_strand=mm_strand,
            occ_cutoff=occ_cutoff,
        )

    # ---- external-sort construction (genome-scale, bounded memory) -------
    @classmethod
    def build_external(
        cls,
        contigs: Dict[str, str],
        path: str,
        k: int = 15,
        w: int = 10,
        occ_frac: float = 2e-4,
        chunk: int = 16 << 20,
    ) -> "ReferenceIndex":
        """Build the index directly into the ``.vmi`` directory ``path``
        with peak memory bounded by the sketch chunk size (plus one
        hash-radix bucket), instead of materializing and argsorting the
        whole minimizer table in RAM.  Returns the memory-mapped index.

        External sort by hash radix: minimizers are spilled to 256
        bucket files keyed on the top 8 hash bits; each bucket is then
        loaded alone, lexsorted by (hash, pos), position-deduped and
        streamed into the final memory-mapped arrays.  Bucket order ==
        ascending hash order, so the result is bit-identical to
        ``build()`` (equality is tested).  This is what makes human-scale
        (3 Gb+) references buildable in a few GB of RSS, the analogue of
        minimap2's multi-part index the reference relies on via
        ``mp.Aligner`` (vacmap:344).
        """
        import json
        import os
        import shutil

        from numpy.lib.format import open_memmap

        if path.endswith(".npz"):
            path = path[: -len(".npz")]
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "_build_tmp")
        os.makedirs(tmp, exist_ok=True)

        # ``contigs`` may be a dict OR a streaming iterable of
        # (name, seq) pairs — with an iterable the genome is never held
        # in Python strings: each contig is encoded (case-insensitive
        # LUT, no .upper() copy) and appended straight into the final
        # ``seq.npy``, whose npy header is reserved up front and patched
        # with the total length once the stream ends (one disk pass
        # instead of spill-then-copy).
        import struct

        items = contigs.items() if hasattr(contigs, "items") else contigs
        names, starts, lens = [], [], []
        off = 0
        HDR = 128  # npy v1: 10-byte prelude + 118-byte padded header
        seq_path = os.path.join(path, "seq.npy")
        with open(seq_path, "w+b") as sf:
            sf.write(b"\x00" * HDR)
            for name, s in items:
                names.append(name)
                starts.append(off)
                lens.append(len(s))
                off += len(s)
                encode(s).tofile(sf)
            d = ("{'descr': '|u1', 'fortran_order': False, "
                 "'shape': (%d,), }" % off)
            pad = HDR - 10 - len(d) - 1
            hdr = (b"\x93NUMPY" + bytes([1, 0])
                   + struct.pack("<H", len(d) + pad + 1)
                   + d.encode() + b" " * pad + b"\n")
            assert len(hdr) == HDR
            sf.seek(0)
            sf.write(hdr)
        hash_dt = np.uint32 if 2 * k <= 32 else np.int64
        pos_dt = np.uint32 if off < 2**32 else np.int64
        rec_dt = np.dtype([("h", hash_dt), ("p", pos_dt), ("s", np.int8)])
        NB = 256
        shift = max(0, 2 * k - 8)

        seq_mm = np.load(seq_path, mmap_mode="r")

        # ---- fast path: native MT sorted build over the DISK-backed
        # genome (OS-paged) into disk-backed table memmaps.  Peak RSS is
        # the table working set (~2 B/bp), not the genome; output is
        # bit-identical to the spill path below (both equal build()).
        from .. import native as _native

        if (2 * k <= 32 and _native.available()
                and not os.environ.get("VACMAP_TPU_FORCE_SPILL")):
            idx = cls._external_native_table(
                path, tmp, seq_mm, names, starts, lens, k, w, occ_frac,
                hash_dt, pos_dt,
            )
            if idx is not None:
                return idx

        # ---- spill phase: sketch chunks, scatter to hash-radix buckets
        bucket_files = [
            open(os.path.join(tmp, f"b{b}.bin"), "wb") for b in range(NB)
        ]
        try:
            overlap = k + 2 * w - 3
            for ci, name in enumerate(names):
                st, ln = starts[ci], lens[ci]
                pos0 = 0
                while pos0 < ln:
                    end = min(pos0 + chunk, ln)
                    h, p, sd = minimizers(seq_mm[st + pos0 : st + end], k, w)
                    if len(h):
                        rec = np.empty(len(h), rec_dt)
                        rec["h"] = h.astype(hash_dt)
                        rec["p"] = (p + st + pos0).astype(pos_dt)
                        rec["s"] = sd
                        b = (h >> shift).astype(np.int64)
                        order = np.argsort(b, kind="stable")
                        rec = rec[order]
                        bnd = np.flatnonzero(np.diff(b[order]))
                        cuts = np.concatenate(([0], bnd + 1, [len(rec)]))
                        bids = b[order][cuts[:-1]]
                        for j, bid in enumerate(bids):
                            rec[cuts[j] : cuts[j + 1]].tofile(
                                bucket_files[int(bid)]
                            )
                    if end == ln:
                        break
                    pos0 = end - overlap
        finally:
            for f in bucket_files:
                f.close()

        # ---- merge phase A: per bucket, sort + dedup, count + occ hist
        HMAX = 1 << 16
        hist = np.zeros(HMAX + 1, np.int64)
        n_total = 0
        for b in range(NB):
            fp = os.path.join(tmp, f"b{b}.bin")
            rec = np.fromfile(fp, rec_dt)
            if len(rec):
                o = np.lexsort((rec["p"], rec["h"]))
                rec = rec[o]
                uniq = np.empty(len(rec), bool)
                uniq[0] = True
                uniq[1:] = (rec["h"][1:] != rec["h"][:-1]) | (
                    rec["p"][1:] != rec["p"][:-1]
                )
                rec = rec[uniq]
                bnd = np.flatnonzero(rec["h"][1:] != rec["h"][:-1])
                counts = np.diff(np.concatenate(([0], bnd + 1, [len(rec)])))
                hist += np.bincount(
                    np.minimum(counts, HMAX), minlength=HMAX + 1
                )
            rec.tofile(fp)  # overwrite with the sorted/deduped bucket
            n_total += len(rec)

        # occ cutoff: exact same quantile as build() (linear interpolation
        # over the multiset of per-hash counts, via the histogram)
        occ_cutoff = 2**30
        n_distinct = int(hist.sum())
        if n_distinct:
            hpos = (n_distinct - 1) * (1.0 - occ_frac)
            i0 = int(np.floor(hpos))
            cum = np.cumsum(hist)
            v0 = int(np.searchsorted(cum, i0 + 1))
            v1 = int(np.searchsorted(cum, min(i0 + 1, n_distinct - 1) + 1))
            q = v0 + (hpos - i0) * (v1 - v0)
            occ_cutoff = int(max(10, q))

        # ---- merge phase B: stream buckets (asc hash) into final arrays
        mm_h = open_memmap(
            os.path.join(path, "mm_hash.npy"), mode="w+", dtype=hash_dt,
            shape=(n_total,),
        )
        mm_p = open_memmap(
            os.path.join(path, "mm_pos.npy"), mode="w+", dtype=pos_dt,
            shape=(n_total,),
        )
        mm_s = open_memmap(
            os.path.join(path, "mm_strand.npy"), mode="w+", dtype=np.int8,
            shape=(n_total,),
        )
        cur = 0
        for b in range(NB):
            rec = np.fromfile(os.path.join(tmp, f"b{b}.bin"), rec_dt)
            if len(rec):
                mm_h[cur : cur + len(rec)] = rec["h"]
                mm_p[cur : cur + len(rec)] = rec["p"]
                mm_s[cur : cur + len(rec)] = rec["s"]
                cur += len(rec)
        for a in (mm_h, mm_p, mm_s):
            a.flush()
        del seq_mm, mm_h, mm_p, mm_s

        np.save(os.path.join(path, "starts.npy"), np.asarray(starts, np.int64))
        np.save(os.path.join(path, "lens.npy"), np.asarray(lens, np.int64))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "magic": VMI_MAGIC, "k": k, "w": w, "names": names,
                    "occ_cutoff": occ_cutoff,
                },
                f,
            )
        shutil.rmtree(tmp, ignore_errors=True)
        return cls.load(path)

    @classmethod
    def _external_native_table(cls, path, tmp, seq_mm, names, starts, lens,
                               k, w, occ_frac, hash_dt, pos_dt):
        """Genome-scale table build via the C++ MT sorted build routine
        (vacmap_native.cpp::index_build_sorted) writing into disk-backed
        int64 memmaps, then a blockwise converting copy into the final
        uint32 ``.vmi`` arrays.  Returns the loaded index, or None to
        fall through to the pure-python spill build routine (no native lib /
        capacity miss)."""
        import json
        import os
        import shutil

        from numpy.lib.format import open_memmap

        from .. import native as _native

        off = int(seq_mm.shape[0])
        cap = max(off // 2 + 64, 64)
        # table temporaries: RAM when the estimated table (density
        # 2/(w+1), 17 B/entry int64 working set, x2 safety) fits in half
        # of free memory — the build routine's RSS is then ~the table, never
        # the genome (which stays OS-paged on disk).  Disk-backed
        # memmaps otherwise (truly RAM-starved hosts; slower: the
        # radix scatter dirties them in random order).
        try:
            avail = (os.sysconf("SC_AVPHYS_PAGES")
                     * os.sysconf("SC_PAGE_SIZE"))
        except (ValueError, OSError):
            avail = 0
        est = int(off * (2.0 / (w + 1)) * 17 * 2)
        if est < avail // 2:
            th = np.empty(cap, np.int64)
            tp = np.empty(cap, np.int64)
            ts = np.empty(cap, np.int8)
        else:
            th = open_memmap(os.path.join(tmp, "th.npy"), mode="w+",
                             dtype=np.int64, shape=(cap,))
            tp = open_memmap(os.path.join(tmp, "tp.npy"), mode="w+",
                             dtype=np.int64, shape=(cap,))
            ts = open_memmap(os.path.join(tmp, "ts.npy"), mode="w+",
                             dtype=np.int8, shape=(cap,))
        m = _native.index_build_sorted_native(
            seq_mm, starts, lens, k, w, out=(th, tp, ts)
        )
        if m is None:
            return None
        mm_h = open_memmap(os.path.join(path, "mm_hash.npy"), mode="w+",
                           dtype=hash_dt, shape=(m,))
        mm_p = open_memmap(os.path.join(path, "mm_pos.npy"), mode="w+",
                           dtype=pos_dt, shape=(m,))
        mm_s = open_memmap(os.path.join(path, "mm_strand.npy"), mode="w+",
                           dtype=np.int8, shape=(m,))
        BLK = 64 << 20
        for i in range(0, m, BLK):
            j = min(i + BLK, m)
            mm_h[i:j] = th[i:j].astype(hash_dt)
            mm_p[i:j] = tp[i:j].astype(pos_dt)
            mm_s[i:j] = ts[i:j]
        for a in (mm_h, mm_p, mm_s):
            a.flush()
        occ_cutoff = cls._occ_cutoff_sorted(mm_h, occ_frac)
        del th, tp, ts, mm_h, mm_p, mm_s
        np.save(os.path.join(path, "starts.npy"),
                np.asarray(starts, np.int64))
        np.save(os.path.join(path, "lens.npy"), np.asarray(lens, np.int64))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "magic": VMI_MAGIC, "k": k, "w": w, "names": names,
                    "occ_cutoff": occ_cutoff,
                },
                f,
            )
        shutil.rmtree(tmp, ignore_errors=True)
        return cls.load(path)

    # ---- persistence -----------------------------------------------------
    # .vmi format: a directory of raw .npy arrays plus meta.json.  Arrays
    # load memory-mapped, so (a) index load is O(metadata) and (b) forked
    # worker processes share one physical copy of a genome-scale index.
    _ARRAYS = ("starts", "lens", "seq", "mm_hash", "mm_pos", "mm_strand")

    def save(self, path: str) -> None:
        import json
        import os

        if path.endswith(".npz"):
            path = path[: -len(".npz")]
        os.makedirs(path, exist_ok=True)
        meta = {
            "magic": VMI_MAGIC,
            "k": self.k,
            "w": self.w,
            "names": self.contig_names,
            "occ_cutoff": self.occ_cutoff,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        arrays = dict(
            starts=self.contig_starts, lens=self.contig_lens,
            seq=self.seq_codes, mm_hash=self.mm_hash, mm_pos=self.mm_pos,
            mm_strand=self.mm_strand,
        )
        for name in self._ARRAYS:
            np.save(os.path.join(path, name + ".npy"), arrays[name])

    @staticmethod
    def _available_ram() -> int:
        import os

        try:
            return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError):
            return 0

    @classmethod
    def load(cls, path: str, in_ram: bool = None) -> "ReferenceIndex":
        """Load a .vmi index.  ``in_ram`` materializes the arrays in RAM
        (auto: when they fit in half the free memory and VACMAP_TPU_LOWMEM
        is unset) — the per-slice python memmap overhead is a measured hot
        spot at ~40 ref windows/read, and a fork-based worker pool shares
        the pages copy-on-write."""
        import json
        import os

        if path.endswith(".npz") and not os.path.isdir(path):
            if os.path.isdir(path[: -len(".npz")]):
                path = path[: -len(".npz")]
        if os.path.isdir(path):
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            if meta.get("magic") != VMI_MAGIC:
                raise ValueError(f"not a {VMI_MAGIC} index: {path}")
            arr = {
                name: np.load(os.path.join(path, name + ".npy"), mmap_mode="r")
                for name in cls._ARRAYS
            }
            if in_ram is None:
                if os.environ.get("VACMAP_TPU_LOWMEM", ""):
                    in_ram = False
                else:
                    total = sum(a.nbytes for a in arr.values())
                    in_ram = total * 2 < cls._available_ram()
            if in_ram:
                # np.array (not ascontiguousarray: that is a NO-OP on an
                # already-contiguous memmap and silently left the arrays
                # on disk — round-5 fix) forces real RAM copies, shared
                # COW across forked workers
                arr = {k: np.array(a) for k, a in arr.items()}
            return cls(
                k=int(meta["k"]),
                w=int(meta["w"]),
                contig_names=list(meta["names"]),
                contig_starts=arr["starts"],
                contig_lens=arr["lens"],
                seq_codes=arr["seq"],
                mm_hash=arr["mm_hash"],
                mm_pos=arr["mm_pos"],
                mm_strand=arr["mm_strand"],
                occ_cutoff=int(meta["occ_cutoff"]),
            )
        # legacy single-file .npz
        z = np.load(path, allow_pickle=False)
        if str(z["magic"]) != VMI_MAGIC:
            raise ValueError(f"not a {VMI_MAGIC} index: {path}")
        return cls(
            k=int(z["k"]),
            w=int(z["w"]),
            contig_names=[str(x) for x in z["names"]],
            contig_starts=z["starts"],
            contig_lens=z["lens"],
            seq_codes=z["seq"],
            mm_hash=z["mm_hash"],
            mm_pos=z["mm_pos"],
            mm_strand=z["mm_strand"],
            occ_cutoff=int(z["occ_cutoff"]),
        )

    # ---- queries ---------------------------------------------------------
    def contig_of(self, pos: int) -> str:
        """Contig containing global position `pos` (reference pos2contig,
        mammap_clrnano.py:51)."""
        i = int(np.searchsorted(self.contig_starts, pos, side="right")) - 1
        return self.contig_names[max(i, 0)]

    def contig_index_of(self, pos: int) -> int:
        return max(int(np.searchsorted(self.contig_starts, pos, side="right")) - 1, 0)

    def start_of(self, name: str) -> int:
        return int(self.contig_starts[self.contig_names.index(name)])

    def len_of(self, name: str) -> int:
        return int(self.contig_lens[self.contig_names.index(name)])

    def fetch_codes(self, gstart: int, gend: int) -> np.ndarray:
        """Encoded reference slice in global coordinates."""
        return self.seq_codes[gstart:gend]

    def contig2seq(self) -> Dict[str, str]:
        from ..seq import decode

        out = {}
        for i, name in enumerate(self.contig_names):
            st, ln = int(self.contig_starts[i]), int(self.contig_lens[i])
            out[name] = decode(self.seq_codes[st : st + ln])
        return out

    # ---- seeding ---------------------------------------------------------
    def __post_init__(self):
        # build the prefix-bucket lookup table eagerly: the CLI and bench
        # fork workers AFTER constructing the index, so an eager table is
        # built once and shared copy-on-write — lazily each worker would
        # redo the genome-scale searchsorted and hold a private copy
        try:
            self._ensure_prefix()
        except Exception:
            pass  # degenerate arrays in tests; the lazy path will retry

    def _ensure_prefix(self):
        if not hasattr(self, "_prefix_starts"):
            # hashes are < 4^k: bucket by the top significant bits, sized
            # so buckets hold ~16 entries (probe chains shrink to ~4
            # levels on genome-scale tables; the table itself is what
            # misses, so a few-MB pstarts is a good trade).  At 3 Gb the
            # 22-bit cap left 135-entry buckets (7 probe levels — the
            # round-4 genome-scale seed tax); allow up to 26 bits when
            # the direct-index table costs < 1/16 of free RAM (512 MB at
            # 26 bits, fork-COW-shared across workers).
            bits = 2 * self.k
            want = max(16, int(len(self.mm_hash) / 16).bit_length())
            pbits = min(bits, min(want, 26))
            if pbits > 22:
                try:
                    avail = self._available_ram()
                except Exception:
                    avail = 0
                while pbits > 22 and (8 << pbits) > max(avail, 0) // 16:
                    pbits -= 1
            self._prefix_shift = max(bits - pbits, 0)
            edges = (
                np.arange(1 << min(bits, pbits), dtype=np.uint64)
                << self._prefix_shift
            ).astype(self.mm_hash.dtype)
            starts = np.searchsorted(self.mm_hash, edges, side="left")
            self._prefix_starts = np.concatenate(
                [starts, [len(self.mm_hash)]]
            ).astype(np.int64)

    def _lookup_ranges(self, h: np.ndarray):
        """Native prefix-bucketed range lookup over the sorted hash table
        (the plain searchsorted is cache-miss bound at genome scale)."""
        from .. import native

        if not native.available() or len(self.mm_hash) == 0:
            return None
        self._ensure_prefix()
        return native.hash_lookup_ranges(
            self.mm_hash, self._prefix_starts, self._prefix_shift, h
        )

    def seeds(
        self,
        read: str,
        check_num: int = 100,
        mid_occ: int = -1,
        merge: bool = True,
    ) -> np.ndarray:
        """Anchor seeding: equivalent of ``index.map(seq, check_num,
        mid_occ)`` (mammap_clrnano.py:23985).

        Returns an (n, 4) int64 array of anchors sorted by read position.
        ``mid_occ < 0`` uses the index's automatic occurrence cutoff.
        ``check_num`` caps the number of candidate reference clusters kept
        (top clusters by anchor count), bounding downstream chaining work
        on repetitive reads; <= 0 disables the cap.
        """
        codes = encode(read)
        h, p, s = minimizers(codes, self.k, self.w)
        if len(h) == 0:
            return np.empty((0, 4), np.int64)
        cutoff = self.occ_cutoff if mid_occ < 0 else mid_occ
        # one-call native tail: lookup + expand + cluster cap + colinear
        # merge + final sort (bit-identical to the numpy path below,
        # which remains the oracle/fallback)
        if merge and self.mm_hash.dtype == np.uint32:
            from .. import native

            if native.available() and len(self.mm_hash):
                self._lookup_ranges(h[:0])  # ensure prefix tables exist
                anchors = native.seeds_core_native(
                    self.mm_hash, self.mm_pos, self.mm_strand,
                    self._prefix_starts, self._prefix_shift,
                    h, p, s, cutoff,
                    check_num if check_num and check_num > 0 else 0,
                    self.k,
                )
                if anchors is not None:
                    return anchors
        # match the table dtype so searchsorted never upcasts the (large)
        # table array
        h = h.astype(self.mm_hash.dtype, copy=False)
        rng = self._lookup_ranges(h)
        if rng is not None:
            lo, hi = rng
        else:
            lo = np.searchsorted(self.mm_hash, h, side="left")
            hi = np.searchsorted(self.mm_hash, h, side="right")
        occ = hi - lo
        keep = (occ > 0) & (occ <= cutoff)
        if not np.any(keep):
            return np.empty((0, 4), np.int64)
        lo, hi, p, s = lo[keep], hi[keep], p[keep], s[keep]
        n_hits = (hi - lo).astype(np.int64)
        total = int(n_hits.sum())
        # expand hit ranges without a Python loop
        out_read = np.repeat(p, n_hits)
        out_qstrand = np.repeat(s, n_hits)
        # ragged range expansion: offsets within each range
        csum = np.concatenate(([0], np.cumsum(n_hits)))
        within = np.arange(total, dtype=np.int64) - np.repeat(csum[:-1], n_hits)
        idx = np.repeat(lo, n_hits) + within
        out_ref = self.mm_pos[idx]
        out_rstrand = self.mm_strand[idx]
        strand = (out_qstrand * out_rstrand).astype(np.int64)
        # For reverse-strand matches the minimizer position marks the
        # forward k-mer start on both sides; the matched ref interval is
        # [refpos, refpos+k) either way, which is already the leftmost
        # convention the chain DP expects.
        anchors = np.stack(
            [out_read, out_ref, strand, np.full(total, self.k, np.int64)], axis=1
        )
        if check_num and check_num > 0:
            anchors = self._cluster_cap(anchors, check_num)
        if merge and len(anchors):
            anchors = merge_colinear_anchors(anchors)
        order = np.lexsort((anchors[:, 1], anchors[:, 0]))
        return anchors[order]

    @staticmethod
    def _cluster_cap(anchors: np.ndarray, check_num: int) -> np.ndarray:
        """Keep the top `check_num` reference clusters by anchor count.

        Clusters are runs of ref-sorted anchors with gaps < 100 kb —
        an explicit reimplementation of the reference's opaque C-side
        candidate-cluster cap (CLI -c, vacmap:105).
        """
        if len(anchors) == 0:
            return anchors
        order = np.argsort(anchors[:, 1], kind="stable")
        ref_sorted = anchors[order]
        gaps = np.diff(ref_sorted[:, 1])
        boundaries = np.flatnonzero(gaps > 100_000) + 1
        cluster_id = np.zeros(len(ref_sorted), np.int64)
        cluster_id[boundaries] = 1
        cluster_id = np.cumsum(cluster_id)
        n_clusters = int(cluster_id[-1]) + 1
        if n_clusters <= check_num:
            return anchors
        counts = np.bincount(cluster_id)
        keep_clusters = np.argsort(counts)[::-1][:check_num]
        keep_mask = np.isin(cluster_id, keep_clusters)
        return ref_sorted[keep_mask]


def merge_colinear_anchors(anchors: np.ndarray, max_len: int = 250) -> np.ndarray:
    """Merge overlapping/adjacent same-diagonal anchors into longer ones.

    Mirrors what the reference's local harvester does with its per-diagonal
    cache (``mammap_clrnano.py:23198-23344``) but vectorized: anchors are
    grouped by strand-aware diagonal, and runs where each anchor starts at
    or before the previous anchor's end are fused.  Long runs are capped at
    `max_len` to keep DP bonuses bounded.
    """
    if len(anchors) == 0:
        return anchors
    readpos, refpos, strand, length = anchors.T
    diag = np.where(strand == 1, refpos - readpos, -(refpos + readpos + length))
    order = np.lexsort((readpos, diag, strand))
    a = anchors[order]
    d = diag[order]
    # break when diagonal changes or read gap > 0 (not overlapping/adjacent)
    prev_end = a[:-1, 0] + a[:-1, 3]
    new_run = np.empty(len(a), bool)
    new_run[0] = True
    new_run[1:] = (d[1:] != d[:-1]) | (a[1:, 0] > prev_end)
    run_id = np.cumsum(new_run) - 1
    n_runs = run_id[-1] + 1
    first = np.flatnonzero(new_run)
    last = np.concatenate([first[1:] - 1, [len(a) - 1]])
    r_start = a[first, 0]
    r_end = a[last, 0] + a[last, 3]
    lengths = r_end - r_start
    strands = a[first, 2]
    # refpos: +strand keeps first anchor's refpos; -strand leftmost ref is
    # the LAST anchor's refpos (ref decreases as read increases)
    refs = np.where(strands == 1, a[first, 1], a[last, 1])
    merged = np.stack([r_start, refs, strands, lengths], axis=1)
    # split runs longer than max_len into chunks
    too_long = lengths > max_len
    if np.any(too_long):
        parts = [merged[~too_long]]
        for r, y, sd, ln in merged[too_long]:
            n_chunks = int((ln + max_len - 1) // max_len)
            for c in range(n_chunks):
                off = c * max_len
                cl = min(max_len, ln - off)
                if sd == 1:
                    parts.append(np.array([[r + off, y + off, sd, cl]], np.int64))
                else:
                    # leftmost ref of chunk: total span is [y, y+ln); chunk
                    # covering read [r+off, r+off+cl) maps to ref
                    # [y+ln-off-cl, y+ln-off)
                    parts.append(
                        np.array([[r + off, y + ln - off - cl, sd, cl]], np.int64)
                    )
        merged = np.concatenate(parts)
    return merged
