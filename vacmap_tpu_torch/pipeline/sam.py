"""SAM record emission: flags, NM/MD/cs tags, SA tags, clip handling.

Equivalent of ``get_bam_dict_str`` / ``P_alignmentstring`` /
``reassign_mapq`` / ``mergecigar`` / ``nm_from_cigar``
(mammap_clrnano.py:20841-21201, :5391-5424, :11661-11707, :4773;
output_functions.py:300-349).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..seq import revcomp

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def cigar_ops(cigar: str):
    for ln, op in _CIGAR_RE.findall(cigar):
        yield int(ln), op


def merge_cigar(cigar: str) -> tuple[str, int]:
    """Merge adjacent same-op runs; returns (cigar, n_ops)."""
    out: List[list] = []
    pre_op = None
    for ln, op in _CIGAR_RE.findall(cigar):
        if op == pre_op:
            out[-1][0] += int(ln)
        else:
            out.append([int(ln), op])
            pre_op = op
    return "".join(f"{ln}{op}" for ln, op in out), len(out)


def merge_nm_collapse(cigar: str, collapse_eqx: bool):
    """One-pass cigar finishing for =/X cigars: merged cigar, op count,
    NM (X+I+D sum), and the M-collapsed output cigar.  Falls back to the
    multi-pass path when M runs are present (NM then needs sequences)."""
    from .. import native

    if native.available():
        res = native.cigar_finish_native(cigar, collapse_eqx)
        if res is not None:
            return res
    runs: List[list] = []
    pre_op = None
    nm = 0
    has_m = False
    for ln_s, op in _CIGAR_RE.findall(cigar):
        ln = int(ln_s)
        if op == "M":
            has_m = True
        elif op in "XID":
            nm += ln
        if op == pre_op:
            runs[-1][0] += ln
        else:
            runs.append([ln, op])
            pre_op = op
    merged = "".join(f"{ln}{op}" for ln, op in runs)
    if not collapse_eqx:
        return merged, len(runs), (None if has_m else nm), merged
    out: List[list] = []
    pre_op = None
    for ln, op in runs:
        if op in "=X":
            op = "M"
        if op == pre_op:
            out[-1][0] += ln
        else:
            out.append([ln, op])
            pre_op = op
    collapsed = "".join(f"{ln}{op}" for ln, op in out)
    return merged, len(out), (None if has_m else nm), collapsed


def nm_from_cigar(cigar: str, query: str, ref: str) -> int:
    """NM = mismatches (M/X) + inserted + deleted bases, Picard-consistent
    (output_functions.py:300-349).  With an =/X cigar (no M runs) NM is a
    pure op-length sum and the sequences are not touched."""
    if "M" not in cigar:
        return sum(int(ln) for ln, op in _CIGAR_RE.findall(cigar) if op in "XID")
    nm = q = r = 0
    for ln, op in cigar_ops(cigar):
        if op == "M":
            for i in range(ln):
                if query[q + i].upper() != ref[r + i].upper():
                    nm += 1
            q += ln
            r += ln
        elif op == "I":
            nm += ln
            q += ln
        elif op == "D":
            nm += ln
            r += ln
        elif op == "N":
            r += ln
        elif op == "S":
            q += ln
        elif op == "=":
            q += ln
            r += ln
        elif op == "X":
            nm += ln
            q += ln
            r += ln
    return nm


def md_cs_from_cigar(
    cigar: str, target: str, query: str, short_cs: bool = True
) -> tuple[str, str]:
    """MD and cs tag strings; the CIGAR must use =/X (not M) for matches
    (get_MD_CSshort/long, mammap_clrnano.py:19012-19141)."""
    md = []
    cs = []
    r = q = 0
    preop = ""
    eq_run = 0
    for ln, op in cigar_ops(cigar):
        if op == "X":
            if eq_run > 0:
                md.append(str(eq_run))
            elif preop == "D":
                md.append("0")
            md.append(target[r])
            cs.append("*" + (target[r] + query[q]).lower())
            for j in range(1, ln):
                md.append("0" + target[r + j])
                cs.append("*" + (target[r + j] + query[q + j]).lower())
            r += ln
            q += ln
            eq_run = 0
        elif op == "=":
            if short_cs:
                cs.append(":" + str(ln))
            else:
                cs.append("=" + target[r : r + ln].upper())
            r += ln
            q += ln
            eq_run += ln
        elif op == "D":
            if eq_run > 0:
                md.append(str(eq_run))
            elif preop == "X":
                md.append("0")
            md.append("^" + target[r : r + ln])
            cs.append("-" + target[r : r + ln].lower())
            r += ln
            eq_run = 0
        elif op == "I":
            cs.append("+" + query[q : q + ln].lower())
            q += ln
            continue
        elif op in ("S", "H"):
            continue
        else:
            return "", ""
        preop = op
    if eq_run > 0:
        md.append(str(eq_run))
    return "".join(md), "".join(cs)


def reassign_mapq(records: List[list]) -> List[list]:
    """--markunbalancetra: greedily link sub-alignments colinear on the
    reference (refgap < 10, within 100 kb); unlinked ones get MAPQ 0
    (mammap_clrnano.py:11661-11707)."""
    iloc = 0
    g_list = [iloc]
    while g_list[-1] < len(records) - 1:
        iloc = g_list[-1]
        test = iloc
        b = records[iloc]
        hit = False
        while test + 1 < len(records):
            test += 1
            r = records[test]
            if r[1] != b[1]:
                continue
            if r[2] == "+":
                refgap = r[5] - b[6]
            else:
                refgap = b[5] - r[6]
            if abs(refgap) > 100_000:
                continue
            if refgap < 10:
                g_list.append(test)
                hit = True
                break
        if not hit:
            g_list.append(iloc + 1)
    out = []
    for i, rec in enumerate(records):
        rec = list(rec)
        if i not in g_list:
            rec[7] = 0
        out.append(rec)
    return out


def paired_indel(cigars: List[str], indelsize: int = 30) -> bool:
    """True when >= 2 indels > indelsize of similar size (ratio > 0.7)
    exist across the records (pairedindel, mammap_clrnano.py:5604-5650)."""
    indel = []
    for cig in cigars:
        for ln, op in cigar_ops(cig):
            if op in ("D", "I") and ln > indelsize:
                indel.append(ln)
    indel.sort()
    pre = 0
    for now in indel:
        if pre and min(pre, now) / max(pre, now) > 0.7:
            return True
        pre = now
    return False


def _emit_mq(mq: int, quantize: bool) -> int:
    if quantize:
        return 60 if mq != 0 else 1
    return mq


def sam_tag(tag: str, value) -> str:
    if isinstance(value, int):
        code = "i"
    elif isinstance(value, float):
        code = "f"
    else:
        code = "Z"
    return f"{tag}:{code}:{value}"


def sam_line(fields: Dict) -> str:
    cols = ["*", "4", "*", "0", "255", "*", "*", "0", "0", "*", "*"]
    order = {
        "QNAME": 0, "FLAG": 1, "RNAME": 2, "POS": 3, "MAPQ": 4,
        "CIGAR": 5, "RNEXT": 6, "PNEXT": 7, "TLEN": 8, "SEQ": 9, "QUAL": 10,
    }
    extras = []
    for k, v in fields.items():
        if k in order:
            cols[order[k]] = str(v)
        else:
            extras.append(sam_tag(k, v))
    return "\t".join(cols + extras)


def records_to_sam(
    records: List[list],
    query: str,
    qual: Optional[str],
    ref_fetch,  # callable(contig, start, end) -> str
    md: bool = False,
    cs: bool = False,
    short_cs: bool = True,
    cigar2cg: bool = False,
    markunbalancetra: bool = False,
    hardclip: bool = False,
    fakecigar: bool = False,
    rg_id: Optional[str] = None,
    comment: Optional[str] = None,
    collapse_eqx: bool = False,
    keep_order: bool = False,
    mapq_quantize: bool = False,
) -> List[str]:
    """Records (readid, contig, strand, q_st, q_en, r_st, r_en, mapq,
    cigar) -> SAM text lines.  Longest query span becomes the primary
    (flag 0/16); the rest are supplementary (2048/2064) with SA tags.

    ``keep_order=True`` is the R-mode emitter
    (mammap_noprefercloser.py live get_bam_dict_str): records keep their
    upstream order (the reference's ``sortbycontig`` key is x[0], the
    readid — a stable no-op sort) and a mapq-1 first record is demoted
    when the second record isn't mapq 1.

    ``mapq_quantize=True`` is the asm emitter's MAPQ rule: emitted MAPQ
    (and SA-tag mq) is 60 for any nonzero raw mapq, else 1
    (mammap_asm.py live get_bam_dict_str); the demotion rule above still
    sees the raw values."""
    if markunbalancetra:
        records = reassign_mapq(records)
    else:
        records = [list(r) for r in records]

    rc_query = revcomp(query)
    primary_iloc = 0
    if keep_order:
        if len(records) > 1 and records[0][7] == 1 and records[1][7] != 1:
            primary_iloc = 1
    else:
        # stable sort ascending then reverse (ties reversed, matching the
        # reference's sort + [::-1] at mammap_clrnano.py:20855-20856)
        records.sort(key=lambda r: r[4] - r[3])
        records.reverse()

    iloc2nm, iloc2md, iloc2cs, iloc2ncig, iloc2fake = {}, {}, {}, {}, {}
    clip = "H" if hardclip else "S"
    for i, item in enumerate(records):
        oriented = query if item[2] == "+" else rc_query
        cigarstring, n_cigar, nm_fast, out_cigar = merge_nm_collapse(
            item[8], collapse_eqx
        )
        # the reference slice is only needed for MD/cs or M-op NM
        need_ref = md or cs or nm_fast is None
        tmp_query = oriented[item[3] : item[4]] if need_ref else ""
        tmp_target = ref_fetch(item[1], item[5], item[6]) if need_ref else ""
        if md or cs:
            mdstr, csstr = md_cs_from_cigar(cigarstring, tmp_target, tmp_query, short_cs)
            iloc2md[i] = mdstr
            iloc2cs[i] = csstr
        if nm_fast is not None:
            iloc2nm[i] = nm_fast
        else:
            # soft-clipped cigars walk the full read (S advances the query
            # cursor); hard-clipped cigars walk the aligned slice
            iloc2nm[i] = nm_from_cigar(
                cigarstring, tmp_query if hardclip else oriented, tmp_target
            )
        item[8] = out_cigar
        iloc2ncig[i] = n_cigar
        if fakecigar:
            top = f"{item[3]}{clip}" if item[3] > 0 else ""
            tail = f"{len(query) - item[4]}{clip}" if len(query) - item[4] > 0 else ""
            diff = item[4] - item[3] - item[6] + item[5]
            if diff > 0:
                body = f"{item[6] - item[5]}M{diff}I"
            elif diff < 0:
                body = f"{item[4] - item[3]}M{abs(diff)}D"
            else:
                body = f"{item[4] - item[3]}M"
            iloc2fake[i] = top + body + tail

    if qual is not None and len(qual) != len(query):
        qual = None
    rc_qual = qual[::-1] if qual is not None else None

    lines = []
    for i, item in enumerate(records):
        d: Dict = {}
        if rg_id is not None:
            d["RG"] = rg_id
        d["QNAME"] = item[0]
        d["RNAME"] = item[1]
        base = 0 if i == primary_iloc else 2048
        d["FLAG"] = str(base if item[2] == "+" else base + 16)
        d["POS"] = str(item[5] + 1)
        if iloc2ncig[i] > 65535 and cigar2cg:
            d["CG"] = item[8]
        else:
            d["CIGAR"] = item[8]
        if len(records) > 1:
            sa = []
            for j, other in enumerate(records):
                if j == i:
                    continue
                cig = iloc2fake[j] if fakecigar else other[8]
                mq_j = _emit_mq(other[7], mapq_quantize)
                sa.append(
                    f"{other[1]},{other[5] + 1},{other[2]},{cig},{mq_j},{iloc2nm[j]};"
                )
            d["SA"] = "".join(sa)
        d["MAPQ"] = str(_emit_mq(item[7], mapq_quantize))
        if item[2] == "+":
            d["SEQ"] = query[item[3] : item[4]] if hardclip else query
            qsrc = qual
        else:
            d["SEQ"] = rc_query[item[3] : item[4]] if hardclip else rc_query
            qsrc = rc_qual
        if qsrc is not None:
            d["QUAL"] = qsrc[item[3] : item[4]] if hardclip else qsrc
        d["NM"] = iloc2nm[i]
        if md:
            d["MD"] = iloc2md[i]
        if cs:
            d["cs"] = iloc2cs[i]
        if comment is not None:
            # FASTA/Q comment copied verbatim as a CO-style trailing field
            lines.append(sam_line(d) + "\t" + comment)
        else:
            lines.append(sam_line(d))
    return lines
