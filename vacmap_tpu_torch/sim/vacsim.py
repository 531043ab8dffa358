"""vacsim-tpu-torch: structural-variant simulator (counterpart of
``vacmap_tpu/sim/vacsim.py``, a reimplementation of VACmap's vacsim tool;
the same seed writes the same altered genome and truth VCF).

Reads a parameter file composed of lines:

    Specified{DEL:500:1000;number=20}
    Random{eventset=['DEL:100:200,NML:100:200','INV:100:200'];eventcount=[1,5];number=50}

composes DEL/INS/INV/DUP/TRA/NML events into (possibly complex) SVs,
places them in N-free genome intervals, writes the altered FASTA (two
haplotypes when heterozygous_ratio > 0) and a truth VCF.

Improvements over the reference: seeded RNG (-seed) for reproducibility;
no heapdict/pysam/pandas dependencies; 'reference' mode (swapping
INS<->DEL truth coordinates into the altered-genome frame) implemented
with the built-in VCF reader.
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..seq import revcomp

EDGE = 200


# ---------------------------------------------------------------------------
# event grammar
# ---------------------------------------------------------------------------


def decode_sv_recipe(recipe: str, rng) -> Tuple[int, int, List[list]]:
    """Expand one recipe string 'OP:min:max[,...],times' into concrete
    event layouts in SV-local coordinates (reference decode_sim_sv_info)."""
    parts = recipe.split(",")
    times = int(parts[-1])
    ops = parts[:-1]
    s1 = s2 = 0
    out: List[list] = []
    preop = ""
    for _ in range(times):
        for op in ops:
            f = op.split(":")
            svtype = f[0]
            svlen = int(rng.integers(int(f[1]), int(f[2])))
            if svtype == "DEL":
                out.append(["DEL", s1, s1 + svlen])
                s1 += svlen
            elif svtype == "INS":
                out.append(["INS", s1, svlen])
            elif svtype == "DUP":
                rev, dup_times = int(f[3]), int(f[4])
                out.append(["DUP", s1, s1 + svlen, rev, dup_times])
                s1 += svlen
            elif svtype == "INV":
                out.append(["INV", s1, s1 + svlen])
                s1 += svlen
            elif svtype == "TRA":
                rev = int(f[3])
                out.append(["TRA", s1, s1 + svlen, s2, s2 + svlen, rev])
                s1 += svlen
                s2 += svlen
            elif svtype == "NML":
                s1 += svlen
                if preop == "TRA":
                    s2 += svlen
            preop = svtype
    return s1, s2, out


def random_recipes(eventset, eventcount, number, rng) -> List[str]:
    """Compose random complex-SV recipes from an event menu
    (reference random_create_sim_sv_info_list, the live second def)."""
    recipes = []
    for _ in range(number):
        n_events = int(rng.integers(max(eventcount[0], 1), max(eventcount[1], 1)))
        done = 0
        style = ""
        for _try in range(1000):
            if done >= n_events:
                break
            menu = eventset[int(rng.integers(0, len(eventset)))]
            for ev in menu.split(","):
                if not ev:
                    continue
                f = ev.split(":")
                svtype, lo, hi = f[0], f[1], f[2]
                if svtype in ("DEL", "INS", "INV", "NML"):
                    style += f"{svtype}:{lo}:{hi},"
                elif svtype == "DUP":
                    style += f"DUP:{lo}:{hi}:0:1,"
                    done += 1
                elif svtype == "TRA":
                    rev = int(rng.integers(0, 2))
                    style += f"TRA:{lo}:{hi}:{rev},"
                    done += 1
                if svtype != "NML":
                    done += 1
        recipes.append(style + "1")
    return recipes


def parse_parameter_file(text: str, rng) -> List[Tuple[int, int, List[list]]]:
    decoded = []
    for raw in text.split("\n"):
        line = raw.replace(" ", "")
        if not line or "{" not in line:
            continue
        head = line.split("{")[0]
        body = line[len(head) + 1 : -1]
        if head == "Specified":
            number = int(body.split(";")[-1].split("=")[1])
            recipe = body.split(";")[0] + ",1"
            for _ in range(number):
                decoded.append(decode_sv_recipe(recipe, rng))
        elif head == "Random":
            params = {}
            for item in body.split(";"):
                k, v = item.split("=", 1)
                params[k] = ast.literal_eval(v)
            for recipe in random_recipes(
                params["eventset"], params["eventcount"], params["number"], rng
            ):
                decoded.append(decode_sv_recipe(recipe, rng))
    decoded.sort(key=lambda d: d[0], reverse=True)
    return decoded


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class IntervalPool:
    """N-free interval pool per contig; placing an SV splits its interval
    so SVs never overlap (reference contig2usable_interval heapdict)."""

    def __init__(self, contigs: Dict[str, str]):
        self.pool: Dict[str, List[Tuple[int, int]]] = {}
        self.names: List[str] = []
        probs = []
        for name, seq in contigs.items():
            ivals = []
            good_start = None
            n_good = 0
            for i, c in enumerate(seq):
                if c in "ACGT":
                    if good_start is None:
                        good_start = i
                    n_good += 1
                else:
                    if good_start is not None and i - good_start > EDGE:
                        ivals.append((good_start, i))
                    good_start = None
            if good_start is not None and len(seq) - good_start > EDGE:
                ivals.append((good_start, len(seq)))
            self.pool[name] = ivals
            self.names.append(name)
            probs.append(n_good)
        total = sum(probs) or 1
        self.probs = np.array(probs, float) / total

    def place(self, span1: int, span2: int, rng):
        """Returns (ok, contig1, start1, contig2, start2)."""
        for _ in range(50):
            c1 = self.names[int(rng.choice(len(self.names), p=self.probs))]
            c2 = self.names[int(rng.choice(len(self.names), p=self.probs))]
            if span2 > 0 and c1 == c2 and len(self.names) > 1:
                continue
            s1 = self._take(c1, span1, rng)
            if s1 is None:
                continue
            if span2 == 0:
                return True, c1, s1, c1, s1
            s2 = self._take(c2, span2, rng)
            if s2 is None:
                continue
            return True, c1, s1, c2, s2
        return False, "-1", -1, "-1", -1

    def _take(self, contig: str, span: int, rng):
        ivals = self.pool[contig]
        if not ivals:
            return None
        order = rng.permutation(len(ivals))
        for k in order:
            a, b = ivals[k]
            if b - a - 2 * EDGE <= span or a + EDGE >= b - span - EDGE:
                continue
            start = int(rng.integers(a + EDGE, b - span - EDGE))
            ivals.pop(int(k))
            ivals.append((a, start))
            ivals.append((start + span, b))
            return start
        return None


# ---------------------------------------------------------------------------
# applying events
# ---------------------------------------------------------------------------


def materialize(event, c1, c2, r1, r2, contigs, uid):
    """One event -> list of edit ops [contig, start, end, alt_seq, type,
    uid, truth_record] (reference add_SV)."""
    t = event[0]
    if t == "DEL":
        st, en = r1 + event[1], r1 + event[2]
        return [[c1, st, en, "", "DEL", uid, ["DEL", c1, st, en]]]
    if t == "INS":
        st, ln = r1 + event[1], event[2]
        alt = "".join(np.random.default_rng(abs(hash((uid, st))) % 2**31).choice(
            list("ACGT"), ln))
        return [[c1, st, st, alt, "INS", uid, ["INS", c1, st, ln]]]
    if t == "INV":
        st, en = r1 + event[1], r1 + event[2]
        alt = revcomp(contigs[c1][st:en])
        return [[c1, st, en, alt, "INV", uid, ["INV", c1, st, en]]]
    if t == "DUP":
        st, en, rev, times = r1 + event[1], r1 + event[2], event[3], event[4]
        seg = contigs[c1][st:en]
        if rev:
            seg = revcomp(seg)
        return [[c1, en, en, seg * times, "DUP", uid, ["DUP", c1, st, en, rev, times]]]
    if t == "TRA":
        st1, en1 = r1 + event[1], r1 + event[2]
        st2, en2 = r2 + event[3], r2 + event[4]
        rev = event[5]
        a = contigs[c2][st2:en2]
        b = contigs[c1][st1:en1]
        if rev:
            a, b = revcomp(a), revcomp(b)
        truth = ["TRA", c1, st1, en1, c2, st2, en2, rev]
        return [
            [c1, st1, en1, a, "TRA", uid, truth],
            [c2, st2, en2, b, "TRA", uid, truth],
        ]
    return []


SVTYPE_CODE = {"INS": 1, "DEL": 2, "INV": 3, "DUP": 4, "TRA": 5}


def write_vcf(records, contig2length, path):
    lines = [
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed">',
    ]
    for c, ln in contig2length.items():
        lines.append(f"##contig=<ID={c},length={int(ln)}>")
    lines += [
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the structural variant">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of SV">',
        '##INFO=<ID=SVLEN,Number=.,Type=Integer,Description="Difference in length between REF and ALT alleles">',
        '##INFO=<ID=CHR2,Number=1,Type=String,Description="Partner contig for BND">',
        '##INFO=<ID=bp,Number=1,Type=Integer,Description="Breakpoint">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t.",
    ]
    seen = set()
    for rec in sorted(records, key=lambda r: (r[0], r[1])):
        key = tuple(map(str, rec))
        if key in seen:
            continue
        seen.add(key)
        contig, start, svlen, bp, uid, chr2, code = rec
        name = {1: "INS", 2: "DEL", 3: "INV", 4: "DUP", 5: "BND"}[code]
        if code == 1:
            info = f"SVLEN={svlen};SVTYPE=INS;END={start + 1};bp={bp}"
        elif code == 5:
            info = f"SVLEN=999;SVTYPE=BND;END={svlen};CHR2={chr2};bp={bp}"
        else:
            info = f"SVLEN={svlen};SVTYPE={name};END={start + svlen};bp={bp}"
        lines.append(f"{contig}\t{start}\t{uid}\t.\t.\t999\tPASS\t{info}\tGT\t.")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def simulate(
    parameter_text: str,
    contigs: Dict[str, str],
    heterozygous_ratio: float = 0.8,
    seed: int = 0,
) -> Tuple[Dict[str, str], List[list]]:
    """Returns (altered contigs, truth vcf records)."""
    rng = np.random.default_rng(seed)
    decoded = parse_parameter_file(parameter_text, rng)
    pool = IntervalPool(contigs)
    contig_ops: Dict[str, List] = {}
    het: Dict[int, bool] = {}
    uid = 1
    for span1, span2, events in decoded:
        ok, c1, r1, c2, r2 = pool.place(span1, span2, rng)
        if not ok:
            raise RuntimeError("Failed to simulate: no space available")
        for ev in events:
            het[uid] = int(rng.integers(100)) <= heterozygous_ratio * 100
            for op in materialize(ev, c1, c2, r1, r2, contigs, uid):
                contig_ops.setdefault(op[0], []).append(op)
        uid += 1

    vcf_truth = []
    altered: Dict[str, str] = {}
    for contig, seq in contigs.items():
        ops = sorted(contig_ops.get(contig, []), key=lambda o: o[1])
        hap1, hap2 = [], []
        pre = 0
        for op in ops:
            hap1.append(seq[pre : op[1]])
            hap2.append(seq[pre : op[1]])
            hap1.append(op[3])
            hap2.append(op[3] if not het[op[5]] else seq[op[1] : op[2]])
            pre = op[2]
            vcf_truth.append(op[6] + [op[5]])
        hap1.append(seq[pre:])
        hap2.append(seq[pre:])
        if heterozygous_ratio > 0:
            altered[contig + "_hap1"] = "".join(hap1)
            altered[contig + "_hap2"] = "".join(hap2)
        else:
            altered[contig] = "".join(hap1)
    return altered, vcf_truth


def truth_to_vcf_rows(vcf_truth):
    rows = []
    for line in dict(((tuple(map(str, t))), t) for t in vcf_truth).values():
        t = line[0]
        uid = line[-1]
        if t in ("DEL", "INV", "DUP"):
            rows.append([line[1], line[2], line[3] - line[2], line[2], uid, "", SVTYPE_CODE[t]])
        elif t == "INS":
            rows.append([line[1], line[2], line[3], line[2], uid, "", 1])
        elif t == "TRA":
            rows.append([line[1], line[2], line[5], line[2], uid, line[4], 5])
            rows.append([line[1], line[3], line[6], line[3], uid, line[4], 5])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vacsim-tpu-torch")
    ap.add_argument("-parameterfilepath", required=True)
    ap.add_argument("-inputgenomepath", required=True)
    ap.add_argument("-altedgenomepath", required=True)
    ap.add_argument("-outputvcfpath", required=True)
    ap.add_argument("-heterozygous_ratio", type=float, default=0.8)
    ap.add_argument("-mode", default="read", choices=["read", "reference"])
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..io.fastx import fastx_read

    contigs = {}
    for rec in fastx_read(args.inputgenomepath):
        contigs[rec[0]] = rec[1].upper()
    with open(args.parameterfilepath) as f:
        text = f.read()
    altered, truth = simulate(text, contigs, args.heterozygous_ratio, args.seed)
    with open(args.altedgenomepath, "w") as f:
        for name, seq in altered.items():
            f.write(f">{name}\n{seq}\n")
    rows = truth_to_vcf_rows(truth)
    if args.mode == "reference":
        # swap INS<->DEL and shift truth coordinates into the altered frame
        rows.sort(key=lambda r: (r[0], r[1]))
        bias = 0
        out = []
        for r in rows:
            r = list(r)
            if args.heterozygous_ratio > 0:
                r[0] = r[0] + "_hap1"
            r[1] += bias
            if r[6] == 1:  # INS -> DEL
                r[6] = 2
                bias += abs(r[2])
            elif r[6] == 2:  # DEL -> INS
                r[6] = 1
                bias -= abs(r[2])
            else:
                print("Fail in reference mode: unsupported SVTYPE", file=sys.stderr)
                return 1
            out.append(r)
        rows = out
    contig2length = {c: len(s) for c, s in contigs.items()}
    write_vcf(rows, contig2length, args.outputvcfpath)
    return 0


if __name__ == "__main__":
    sys.exit(main())
