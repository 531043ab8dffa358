"""The comparison that decides ``correct``: a sample of the reads whose
records the window emitted, judged by the plain reference (``judge.py``)
against the generator's truth and a plain DP, each number beside the
limit that the configuration's ``check`` gives it.

The sample is drawn from the seed and always holds the longest reads the
window mapped.  ``sam_faults`` is exact (limit 0); ``unplaced_share`` and
``score_gap_per_kb`` have limits set between what sound runs read and
what the bfloat16 control and the planted faults read (PERF.md gives the
readings).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import judge

LIMITS = ("sam_faults", "unplaced_share", "score_gap_per_kb")


def sample(lengths: Sequence[int], seed: int, n: int, longest: int) -> List[int]:
    """Indices of ``n`` reads (or all, when fewer): the ``longest``
    longest, and the rest drawn from the seed."""
    count = len(lengths)
    if count <= n:
        return list(range(count))
    order = np.argsort(-np.asarray(lengths), kind="stable")
    chosen = set(order[:longest].tolist())
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x5EED])
    rest = [i for i in rng.permutation(count).tolist() if i not in chosen]
    chosen.update(rest[: n - len(chosen)])
    return sorted(chosen)


def compare(pool, lines, seed: int, chk: dict, genome, contig: str,
            control: bool = False, log=None):
    """(checks, judge's numbers): ``checks`` maps each compared number to
    ``{"value", "limit"}``; ``lines`` are the program's SAM lines of the
    pool's first ``len(lines)`` reads."""
    idx = sample([len(pool.reads[i][1]) for i in range(len(lines))], seed,
                 int(chk["sample_reads"]), int(chk["longest_reads"]))
    got = judge.judge([pool.reads[i] for i in idx], [lines[i] for i in idx],
                      [pool.truth(i) for i in idx], genome, contig,
                      control=control, show=log)
    checks = {k: {"value": got[k], "limit": chk["limits"][k]} for k in LIMITS}
    return checks, got


def passed(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
