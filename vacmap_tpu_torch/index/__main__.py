"""Standalone index pre-build: python -m vacmap_tpu_torch.index ref.fa [out.vmi.npz] [k] [w]

Equivalent of the reference's index.py helper (index.py:26)."""

import sys

from ..io.fastx import fastx_read
from .index import ReferenceIndex


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    ref = sys.argv[1]
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 15
    w = int(sys.argv[4]) if len(sys.argv) > 4 else 10
    out = sys.argv[2] if len(sys.argv) > 2 else f"{ref}.w{w}_k{k}.vmi"
    # in-RAM native build when it fits (~8 B/bp peak; 10x faster than
    # the bounded-memory external-sort build routine), external otherwise or
    # with VACMAP_TPU_LOWMEM=1
    import os

    fsize = os.path.getsize(ref)
    approx = fsize * 4 if ref.endswith(".gz") else fsize
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        avail = 0
    if os.environ.get("VACMAP_TPU_LOWMEM") or approx * 8 >= avail // 2:
        ReferenceIndex.build_external(
            ((r[0], r[1]) for r in fastx_read(ref)), out, k=k, w=w
        )
    else:
        contigs = {r[0]: r[1] for r in fastx_read(ref)}
        ReferenceIndex.build(contigs, k=k, w=w).save(out)
    print(f"index written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
