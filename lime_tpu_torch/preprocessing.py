"""Preprocessing: FASTA reads + genomes → the four collection indexes
(copy of ``lime_tpu/preprocessing.py``).

Replaces the reference's entire L0/L1 stack (Install_tools_preprocessing.sh
clones seqtk/BCR/egsa/eGap; Preprocessing.sh:55-196 drives them through
reverse-complementing, per-set BWT construction and the eGap merge) with one
self-contained builder: reverse complements are computed in-process and each
collection's merged eBWT/LCP/DA is built directly.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .formats.arrays import write_docs
from .formats.fasta import read_fasta, reverse_complement, write_fasta
from .index.builder import build_index_files
from .utils.timing import PhaseTimer


def preprocess(reads1: str, reads2: Optional[str], genomes: str,
               out_dir: str, max_lcp: Optional[int] = None) -> List[str]:
    """Build collection indexes; returns the collection fasta paths.

    Paired-end (reads2 given): four collections 1F, 1RC, 2F, 2RC.
    Single-end: two collections F, RC.  Each collection file contains the
    reads of that strand followed by all genomes (document-id convention:
    reads occupy [0, numReads), reference src/ClusterLCP.cpp:20-23).
    """
    timer = PhaseTimer("preprocess")
    os.makedirs(out_dir, exist_ok=True)
    with timer.phase("load"):
        g_names, g_seqs = read_fasta(genomes)
        sets = [("1" if reads2 else "", read_fasta(reads1))]
        if reads2:
            sets.append(("2", read_fasta(reads2)))

    out_paths: List[str] = []
    for tag, (r_names, r_seqs) in sets:
        for strand in ("F", "RC"):
            with timer.phase(f"build_{tag}{strand}"):
                seqs = (r_seqs if strand == "F"
                        else [reverse_complement(s) for s in r_seqs])
                path = os.path.join(out_dir, f"col_{tag}{strand}.fasta")
                write_fasta(path, list(r_names) + list(g_names),
                            list(seqs) + list(g_seqs))
                all_seqs = list(seqs) + list(g_seqs)
                try:
                    build_index_files(path, all_seqs, max_lcp=max_lcp)
                except MemoryError:
                    # beyond-RAM regime: blockwise build + external
                    # merge under a budget (the reference's eGap --em)
                    from .index.external import build_index_files_external

                    budget = int(os.environ.get("LIME_BUILD_MEM",
                                                4 << 30))
                    build_index_files_external(path, all_seqs,
                                               mem_budget=budget,
                                               max_lcp=max_lcp)
                write_docs(path, len(seqs) + len(g_seqs))
                out_paths.append(path)
    timer.report()
    return out_paths
