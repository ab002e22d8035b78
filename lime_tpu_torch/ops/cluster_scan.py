"""Alpha-cluster detection (pipeline step 1) on the host.

Copies of ``lime_tpu/ops/cluster_scan.py``'s :func:`find_clusters` (the
numpy scan, verbatim) and :func:`cluster_metadata`.  The staged
``cluster_lcp`` takes the native planner (``native.plan_clusters``) and
falls back to :func:`find_clusters` when the native library is missing
(``native.available()`` False), as ``lime_tpu`` does.

Semantics (reference src/ClusterLCP.cpp:14-43, 191-264): scanning positions
i = 1..n-1, a cluster opens at the first i with lcp[i] >= alpha and covers
rows [i-1, j-1] where j is the first subsequent position with lcp[j] < alpha;
the emitted record is (p_start = i-1, len = j-i+1).  A cluster is kept only
if its rows contain at least one read (da < num_reads) and one genome: with
m[i] = lcp[i] >= alpha (m[0] False), clusters are the maximal runs of m
extended one row left, and membership is a range-sum of the read indicator.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats.arrays import AuxMetadata


def find_clusters(lcp: np.ndarray, da: np.ndarray, num_reads: int,
                  alpha: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (p_start, lens) int64 arrays of kept alpha-clusters, in order."""
    n = len(lcp)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    m = lcp >= alpha
    m[0] = False

    mi = m.astype(np.int8)
    d = np.diff(mi)
    run_starts = np.flatnonzero(d == 1) + 1  # first i of each run
    run_ends = np.flatnonzero(d == -1) + 1  # one past last i of each run
    if m[-1]:
        run_ends = np.append(run_ends, n)

    p_start = run_starts - 1
    lens = run_ends - p_start  # rows [p_start, run_end-1]

    # Membership: count reads among rows [p_start, run_end).
    is_read = (da < num_reads).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(is_read)])
    n_reads_in = csum[run_ends] - csum[p_start]
    keep = (n_reads_in > 0) & (n_reads_in < lens)
    return p_start[keep], lens[keep]


def cluster_metadata(p_start: np.ndarray, lens: np.ndarray, num_reads: int,
                     num_genomes: int, alpha: int) -> AuxMetadata:
    return AuxMetadata(
        num_reads=num_reads,
        num_genomes=num_genomes,
        alpha=alpha,
        max_len=int(lens.max()) if len(lens) else 0,
        n_clusters=int(len(lens)),
    )
