"""The numbers that decide ``correct``: what the program wrote, counted
against the plain reference's answer.  Every count is exact (limit 0)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def csv_rows_wrong(path: str, want: Sequence[str]) -> int:
    """Lines of the CSV at ``path`` that differ from ``want`` (the
    reference's lines, header first), a missing or extra line counting
    as one."""
    with open(path) as f:
        got = f.read().split("\n")
    if got and got[-1] == "":
        got.pop()
    same = sum(a == b for a, b in zip(got, want))
    return max(len(got), len(want)) - same


def clusters_wrong(path: str, p_start: np.ndarray, lens: np.ndarray) -> int:
    """Records of a ``.clrs`` file (u64 first row, u64 rows) not among the
    reference's clusters, plus reference clusters missing from it."""
    rec = np.fromfile(path, np.uint64).reshape(-1, 2).astype(np.int64)
    got = (rec[:, 0] << 17) | rec[:, 1]
    want = (np.asarray(p_start, np.int64) << 17) | np.asarray(lens,
                                                              np.int64)
    if np.array_equal(got, want):
        return 0
    return int(np.setxor1d(got, want).size)


def res_reads_wrong(prefix: str, pos_want: np.ndarray,
                    recs_want: np.ndarray) -> int:
    """Reads whose ``.res`` score list (``<prefix>.pos`` entry and its
    header and entries in ``<prefix>.bin``) differs from the reference's;
    one more if the record streams differ elsewhere (sentinel, tail)."""
    pos = np.fromfile(prefix + ".pos", np.uint64)
    recs = np.fromfile(prefix + ".bin", np.uint64)
    R = len(pos_want)
    if len(pos) != R:
        return R
    wrong = pos != pos_want
    idx = np.flatnonzero(~wrong & (pos_want > 0))
    start = pos_want[idx].astype(np.int64)
    size = (recs_want[start] >> np.uint64(32)).astype(np.int64) + 1
    inside = start + size <= len(recs)
    wrong[idx[~inside]] = True
    idx, start, size = idx[inside], start[inside], size[inside]
    src = (np.repeat(start - (np.cumsum(size) - size), size)
           + np.arange(int(size.sum())))
    differs = recs[src] != recs_want[src]
    wrong[np.repeat(idx, size)[differs]] = True
    n = int(wrong.sum())
    if n == 0 and (len(recs) != len(recs_want) or len(recs) == 0
                   or recs[0] != recs_want[0]):
        n = 1
    return n


def accuracy(path: str, truth_taxid: np.ndarray) -> dict:
    """Sensitivity and precision of an assignment CSV against the planted
    origins (``truth_taxid[i]`` the taxid read i came from, -1 for a
    negative control): a C or H row at the true taxid is a true positive,
    at another (or on a negative control) a false positive, and a
    positive read left U or A a false negative."""
    with open(path) as f:
        rows: List[List[str]] = [line.split(",") for line in
                                 f.read().split("\n")[1:] if line]
    tp = fp = fn = 0
    for (kind, rid, taxid, _), want in zip(rows, truth_taxid.tolist()):
        if kind in ("C", "H"):
            if int(taxid) == want:
                tp += 1
            else:
                fp += 1
        elif want >= 0:
            fn += 1
    return {"sensitivity": tp / max(tp + fn, 1),
            "precision": tp / max(tp + fp, 1)}
