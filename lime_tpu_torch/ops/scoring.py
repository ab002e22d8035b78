"""Cluster scoring (pipeline step 2) on the host: the numpy exact scorer.

Copies of ``lime_tpu/ops/scoring.py``: :func:`_expand_positions`,
:func:`_segment_stats`, :func:`_pair_indices`, :func:`iupac_waterfall`
and :func:`normalize_scores` verbatim, and :func:`score_clusters`, whose
pairs score in groups on a thread pool (below).  The port's exact
scores come from the native SIMD scorer
(``native.score_clusters_native``); this scorer is what runs without
the native library (``native.available()`` False), as in ``lime_tpu``,
and an oracle that shares no code with it.

The dense read x genome similarity matrix from the alpha-clusters, in
one of two variants (the reference selects at compile time,
src/ClusterBWT_DA.cpp:80-252):

- symbol-aware (EBWT=1): per (cluster, document) 16-symbol histograms; a
  (read, genome) pair in a cluster scores sum_sym min(read_h, ref_h) plus
  greedy matching of leftover ACGT symbols against leftover IUPAC-degenerate
  symbols.
- document-only (EBWT=0): per (cluster, document) occurrence counts; the
  pair scores min(read_count, ref_count).

Parity notes (the reference's counter semantics):

- eBWT bytes map through a 256-entry LUT defaulting to rank 0 — the
  reference's unordered_map operator[] default-inserts 0 for unknown bytes
  such as '$' (src/ClusterBWT_DA.cpp:39 via umapIUPAC).
- genome counters saturate at 255 (USim_MAX) per increment
  (src/ClusterBWT_DA.cpp:96, 222); read counters and the similarity matrix
  are unsaturated uchar and wrap mod 256 (src/ClusterBWT_DA.cpp:123, 183).
  Wrapping per-increment equals a final mod, so we accumulate wide and wrap
  once; the dense matrix itself is stored u8 so += wraps exactly like the
  reference's SimArray_.
- the IUPAC leftover waterfall reproduces the reference's order-of-update
  quirk in its first pairing block (src/ClusterBWT_DA.cpp:150-161): the
  losing counter is zeroed but the winning counter is never decremented.

Everything is one grouped computation: expand clusters to a position
stream, lexsort by (cluster, document), build per-segment histograms
with one scatter-add, then score all (read-segment, genome-segment)
pairs in vectorized chunks.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from ..config import LimeConfig
from ..constants import (
    ALPHABET_SIZE,
    IUPAC_WATERFALL_PAIRS,
    SIM_SATURATE_U8,
    SYMBOL_RANK_LUT,
)


def _expand_positions(p_start: np.ndarray, lens: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(cluster id, global position) per covered index row."""
    total = int(lens.sum())
    cid = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    offsets = np.concatenate([[0], np.cumsum(lens[:-1])])
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets, lens)
    gpos = np.repeat(p_start, lens) + within
    return cid, gpos


def _segment_stats(cid: np.ndarray, doc: np.ndarray, sym: np.ndarray | None):
    """Group the position stream by (cluster, document).

    Returns (seg_cid, seg_doc, seg_count, seg_hist or None), segments sorted
    by (cluster, document).
    """
    order = np.lexsort((doc, cid))
    cid_s, doc_s = cid[order], doc[order]
    new_seg = np.empty(len(cid_s), dtype=bool)
    new_seg[0] = True
    new_seg[1:] = (cid_s[1:] != cid_s[:-1]) | (doc_s[1:] != doc_s[:-1])
    seg_id = np.cumsum(new_seg) - 1
    n_seg = int(seg_id[-1]) + 1
    starts = np.flatnonzero(new_seg)
    seg_cid = cid_s[starts]
    seg_doc = doc_s[starts]
    seg_count = np.diff(np.append(starts, len(cid_s)))
    seg_hist = None
    if sym is not None:
        seg_hist = np.zeros((n_seg, ALPHABET_SIZE), dtype=np.int64)
        np.add.at(seg_hist, (seg_id, sym[order]), 1)
    return seg_cid, seg_doc, seg_count, seg_hist


def _pair_indices(seg_cid: np.ndarray, is_read_seg: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """All (read-segment, genome-segment) index pairs within each cluster.

    Segments are sorted by (cluster, doc) and reads have smaller doc ids, so
    each cluster's segments are its read segments followed by its genome
    segments.
    """
    n_seg = len(seg_cid)
    first = np.flatnonzero(np.concatenate(
        [[True], seg_cid[1:] != seg_cid[:-1]]))
    seg_per = np.diff(np.append(first, n_seg))
    csum_read = np.concatenate([[0], np.cumsum(is_read_seg)])
    n_read = csum_read[first + seg_per] - csum_read[first]
    n_gen = seg_per - n_read

    pairs_per = n_read * n_gen
    total = int(pairs_per.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    pc = np.repeat(np.arange(len(first), dtype=np.int64), pairs_per)
    offsets = np.concatenate([[0], np.cumsum(pairs_per[:-1])])
    q = np.arange(total, dtype=np.int64) - np.repeat(offsets, pairs_per)
    g_per = n_gen[pc]
    r_idx = q // g_per
    g_idx = q - r_idx * g_per
    rs = first[pc] + r_idx
    gs = first[pc] + n_read[pc] + g_idx
    return rs, gs


def iupac_waterfall(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Greedy leftover matching (reference src/ClusterBWT_DA.cpp:146-177).

    ``u`` are unmatched read symbols, ``v`` unmatched genome symbols, both
    (pairs, 16).  Mutates u/v like the reference does, including its
    first-block update quirk.  Returns the per-pair extra score.
    """
    t = np.zeros(u.shape[0], dtype=np.int64)
    for i, a in IUPAC_WATERFALL_PAIRS:
        # Genome degenerate v[a] absorbs read ACGT u[i].
        va, ui = v[:, a], u[:, i]
        gate = va > 0
        t += np.where(gate, np.minimum(va, ui), 0)
        win_a = va > ui
        u[:, i] = np.where(gate & win_a, 0, ui)
        v[:, a] = np.where(gate & ~win_a, 0, va)
        # Read degenerate u[a] absorbs genome ACGT v[i].  Copies, not views:
        # u[:, a] is assigned before v[:, i] is computed, and the reference
        # decrements v[i] by the PRE-update u[a] (ClusterBWT_DA.cpp:163-174
        # — unlike its first block, the second block's updates are properly
        # sequenced).
        ua, vi = u[:, a].copy(), v[:, i].copy()
        gate2 = ua > 0
        t += np.where(gate2, np.minimum(ua, vi), 0)
        win_u = ua > vi
        u[:, a] = np.where(gate2, np.where(win_u, ua - vi, 0), ua)
        v[:, i] = np.where(gate2, np.where(win_u, 0, vi - ua), vi)
    return t


def score_clusters(p_start: np.ndarray, lens: np.ndarray, da: np.ndarray,
                   ebwt: np.ndarray | None, num_reads: int, num_refs: int,
                   config: LimeConfig, pair_chunk: int = 1 << 19,
                   ) -> np.ndarray:
    """Dense similarity matrix (num_reads, num_refs) in ``config.sim_dtype``.

    The matrix dtype carries the reference's counter semantics: u8 entries
    wrap mod 256 on accumulation exactly like SimArray_ (+= on uchar,
    src/ClusterBWT_DA.cpp:183); wide_sim uses u32.

    ``lime_tpu``'s arithmetic, pair for pair, in parallel.  The original
    forms every (read-segment, genome-segment) pair at once and scores
    them in ``pair_chunk`` chunks one after another; here whole clusters
    go in groups of about ``pair_chunk`` pairs to a thread each (one
    thread per core, at most 8), each forming its group's pairs with
    :func:`_pair_indices` and scoring them (numpy releases the GIL in the
    gathers and reductions that dominate).  The histograms are gathered
    in the narrowest signed type that holds their largest count (int8,
    int16 or int64: every minimum and leftover fits too; below 128 the
    read counters' wrap and the genome counters' saturation change
    nothing).  The adds into the matrix stay on the calling thread,
    through flat indices; integer adds, wrapping or not, do not depend on
    their order.  On the paper shape the original's serial pass took
    ``chip_smoke.py`` past its time limit (PERF.md).
    """
    sim = np.zeros((num_reads, num_refs), dtype=config.sim_dtype)
    if len(p_start) == 0:
        return sim

    cid, gpos = _expand_positions(np.asarray(p_start, np.int64),
                                  np.asarray(lens, np.int64))
    # gather-first keeps memmapped inputs lazy: only the clusters' pages are
    # touched and converted, not the whole array
    doc = np.asarray(da[gpos], np.int64)
    sym = None
    if config.use_ebwt:
        if ebwt is None:
            raise ValueError("use_ebwt=True requires the .ebwt array")
        sym = SYMBOL_RANK_LUT[np.asarray(ebwt[gpos])].astype(np.int64)

    seg_cid, seg_doc, seg_count, seg_hist = _segment_stats(cid, doc, sym)
    is_read_seg = seg_doc < num_reads

    wrap = config.sim_modulus  # 256 for u8 counters, None for wide
    has_degenerate = (config.use_ebwt
                      and bool(seg_hist[:, 4:ALPHABET_SIZE - 1].any()))
    small = False  # every count below 128
    if config.use_ebwt:
        top = int(seg_hist.max())
        small = top <= 127
        seg_hist = seg_hist.astype(np.int8 if small else np.int16
                                   if top <= 32767 else np.int64)

    # each cluster's first segment and pair count; the groups' segment
    # bounds, a group starting at each cluster whose first pair crosses a
    # multiple of pair_chunk
    n_seg = len(seg_cid)
    first = np.flatnonzero(np.concatenate(
        [[True], seg_cid[1:] != seg_cid[:-1]]))
    n_read = np.add.reduceat(is_read_seg.astype(np.int64), first)
    pairs = n_read * (np.diff(np.append(first, n_seg)) - n_read)
    before = np.cumsum(pairs) - pairs
    bounds = np.append(
        first[np.flatnonzero(np.diff(before // pair_chunk, prepend=-1))],
        n_seg)

    def group(k: int):
        """The flat matrix index and score of each pair of group ``k``."""
        s0, s1 = int(bounds[k]), int(bounds[k + 1])
        rs, gs = _pair_indices(seg_cid[s0:s1], is_read_seg[s0:s1])
        out = []
        for lo in range(0, len(rs), pair_chunk):
            r = rs[lo:lo + pair_chunk] + s0
            g = gs[lo:lo + pair_chunk] + s0
            if config.use_ebwt:
                rh = seg_hist[r]
                if wrap and not small:
                    rh = rh % wrap  # unsaturated uchar read counters
                gh = seg_hist[g] if small else np.minimum(seg_hist[g],
                                                          SIM_SATURATE_U8)
                m = np.minimum(rh, gh)
                t = m.sum(axis=1)
                if has_degenerate:
                    t += iupac_waterfall(rh - m, gh - m)
            else:
                rc = seg_count[r]
                if wrap:
                    rc = rc % wrap
                gc = np.minimum(seg_count[g], SIM_SATURATE_U8)
                t = np.minimum(rc, gc)
            if wrap:
                t = t % wrap
            out.append((seg_doc[r] * num_refs + (seg_doc[g] - num_reads),
                        t.astype(sim.dtype)))
        return out

    n_groups = len(bounds) - 1
    workers = min(8, os.cpu_count() or 1, n_groups)
    flat = sim.reshape(-1)
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        for out in pool.map(group, range(n_groups)):
            for idx, t in out:
                np.add.at(flat, idx, t)
    return sim


def normalize_scores(sim: np.ndarray, read_len: int, alpha: int) -> np.ndarray:
    """float32 normalized similarities: sim / (read_len + 1 - alpha).

    Matches the reference's float cast and uint norm
    (src/ClusterBWT_DA.cpp:555, 404).
    """
    norm = np.float32(np.uint32(read_len + 1 - alpha))
    return sim.astype(np.float32) / norm
