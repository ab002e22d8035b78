"""The plain reference that decides ``correct``: LiME's alpha-cluster scan,
exact symbol-aware scorer, classify cascade and CSV formatter, written
again in plain torch (any device) from the index files alone.

It imports nothing of the program (``lime_tpu_torch``), of ``lime_tpu`` or
of ``jax``, and takes nothing the program made: the benchmark hands it the
same ``.ebwt``/``.lcp``/``.da`` files and lineage it hands the program.
The semantics are the original tool's (src/ClusterLCP.cpp,
src/ClusterBWT_DA.cpp, src/Classify.cpp), as the program's numpy copies
state them:

- scan: a cluster opens at the first i with lcp[i] >= alpha and covers
  rows [i-1, j-1], j the next position with lcp[j] < alpha; it is kept
  when it holds at least one read row (da < num_reads) and one genome row;
- score: per (cluster, document) 16-symbol histograms of the eBWT bytes
  (unknown bytes, ``$`` among them, count as ``A``; ``\\0`` is rank 15); a
  (read, genome) pair of a cluster scores the sum over symbols of
  min(read count mod 256, genome count saturated at 255), plus the
  IUPAC leftover waterfall, mod 256; the matrix accumulates mod 256;
- classify: each file's row divided by ``read_len + 1 - alpha`` (a true
  division by a tensor), gated by beta, then the cascade's stages 1 to 3
  (``A`` where they leave a read undecided);
- CSV: ``C,<read>,<taxid>,<sim as %g>``, ``U,<read>,NA,0``,
  ``A,<read>,NA,0`` under the header.

``dtype`` is the precision of the classify arithmetic: float32 is the
configuration's; the control runs it in bfloat16.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

CSV_HEADER = "C/U/A/H,IdSeqRead,TaxID,maxSim"
ALPHABET = 16
TYPE_U, TYPE_C, TYPE_A = 0, 1, 2

#: eBWT byte -> symbol rank; bytes not in the table count as rank 0
SYMBOL_RANK = np.zeros(256, np.int64)
for _r, _c in enumerate("ACGTRYSWKMBDHVN"):
    SYMBOL_RANK[ord(_c)] = _r
SYMBOL_RANK[0] = 15

#: which of A/C/G/T each degenerate rank stands for
_COMPAT = {4: "AG", 5: "CT", 6: "CG", 7: "AT", 8: "GT", 9: "AC",
           10: "CGT", 11: "AGT", 12: "ACT", 13: "ACG", 14: "ACGT"}
#: the waterfall's (ACGT rank, degenerate rank) pairs, in its order
WATERFALL = tuple((i, a) for i in range(4) for a in range(4, 15)
                  if "ACGT"[i] in _COMPAT[a])


def load_index(fasta: str, device) -> Tuple[torch.Tensor, ...]:
    """(ebwt uint8, lcp int64, da int64) of one collection on ``device``."""
    dev = torch.device(device)

    def u32(ext):  # widened on the device: u32 as int32 bits, then masked
        bits = torch.from_numpy(np.fromfile(fasta + ext, "<i4")).to(dev)
        return bits.to(torch.int64) & 0xFFFFFFFF

    ebwt = torch.from_numpy(np.fromfile(fasta + ".ebwt", np.uint8)).to(dev)
    return ebwt, u32(".lcp"), u32(".da")


def find_clusters(lcp: torch.Tensor, da: torch.Tensor, num_reads: int,
                  alpha: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first row, rows) int64 of every kept alpha-cluster, in order."""
    n = lcp.shape[0]
    dev = lcp.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),) * 2
    m = (lcp >= alpha).to(torch.int8)
    m[0] = 0
    d = m[1:] - m[:-1]
    run_starts = torch.nonzero(d == 1).flatten() + 1
    run_ends = torch.nonzero(d == -1).flatten() + 1
    if bool(m[-1]):
        run_ends = torch.cat([run_ends, torch.tensor([n], device=dev)])
    p_start = run_starts - 1
    lens = run_ends - p_start
    csum = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    csum[1:] = torch.cumsum((da < num_reads).to(torch.int64), 0)
    reads_in = csum[run_ends] - csum[p_start]
    keep = (reads_in > 0) & (reads_in < lens)
    return p_start[keep], lens[keep]


def _waterfall(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Greedy leftover matching of unmatched read symbols ``u`` and genome
    symbols ``v`` ((pairs, 16) each, both updated), with the original's
    first-block quirk: the losing counter is zeroed, the winner is not
    decremented.  Returns the extra score per pair."""
    t = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for i, a in WATERFALL:
        va, ui = v[:, a].clone(), u[:, i].clone()
        gate = va > 0
        t += torch.where(gate, torch.minimum(va, ui), 0)
        win = va > ui
        u[:, i] = torch.where(gate & win, 0, ui)
        v[:, a] = torch.where(gate & ~win, 0, va)
        ua, vi = u[:, a].clone(), v[:, i].clone()
        gate = ua > 0
        t += torch.where(gate, torch.minimum(ua, vi), 0)
        win = ua > vi
        u[:, a] = torch.where(gate, torch.where(win, ua - vi, 0), ua)
        v[:, i] = torch.where(gate, torch.where(win, 0, vi - ua), vi)
    return t


def score_matrix(ebwt: torch.Tensor, da: torch.Tensor, p_start, lens,
                 num_reads: int, num_genomes: int,
                 pair_chunk: int = 1 << 24) -> torch.Tensor:
    """The (num_reads, num_genomes) uint8 similarity matrix of the
    clusters ``(p_start, lens)``."""
    dev = ebwt.device
    R, G = num_reads, num_genomes
    acc = torch.zeros(R * G, dtype=torch.int32, device=dev)
    if len(lens) == 0:
        return acc.view(R, G).to(torch.uint8)
    total = int(lens.sum())
    cid = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), lens)
    first_row = torch.cumsum(lens, 0) - lens
    gpos = (torch.repeat_interleave(p_start - first_row, lens)
            + torch.arange(total, device=dev))
    docs = R + G
    key = cid * docs + da[gpos]
    sym = torch.from_numpy(SYMBOL_RANK).to(dev)[ebwt[gpos].to(torch.int64)]
    del cid, gpos
    key, order = torch.sort(key)
    sym = sym[order]
    del order
    new_seg = torch.ones(total, dtype=torch.bool, device=dev)
    new_seg[1:] = key[1:] != key[:-1]
    seg_id = torch.cumsum(new_seg, 0) - 1
    starts = torch.nonzero(new_seg).flatten()
    n_seg = starts.shape[0]
    seg_cid = key[starts] // docs
    seg_doc = key[starts] % docs
    hist = torch.zeros(n_seg * ALPHABET, dtype=torch.int32, device=dev)
    hist.index_add_(0, seg_id * ALPHABET + sym,
                    torch.ones(total, dtype=torch.int32, device=dev))
    hist = hist.view(n_seg, ALPHABET)
    del key, sym, new_seg, seg_id, starts
    used = hist.any(dim=0)
    degenerate = bool(used[4:15].any())
    if not degenerate:  # symbols no cluster holds add nothing
        hist = hist[:, torch.nonzero(used).flatten()]

    is_read = seg_doc < R
    first = torch.nonzero(torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        seg_cid[1:] != seg_cid[:-1]])).flatten()
    seg_per = torch.diff(torch.cat([
        first, torch.tensor([n_seg], device=dev)]))
    csum = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    csum[1:] = torch.cumsum(is_read.to(torch.int64), 0)
    n_read = csum[first + seg_per] - csum[first]
    n_gen = seg_per - n_read
    pairs = (n_read * n_gen).cpu().numpy()
    before = np.cumsum(pairs) - pairs
    bounds = np.append(np.flatnonzero(np.diff(before // pair_chunk,
                                              prepend=-1)), len(pairs))
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        per = torch.from_numpy(pairs[c0:c1]).to(dev)
        n_pairs = int(pairs[c0:c1].sum())
        if n_pairs == 0:
            continue
        pc = torch.repeat_interleave(
            torch.arange(int(c0), int(c1), device=dev), per)
        q = torch.arange(n_pairs, device=dev) - torch.repeat_interleave(
            torch.cumsum(per, 0) - per, per)
        g_per = n_gen[pc]
        r_idx = q // g_per
        rs = first[pc] + r_idx
        gs = first[pc] + n_read[pc] + (q - r_idx * g_per)
        del pc, q, g_per, r_idx
        rh = hist[rs] % 256  # the read counters are unsaturated bytes
        gh = torch.clamp(hist[gs], max=255)  # genome counters saturate
        m = torch.minimum(rh, gh)
        t = m.sum(dim=1, dtype=torch.int32)
        if degenerate:
            t += _waterfall(rh - m, gh - m)
        del rh, gh, m
        acc.index_add_(0, seg_doc[rs] * G + (seg_doc[gs] - R), t % 256)
        del rs, gs, t
    return (acc % 256).to(torch.uint8).view(R, G)


def _unanimous(tax: torch.Tensor, mask: torch.Tensor):
    """(every masked entry shares one taxid and there is one, that id)."""
    t = tax[None, :]
    tmin = torch.where(mask, t, torch.iinfo(torch.int64).max).amin(dim=1)
    tmax = torch.where(mask, t, -1).amax(dim=1)
    return mask.any(dim=1) & (tmin == tmax), tmax


def _normalised(planes: Sequence[torch.Tensor], lo: int, hi: int,
                norm: torch.Tensor, beta: torch.Tensor):
    """(dense (B, F, G), gated row maxima (B, F)) of reads [lo, hi)."""
    xs, ms = [], []
    for p in planes:
        x = p[lo:hi].to(norm.dtype) / norm
        rowmax = (x.amax(dim=1) if x.shape[1]
                  else torch.zeros(hi - lo, dtype=norm.dtype,
                                   device=x.device))
        q = rowmax > beta
        xs.append(torch.where(q[:, None], x, 0))
        ms.append(torch.where(q, rowmax, 0))
    return torch.stack(xs, dim=1), torch.stack(ms, dim=1)


def _cascade(dense, max_sim, tax, error):
    """Stages 1 to 3 of the cascade over one read block."""
    B, F, _ = dense.shape
    types = torch.zeros(B, dtype=torch.int8, device=dense.device)
    out_tax = torch.zeros(B, dtype=torch.int64, device=dense.device)
    out_sim = torch.zeros(B, dtype=dense.dtype, device=dense.device)

    def assign(mask, taxid, sim):
        types[mask] = TYPE_C
        out_tax[mask] = taxid[mask]
        out_sim[mask] = sim[mask]

    highest = max_sim.amax(dim=1)
    present = highest > 0
    top_file = (max_sim > 0) & ((highest[:, None] - max_sim) < error)
    cand = (((max_sim[:, :, None] - dense) < error) & (dense > 0)
            & top_file[:, :, None])
    cand1 = cand.any(dim=1)
    uni1, tax1 = _unanimous(tax, cand1)
    assign(present & uni1, tax1, highest)
    undecided = present & ~uni1

    if F == 4:
        pair0 = dense[:, 0] + dense[:, 3]
        pair1 = dense[:, 1] + dense[:, 2]
    else:
        pair0, pair1 = dense[:, 0], dense[:, 1]
    has = cand1.any(dim=1)
    maxsum0 = torch.where(has, torch.where(cand1, pair0, -1).amax(dim=1), 0)
    maxsum1 = torch.where(has, torch.where(cand1, pair1, -1).amax(dim=1), 0)
    win0 = maxsum0 > maxsum1 + error
    win1 = maxsum1 > maxsum0 + error
    uni2_0, tax2_0 = _unanimous(tax, cand1 & (pair0 == maxsum0[:, None]))
    uni2_1, tax2_1 = _unanimous(tax, cand1 & (pair1 == maxsum1[:, None]))
    s2_0 = undecided & win0 & uni2_0
    s2_1 = undecided & win1 & uni2_1
    assign(s2_0, tax2_0, maxsum0)
    assign(s2_1, tax2_1, maxsum1)
    undecided &= ~(s2_0 | s2_1)

    h0 = pair0.amax(dim=1)
    h1 = pair1.amax(dim=1)
    gen0 = (h0[:, None] - pair0) < error
    gen1 = (h1[:, None] - pair1) < error
    gen = torch.where((h0 > h1)[:, None], gen0,
                      torch.where((h0 < h1)[:, None], gen1, gen0 | gen1))
    uni3, tax3 = _unanimous(tax, gen)
    assign(undecided & uni3, tax3, torch.maximum(h0, h1))
    types[undecided & ~uni3] = TYPE_A
    return types, out_tax, out_sim


def classify(planes: Sequence[torch.Tensor], read_len: int, alpha: int,
             beta: float, error: float, tax: np.ndarray,
             dtype=torch.float32, block: int = 1 << 14):
    """Per-read (types int8, taxid int64, sim float64) numpy arrays of 2
    or 4 per-file uint8 matrices; ``tax`` is each genome's taxid at the
    classify rank."""
    dev = planes[0].device
    num_reads = planes[0].shape[0]
    norm = torch.tensor(float(read_len + 1 - alpha), dtype=dtype,
                        device=dev)
    beta_t = torch.tensor(float(np.float32(beta)), dtype=dtype, device=dev)
    error_t = torch.tensor(float(np.float32(error)), dtype=dtype,
                           device=dev)
    tax_t = torch.from_numpy(np.asarray(tax, np.int64)).to(dev)
    types = np.zeros(num_reads, np.int8)
    taxid = np.zeros(num_reads, np.int64)
    sim = np.zeros(num_reads, np.float64)
    for lo in range(0, num_reads, block):
        hi = min(lo + block, num_reads)
        dense, maxs = _normalised(planes, lo, hi, norm, beta_t)
        t, x, s = _cascade(dense, maxs, tax_t, error_t)
        types[lo:hi] = t.cpu().numpy()
        taxid[lo:hi] = x.cpu().numpy()
        sim[lo:hi] = s.to(torch.float64).cpu().numpy()
    return types, taxid, sim


def csv_lines(types: np.ndarray, taxid: np.ndarray,
              sim: np.ndarray) -> List[str]:
    """The assignment CSV as lines without their newlines, header first."""
    lines = [CSV_HEADER]
    for rid, (t, x, s) in enumerate(zip(types.tolist(), taxid.tolist(),
                                        sim.tolist())):
        if t == TYPE_C:
            lines.append(f"C,{rid},{x},{s:g}")
        elif t == TYPE_A:
            lines.append(f"A,{rid},NA,0")
        else:
            lines.append(f"U,{rid},NA,0")
    return lines


def res_records(plane: torch.Tensor, read_len: int, alpha: int,
                beta: float, dtype=torch.float32
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(``.res.pos`` u64 per read, ``.res.bin`` records as u64: f32 sim in
    the low half, u32 genome in the high half) of one collection: a
    ``(0, 0)`` sentinel, then for each read whose normalised maximum
    exceeds beta a header ``(maximum, list size)`` and ``(sim, genome)``
    for each genome it scores, in genome order.  ``dtype`` is the
    precision of the division (float32 is the configuration's); the
    records hold float32."""
    dev = plane.device
    R = plane.shape[0]
    norm = torch.tensor(float(read_len + 1 - alpha), dtype=dtype,
                        device=dev)
    x = plane.to(dtype) / norm
    rowmax = (x.amax(dim=1) if x.shape[1]
              else torch.zeros(R, dtype=dtype, device=dev))
    qual = rowmax > torch.tensor(float(np.float32(beta)), dtype=dtype,
                                 device=dev)
    nz = (x > 0) & qual[:, None]
    sizes = nz.sum(dim=1)
    per_read = torch.where(qual, 1 + sizes, 0)
    header = 1 + torch.cumsum(per_read, 0) - per_read
    pos = torch.where(qual, header, 0)
    total = 1 + int(per_read.sum())
    x, rowmax = x.to(torch.float32), rowmax.to(torch.float32)
    sims = torch.zeros(total, dtype=torch.float32, device=dev)
    ids = torch.zeros(total, dtype=torch.int64, device=dev)
    sims[header[qual]] = rowmax[qual]
    ids[header[qual]] = sizes[qual]
    rows, cols = torch.nonzero(nz, as_tuple=True)
    within = torch.arange(len(rows), device=dev) - (
        torch.cumsum(sizes, 0) - sizes)[rows]
    dest = header[rows] + 1 + within
    sims[dest] = x[rows, cols]
    ids[dest] = cols
    recs = (sims.cpu().numpy().view(np.uint32).astype(np.uint64)
            | (ids.cpu().numpy().astype(np.uint64) << np.uint64(32)))
    return pos.cpu().numpy().astype(np.uint64), recs
