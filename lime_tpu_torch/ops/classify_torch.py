"""The classify program: counter wrap, normalise, beta gate and the
4-stage cascade over the per-file score planes (torch port of
``lime_tpu/ops/classify_tpu.py`` and of ``_classify_program_planes`` /
``_pack_triplet`` in ``lime_tpu/ops/fused_pipeline.py``).

float32 op for op with the host cascade (``lime_tpu.ops.classify_ops``):
every comparison and sum keeps the same operands and association order,
so types and taxids are exact and sims bit-equal.  Taxids are int64 with
a 0xFFFFFFFF sentinel (torch has no min/max for uint32); they narrow to
their u32 bits only in the packed triplet.  The division ``x / norm`` is a
true division by a float32 tensor on the planes' device: a reciprocal
multiply differs by one ulp on some counts.  The cascade runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from lime_tpu.constants import NUM_RANKS
from lime_tpu.ops.classify_ops import TYPE_A, TYPE_C, TYPE_H, ClassifyResult

_SENTINEL = 0xFFFFFFFF


def _unanimous(tax: torch.Tensor, mask: torch.Tensor):
    """(all masked entries share one value & any, that value).

    ``tax`` (T,) int64, ``mask`` (B, T) bool."""
    t = tax[None, :]
    tmin = torch.where(mask, t, _SENTINEL).amin(dim=1)
    tmax = torch.where(mask, t, 0).amax(dim=1)
    return mask.any(dim=1) & (tmin == tmax), tmax


def cascade_core(dense, max_sim, tax, rank_matrix, valid_t, error,
                 num_file: int, tax_rank: int, assign_higher: bool):
    """The 4-stage cascade over one read block.

    ``dense`` (B, F, T) float32, ``max_sim`` (B, F) float32, ``tax`` (T,)
    int64, ``rank_matrix`` (NUM_RANKS, T) int64, ``valid_t`` (T,) bool
    (genome lanes past the real count are padding), ``error`` a float32
    tensor.  Returns (types int8, taxid int64, sim float32), each (B,).
    """
    B = dense.shape[0]
    dev = dense.device
    neg = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    types = torch.zeros(B, dtype=torch.int8, device=dev)
    out_tax = torch.zeros(B, dtype=torch.int64, device=dev)
    out_sim = torch.zeros(B, dtype=torch.float32, device=dev)
    c_type = torch.tensor(TYPE_C, dtype=torch.int8, device=dev)

    highest = max_sim.amax(dim=1)
    present = highest > 0

    # Stage 1
    top_file = (max_sim > 0) & ((highest[:, None] - max_sim) < error)
    cand = (((max_sim[:, :, None] - dense) < error) & (dense > 0)
            & top_file[:, :, None])
    cand1 = cand.any(dim=1)
    uni1, tax1 = _unanimous(tax, cand1)
    s1 = present & uni1
    types = torch.where(s1, c_type, types)
    out_tax = torch.where(s1, tax1, out_tax)
    out_sim = torch.where(s1, highest, out_sim)
    undecided = present & ~uni1

    # Mate-pairing sums
    if num_file == 4:
        pair0 = dense[:, 0] + dense[:, 3]
        pair1 = dense[:, 1] + dense[:, 2]
    else:
        pair0 = dense[:, 0]
        pair1 = dense[:, 1]

    # Stage 2
    has_c = cand1.any(dim=1)
    maxsum0 = torch.where(has_c, torch.where(cand1, pair0, neg).amax(dim=1),
                          zero)
    maxsum1 = torch.where(has_c, torch.where(cand1, pair1, neg).amax(dim=1),
                          zero)
    win0 = maxsum0 > maxsum1 + error
    win1 = maxsum1 > maxsum0 + error
    uni2_0, tax2_0 = _unanimous(tax, cand1 & (pair0 == maxsum0[:, None]))
    uni2_1, tax2_1 = _unanimous(tax, cand1 & (pair1 == maxsum1[:, None]))
    s2_0 = undecided & win0 & uni2_0
    s2_1 = undecided & win1 & uni2_1
    types = torch.where(s2_0 | s2_1, c_type, types)
    out_tax = torch.where(s2_0, tax2_0, torch.where(s2_1, tax2_1, out_tax))
    out_sim = torch.where(s2_0, maxsum0,
                          torch.where(s2_1, maxsum1, out_sim))
    undecided = undecided & ~(s2_0 | s2_1)

    # Stage 3 (Exam_2 over all real genomes)
    h0 = pair0.amax(dim=1)
    h1 = pair1.amax(dim=1)
    h = torch.maximum(h0, h1)
    gen0 = ((h0[:, None] - pair0) < error) & valid_t[None, :]
    gen1 = ((h1[:, None] - pair1) < error) & valid_t[None, :]
    gen = torch.where((h0 > h1)[:, None], gen0,
                      torch.where((h0 < h1)[:, None], gen1, gen0 | gen1))
    uni3, tax3 = _unanimous(tax, gen)
    s3 = undecided & uni3
    types = torch.where(s3, c_type, types)
    out_tax = torch.where(s3, tax3, out_tax)
    out_sim = torch.where(s3, h, out_sim)
    ambiguous = undecided & ~uni3

    # Stage 4
    a_type = torch.tensor(TYPE_A, dtype=torch.int8, device=dev)
    if assign_higher:
        h_type = torch.tensor(TYPE_H, dtype=torch.int8, device=dev)
        remaining = ambiguous
        for level in range(max(tax_rank - 1, 0), NUM_RANKS):
            uni_h, tax_h = _unanimous(rank_matrix[level], gen)
            okay = remaining & uni_h & (tax_h != 0)
            types = torch.where(okay, h_type, types)
            out_tax = torch.where(okay, tax_h, out_tax)
            out_sim = torch.where(okay, h, out_sim)
            remaining = remaining & ~okay
        types = torch.where(remaining, a_type, types)
    else:
        types = torch.where(ambiguous, a_type, types)
    return types, out_tax, out_sim


def blockwise_cascade(sims, tax, rank_matrix, valid_t, error, norm, beta,
                      num_files: int, tax_rank: int, assign_higher: bool,
                      is_mod: bool, block: int):
    """Counter wrap + normalise + beta gate + cascade over (F, R_pad, G_pad).

    Walks read blocks so one (block, F, G_pad) float32 tile is live at a
    time.  ``is_mod``: ``sims`` is an int8 accumulator whose bits are the
    mod-256 counters (read through a uint8 view, not a value cast);
    otherwise plain int32 counts.  ``norm``, ``beta``, ``error`` are
    float32 tensors on the planes' device.  R_pad must be a multiple of
    ``block``.
    """
    F, r_pad, g_pad = sims.shape
    dev = sims.device
    types = torch.zeros(r_pad, dtype=torch.int8, device=dev)
    taxid = torch.zeros(r_pad, dtype=torch.int64, device=dev)
    sim = torch.zeros(r_pad, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    for lo in range(0, r_pad, block):
        blk = sims[:, lo:lo + block]
        x = (blk.view(torch.uint8) if is_mod else blk).to(torch.float32)
        norm_rows = torch.div(x, norm)
        rowmax = norm_rows.amax(dim=2)  # (F, block)
        qualify = rowmax > beta
        dense = torch.where(qualify[:, :, None], norm_rows,
                            zero).permute(1, 0, 2)
        maxs = torch.where(qualify, rowmax, zero).T
        t, x_, s = cascade_core(dense, maxs, tax, rank_matrix, valid_t,
                                error, num_files, tax_rank, assign_higher)
        types[lo:lo + block] = t
        taxid[lo:lo + block] = x_
        sim[lo:lo + block] = s
    return types, taxid, sim


def classify_reads_torch(dense: np.ndarray, max_sim: np.ndarray,
                         tax: np.ndarray, rank_matrix: np.ndarray | None,
                         tax_rank: int, error: np.float32,
                         assign_higher: bool, device) -> ClassifyResult:
    """The cascade over one read block on ``device``: the counterpart of
    ``lime_tpu.ops.classify_tpu.classify_reads_tpu`` (and a drop-in for
    ``classify_ops.classify_reads``).

    ``dense`` (B, F, T) float32 normalised scores, ``max_sim`` (B, F),
    ``tax`` (T,) taxids, ``rank_matrix`` (NUM_RANKS, T) or None.
    """
    B, F, T = dense.shape
    rm = (np.asarray(rank_matrix, np.int64) if rank_matrix is not None
          else np.zeros((NUM_RANKS, T), np.int64))

    def put(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    types, taxid, sim = cascade_core(
        put(dense), put(max_sim), put(tax, np.int64), put(rm),
        torch.ones(T, dtype=torch.bool, device=device),
        torch.tensor(np.float32(error), device=device), F, tax_rank,
        assign_higher)
    return ClassifyResult(types.cpu().numpy(),
                          taxid.cpu().numpy().astype(np.uint32),
                          sim.cpu().numpy())


def _pack_triplet(types, taxid, sim) -> torch.Tensor:
    """(types int8, taxid int64, sim float32) -> one (3, R_pad) int32
    buffer holding the u32 bits of (type, taxid, sim): a single download.
    """
    tx = taxid.to(torch.int64)
    tx = torch.where(tx >= 1 << 31, tx - (1 << 32), tx).to(torch.int32)
    return torch.stack([types.to(torch.int32), tx,
                        sim.contiguous().view(torch.int32)])


def _unpack_triplet(packed_h: np.ndarray):
    """Host-side decode of :func:`_pack_triplet`'s buffer."""
    u = np.ascontiguousarray(packed_h).view(np.uint32)
    return (u[0].astype(np.uint8), u[1].astype(np.uint32),
            u[2].view(np.float32))


def alloc_planes(num_files: int, r_pad: int, g_pad: int,
                 dtype: torch.dtype, device: torch.device):
    """One zeroed flat buffer of ``F*r_pad*g_pad + 1`` counters and its
    ``(F, r_pad, g_pad)`` view.  The extra last element is the sink the
    correction scatter's pad entries (file index ``F``) land in."""
    buf = torch.zeros(num_files * r_pad * g_pad + 1, dtype=dtype,
                      device=device)
    return buf, buf[:-1].view(num_files, r_pad, g_pad)


def _classify_program_planes(buf, num_files: int, r_pad: int, g_pad: int,
                             crows, ccols, cvals, cfile, tax, rank_matrix,
                             valid_t, error, norm, beta, tax_rank: int,
                             assign_higher: bool, is_mod: bool,
                             block: int) -> torch.Tensor:
    """Sparse corrections + blockwise cascade over the planes in ``buf``.

    ``buf`` is :func:`alloc_planes`' flat buffer.  The corrections
    ``(cfile, crows, ccols, cvals)`` scatter-add in place (int8 adds wrap
    mod 256; values enter pre-wrapped); pad entries carry file index
    ``num_files`` with row and column 0, which is exactly the sink
    element, so no real entry is ever dropped.  Returns the packed
    (3, R_pad) triplet.
    """
    if crows.shape[0]:
        flat = ((cfile.to(torch.int64) * r_pad + crows.to(torch.int64))
                * g_pad + ccols.to(torch.int64))
        buf.index_add_(0, flat, cvals.to(buf.dtype))
    sims = buf[:-1].view(num_files, r_pad, g_pad)
    return _pack_triplet(*blockwise_cascade(
        sims, tax, rank_matrix, valid_t, error, norm, beta, num_files,
        tax_rank, assign_higher, is_mod, block))


def planes_from_numpy(planes, device) -> list:
    """Score planes as numpy arrays -> tensors on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(p)).to(device)
            for p in planes]


def planes_to_numpy(planes) -> list:
    """Score plane tensors -> numpy arrays."""
    return [p.detach().cpu().numpy() for p in planes]
