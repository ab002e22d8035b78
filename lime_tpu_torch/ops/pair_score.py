"""G-independent device scoring over planner-emitted packed pair streams.

Torch port of ``lime_tpu/ops/pair_score.py`` (the packed-stream half).
The native planner (``native.plan_pairs_packed``) re-emits each
sparse cluster once per genome document it contains, packed as three
buffers per collection: 5 metadata bits per row (8 rows per 5-byte
group), a W-bit read id per row (8 rows per W/4 u32 words) and one u16
genome column per copy, pre-cut into chunks on copy boundaries.  Per
chunk the device unpacks the rows, counts pair hits
(:func:`pair_kernels.pair_hits`), broadcasts each copy's genome column to
its rows and scatter-adds the hits into the ``(R_pad, G_pad)`` plane.
int8 adds wrap mod 256: the reference's unsaturated uchar counters.

In the row-blocked mode the uploaded buffers stay on the device and
every chunk is replayed once per row block, by a plain loop, into an
``(F, B, G_pad)`` stack (:func:`pair_score_packed_offset`): ``lime_tpu``
replays them with ``lax.scan`` only to amortise its relay's launch cost.

The one-byte-per-row stream of ``native.plan_pairs`` (bit 6 m, bit 5
docrun, bit 4 side, bits 0-3 symbol rank, plus an int32 scatter index per
row) is scored by :func:`pair_score_into`, on the same pair-hit kernel:
``lime_tpu`` scores it with its XLA band formula, which the kernel's
plain version is.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..host import _gcol_padded, _pack24
from .pair_kernels import (_KERNEL_FOR_CAP, BUCKET_CAPS, LAUNCHES, PAIR_TILE,
                           _pair_hits_core, pair_hits)

__all__ = ["BUCKET_CAPS", "PAIR_TILE", "_pair_hits_core", "_unpack_bits5",
           "_unpack_rows", "_hits_dispatch", "_pair_packed_block",
           "_pair_packed_block_offset", "pair_upload",
           "pair_score_packed_into", "pair_score_packed_offset",
           "chunk_views",
           "chunk_codes", "coo_scatter_into", "coo_scatter_into_stack",
           "to_device", "PAIR_CHUNK", "PAIR_CHUNK_SMALL", "LAST_RUN",
           "pair_score_into", "pair_hits_host", "unpacked_chunks",
           "kernel_codes"]

# Upload chunk sizes (rows) of the one-byte-per-row stream, as
# ``lime_tpu``'s: streams ship in chunks cut at copy boundaries, on a
# pow2 ladder between the two sizes (a 300K stream must not pad to 8M
# rows).  Both are multiples of PAIR_TILE, as the pair-hit kernel needs.
PAIR_CHUNK = 8 << 20
PAIR_CHUNK_SMALL = 256 << 10

#: :func:`pair_score_into`'s last run: ``chunks`` per pair-hit kernel
#: (one launch each on a card), ``rows`` scored and ``host_copies``, the
#: copies holding a symbol above rank 3 that the host scored
LAST_RUN: dict = {}


def _unpack_bits5(bits_b: torch.Tensor) -> torch.Tensor:
    """(N/8*5,) u8 groups -> (N,) int32 of 5-bit lane values."""
    g = bits_b.reshape(-1, 5).to(torch.int32)
    lanes = []
    for j in range(8):
        off = 5 * j
        a, sh = off >> 3, off & 7
        v = g[:, a] >> sh
        if sh + 5 > 8:
            v = v | (g[:, a + 1] << (8 - sh))
        lanes.append(v & 31)
    return torch.stack(lanes, dim=1).reshape(-1)


def _unpack_rows(rows_w: torch.Tensor, row_bits: int) -> torch.Tensor:
    """(N/8*W/4,) u32 groups (held as int32 bits) -> (N,) int64 values.

    torch has no shift or compare kernels for uint32, so the words widen
    to int64 and mask back to their 32 unsigned bits first.
    """
    nw = row_bits // 4
    g = rows_w.reshape(-1, nw).to(torch.int64) & 0xFFFFFFFF
    mask = (1 << row_bits) - 1
    lanes = []
    for j in range(8):
        off = row_bits * j
        a, sh = off >> 5, off & 31
        v = g[:, a] >> sh
        if sh + row_bits > 32:
            v = v | (g[:, a + 1] << (32 - sh))
        lanes.append(v & mask)
    return torch.stack(lanes, dim=1).reshape(-1)


def _hits_dispatch(codes: torch.Tensor, window: int, cap: int = 255):
    """Pair hits for one decoded chunk of int32 codes.

    On a CUDA tensor this always launches the hand-written kernel for the
    chunk's bucket; on a CPU tensor it takes the plain version.  Chunk
    lengths are pow2 >= 65536 or 512K multiples, so they are multiples of
    PAIR_TILE; :func:`pair_hits` raises on anything else.
    """
    return pair_hits(codes.to(torch.uint8), window, cap)


def _decode_chunk(rows_w, bits_b, gcol, window, row_bits: int, cap: int):
    """One packed chunk, unpacked and scored: per row its read id, genome
    column (int64), genome-side flag and pair hits (int32).

    The genome column is constant per copy, so it ships once per copy and
    broadcasts to rows via a cumsum of copy-start bits + one gather (a
    copy's first row is always read-side; pad rows carry side=1 and m=0
    and never increment the cumsum).
    """
    codes = _unpack_bits5(bits_b)
    row = _unpack_rows(rows_w, row_bits)
    hits = _hits_dispatch(codes, window, cap=cap)
    m = (codes >> 2) & 1
    gs = ((codes >> 4) & 1).bool()
    copy_start = ((m == 0) & ~gs).to(torch.int64)
    # pad rows before a chunk's first copy would index -1: clamp, they
    # are genome-side and every caller drops those
    cidx = (torch.cumsum(copy_start, 0) - 1).clamp_(min=0)
    gc = gcol[cidx].to(torch.int64) & 0xFFFF
    return row, gc, gs, hits


def _pair_packed_block(sim: torch.Tensor, rows_w, bits_b, gcol, window,
                       drop: int, row_bits: int, cap: int = 255) -> None:
    """One packed chunk: unpack, score, one scatter-add into ``sim``.

    Genome-side rows land in the drop row ``drop // g_pad`` (= num_reads,
    inside R_pad), spread over its columns so their zero-value adds do
    not all hit one address.  Updates ``sim`` in place.
    """
    row, gc, gs, hits = _decode_chunk(rows_w, bits_b, gcol, window,
                                      row_bits, cap)
    g_pad = sim.shape[1]
    spread = torch.arange(row.shape[0], device=row.device) % g_pad
    flat = torch.where(gs, drop + spread, row * g_pad + gc)
    vals = torch.where(gs, 0, hits).to(sim.dtype)
    sim.view(-1).index_add_(0, flat, vals)


def _pair_packed_block_offset(stack: torch.Tensor, fi: int, rows_w, bits_b,
                              gcol, window, row_base: int, row_bits: int,
                              cap: int = 255) -> None:
    """One packed chunk into plane ``fi`` of the ``(F, B, g_pad)`` row-block
    stack, whose row 0 is read ``row_base`` (the row-blocked mode).

    Only the read-side rows inside the block with a nonzero hit count
    are added: with many blocks most of a chunk's rows fall outside, and
    routing them all to one sink address would serialise its atomics.
    Selecting them waits for the device (the size of the selection); a
    variant that instead adds 0 for every other row at cells spread over
    the block, with no wait, measured no faster on an H100 (PERF.md):
    the replay is bound by the host's launches either way.
    """
    row, gc, gs, hits = _decode_chunk(rows_w, bits_b, gcol, window,
                                      row_bits, cap)
    _, B, g_pad = stack.shape
    local = row - row_base
    sel = torch.nonzero(~gs & (local >= 0) & (local < B)
                        & (hits != 0)).squeeze(1)
    stack[fi].view(-1).index_add_(0, local[sel] * g_pad + gc[sel],
                                  hits[sel].to(stack.dtype))


def to_device(arr: np.ndarray, device: torch.device, keep: list):
    """Host numpy array -> tensor on ``device``.

    On CUDA the array is staged in pinned memory and copied with
    ``non_blocking=True``; the pinned buffer and the copy's event go to
    ``keep``, which the caller holds until the event completes.
    """
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    pinned = t.pin_memory()
    out = pinned.to(device, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    keep.append((pinned, ev))
    return out


def pair_upload(arrays, chunks, device: torch.device, keep: list):
    """Ship one collection's three planner buffers to the device.

    The u32 row words travel as their int32 bits and the u16 genome
    columns as int16 bits (torch has no arithmetic on uint32/uint16);
    the consumers mask them back to unsigned values.
    """
    rows_all, bits_all, gcol_all = arrays
    return (to_device(rows_all.view(np.int32), device, keep),
            to_device(bits_all, device, keep),
            to_device(_gcol_padded(gcol_all, chunks).view(np.int16),
                      device, keep))


def pair_score_packed_into(sim: torch.Tensor, arrays, chunks, windows,
                           row_bits: int, num_reads: int,
                           keep: list) -> None:
    """Accumulate all packed pair chunks into the device plane ``sim``.

    ``arrays``/``chunks``/``windows``/``row_bits`` are the output of
    native.plan_pairs_packed.  The three planner buffers upload once per
    collection and every chunk is a slice of them.  Launches are
    asynchronous on the current stream; ``sim`` is updated in place.
    """
    uploaded = pair_upload(arrays, chunks, sim.device, keep)
    drop = num_reads * sim.shape[1]
    for bucket, rows_w, bits_b, gcol in chunk_views(*uploaded, chunks,
                                                    row_bits):
        _pair_packed_block(sim, rows_w, bits_b, gcol, windows[bucket], drop,
                           row_bits, BUCKET_CAPS[bucket])


def pair_score_packed_offset(stack: torch.Tensor, fi: int, uploaded,
                             chunks, windows, row_bits: int,
                             row_base: int) -> None:
    """Replay one collection's uploaded pair chunks (``pair_upload``'s
    buffers) into plane ``fi`` of a row-block stack at ``row_base``: one
    pair-kernel launch per chunk, in place, on the current stream."""
    for bucket, rows_w, bits_b, gcol in chunk_views(*uploaded, chunks,
                                                    row_bits):
        _pair_packed_block_offset(stack, fi, rows_w, bits_b, gcol,
                                  windows[bucket], row_base, row_bits,
                                  BUCKET_CAPS[bucket])


def chunk_views(d_rows, d_bits, d_gcol, chunks, row_bits: int):
    """Per planner chunk, ``(bucket, rows_w, bits_b, gcol)``: its slices
    of the three uploaded buffers (the genome columns pow2-rounded, as
    :func:`host._gcol_padded` padded them)."""
    wpg = row_bits // 4  # words per 8-row group
    for bucket, _, n_rows, wo, bo, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        yield (bucket, d_rows[wo:wo + n_rows // 8 * wpg],
               d_bits[bo:bo + n_rows // 8 * 5], d_gcol[go:go + gcap])


def chunk_codes(arrays, chunks, row_bits: int, device: torch.device):
    """Per planner chunk of one collection, ``(bucket, codes)``: its 5-bit
    codes on ``device`` as uint8, unpacked as :func:`_pair_packed_block`
    unpacks them (the pair kernel's input)."""
    keep = []
    out = [(bucket, _unpack_bits5(bits_b).to(torch.uint8))
           for bucket, _, bits_b, _ in chunk_views(
               *pair_upload(arrays, chunks, device, keep), chunks, row_bits)]
    if device.type == "cuda":
        torch.cuda.synchronize()  # the uploads' pinned buffers in ``keep``
    return out


# ---------------------------------------------------------------------------
# Delta-COO chains (host-scored planes: the dense rescue and the host share)
# ---------------------------------------------------------------------------

def _coo_scatter_block24(sim: torch.Tensor, buf: torch.Tensor,
                         base_row: int, n: int) -> None:
    """Packed coo24 chain ``[drow4|colhi4][col_lo][val]`` (n entries per
    plane) into ``sim``; values are u8 bits added as int8 (wrap mod 256).
    Pad entries decode to (last row, col 0, val 0): in-range no-ops."""
    d = buf[:n].to(torch.int64)
    col = ((d & 15) << 8) | buf[n:2 * n].to(torch.int64)
    val = buf[2 * n:3 * n].view(torch.int8)
    rows = base_row + torch.cumsum(d >> 4, 0)
    g_pad = sim.shape[1]
    sim.view(-1).index_add_(0, rows * g_pad + col, val)


def _coo_scatter_block(sim: torch.Tensor, drow: torch.Tensor,
                       col: torch.Tensor, val: torch.Tensor,
                       base_row: int) -> None:
    """Plain delta-COO chain (u8 row deltas, u16 columns as int16 bits,
    u8 or u32 values as int8/int32 bits) into ``sim``."""
    rows = base_row + torch.cumsum(drow.to(torch.int64), 0)
    g_pad = sim.shape[1]
    flat = rows * g_pad + (col.to(torch.int64) & 0xFFFF)
    sim.view(-1).index_add_(0, flat, val)


def coo_scatter_into(sim: torch.Tensor, chain, keep: list,
                     packed24: bool = False) -> None:
    """Upload one merged delta-COO chain and scatter it into ``sim``.

    ``packed24`` selects the 3-byte single-buffer format (the chain was
    compacted with max_drow=15 and has < 4096 genome columns).  Eager
    torch has no per-shape compile, so the plain chain ships unpadded.
    """
    dev = sim.device
    if packed24:
        base0, buf, size = _pack24(chain)
        _coo_scatter_block24(sim, to_device(buf, dev, keep), int(base0),
                             size)
        return
    base0, drow, col, val = chain
    vdt = np.int8 if sim.dtype == torch.int8 else np.int32
    _coo_scatter_block(sim, to_device(drow, dev, keep),
                       to_device(col.astype(np.uint16).view(np.int16), dev,
                                 keep),
                       to_device(val.view(vdt), dev, keep), int(base0))



def coo_scatter_into_stack(stack: torch.Tensor, chain, fi: int, keep: list,
                           packed24: bool = False) -> None:
    """Upload one delta-COO chain and scatter it into plane ``fi`` of a
    row-block stack (``lime_tpu``'s ``coo_scatter_into_stack``).  The
    chain's rows are relative to the block's base: the caller compacts its
    host plane's row slice.  ``stack[fi]`` of the contiguous ``(F, B,
    g_pad)`` stack is a contiguous view, so the plain scatters add into
    the stack in place."""
    coo_scatter_into(stack[fi], chain, keep, packed24=packed24)


# ---------------------------------------------------------------------------
# One byte per row: native.plan_pairs' stream
# ---------------------------------------------------------------------------

#: the byte of a pad row in both layouts: genome side, m = 0, docrun 0,
#: symbol 0, so a copy of its own with no read row (the packed planner's
#: pad); a read-side pad would start a copy with no genome run
PAD_BYTE = 0x10


def _cut_at_copy(packed: np.ndarray, lo: int, hi: int) -> int:
    """Largest copy-start index in (lo, hi] — every copy is <= 255 rows,
    so one exists within the last 256 positions of any window."""
    tail = packed[max(lo + 1, hi - 256):hi]
    starts = np.flatnonzero((tail & 0x40) == 0)
    if len(starts) == 0:  # single giant copy cannot happen by construction
        raise AssertionError("no copy boundary within 256 rows")
    return hi - len(tail) + int(starts[-1])


def pair_hits_host(packed: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle of the pair hits of a one-byte-per-row stream
    (copy of ``lime_tpu.ops.pair_score.pair_hits_host``).

    Scans whole runs instead of a band — identical to the band formula
    whenever every copy is no longer than its bucket window, which the
    planner guarantees by construction.  Occurrence indexes are ranks
    within (doc-run, symbol) groups, and hits are per-(copy, symbol, occ)
    genome-row counts via one np.unique + bincount.
    """
    m = ((packed >> 6) & 1).astype(bool)
    dr = ((packed >> 5) & 1).astype(bool)
    gs = ((packed >> 4) & 1).astype(bool)
    sym = (packed & 15).astype(np.int64)
    n = len(packed)
    if n == 0:
        return np.zeros(0, np.int32)
    seg_doc = np.cumsum(~dr)         # doc-run id per row
    seg_copy = np.cumsum(~m)         # copy (cluster-run) id per row
    # occ = rank in position order within each (doc-run, symbol) group
    # (lexsort is stable, so equal keys keep position order)
    order = np.lexsort((sym, seg_doc))
    key = seg_doc[order] * 16 + sym[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(new)
    lens = np.diff(np.append(starts, n))
    rank_sorted = np.arange(n, dtype=np.int64) - np.repeat(starts, lens)
    occ = np.empty(n, np.int64)
    occ[order] = rank_sorted
    # hits[i] (read rows) = genome rows in the same copy with the same
    # (symbol, occ) key
    combined = (seg_copy * 16 + sym) * np.int64(n + 1) + occ
    _, inv = np.unique(combined, return_inverse=True)
    g_count = np.bincount(inv[gs], minlength=int(inv.max()) + 1)
    return np.where(gs, 0, g_count[inv]).astype(np.int32)


def _cap_for(window: int) -> int:
    """The smallest bucket cap holding copies of ``window`` rows: the
    kernel's cap comes from the window, since the planner leaves empty
    buckets out of its list."""
    for cap in BUCKET_CAPS:
        if window <= cap:
            return cap
    raise ValueError(f"pair window {window} exceeds {BUCKET_CAPS[-1]}")


def _host_scored(chunk: np.ndarray, flat: np.ndarray):
    """The copies of one chunk holding a symbol above rank 3 (the
    ``'\\0'`` terminator, rank 15), which the kernel's 2-bit symbols
    cannot tell apart, scored on the host with :func:`pair_hits_host`.

    Their rows become pad rows in ``chunk`` (in place), so the kernel
    counts nothing there.  Returns ``(flat, hits)`` of their read rows
    and the number of such copies.
    """
    wide_sym = (chunk & 15) > 3
    if not wide_sym.any():
        return None, 0
    copy = np.cumsum((chunk & 0x40) == 0)
    held = np.unique(copy[wide_sym])
    rows = np.flatnonzero(np.isin(copy, held))
    sub = chunk[rows]
    hits = pair_hits_host(sub)
    read = (sub & 0x10) == 0
    chunk[rows] = PAD_BYTE
    return (flat[rows][read], hits[read]), len(held)


def unpacked_chunks(buckets, num_reads: int, g_pad: int):
    """``native.plan_pairs``' buckets cut into upload chunks, as
    ``lime_tpu``'s ``pair_score_into`` cuts them: per chunk ``(packed,
    flat, window, cap, host, n_host)``, numpy, padded to its ladder size
    with :data:`PAD_BYTE` rows whose index is the ``num_reads * g_pad``
    drop cell; ``host`` and ``n_host`` as :func:`_host_scored` returns
    them (the copies are pad rows in ``packed`` already)."""
    drop_flat = num_reads * g_pad
    for packed, flat, window in buckets:
        n = len(packed)
        cap = _cap_for(window)
        size = PAIR_CHUNK_SMALL
        while size < n and size < PAIR_CHUNK:
            size <<= 1
        lo = 0
        while lo < n:
            hi = min(lo + size, n)
            if hi < n:
                hi = _cut_at_copy(packed, lo, hi)
            chunk_p = np.full(size, PAD_BYTE, np.uint8)
            chunk_p[:hi - lo] = packed[lo:hi]
            chunk_f = np.full(size, drop_flat, np.int32)
            chunk_f[:hi - lo] = flat[lo:hi]
            host, n_host = _host_scored(chunk_p[:hi - lo], chunk_f[:hi - lo])
            yield chunk_p, chunk_f, window, cap, host, n_host
            lo = hi


def kernel_codes(packed: torch.Tensor):
    """One chunk of the one-byte-per-row stream reordered and re-encoded
    for the pair-hit kernel, on ``packed``'s device.

    The kernel reads a copy's genome count at its last row, but
    ``native.plan_pairs`` emits a copy's document runs in first-seen
    order, so its genome run may come first or in the middle.  A stable
    sort keyed by (copy, side) moves it last; the hits do not depend on
    the order of the runs (occurrences count within a document run, a
    read row's hits over its copy).  The bytes are re-encoded as the
    kernel's codes (bits 0-1 symbol, 2 m, 3 docrun, 4 side), m recomputed
    for the new order.  Returns ``(codes, perm)``: uint8 codes and the
    int64 permutation, ``codes[i]`` being input row ``perm[i]``.
    """
    p = packed.to(torch.int32)
    copy = torch.cumsum(1 - ((p >> 6) & 1), 0)
    key = copy.to(torch.int64) * 2 + ((p >> 4) & 1)
    key, perm = torch.sort(key, stable=True)
    p = p[perm]
    copy = key >> 1
    m = torch.ones_like(p)
    m[0] = 0
    m[1:] = (copy[1:] == copy[:-1]).to(torch.int32)
    codes = ((p & 3) | (m << 2) | (((p >> 5) & 1) << 3)
             | (((p >> 4) & 1) << 4))
    return codes.to(torch.uint8), perm


def _pair_chunk(sim: torch.Tensor, packed: torch.Tensor,
                flat: torch.Tensor, window: int, cap: int, host,
                drop: int) -> None:
    """One chunk: reorder and re-encode, pair hits (the kernel of ``cap``
    on a card, its plain version on the CPU), one scatter-add into
    ``sim``; the host-scored copies' hits join the scatter.  Genome rows
    add zero at cells of the drop row, spread over its columns."""
    codes, perm = kernel_codes(packed)
    hits = pair_hits(codes, window, cap)
    gs = ((codes >> 4) & 1).bool()
    g_pad = sim.shape[1]
    spread = torch.arange(codes.shape[0], device=codes.device) % g_pad
    idx = torch.where(gs, drop + spread, flat[perm].to(torch.int64))
    vals = torch.where(gs, 0, hits)
    if host is not None:
        h_flat, h_hits = host
        idx = torch.cat([idx, torch.from_numpy(h_flat).to(
            idx.device, torch.int64)])
        vals = torch.cat([vals, torch.from_numpy(h_hits).to(vals.device)])
    sim.view(-1).index_add_(0, idx, vals.to(sim.dtype))


def pair_score_into(sim: torch.Tensor, buckets, num_reads: int, g_pad: int,
                    timer=None) -> torch.Tensor:
    """Accumulate ``native.plan_pairs``' buckets into the plane ``sim``.

    ``sim`` is an int8 (or int32, ``wide_sim``) ``(rows > num_reads,
    g_pad)`` tensor; row ``num_reads`` is the drop row.  Each stream
    ships in chunks cut at copy boundaries (:func:`unpacked_chunks`), and
    every chunk launches the pair-hit kernel once on a card.  int8 adds
    wrap mod 256 (the original's uchar counters).  Updates ``sim`` in
    place, on the current stream, and returns it.  ``timer`` (a
    ``PhaseTimer``) gets the host's time in a ``pair_score`` phase.
    """
    if sim.dim() != 2 or sim.shape[1] != g_pad or sim.shape[0] <= num_reads:
        raise ValueError(f"sim must be (rows > {num_reads}, {g_pad}), got "
                         f"{tuple(sim.shape)}")
    stats = {"chunks": {name: 0 for name in LAUNCHES}, "rows": 0,
             "host_copies": 0}
    ctx = timer.phase("pair_score") if timer else contextlib.nullcontext()
    with ctx:
        for chunk_p, chunk_f, window, cap, host, n_host in unpacked_chunks(
                buckets, num_reads, g_pad):
            _pair_chunk(sim, torch.from_numpy(chunk_p).to(sim.device),
                        torch.from_numpy(chunk_f).to(sim.device), window,
                        cap, host, num_reads * g_pad)
            stats["chunks"][_KERNEL_FOR_CAP[cap]] += 1
            stats["rows"] += len(chunk_p)
            stats["host_copies"] += n_host
    LAST_RUN.clear()
    LAST_RUN.update(stats)
    return sim
