"""G-independent device scoring over planner-emitted packed pair streams.

Torch port of ``lime_tpu/ops/pair_score.py`` (the packed-stream half).
The native planner (``lime_tpu.native.plan_pairs_packed``) re-emits each
sparse cluster once per genome document it contains, packed as three
buffers per collection: 5 metadata bits per row (8 rows per 5-byte
group), a W-bit read id per row (8 rows per W/4 u32 words) and one u16
genome column per copy, pre-cut into chunks on copy boundaries.  Per
chunk the device unpacks the rows, counts pair hits
(:func:`pair_kernels.pair_hits`), broadcasts each copy's genome column to
its rows and scatter-adds the hits into the ``(R_pad, G_pad)`` plane.
int8 adds wrap mod 256: the reference's unsaturated uchar counters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import _gcol_padded, _pack24
from .pair_kernels import BUCKET_CAPS, PAIR_TILE, _pair_hits_core, pair_hits

__all__ = ["BUCKET_CAPS", "PAIR_TILE", "_pair_hits_core", "_unpack_bits5",
           "_unpack_rows", "_hits_dispatch", "_pair_packed_block",
           "pair_upload", "pair_score_packed_into", "coo_scatter_into",
           "to_device"]


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


def _pair_packed_block(sim: torch.Tensor, rows_w, bits_b, gcol, window,
                       drop: int, row_bits: int, cap: int = 255) -> None:
    """One packed chunk: unpack, score, one scatter-add into ``sim``.

    The genome column is constant per copy, so it ships once per copy and
    broadcasts to rows via a cumsum of copy-start bits + one gather (a
    copy's first row is always read-side; pad rows carry side=1 and m=0
    and never increment the cumsum).  Genome-side rows land in the drop
    row ``drop // g_pad`` (= num_reads, inside R_pad), spread over its
    columns so their zero-value adds do not all hit one address.
    Updates ``sim`` in place.
    """
    codes = _unpack_bits5(bits_b)
    row = _unpack_rows(rows_w, row_bits)
    hits = _hits_dispatch(codes, window, cap=cap)
    m = (codes >> 2) & 1
    gs = ((codes >> 4) & 1).bool()
    copy_start = ((m == 0) & ~gs).to(torch.int64)
    # pad rows before a chunk's first copy would index -1: clamp, they
    # are genome-side and go to the drop row anyway
    cidx = (torch.cumsum(copy_start, 0) - 1).clamp_(min=0)
    gc = gcol[cidx].to(torch.int64) & 0xFFFF
    g_pad = sim.shape[1]
    spread = torch.arange(codes.shape[0], device=codes.device) % g_pad
    flat = torch.where(gs, drop + spread, row * g_pad + gc)
    vals = torch.where(gs, 0, hits).to(sim.dtype)
    sim.view(-1).index_add_(0, flat, vals)


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
    d_rows, d_bits, d_gcol = pair_upload(arrays, chunks, sim.device, keep)
    g_pad = sim.shape[1]
    drop = num_reads * g_pad
    wpg = row_bits // 4  # words per 8-row group
    for bucket, _, n_rows, wo, bo, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        _pair_packed_block(
            sim, d_rows[wo:wo + n_rows // 8 * wpg],
            d_bits[bo:bo + n_rows // 8 * 5], d_gcol[go:go + gcap],
            windows[bucket], drop, row_bits, BUCKET_CAPS[bucket])


# ---------------------------------------------------------------------------
# Delta-COO chains (the dense host rescue)
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

