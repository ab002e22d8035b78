"""Scoring of genome-dense clusters (torch port of
``lime_tpu/ops/dense_score.py``).

With per-cluster indicator features ``phi_r[s, k] = [count_r(s) > k]``
and ``psi_g[s, k] = [count_g(s) > k]`` the symbol-aware score
``sum_s min(count_r(s), count_g(s))`` is ``phi_r . psi_g``.  The host
packer (:func:`lime_tpu_torch.host.pack_chunks`) emits fixed-shape chunks
of flat feature indices.

On a CUDA plane one hand-written kernel scores a chunk
(:mod:`.dense_kernels`, ``csrc/dense_pairs.cu``): F = nsym * K <= 32, so
each lane's and each genome's features are one 32-bit mask and the score
is their popcount, computed for the lanes that carry a read against
their own cluster's genome columns only, and added straight into the
plane.

On a CPU plane the plain version runs ``lime_tpu``'s chain in torch
(:func:`_dense_rows`): the device scatters the triples into the two
feature tensors, runs one batched matmul and scatter-adds the rows into
the plane.  The features are float32: inputs are 0/1 and every sum is at
most F = 32, so the product is exact.  The product runs in column tiles
of at most 3,456 columns (:func:`dense_tile_for`; one tile up to that
width), each built from the genome triples of its columns, so no
feature tensor of the database's whole width exists.  Both versions
count the cells the kernel scores (lanes that carry a read times their
cluster's genomes) into a status of :func:`.dense_kernels.new_status`, which
:func:`.dense_kernels.take` reads; the kernel's faults go there too.

In the row-blocked mode each chunk uploads once per run and is replayed
once per row block by a plain loop (:func:`_dense_chunk_offset`);
``lime_tpu``'s ``_dense_scan_class`` batches the replays with
``lax.scan`` only to amortise its relay's launch cost.

:func:`dense_score_into` is the whole path for one cluster list: pack on
the host, then every chunk into one plane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import B_BLK, C_BLK, K, PR, pack_chunks
from . import dense_kernels


def dense_tile_for(g_pad: int) -> int:
    """Genome columns one product of the plain version covers: the whole
    width up to 3,456 columns (the G_pad of a 3,423-genome database),
    else the fewest equal tiles of at most that, multiples of 128 (the last one
    narrower), so that one chunk's feature tensors and products stay the
    size they have at G_pad 3,456 whatever the width."""
    n = -(-g_pad // 3456)
    return -(-g_pad // (n * 128)) * 128


def _dense_rows(ridx: torch.Tensor, gidx: torch.Tensor, cmap: torch.Tensor,
                b_blk: int, c_blk: int, pr: int, f: int, g_pad: int):
    """One fixed-shape chunk's scores: scatter features, batched matmul.
    Yields ``(c0, rows)`` for each genome-column tile of
    :func:`dense_tile_for`'s width, in order (one tile up to 3,456
    columns): ``rows`` int32 ``(b_blk * pr, w)``, one row per read lane,
    holds columns ``[c0, c0 + w)``.

    Triple pads carry the index one past each feature buffer; the
    buffers get one extra sink slot there, sliced off before the matmul,
    so a real out-of-range index still raises.  Pad entries have all-zero
    phi rows, so their rows are zero.  Each tile's psi takes the genome
    triples of its columns and sends the others to its sink slot, chosen
    on the device with no wait; the sums are of 0/1 values, at most
    ``f``, so a tile's columns are exactly those of the whole product.
    Every tile's psi has the first tile's width, the last one's extra
    columns are empty.
    """
    dev = ridx.device
    phi = torch.zeros(b_blk * pr * f + 1, dtype=torch.float32, device=dev)
    phi.index_add_(0, ridx, torch.ones(ridx.shape[0], device=dev))
    phi = phi[:-1].view(b_blk, pr, f)
    tile = dense_tile_for(g_pad)
    sink = c_blk * tile * f
    g = gidx.to(torch.int64)
    doc = g // f  # cluster * g_pad + column
    cl = doc // g_pad
    col = doc - cl * g_pad
    # the triple's slot in a (c_blk, tile, f) psi, less the tile's c0 * f
    at = cl * (tile * f) + (g - cl * (g_pad * f))
    which = torch.where(cl < c_blk, col // tile, -1)
    # pads go to the sink; an index past the pad stays past it, and raises
    other = torch.where(g > c_blk * g_pad * f, g + sink, sink)
    ones = torch.ones(gidx.shape[0], device=dev)
    for t, c0 in enumerate(range(0, g_pad, tile)):
        w = min(tile, g_pad - c0)
        psi = torch.zeros(sink + 1, dtype=torch.float32, device=dev)
        psi.index_add_(0, torch.where(which == t, at - c0 * f, other), ones)
        psi = psi[:-1].view(c_blk, tile, f)
        out = torch.bmm(phi, psi[cmap].transpose(1, 2))  # (b_blk, pr, tile)
        rows = out.reshape(b_blk * pr, tile)[:, :w].to(torch.int32)
        del psi, out
        yield c0, rows


def _count_plain(status: torch.Tensor, ridx: torch.Tensor,
                 gidx: torch.Tensor, cmap: torch.Tensor,
                 lane_ok: torch.Tensor, b_blk: int, c_blk: int, pr: int,
                 f: int, g_pad: int) -> None:
    """Add to ``status`` the cells the kernel scores in a chunk:
    per entry, its lanes that carry a read triple (and ``lane_ok``) times
    its cluster's genomes, counted as the kernel counts them, one per run
    of a (cluster, genome) pair's triples."""
    lanes = ridx[ridx != b_blk * pr * f].to(torch.int64) // f
    has = torch.zeros(b_blk * pr, dtype=torch.bool, device=ridx.device)
    has[lanes] = True
    keys = gidx[gidx != c_blk * g_pad * f].to(torch.int64) // f
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    runs = keys[head] // g_pad
    genomes = torch.bincount(runs, minlength=c_blk)
    cells = ((has & lane_ok).view(b_blk, pr).sum(1)
             * genomes[cmap.to(torch.int64)]).sum()
    status[0] += cells


def _dense_chunk(sim: torch.Tensor, ridx: torch.Tensor, gidx: torch.Tensor,
                 cmap: torch.Tensor, rid: torch.Tensor, b_blk: int,
                 c_blk: int, pr: int, f: int, g_pad: int,
                 status: torch.Tensor) -> None:
    """One fixed-shape chunk into ``sim`` (in place): on the card the
    kernel; on the CPU per column tile one row scatter-add of
    :func:`_dense_rows`, whose pad entries' rows (the ``num_reads`` drop
    row) add zero.

    ``status`` (:func:`.dense_kernels.new_status` on ``sim``'s device)
    gathers the cells scored and the kernel's faults for the caller to
    :func:`.dense_kernels.take` after its own synchronisation."""
    if sim.device.type == "cuda":
        dense_kernels.dense_pairs_into(sim, ridx, gidx, cmap, rid, b_blk,
                                       c_blk, pr, f, g_pad, status)
        return
    for c0, add in _dense_rows(ridx, gidx, cmap, b_blk, c_blk, pr, f,
                               g_pad):
        sim[:, c0:c0 + add.shape[1]].index_add_(0, rid, add.to(sim.dtype))
    _count_plain(status, ridx, gidx, cmap,
                 torch.ones_like(rid, dtype=torch.bool), b_blk, c_blk, pr,
                 f, g_pad)


def _dense_chunk_offset(stack: torch.Tensor, fi: int, ridx: torch.Tensor,
                        gidx: torch.Tensor, cmap: torch.Tensor,
                        rid: torch.Tensor, row_base: int, b_blk: int,
                        c_blk: int, pr: int, f: int, g_pad: int,
                        rid_sorted: np.ndarray,
                        status: torch.Tensor) -> bool:
    """:func:`_dense_chunk` into plane ``fi`` of the ``(F, B, g_pad)``
    row-block stack, whose row 0 is read ``row_base``; False, with
    nothing launched or computed, where no row of the chunk is in the
    block, which ``rid_sorted`` (the chunk's ``rid`` values, sorted on
    the host) answers without a wait.  ``status`` as for
    :func:`_dense_chunk`.

    On the card the kernel drops the lanes outside the block.  On the CPU
    only the rows inside the block are added.
    """
    at = np.searchsorted(rid_sorted, row_base)
    if at == len(rid_sorted) or rid_sorted[at] >= row_base + stack.shape[1]:
        return False
    if stack.device.type == "cuda":
        dense_kernels.dense_pairs_into(stack[fi], ridx, gidx, cmap, rid,
                                       b_blk, c_blk, pr, f, g_pad, status,
                                       row_base)
        return True
    local = rid.to(torch.int64) - row_base
    inside = (local >= 0) & (local < stack.shape[1])
    sel = torch.nonzero(inside).squeeze(1)
    local = local[sel]
    for c0, add in _dense_rows(ridx, gidx, cmap, b_blk, c_blk, pr, f,
                               g_pad):
        stack[fi, :, c0:c0 + add.shape[1]].index_add_(
            0, local, add[sel].to(stack.dtype))
    _count_plain(status, ridx, gidx, cmap, inside, b_blk, c_blk, pr, f,
                 g_pad)
    return True


def dense_score_into(sim: torch.Tensor, starts: np.ndarray,
                     lens: np.ndarray, da: np.ndarray, ebwt, num_reads: int,
                     num_genomes: int, g_pad: int):
    """Accumulate dense-cluster scores into the plane ``sim``.

    ``sim`` is the ``(rows >= num_reads + 1, g_pad)`` accumulator (int8
    or int32) with the scatter drop row at ``num_reads``; it is updated
    in place, on the current stream.  Returns ``(sim, left_starts,
    left_lens)``: the clusters the identity cannot express, for the exact
    host scorer (``lime_tpu.ops.dense_score.dense_score_into``'s
    contract).
    """
    chunks, left_s, left_l = pack_chunks(starts, lens, da, ebwt, num_reads,
                                         num_genomes, g_pad)
    f = (4 if ebwt is not None else 1) * K
    status = dense_kernels.new_status(sim.device)
    for arrs in chunks:
        _dense_chunk(sim, *(torch.from_numpy(a).to(sim.device)
                            for a in arrs), B_BLK, C_BLK, PR, f, g_pad,
                     status)
    dense_kernels.take(status)
    return sim, left_s, left_l
