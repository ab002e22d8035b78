"""Histogram-matmul scoring of genome-dense clusters (torch port of
``lime_tpu/ops/dense_score.py``).

With per-cluster indicator features ``phi_r[s, k] = [count_r(s) > k]``
and ``psi_g[s, k] = [count_g(s) > k]`` the symbol-aware score
``sum_s min(count_r(s), count_g(s))`` is ``phi_r . psi_g``.  The host
packer (:func:`lime_tpu_torch.host.pack_chunks`) emits fixed-shape chunks
of flat feature indices; per chunk the device scatters them into the two
feature tensors, runs one batched matmul and scatter-adds the rows into
the int8 plane.  These are plain torch ops (on the TPU they were XLA's,
outside any Pallas kernel).

The features are float32: inputs are 0/1 and every sum is at most
F = 32, so the product is exact (float32 matmuls on the card run in full
float32 unless TF32 is enabled, and 0/1 sums <= 32 are exact in TF32
too).

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


def _dense_rows(ridx: torch.Tensor, gidx: torch.Tensor, cmap: torch.Tensor,
                b_blk: int, c_blk: int, pr: int, f: int,
                g_pad: int) -> torch.Tensor:
    """One fixed-shape chunk's scores: scatter features, batched matmul;
    int32 ``(b_blk * pr, g_pad)``, one row per read lane.

    Triple pads carry the index one past each feature buffer; the
    buffers get one extra sink slot there, sliced off before the matmul,
    so a real out-of-range index still raises.  Pad entries have all-zero
    phi rows, so their rows are zero.
    """
    dev = ridx.device
    phi = torch.zeros(b_blk * pr * f + 1, dtype=torch.float32, device=dev)
    phi.index_add_(0, ridx, torch.ones(ridx.shape[0], device=dev))
    psi = torch.zeros(c_blk * g_pad * f + 1, dtype=torch.float32,
                      device=dev)
    psi.index_add_(0, gidx, torch.ones(gidx.shape[0], device=dev))
    phi = phi[:-1].view(b_blk, pr, f)
    psi = psi[:-1].view(c_blk, g_pad, f)
    out = torch.bmm(phi, psi[cmap].transpose(1, 2))  # (b_blk, pr, g_pad)
    return out.reshape(b_blk * pr, g_pad).to(torch.int32)


def _dense_chunk(sim: torch.Tensor, ridx: torch.Tensor, gidx: torch.Tensor,
                 cmap: torch.Tensor, rid: torch.Tensor, b_blk: int,
                 c_blk: int, pr: int, f: int, g_pad: int) -> None:
    """One fixed-shape chunk: scores, then one row scatter-add into
    ``sim`` (in place).  Pad entries' rows (the ``num_reads`` drop row)
    add zero."""
    add = _dense_rows(ridx, gidx, cmap, b_blk, c_blk, pr, f, g_pad)
    sim.index_add_(0, rid, add.to(sim.dtype))


def _dense_chunk_offset(stack: torch.Tensor, fi: int, ridx: torch.Tensor,
                        gidx: torch.Tensor, cmap: torch.Tensor,
                        rid: torch.Tensor, row_base: int, b_blk: int,
                        c_blk: int, pr: int, f: int, g_pad: int) -> None:
    """:func:`_dense_chunk` into plane ``fi`` of the ``(F, B, g_pad)``
    row-block stack, whose row 0 is read ``row_base``.

    Only the rows inside the block are added (most rows of a chunk fall
    outside it when there are many blocks); selecting them waits for the
    device.  Adding zero rows for the others instead, with no wait,
    measured slower on an H100 (PERF.md): eight times the atomic adds.
    """
    add = _dense_rows(ridx, gidx, cmap, b_blk, c_blk, pr, f, g_pad)
    local = rid.to(torch.int64) - row_base
    sel = torch.nonzero((local >= 0) & (local < stack.shape[1])).squeeze(1)
    stack[fi].index_add_(0, local[sel], add[sel].to(stack.dtype))


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
    for arrs in chunks:
        _dense_chunk(sim, *(torch.from_numpy(a).to(sim.device)
                            for a in arrs), B_BLK, C_BLK, PR, f, g_pad)
    return sim, left_s, left_l
