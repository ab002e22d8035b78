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
"""

from __future__ import annotations

import torch


def _dense_chunk(sim: torch.Tensor, ridx: torch.Tensor, gidx: torch.Tensor,
                 cmap: torch.Tensor, rid: torch.Tensor, b_blk: int,
                 c_blk: int, pr: int, f: int, g_pad: int) -> None:
    """One fixed-shape chunk: scatter features, batched matmul, row
    scatter-add into ``sim`` (in place).

    Triple pads carry the index one past each feature buffer; the
    buffers get one extra sink slot there, sliced off before the matmul,
    so a real out-of-range index still raises.  Pad entries have all-zero
    phi rows, so their rid rows (the ``num_reads`` drop row) add zero.
    """
    dev = sim.device
    phi = torch.zeros(b_blk * pr * f + 1, dtype=torch.float32, device=dev)
    phi.index_add_(0, ridx, torch.ones(ridx.shape[0], device=dev))
    psi = torch.zeros(c_blk * g_pad * f + 1, dtype=torch.float32,
                      device=dev)
    psi.index_add_(0, gidx, torch.ones(gidx.shape[0], device=dev))
    phi = phi[:-1].view(b_blk, pr, f)
    psi = psi[:-1].view(c_blk, g_pad, f)
    out = torch.bmm(phi, psi[cmap].transpose(1, 2))  # (b_blk, pr, g_pad)
    add = out.reshape(b_blk * pr, g_pad).to(torch.int32)
    sim.index_add_(0, rid, add.to(sim.dtype))
