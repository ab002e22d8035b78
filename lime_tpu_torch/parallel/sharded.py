"""The banded scoring core of ``lime_tpu/parallel/sharded.py`` in torch.

**Banded formulation.**  With every cluster bounded by ``window``
positions, any scoring pair (i-o, i) lies within ``o <= window``, and
"same cluster" for the pair is AND(m[k], k in (i-o, i]) where
m = lcp >= alpha.  Per position the occurrence index is the count of
earlier same-cluster positions, at most ``window`` back, with the same
(document, symbol); a (read, genome) pair scores once for every read
position and genome partner with equal (symbol, occurrence index).  See
``lime_tpu/ops/fused_pass.py`` for why that sum is the reference's
histogram score.

Here one function, :func:`banded_partial_sim`, serves what the JAX
module splits between its XLA formulation and ``_pallas_partial_sim``:
it packs the stream and hands it to K3
(:func:`lime_tpu_torch.ops.banded_kernels.banded_sim_into`), whose
CUDA kernel fuses the segment-sum and needs no position blocks, and
whose plain version on the CPU is the XLA formulation in blocks.  The
SPMD engines of the JAX module (``make_sharded_pipeline``,
``make_pair_sharded_pipeline``, ``run_sharded*``) are not ported yet
(ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..host import _g_pad_for
from ..ops.banded_kernels import banded_sim_into, pack_positions
from ..ops.banded_kernels import scatter_sim as _scatter_into


def banded_partial_sim(m: torch.Tensor, doc: torch.Tensor,
                       sym: torch.Tensor, num_reads: int, num_refs: int,
                       window: int, emit_ok: Optional[torch.Tensor] = None,
                       out_rows: Optional[int] = None,
                       acc_dtype: torch.dtype = torch.int32
                       ) -> torch.Tensor:
    """Partial similarity matrix from one position stream.

    - ``m``: the in-run indicator lcp >= alpha, position 0 forced False.
    - ``doc`` document ids, ``sym`` symbol ranks (0..15), all ``(L,)`` on
      one device; a CUDA stream runs K3, a CPU one its plain version.
    - ``window`` (<= 255): the longest cluster the band covers.
    - ``emit_ok``: positions allowed to emit pairs (None = all); every
      scored pair has one read-side element, and that element emits it.
    - ``out_rows``: None returns ``(num_reads, num_refs)`` sliced exact;
      otherwise the raw accumulator ``(out_rows, G_pad)`` with the drop
      row at ``num_reads`` (rows past it stay zero).
    - ``acc_dtype``: ``torch.int8`` wraps mod 256 (the reference's uchar
      counters); ``torch.int32`` does not.
    """
    if emit_ok is None:
        emit_ok = torch.ones_like(m, dtype=torch.bool)
    g_pad = _g_pad_for(num_refs)
    n_rows = out_rows if out_rows is not None else num_reads + 1
    packed = pack_positions(m, emit_ok, sym).contiguous()
    sim = torch.zeros((n_rows, g_pad), dtype=acc_dtype, device=m.device)
    banded_sim_into(sim, packed, doc.to(torch.int32).contiguous(), window,
                    num_reads)
    if out_rows is not None:
        return sim
    return sim[:num_reads, :num_refs]


def _scatter_sim(v: torch.Tensor, rows: torch.Tensor, num_reads: int,
                 n_rows: Optional[int] = None,
                 acc_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Segment-sum V rows by read id into a fresh ``(n_rows, G)``
    accumulator (``n_rows`` defaults to ``num_reads + 1``: the drop row).
    An index outside it raises."""
    if n_rows is None:
        n_rows = num_reads + 1
    sim = torch.zeros((n_rows, v.shape[1]), dtype=acc_dtype,
                      device=v.device)
    return _scatter_into(sim, v, rows)


def banded_fused_step(lcp: torch.Tensor, da: torch.Tensor,
                      sym: torch.Tensor, num_reads: int, num_refs: int,
                      alpha: int, window: int) -> torch.Tensor:
    """Single-device fused scan + score step over one collection."""
    L = lcp.shape[-1]
    m = (lcp >= alpha) & (torch.arange(L, device=lcp.device) != 0)
    return banded_partial_sim(m, da, sym, num_reads, num_refs, window)
