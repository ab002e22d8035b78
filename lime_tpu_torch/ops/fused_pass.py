"""Cluster detection and banded scoring on a torch device.

Torch port of ``lime_tpu/ops/fused_pass.py``, the device half of the
staged ``cluster_bwt`` stage: the whole collection's position stream is
scored in one K3 launch (``ops/banded_kernels.py``) into an int32
``(num_reads + 1, G_pad)`` accumulator; clusters the occurrence identity
cannot express (longer than the window, or holding an IUPAC-degenerate
symbol) are masked out of the emit gate and scored exactly on the host.
The counter wrap (mod 256 for the u8 result) runs on the device, so the
host receives the final ``(num_reads, num_refs)`` matrix, not an int64
one.  :func:`find_clusters_tpu` is the device-assisted cluster scan.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

from ..config import LimeConfig
from ..constants import SYMBOL_RANK_LUT
from ..device import resolve_device
from ..host import (_bad_cluster_mask, _g_pad_for, _rescue_sparse,
                    pack_stream)
from .banded_kernels import banded_sim_into
from .pair_score import to_device


def _boundary_block(lcp_blk: torch.Tensor, da_blk: torch.Tensor,
                    prev_m: torch.Tensor, alpha: int, num_reads: int):
    m = lcp_blk >= alpha
    prev = torch.cat([prev_m.reshape(1), m[:-1]])
    return m & ~prev, ~m & prev, da_blk < num_reads, m[-1]


def find_clusters_tpu(lcp: np.ndarray, da: np.ndarray, num_reads: int,
                      alpha: int, block: int = 1 << 24,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Device-assisted alpha-cluster detection over the (lcp, da) stream:
    ``(p_start, lens)`` of every cluster holding both a read and a
    genome position."""
    device = resolve_device(device)
    n = len(lcp)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts_l: List[np.ndarray] = []
    ends_l: List[np.ndarray] = []
    csum_parts: List[np.ndarray] = []
    # prev_m=True for the first block reproduces the reference's
    # skip-leading rule (a run touching position 0 emits no start).
    prev = torch.tensor(True, device=device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s, e, r, prev = _boundary_block(
            torch.from_numpy(np.array(lcp[lo:hi], np.int64)).to(device),
            torch.from_numpy(np.array(da[lo:hi], np.int64)).to(device),
            prev, alpha, num_reads)
        starts_l.append(torch.nonzero(s).flatten().cpu().numpy() + lo)
        ends_l.append(torch.nonzero(e).flatten().cpu().numpy() + lo)
        csum_parts.append(np.cumsum(r.cpu().numpy(), dtype=np.int64))
    base = 0
    for part in csum_parts:
        part += base
        base = part[-1]
    csum = np.concatenate([[0], np.concatenate(csum_parts)])

    run_starts = np.concatenate(starts_l)
    run_ends = np.concatenate(ends_l)
    if len(run_ends) and (len(run_starts) == 0
                          or run_ends[0] <= run_starts[0]):
        run_ends = run_ends[1:]
    if len(run_starts) > len(run_ends):
        run_ends = np.append(run_ends, n)

    p_start = run_starts - 1
    lens = run_ends - p_start
    n_reads_in = csum[run_ends] - csum[p_start]
    keep = (n_reads_in > 0) & (n_reads_in < lens)
    return p_start[keep], lens[keep]


def staged_stream(p_start: np.ndarray, lens: np.ndarray, da: np.ndarray,
                  ebwt: np.ndarray | None, config: LimeConfig,
                  alpha: int | None = None, lcp: np.ndarray | None = None):
    """The banded stream of one collection, built on the host.

    Returns ``(packed u8, doc int32, window, bad_idx)``: one byte per
    position (run mask m = lcp >= alpha with m[0] False, emit gate off
    inside host-routed clusters, symbol rank), the document ids, the
    band window (the longest cluster, capped at 255) and the indices of
    the host-routed clusters.  Without ``lcp`` the run mask is rebuilt
    from the cluster list.
    """
    n = len(da)
    if lcp is not None and alpha is not None:
        m = np.asarray(lcp) >= alpha
        m[0] = False
    else:
        # rows [p_start+1, p_start+len) carry m=True
        m = np.zeros(n, dtype=bool)
        total = int((lens - 1).sum())
        offs = np.concatenate([[0], np.cumsum(lens[:-1] - 1)])
        within = np.arange(total) - np.repeat(offs, lens - 1)
        m[np.repeat(p_start + 1, lens - 1) + within] = True
    window = int(min(max(int(lens.max()), 1), 255))
    ok, bad_idx = _bad_cluster_mask(p_start, lens, ebwt, window,
                                    config.use_ebwt, n)
    sym = (SYMBOL_RANK_LUT[np.asarray(ebwt)] if config.use_ebwt
           else np.zeros(n, np.uint8))
    return (pack_stream(m, ok, sym), np.array(da, dtype=np.int32), window,
            bad_idx)


def _banded_score(packed: torch.Tensor, doc: torch.Tensor, window: int,
                  num_reads: int, num_refs: int) -> torch.Tensor:
    """int32 ``(num_reads + 1, G_pad)`` banded scores of one stream (the
    last row is the drop row)."""
    sim = torch.zeros((num_reads + 1, _g_pad_for(num_refs)),
                      dtype=torch.int32, device=packed.device)
    return banded_sim_into(sim, packed, doc, window, num_reads)


def score_clusters_tpu(p_start: np.ndarray, lens: np.ndarray,
                       da: np.ndarray, ebwt: np.ndarray | None,
                       num_reads: int, num_refs: int, config: LimeConfig,
                       alpha: int | None = None,
                       lcp: np.ndarray | None = None,
                       device="cuda", timer=None) -> np.ndarray:
    """Dense similarity matrix via K3 on ``device``.

    Needs the lcp stream (+ alpha) to form the in-cluster mask, or
    rebuilds the mask from the cluster list when lcp is absent.  Returns
    the ``(num_reads, num_refs)`` matrix in ``config.sim_dtype`` with the
    reference's counter semantics (u8 wraps mod 256).  Host-routed
    clusters are scored exactly and unwrapped on a remapped compact
    collection (``host._rescue_sparse`` with u32 counters: the native
    scorer, or without the native library the numpy
    ``ops.scoring.score_clusters`` with ``wide_sim``) and added to the
    device accumulator before the wrap.
    """
    p_start = np.asarray(p_start, np.int64)
    lens = np.asarray(lens, np.int64)
    if config.use_ebwt and ebwt is None:
        raise ValueError("use_ebwt=True requires the .ebwt array")
    if len(p_start) == 0:
        return np.zeros((num_reads, num_refs), dtype=config.sim_dtype)
    device = resolve_device(device)
    ebwt = ebwt if config.use_ebwt else None

    def phase(label):
        return timer.phase(label) if timer else contextlib.nullcontext()

    with phase("stream"):
        packed, doc, window, bad_idx = staged_stream(p_start, lens, da, ebwt,
                                                     config, alpha, lcp)
    keep = []
    with phase("banded"):
        sim = _banded_score(to_device(packed, device, keep),
                            to_device(doc, device, keep), window, num_reads,
                            num_refs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    del packed, doc, keep
    if len(bad_idx):
        with phase("rescue"):
            rows, cols, vals = _rescue_sparse(
                p_start[bad_idx], lens[bad_idx], da, ebwt, num_reads,
                num_refs, config.replace(wide_sim=True))
            if len(rows):
                flat = (torch.from_numpy(rows.astype(np.int64))
                        * sim.shape[1]
                        + torch.from_numpy(cols.astype(np.int64)))
                sim.view(-1).index_add_(0, flat.to(device),
                                        torch.from_numpy(vals).to(device))
    with phase("fetch"):
        out = sim[:num_reads, :num_refs]
        if config.sim_modulus:
            out = torch.remainder(out, config.sim_modulus).to(torch.uint8)
            return out.cpu().numpy()
        return out.contiguous().cpu().numpy().view(np.uint32)
