"""Process-group set-up and per-rank index-range planning.

The port of ``lime_tpu/parallel/multihost.py``.  The reference scales
across cores by giving every OpenMP thread a private FILE* and a byte
range of the ``.lcp``/``.da`` files, with a straddle protocol at range
boundaries (reference src/ClusterLCP.cpp:100-167, 196-264).  Across
ranks the same decomposition applies: every rank memmaps only its
position range of the index (plus the straddle extension), plans it
locally, and the per-rank compact streams concatenate — in rank order —
into exactly the stream one process would have planned.

``extend_range_to_cluster_boundaries`` is the straddle protocol:

- skip-leading: a range that starts inside an alpha-run advances to the
  first position with ``lcp < alpha`` — those positions belong to the
  previous rank's open cluster (ClusterLCP.cpp:196-202).  The boundary row
  itself starts the range: it closes the previous cluster and is the
  ``p_start`` row of any cluster opening right after it.
- read-past-end: a range whose end falls inside an alpha-run extends until
  the run closes (ClusterLCP.cpp:243-264), so the straddling cluster is
  planned exactly once, by the rank that opened it.

:func:`init_distributed` starts the process group (one process per rank)
from its arguments or the environment.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..constants import SYMBOL_RANK_LUT
from ..formats.arrays import open_da, open_ebwt, open_lcp
from ..host import _DEGENERATE_BYTE

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend: Optional[str] = None,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda",
                     timeout: datetime.timedelta = TIMEOUT
                     ) -> Tuple[int, int]:
    """Initialise the torch.distributed process group; idempotent.

    Reads ``LIME_COORDINATOR`` (``host:port``) / ``LIME_NUM_PROCESSES`` /
    ``LIME_PROCESS_ID`` when the arguments are None, as ``lime_tpu`` does,
    or else the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` that ``torchrun`` sets.  The backend is ``"nccl"`` for a
    CUDA ``device`` and ``"gloo"`` for the CPU unless ``backend`` names
    one; an NCCL rank takes the card ``LOCAL_RANK`` names (default: its
    rank) and raises if there is no such card.  Collectives fail after
    ``timeout``.  Returns ``(rank, world_size)``; ``(0, 1)`` when fewer
    than two processes are asked for (no group is started).
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    coordinator_address = coordinator_address or env.get("LIME_COORDINATOR")
    if num_processes is None:
        num_processes = int(env.get("LIME_NUM_PROCESSES", "0")) or None
    if process_id is None and env.get("LIME_PROCESS_ID") is not None:
        process_id = int(env["LIME_PROCESS_ID"])
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in env and "RANK" in env:
        init_method = "env://"
        num_processes = num_processes or int(env.get("WORLD_SIZE", "1"))
        process_id = int(env["RANK"]) if process_id is None else process_id
    else:
        init_method = None
    if not init_method or not num_processes or num_processes < 2:
        return 0, 1
    if process_id is None:
        raise ValueError("a multi-process run needs each process's id "
                         "(LIME_PROCESS_ID or RANK)")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= count:
            raise RuntimeError(f"rank {process_id} needs CUDA device {local} "
                               f"(LOCAL_RANK) but {count} are visible")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def host_position_range(n_positions: int, num_hosts: int, host_idx: int
                        ) -> Tuple[int, int]:
    """Even [lo, hi) split of the position stream (pre-straddle)."""
    if not 0 <= host_idx < num_hosts:
        raise ValueError(f"host {host_idx} not in [0, {num_hosts})")
    per = -(-n_positions // num_hosts)
    lo = min(host_idx * per, n_positions)
    return lo, min(lo + per, n_positions)


def extend_range_to_cluster_boundaries(lcp: np.ndarray, lo: int, hi: int,
                                       alpha: int) -> Tuple[int, int]:
    """Apply the straddle protocol to [lo, hi) (see module docstring).

    ``lcp`` may be a memmap — only positions near the boundaries are
    touched.  The returned range starts at a position with
    ``lcp < alpha`` (or 0) and ends right after the last run closes (or at
    n), so planning it standalone reproduces the whole-file cluster set for
    the covered region.
    """
    n = len(lcp)
    lo, hi = max(0, lo), min(n, hi)
    while lo > 0 and lo < n and lcp[lo] >= alpha:
        lo += 1  # skip-leading: in-run rows belong to the previous host
    while hi < n and lcp[hi] >= alpha:
        hi += 1  # read-past-end: close the straddling cluster locally
    return lo, hi


def plan_host_range_pairs(fasta_path: str, num_reads: int,
                          num_genomes: int, alpha: int, num_hosts: int,
                          host_idx: int, use_ebwt: bool = True,
                          dense_min: int = 16, dp: int = 1,
                          rows_local: int = 0):
    """Packed pair-stream plan of this host's range of a collection.

    The pair-engine counterpart of :func:`plan_host_range`: only this
    host's byte range (straddle-extended) is faulted in and planned with
    lime_plan_pairs_packed.  Chunks are copy-aligned and carry global
    read-row ids, so per-host chunk sets simply union; the straddle
    protocol guarantees each cluster is planned by exactly one host.
    Returns ``(arrays, chunks, windows, row_bits, dense_start, dense_len,
    bad_start, bad_len)`` with GLOBAL cluster positions in the routing
    lists.
    """
    lcp = open_lcp(fasta_path, mmap=True)
    lo, hi = host_position_range(len(lcp), num_hosts, host_idx)
    lo, hi = extend_range_to_cluster_boundaries(lcp, lo, hi, alpha)
    if hi <= lo:
        empty = np.empty(0, np.int64)
        return ((np.empty(0, np.uint32), np.empty(0, np.uint8),
                 np.empty(0, np.uint16)), [], (1, 1, 1),
                native.row_bits_for(num_reads), empty, empty, empty,
                empty)
    lcp_s = np.ascontiguousarray(lcp[lo:hi])
    da_s = np.ascontiguousarray(open_da(fasta_path, mmap=True)[lo:hi])
    eb_s = (np.ascontiguousarray(open_ebwt(fasta_path, mmap=True)[lo:hi])
            if use_ebwt else None)
    (arrays, chunks, windows, W, den_s, den_l, bad_s,
     bad_l) = native.plan_pairs_packed(
        lcp_s, da_s, eb_s, num_reads, alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE.astype(np.uint8), dense_min=dense_min,
        num_refs=num_genomes, dp=dp, rows_local=rows_local)
    return (arrays, chunks, windows, W, den_s + lo, den_l, bad_s + lo,
            bad_l)


def plan_host_range(fasta_path: str, num_reads: int, num_genomes: int,
                    alpha: int, num_hosts: int, host_idx: int,
                    use_ebwt: bool = True, g_dense: int = 0,
                    use_u16: bool = False):
    """Plan this host's range of a collection from memmapped index files.

    Only this host's byte range (plus the straddle extension) is ever
    faulted in — the analogue of the reference's per-thread fseek ranges
    (src/ClusterLCP.cpp:100-167).  Returns ``(packed, doc, window,
    bad_start, bad_len, (lo, hi))`` where bad_start holds GLOBAL positions
    and concatenating the per-host ``packed``/``doc`` in host order equals
    the whole-file plan.
    """
    lcp = open_lcp(fasta_path, mmap=True)
    lo, hi = host_position_range(len(lcp), num_hosts, host_idx)
    lo, hi = extend_range_to_cluster_boundaries(lcp, lo, hi, alpha)
    if hi <= lo:
        z16 = np.uint16 if use_u16 else np.uint32
        return (np.empty(0, np.uint8), np.empty(0, z16), 1,
                np.empty(0, np.int64), np.empty(0, np.int64), (lo, hi))

    # a range headed by a sub-alpha row never re-opens at index 0; the
    # planner's skip-of-position-0 rule must not also suppress a cluster
    # that OPENS at global position lo+1 — it doesn't, because opening
    # happens at i>=1 and p_start = i-1 = 0 maps to global lo.
    lcp_s = np.ascontiguousarray(lcp[lo:hi])
    da_s = np.ascontiguousarray(open_da(fasta_path, mmap=True)[lo:hi])
    eb_s = (np.ascontiguousarray(open_ebwt(fasta_path, mmap=True)[lo:hi])
            if use_ebwt else None)

    if not native.available():
        raise RuntimeError("per-host planning requires the native library")
    packed, doc, nc, window, bad_s, bad_l, _, _ = native.plan_native(
        lcp_s, da_s, eb_s, num_reads, alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE, use_u16=use_u16, pad_block=1,
        pad_doc=num_reads + num_genomes, g_dense=g_dense)
    return packed, doc, window, bad_s + lo, bad_l, (lo, hi)
