"""Fused serving pipeline on one device: collections -> per-read assignments.

Torch port of ``lime_tpu/ops/fused_pipeline._run_fused_inner`` and
``_run_fused_blocked``.  Three engines, the one-block engine
(:func:`_run_fused_inner`), its all-host job shop (:func:`_job_shop`)
and the row-blocked engine (:func:`_run_fused_blocked`), route each
collection by the same host steps, in this order, and keep only where
the scores land and when:

1. :func:`_plan`: the packed pair planner (C++, GIL released) sends
   sparse clusters to packed pair streams (ops/pair_score.py) for the
   hand-written pair-hit kernels; with ``pair_stream=False``, or past
   2^28 reads or 65536 genomes, the banded planner (:func:`plan_banded`)
   sends them to one position stream for K3 (ops/banded_kernels.py),
   ``dense_threshold`` sending genome-sparse clusters to the host; an
   all-host split takes the light cluster scan.  The engine launches
   the streams at once, so the device scores them while the host packs.
2. :func:`_pack_dense`: genome-dense clusters packed into chunks for the
   dense kernel (ops/dense_score.py, ops/dense_kernels.py; the batched
   histogram matmul is the CPU's plain version); what the packer cannot
   express joins the rescue set.
3. :func:`_rescue`, every engine's rule: IUPAC-degenerate, over-long
   and inexpressible clusters, and the host share, scored by the exact
   host scorer into COO corrections that ride the classify program, or
   into a host plane whose nonzeros ship as a delta-COO chain
   (:func:`plane_corrections`) scattered into the device plane.

A run's counters live in one :class:`_Run`, which writes ``LAST_RUN``
and the log line.  Without the native library the run takes
``lime_tpu``'s fallback: the banded engine on :func:`_plan_python`'s
numpy plan (every mixed cluster of at most 255 rows with no
IUPAC-degenerate symbol in one K3 stream; the rest to the numpy exact
scorer), and no pair streams, dense path or host share
(``LAST_RUN["planner"]`` says which planner ran).

The host share.  ``host_frac`` (or ``LIME_HOST_FRAC``, which overrides
it) hash-routes that share of the pair path's clusters to the exact host
scorer at plan time (:func:`_host_split_for`; unset means none, the
split ``lime_tpu`` picks on a directly attached device).  An all-host
split (``host_frac`` 1, not ``wide_sim``) runs the job shop: two host
workers plan, score and compact one collection each, while this thread
issues every upload and launch.

Every launch is asynchronous on the current stream, so the planning of
collection i+1 overlaps the device's work on collection i, and a one-ahead
thread prefetches the next collection's index from disk.  A final classify
program fuses the counter wrap, normalisation, beta gate and the 4-stage
cascade; one packed (3, R_pad) triplet comes back.

Device memory.  A run's budget is the card's free memory less
``MEMORY_HEADROOM`` (none on the CPU), capped by ``LIME_HBM_BUDGET``.  A
pair-stream run whose ``(F, R_pad, G_pad)`` stack exceeds it runs in the
row-blocked mode: the pair streams and dense chunks upload once and stay
on the card, and every row block of ``B`` reads re-scores them into an
``(F, B, G_pad)`` stack, runs the cascade and fetches its triplet.  That
mode splits the budget in two equal halves: one for the stack (``B``
leaves half of its half as slack, as ``lime_tpu``'s formula does, and
the resident dense chunks come out of that slack), one for the resident
pair streams; ``LIME_HBM_BUDGET`` and ``LIME_STREAM_BUDGET`` cap each
half.  Streams estimated over their half are planned per read-row owner
and swept in owner passes, each uploading only its owner's chunks.  The
cascade's temporaries are held to their size at G_pad 3,456 whatever the
width: it walks read blocks of ``classify_torch.cascade_block_for``, so
they fit in ``MEMORY_HEADROOM``.  The dense kernel allocates nothing; on
the CPU the plain version runs in column tiles of at most 3,456
(``dense_score.dense_tile_for``).  The banded engine has no blocked mode
(nor has ``lime_tpu``'s): a stack over the card's budget raises
``MemoryError``, and ``LIME_HBM_BUDGET`` does not apply to it.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import host, native
from ..config import LimeConfig
from ..device import resolve_device
from ..constants import IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT
from ..formats.arrays import open_da, open_ebwt, open_lcp
from ..formats.lineage import Lineage
from ..host import (_BLOCK, _M_BIT, B_BLK, C_BLK, K, PACK_EMIT_BIT, PR,
                    _DEGENERATE_BYTE, _classify_block_for, _dense_min_for,
                    _dense_threshold_for, _g_pad_for, _pair_dense_min_for,
                    _r_pad_for, _rescue_sparse, merge_coo_segments,
                    pack_chunks, pair_rows_local)
from ..utils.timing import (PhaseTimer, carry_phases, device_memory_stats,
                            profile_run)
from .banded_kernels import banded_sim_into
from .classify_ops import ClassifyResult
from .classify_torch import (_classify_program_planes, _unpack_triplet,
                             alloc_planes, cascade_block_for)
from . import dense_kernels
from .dense_score import _dense_chunk, _dense_chunk_offset
from .pair_score import (coo_scatter_into, coo_scatter_into_stack,
                         pair_score_packed_into, pair_score_packed_offset,
                         pair_upload, to_device)

logger = logging.getLogger("lime_tpu_torch")

#: Device memory kept free beside the score planes: one collection's
#: packed streams and their unpacked int64 temporaries and the cascade's
#: per-block float32 tiles (of a size that does not grow past G_pad
#: 3,456); on the card the dense kernel allocates nothing.
MEMORY_HEADROOM = 8 << 30

#: Statistics of the most recent run, written by :meth:`_Run.finish`
#: and read by chip_smoke.py, the benchmark and tests.
LAST_RUN: dict = {}

#: lime_tpu's row-delta caps of the delta-COO formats: coo24 (12-bit
#: columns, 3 B an entry) and the plain chain (u16 columns)
_MAX_DROW24, _MAX_DROW = 15, 255

_warmed_paths: set = set()


def _host_split_for(config: LimeConfig) -> int:
    """The share of clusters the pair planner routes to the host scorer,
    in 256ths (0 = all on the device, 256 = all on the host).
    ``LIME_HOST_FRAC`` overrides ``config.host_frac``; unset means 0, the
    split ``lime_tpu``'s ``_host_split_for`` picks on a directly attached
    device with no link samples.  Shares under 18 round to none and over
    238 to all, as there."""
    frac = config.host_frac
    env = os.environ.get("LIME_HOST_FRAC")
    if env is not None:
        frac = float(env)
    if frac is None:
        return 0
    host_num = int(round(float(frac) * 256))
    if host_num < 18:
        return 0
    if host_num > 238:
        return 256
    return host_num


def plane_corrections(plane: np.ndarray, num_genomes: int, wide: bool,
                      threads: int = 0, zero_after: bool = False):
    """A host-scored plane (or a row slice of one) as device corrections:
    ``("chain", chain, packed24)``, its nonzeros as one merged delta-COO
    chain (None for an all-zero plane), coo24 (``packed24``) when the
    counters are u8 and the genome column fits 12 bits; past 65,536
    genomes, beyond ``native.coo_compact``'s u16 column, ``("coo", rows,
    cols, vals)`` (int32).  ``zero_after`` returns the plane zeroed."""
    if num_genomes > 65536:
        rows, cols = np.nonzero(plane)
        vals = plane[rows, cols].astype(np.int32)
        if zero_after:
            plane[rows, cols] = 0
        return "coo", rows.astype(np.int32), cols.astype(np.int32), vals
    p24 = not wide and num_genomes < 4096
    max_drow = _MAX_DROW24 if p24 else _MAX_DROW
    chain = merge_coo_segments(
        native.coo_compact(plane, plane.shape[0], num_genomes, wide=wide,
                           threads=threads, max_drow=max_drow,
                           zero_after=zero_after), max_drow=max_drow)
    return "chain", chain, p24


def _chain_bytes(chain, packed24: bool, wide: bool) -> int:
    """Bytes a delta-COO chain uploads: 3 an entry as coo24, else a u8
    row delta, a u16 column and a u8 or u32 value."""
    return len(chain[1]) * (3 if packed24 else 7 if wide else 4)


def _dense_offload(starts, lens, nrr):
    """``lime_tpu``'s pair-heavy offload mask over an all-host run's
    clusters: at least ``LIME_DENSE_OFFLOAD_MIN`` (256) read-genome
    position pairs, at most 65,536 positions."""
    off_min = int(os.environ.get("LIME_DENSE_OFFLOAD_MIN", 256))
    return (nrr * (lens - nrr) >= off_min) & (lens <= 65536)


def _release_done(keep: list) -> None:
    """Drop the pinned staging buffers in ``keep`` whose copies are done
    (``to_device`` holds each with its copy's event)."""
    keep[:] = [(p, ev) for p, ev in keep if not ev.query()]


def _device_memory(device: torch.device) -> int | None:
    """Bytes a run may use on ``device``: the card's free memory less
    MEMORY_HEADROOM; None on the CPU, where nothing bounds a run."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return max(free - MEMORY_HEADROOM, 0)


def _budget(total: int | None, var: str, share: int = 1) -> int | None:
    """``total // share``, capped by the environment variable ``var`` when
    it is set; None when neither bounds it."""
    budget = None if total is None else total // share
    env = os.environ.get(var)
    if env is not None:
        budget = int(env) if budget is None else min(budget, int(env))
    return budget


def _planner() -> str:
    """Which planner a run takes: the C++ one, or the numpy fallback."""
    return "native" if native.available() else "numpy"


def _doc_i32(doc: np.ndarray) -> np.ndarray:
    """The planner's u16, u32 or int32 document ids as int32 (u32 by its
    bits; ids stay below 2^31)."""
    return doc.view(np.int32) if doc.dtype == np.uint32 else \
        doc.astype(np.int32)


def plan_banded(lcp, da, ebwt, num_reads: int, num_genomes: int,
                config: LimeConfig):
    """The banded engine's plan of one collection: ``native.plan_native``
    with the routing thresholds ``config`` sets, its stream padded to
    ``_BLOCK`` with pad document ``num_reads + num_genomes``; without the
    native library :func:`_plan_python`'s stream (``nc`` 1, no dense
    lists), as ``lime_tpu``'s ``plan`` falls back.  Returns ``(packed,
    doc, nc, window, bad_start, bad_len, dense_start, dense_len)``."""
    use_u16 = (num_reads + num_genomes) < 0xFFFF
    if native.available():
        return native.plan_native(
            lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
            _DEGENERATE_BYTE, use_u16, pad_block=_BLOCK,
            pad_doc=num_reads + num_genomes,
            g_dense=_dense_threshold_for(num_genomes, config),
            dense_min=_dense_min_for(num_genomes, config))
    # the numpy fallback has no fast host scorer, so only clusters the
    # banded kernel cannot express route to the host
    packed, doc, window, bad_start, bad_len = _plan_python(
        lcp, da, ebwt, num_reads, num_genomes, config, use_u16)
    empty = np.empty(0, np.int64)
    return packed, doc, 1, window, bad_start, bad_len, empty, empty


def _plan_python(lcp, da, ebwt, num_reads: int, num_genomes: int,
                 config: LimeConfig, use_u16: bool):
    """Vectorized numpy fallback planner (native C++ pass unavailable)."""
    n = len(lcp)
    m = np.asarray(lcp) >= config.alpha
    m[0] = False
    window = 1
    bad_start = np.empty(0, np.int64)
    bad_len = np.empty(0, np.int64)
    d = np.diff(m.view(np.int8))
    run_starts = np.flatnonzero(d == 1) + 1
    run_ends = np.flatnonzero(d == -1) + 1
    if m[-1]:
        run_ends = np.append(run_ends, n)

    gpos = np.empty(0, np.int64)
    within0 = np.empty(0, bool)
    if len(run_starts):
        p_start = run_starts - 1  # cluster rows = run extended one left
        lens = run_ends - p_start
        # membership filter via a prefix-sum of the read-side indicator
        da_arr = np.asarray(da)
        cr = np.concatenate(
            [[0], np.cumsum(da_arr < num_reads, dtype=np.int64)])
        n_read_in = cr[p_start + lens] - cr[p_start]
        mixed = (n_read_in > 0) & (n_read_in < lens)
        p_start, lens = p_start[mixed], lens[mixed]
        if len(p_start):
            # clusters the banded kernel cannot express: longer than the
            # 255 saturation bound, or containing IUPAC-degenerate
            # symbols (the stateful leftover waterfall) — routed to the
            # exact host rescue path
            bad_c = lens > 255
            if config.use_ebwt:
                deg_pos = np.flatnonzero(
                    _DEGENERATE_BYTE[np.asarray(ebwt)])
                if len(deg_pos):
                    cidx = np.searchsorted(p_start, deg_pos,
                                           side="right") - 1
                    inside = ((cidx >= 0)
                              & (deg_pos < p_start[cidx] + lens[cidx]))
                    bad_c[np.unique(cidx[inside])] = True
            bad_idx = np.flatnonzero(bad_c)
            if len(bad_idx):
                bad_start = p_start[bad_idx]
                bad_len = lens[bad_idx]
            keep = ~bad_c
            p_start, lens = p_start[keep], lens[keep]
        if len(p_start):
            window = int(lens.max())
            total = int(lens.sum())
            offs = np.concatenate([[0], np.cumsum(lens[:-1])])
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(offs, lens))
            gpos = np.repeat(p_start, lens) + within
            within0 = within == 0

    nc = len(gpos)
    n_pad = max(_BLOCK, -(-nc // _BLOCK) * _BLOCK)
    sym_c = (SYMBOL_RANK_LUT[np.asarray(ebwt[gpos])] if config.use_ebwt
             else np.zeros(nc, np.uint8))
    mbit = np.logical_not(within0).astype(np.uint8) << _M_BIT
    packed = np.pad(sym_c | mbit, (0, n_pad - nc))
    # pad doc with an out-of-range id: never a read, never a genome
    doc = np.pad(np.asarray(da[gpos]).astype(
        np.uint16 if use_u16 else np.int32), (0, n_pad - nc),
        constant_values=num_reads + num_genomes)
    return packed, doc, window, bad_start, bad_len


def banded_codes(packed):
    """The planner's position codes as K3 takes them (numpy or torch):
    only the run-mask bit and the symbol, and every position may emit
    (``lime_tpu``'s ``_score_program`` passes ``emit_ok=None``); genome
    positions never do."""
    return (packed & ((1 << _M_BIT) | 15)) | (1 << PACK_EMIT_BIT)


def _load_index(fasta: str, config: LimeConfig):
    """One collection's ``(lcp, da, ebwt)``, memory-mapped: the planner's
    threads fault pages in as they scan their ranges, and later consumers
    only gather slices (``ebwt`` None without ``use_ebwt``)."""
    return (open_lcp(fasta, mmap=True), open_da(fasta, mmap=True),
            open_ebwt(fasta, mmap=True) if config.use_ebwt else None)


def _collections(collections: Sequence[str], config: LimeConfig,
                 timer: PhaseTimer):
    """Yield ``(fi, (lcp, da, ebwt))`` per collection, memory-mapped, the
    next collection loaded by a one-ahead thread; waits for it count in
    the ``load`` phase."""
    nxt = {}

    def prefetch(fi):
        nxt[fi] = _load_index(collections[fi], config)
        # warm the page cache with sequential reads so the next
        # collection's planner scan does not stall on disk (once per path
        # per process: re-reading a cached file is a wasted memcpy)
        try:
            buf = bytearray(8 << 20)
            exts = [".lcp", ".da"] + ([".ebwt"] if config.use_ebwt else [])
            for ext in exts:
                path = collections[fi] + ext
                if path in _warmed_paths:
                    continue
                _warmed_paths.add(path)
                with open(path, "rb", buffering=0) as fh:
                    while fh.readinto(buf):
                        pass
        except OSError:  # warming is best-effort; load() already mapped
            pass

    th = None
    with timer.phase("load", args=0):
        arrays = _load_index(collections[0], config)
    for fi in range(len(collections)):
        if fi > 0:
            with timer.phase("load", args=fi):
                th.join()
            arrays = nxt.pop(fi)
        if fi + 1 < len(collections):
            th = threading.Thread(target=prefetch, args=(fi + 1,))
            th.start()
        yield fi, arrays
        arrays = None


def _classify_constants(lineage: Lineage, config: LimeConfig,
                        num_genomes: int, g_pad: int, read_len: int,
                        device: torch.device, keep: list):
    """The classify program's per-run inputs on ``device``: (taxids,
    rank matrix, valid genome lanes, error, norm, beta)."""
    tax_h = np.zeros(g_pad, np.int64)
    tax_h[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_h = np.zeros((lineage.taxids.shape[0], g_pad), np.int64)
    rank_h[:, :num_genomes] = lineage.taxids

    def scalar(v):
        return torch.tensor(np.float32(v), device=device)

    return (to_device(tax_h, device, keep), to_device(rank_h, device, keep),
            to_device(np.arange(g_pad) < num_genomes, device, keep),
            scalar(config.error_tolerance),
            scalar(np.uint32(read_len + 1 - config.alpha)),
            scalar(config.beta))


def _plan_pairs(lcp, da, ebwt, num_reads: int, num_genomes: int,
                config: LimeConfig, host_num: int = 0, dp: int = 1,
                rows_local: int = 0, timer: PhaseTimer | None = None):
    """``native.plan_pairs_packed`` with the fused path's routing; a
    ``host_num``/256 share of the clusters comes back in the host-scored
    lists.  ``timer`` gets the planner's own steps and passes."""
    return native.plan_pairs_packed(
        lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE.astype(np.uint8),
        dense_min=_pair_dense_min_for(config), num_refs=num_genomes,
        host_num=host_num, dp=dp, rows_local=rows_local, timer=timer)


class _Run:
    """One run's shape and counters, which its engine's steps share.
    ``engine`` is ``pair``, ``banded``, ``all_host`` or ``blocked``;
    ``scan_threads`` (0: none) is the all-host light scan's team, and
    ``offload`` whether its pair-heavy clusters go to the dense path
    unless ``LIME_DENSE_OFFLOAD`` says; ``keep`` holds the pinned staging
    buffers with their copies' events, ``corr`` the COO corrections
    (file, rows, cols, vals per rescued collection)."""

    def __init__(self, engine: str, host_num: int, num_reads: int,
                 num_genomes: int, config: LimeConfig, device, timer,
                 scan_threads: int = 0, offload: bool = False,
                 dp: int = 1, rows_local: int = 0):
        self.engine, self.host_num = engine, host_num
        self.num_reads, self.num_genomes = num_reads, num_genomes
        self.config, self.device, self.timer = config, device, timer
        self.scan_threads, self.offload = scan_threads, offload
        self.dp, self.rows_local = dp, rows_local
        self.g_pad = _g_pad_for(num_genomes)
        self.wide = bool(config.wide_sim)
        self.f_feat = (4 if config.use_ebwt else 1) * K
        self.keep, self.corr, self.banded_windows = [], [], []
        self.chunk_counts, self.lanes = [0, 0, 0], [0, 0]
        self.dense_chunks = self.chain_bytes = self.host_plane_bytes = 0
        self.status = dense_kernels.new_status(device)  # dense cells, faults
        self.launched = dense_kernels.LAUNCHES["dense"]
        self.scratch = None  # the one-block engine's reused rescue plane
        self.host_planes = {}  # the row-blocked engine's, per collection

    def tally(self, lanes: int) -> None:
        """One dense chunk computed, with ``lanes`` that carry a read."""
        self.lanes[0] += lanes
        self.lanes[1] += B_BLK * PR

    def add_corrections(self, res, fi: int, plane) -> None:
        """Apply :func:`_rescue`'s result for collection ``fi``: a chain
        scatters into the device ``plane``, COO joins ``corr``, a host
        plane joins ``host_planes``."""
        kind, *rest = res
        if kind == "coo":
            if len(rest[0]):
                self.corr.append((fi, *rest))
        elif kind == "plane":
            self.host_planes[fi] = rest[0]
        elif rest[0] is not None:
            coo_scatter_into(plane, rest[0], self.keep, packed24=rest[1])
            self.chain_bytes += _chain_bytes(*rest, self.wide)

    def finish(self, block: int, mem, **extra) -> None:
        """Close the run: its counters, ``LAST_RUN`` (the engine adds its
        own keys as ``extra``), the log line and the timer's report.
        ``dense_cells``, the cells the dense kernel scored (lanes that
        carry a read, in the row block, times their cluster's genomes),
        is read from ``status`` after the run's last synchronisation,
        which raises on a fault the kernel found."""
        t = self.timer
        t.count("dense_cells", dense_kernels.take(self.status))
        t.count("dense_launches",
                dense_kernels.LAUNCHES["dense"] - self.launched)
        t.count("dense_lanes", self.lanes[0])
        t.count("dense_lanes_total", self.lanes[1])
        t.count("cascade_block", cascade_block_for(block, self.g_pad))
        LAST_RUN.clear()
        LAST_RUN.update({
            "engine": self.engine, "planner": _planner(),
            "host_num": self.host_num,
            "chunks_per_bucket": list(self.chunk_counts),
            "banded_windows": self.banded_windows,
            "dense_chunks": self.dense_chunks,
            "chain_bytes": self.chain_bytes,
            "host_plane_bytes": self.host_plane_bytes, **extra,
            "memory": mem, **t.record()})
        logger.info("fused run: %s", {k: v for k, v in LAST_RUN.items()
                                      if k not in ("phases", "parents")})
        t.report()


@dataclass
class _Plan:
    """One collection's routing (:func:`_plan`): ``(starts, lens)`` of
    its genome-dense clusters and of its rescue set, and its pair plan
    ``(arrays, chunks, windows, row_bits)`` or banded stream."""
    dense: tuple
    rescue: tuple
    pair: tuple | None = None
    banded: tuple | None = None


def _plan(run: _Run, fi: int, lcp, da, ebwt) -> _Plan:
    """The plan step: collection ``fi``'s ``(lcp, da, ebwt)`` routed by
    the run's planner (``plan``).  With ``run.scan_threads`` every
    cluster scores on the host, so the light cluster scan suffices, and
    its read counts pick the pair-heavy clusters that go to the dense
    path (:func:`_dense_offload`).  The banded engine takes
    :func:`plan_banded`; the others the packed pair planner."""
    R, G, config = run.num_reads, run.num_genomes, run.config
    with run.timer.phase("plan", args=fi):
        if run.scan_threads:
            starts, lens, nrr = native.plan_clusters(
                lcp, da, R, config.alpha, threads=run.scan_threads,
                return_nr=True)
        elif run.engine == "banded":
            (packed, doc, nc, window, bad_s, bad_l, den_s,
             den_l) = plan_banded(lcp, da, ebwt, R, G, config)
            plan = _Plan((den_s, den_l), (bad_s, bad_l),
                         banded=(packed, doc, window) if nc else None)
            run.banded_windows.append(window if nc else 0)
        else:
            (arrays, chunks, windows, row_bits, den_s, den_l, bad_s,
             bad_l) = _plan_pairs(lcp, da, ebwt, R, G, config,
                                  run.host_num, run.dp, run.rows_local,
                                  run.timer)
            plan = _Plan((den_s, den_l), (bad_s, bad_l),
                         pair=(arrays, chunks, windows, row_bits))
    if not run.scan_threads:
        for c in plan.pair[1] if plan.pair else ():
            run.chunk_counts[c[0]] += 1
        return plan
    env = os.environ.get("LIME_DENSE_OFFLOAD")
    big = (_dense_offload(starts, lens, nrr)
           if env == "1" or (env != "0" and run.offload)
           else np.zeros(len(starts), bool))
    return _Plan((starts[big], lens[big]), (starts[~big], lens[~big]))


def _pack_dense(run: _Run, fi: int, plan: _Plan, da, ebwt):
    """The dense packing step: ``plan``'s genome-dense clusters packed
    into host chunks (``pack_chunks``, timed as ``dense``), the clusters
    the packer cannot express folded into ``plan.rescue``.  Returns the
    chunks and each one's read lanes that carry a read (``rid`` entries
    other than the ``num_reads`` drop row)."""
    starts, lens = plan.dense
    if not len(starts):
        return [], []
    with run.timer.phase("dense", args=fi):
        chunks, left_s, left_l = pack_chunks(
            starts, lens, da, ebwt, run.num_reads, run.num_genomes,
            run.g_pad, timer=run.timer)
    if len(left_s):
        plan.rescue = tuple(np.concatenate(p)
                            for p in zip(plan.rescue, (left_s, left_l)))
    return chunks, [int(np.count_nonzero(c[3] != run.num_reads))
                    for c in chunks]


def _rescue(run: _Run, fi: int, plan: _Plan, da, ebwt, pooled=None):
    """Exact host scores of ``plan``'s rescue set (``host_score``), by
    every rule the fused engines have:

    - the job shop's workers score into ``pooled``, a plane of its pool,
      on one thread, compacted to a delta-COO chain that hands the plane
      back zeroed (as COO in a run of at most 2^25 read-genome cells);
    - the row-blocked engine keeps, under a host share, one host plane
      per collection for its blocks to slice; else it takes sparse COO,
      refused past ``_COO_POSITION_CAP << 6`` positions (its stream-only
      mode promises no (R, G) host matrix);
    - the one-block engine takes sparse COO where
      :func:`host._coo_rescue_for` says (as ``host._rescue`` does), else
      a scratch plane that later collections reuse, shipped as a chain.

    Returns ``("coo", rows, cols, vals)``, :func:`plane_corrections`'
    result or ``("plane", plane)``."""
    starts, lens = plan.rescue
    R, G, wide = run.num_reads, run.num_genomes, run.wide
    blocked = run.engine == "blocked"
    total = int(np.asarray(lens, np.int64).sum())
    if blocked and not run.host_num and \
            total > (host._COO_POSITION_CAP << 6):
        raise ValueError(
            f"{total} positions route to the exact host scorer "
            "(IUPAC-degenerate or >255-row clusters) — beyond "
            "the row-blocked mode's sparse-correction budget. "
            "Classify this input with the staged host pipeline.")
    with run.timer.phase("host_score", args=fi):
        if pooled is None and (not run.host_num if blocked
                               else host._coo_rescue_for(total, R, G)):
            return ("coo", *_rescue_sparse(starts, lens, da, ebwt, R, G,
                                           run.config))
        if pooled is not None:
            plane = pooled
        elif blocked or run.scratch is None:
            plane = np.zeros((R, G), np.uint32 if wide else np.uint8)
            run.host_plane_bytes += plane.nbytes
            if not blocked:
                run.scratch = plane
        else:
            plane = run.scratch
            plane.fill(0)
        threads = 0 if pooled is None else 1
        native.score_clusters_native(
            np.asarray(starts, np.int64), np.asarray(lens, np.int64),
            np.asarray(da), None if ebwt is None else np.asarray(ebwt),
            R, G, SYMBOL_RANK_LUT, _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
            wide=wide, threads=threads, out=plane)
        if blocked:
            return "plane", plane
        res = plane_corrections(plane, G, wide, threads=threads,
                                zero_after=pooled is not None)
    if pooled is not None and R * G <= (1 << 25) and res[1] is not None:
        base0, drow, col, val = res[1]
        rows = base0 + np.cumsum(drow.astype(np.int64))
        res = ("coo", rows.astype(np.int32), col.astype(np.int32),
               val.astype(np.int32))
    return res


def _dispatch_dense(run: _Run, plane: torch.Tensor, chunks, lanes) -> None:
    """Upload :func:`_pack_dense`'s ``chunks`` and add each one's scores
    into the device ``plane``."""
    for c, n in zip(chunks, lanes):
        run.tally(n)
        _dense_chunk(plane, *(to_device(a, plane.device, run.keep)
                              for a in c),
                     B_BLK, C_BLK, PR, run.f_feat, run.g_pad, run.status)
    run.dense_chunks += len(chunks)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fused(collections: Sequence[str], num_reads: int, num_genomes: int,
              lineage: Lineage, read_len: int, config: LimeConfig,
              device, timer: PhaseTimer | None = None) -> ClassifyResult:
    """Classify every read of 2 or 4 collection indexes on ``device``.

    ``timer`` (a caller's, whose phases then share ``LAST_RUN``) times
    the run's phases; without one the run makes its own.  Set
    ``LIME_PROFILE_DIR`` to capture a ``torch.profiler`` trace of the
    whole run, the row-blocked and host-share branches included, into
    that directory (``utils.timing.profile_run``; the counterpart of
    ``lime_tpu``'s ``jax.profiler.trace``): host activity with a
    ``lime.<phase>`` range per phase, and on a card its kernels and
    copies.  Shapes and stacks are not recorded;
    ``LAST_RUN["trace_export_s"]`` is the time the trace took to write.
    """
    with profile_run(device) as trace:
        result = _run_fused_inner(collections, num_reads, num_genomes,
                                  lineage, read_len, config, device, timer)
    LAST_RUN.update(trace)
    return result


def _run_fused_inner(collections: Sequence[str], num_reads: int,
                     num_genomes: int, lineage: Lineage, read_len: int,
                     config: LimeConfig, device,
                     timer: PhaseTimer | None = None) -> ClassifyResult:
    if timer is None:
        timer = PhaseTimer("torch_fused_pipeline")
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("fused pipeline takes 2 or 4 collections")
    device = resolve_device(device)

    r_pad = _r_pad_for(num_reads)
    g_pad = _g_pad_for(num_genomes)
    block = _classify_block_for(num_reads)
    wide = bool(config.wide_sim)
    pair = (config.pair_stream is not False and native.available()
            and num_reads <= (1 << 28) and num_genomes <= (1 << 16))
    stack_bytes = F * r_pad * g_pad * (4 if wide else 1)
    free = _device_memory(device)
    if pair:
        budget = _budget(free, "LIME_HBM_BUDGET")
        if budget is not None and stack_bytes > budget:
            return _run_fused_blocked(
                collections, num_reads, num_genomes, lineage, read_len,
                config, device, timer,
                _budget(free, "LIME_HBM_BUDGET", 2),
                _budget(free, "LIME_STREAM_BUDGET", 2))
    elif free is not None and stack_bytes > free:
        raise MemoryError(
            f"the banded engine's score planes need {stack_bytes} bytes, "
            f"over the {free} bytes {device} has free beyond the "
            f"{MEMORY_HEADROOM}-byte headroom; the banded engine has no "
            "row-blocked mode (that mode scores pair streams, which need "
            "the native library: with it, leave pair_stream unset)")
    # the host share exists only on the pair path, as in lime_tpu
    host_num = _host_split_for(config) if pair else 0
    all_host = host_num == 256 and not wide
    # the job shop's light scan, on one thread; small runs (at most 2^25
    # cells) offload only when LIME_DENSE_OFFLOAD=1 (lime_tpu asks a
    # fresh link probe, which any link of 5 MB/s or more passes)
    run = _Run("all_host" if all_host else "pair" if pair else "banded",
               host_num, num_reads, num_genomes, config, device, timer,
               scan_threads=1 if all_host else 0,
               offload=num_reads * num_genomes > (1 << 25))

    with timer.phase("score"):
        buf, planes = alloc_planes(F, r_pad, g_pad,
                                   torch.int32 if wide else torch.int8,
                                   device)
        consts = _classify_constants(lineage, config, num_genomes, g_pad,
                                     read_len, device, run.keep)
        if all_host:
            _job_shop(collections, planes, run)
            indexes = ()
        else:
            indexes = _collections(collections, config, timer)
        for fi, (lcp, da, ebwt) in indexes:
            plan = _plan(run, fi, lcp, da, ebwt)
            if plan.pair and plan.pair[1]:
                with timer.phase("dispatch", args=fi):
                    pair_score_packed_into(planes[fi], *plan.pair,
                                           num_reads, run.keep)
            elif plan.banded:
                packed, doc, window = plan.banded
                with timer.phase("dispatch", args=fi):
                    banded_sim_into(
                        planes[fi],
                        banded_codes(to_device(packed, device, run.keep)),
                        to_device(_doc_i32(doc), device, run.keep), window,
                        num_reads)
                packed = doc = plan.banded = None
            d_chunks, lanes = _pack_dense(run, fi, plan, da, ebwt)
            if d_chunks:
                with timer.phase("dispatch", args=fi):
                    _dispatch_dense(run, planes[fi], d_chunks, lanes)
            if len(plan.rescue[0]):
                res = _rescue(run, fi, plan, da, ebwt)
                with timer.phase("dispatch", args=fi):
                    run.add_corrections(res, fi, planes[fi])
            lcp = da = ebwt = plan = None
            _release_done(run.keep)

    # every launch above is asynchronous: the device work they queued
    # completes here (otherwise the wait lands in the classify phase)
    with timer.phase("score_sync"):
        _sync(device)
        run.keep.clear()
    with timer.phase("classify"):
        cfile, crows, ccols, cvals = _corrections(run.corr, wide)
        with timer.phase("classify_run"):
            packed = _classify_program_planes(
                buf, F, r_pad, g_pad,
                *(to_device(a, device, run.keep)
                  for a in (crows, ccols, cvals, cfile)),
                *consts, config.tax_rank, config.assign_higher, not wide,
                block)
            _sync(device)
        with timer.phase("classify_fetch"):
            t_h, x_h, s_h = _unpack_triplet(packed.cpu().numpy())
        run.keep.clear()
    mem = device_memory_stats(device)
    del buf, planes, packed
    run.finish(block, mem)
    return ClassifyResult(t_h[:num_reads], x_h[:num_reads], s_h[:num_reads])


def _job_shop(collections: Sequence[str], planes: torch.Tensor,
              run: _Run) -> None:
    """The all-host split in one block: ``lime_tpu``'s job shop.  Two
    host workers each load, plan, pack and rescue one collection at a
    time, into a pooled host plane; this thread uploads and launches each
    finished collection's dense chunks and chain into ``planes`` (the
    pinned buffers in ``run.keep`` and the stream are not shared)."""
    pool: queue.Queue = queue.Queue()  # zeroed host planes
    R, G = run.num_reads, run.num_genomes

    def host_job(fi):
        with run.timer.phase("load", args=fi):
            lcp, da, ebwt = _load_index(collections[fi], run.config)
        plan = _plan(run, fi, lcp, da, ebwt)
        d_chunks, lanes = _pack_dense(run, fi, plan, da, ebwt)
        try:
            plane = pool.get_nowait()
        except queue.Empty:
            plane = np.zeros((R, G), np.uint8)
        res = _rescue(run, fi, plan, da, ebwt, pooled=plane)
        pool.put(plane)
        return d_chunks, lanes, res

    with ThreadPoolExecutor(max_workers=2) as workers:
        jobs = {workers.submit(carry_phases(host_job), fi): fi
                for fi in range(len(collections))}
        for job in as_completed(jobs):
            fi = jobs[job]
            d_chunks, lanes, res = job.result()
            with run.timer.phase("dispatch", args=fi):
                _dispatch_dense(run, planes[fi], d_chunks, lanes)
                run.add_corrections(res, fi, planes[fi])
            _release_done(run.keep)
    run.host_plane_bytes = pool.qsize() * R * G


def _corrections(corr, wide: bool, base: int = 0,
                 rows_in_block: int | None = None):
    """The COO corrections ``corr`` (file, rows, cols, vals per rescued
    collection) as the classify program's ``(cfile, crows, ccols, cvals)``
    numpy arrays; with ``rows_in_block``, only the rows in ``[base, base
    + rows_in_block)``, relative to ``base``.  Values enter pre-wrapped:
    int8 adds wrap mod 256."""
    empty = np.empty(0, np.int32)
    parts = [(empty, empty, empty, empty)]
    for fi, rows, cols, vals in corr:
        if rows_in_block is not None:
            sel = (rows >= base) & (rows < base + rows_in_block)
            rows, cols, vals = rows[sel] - base, cols[sel], vals[sel]
        parts.append((np.full(len(rows), fi, np.int32),
                      rows.astype(np.int32), cols, vals))
    cfile, crows, ccols, cvals = (np.concatenate(p) for p in zip(*parts))
    return cfile, crows, ccols, cvals.astype(np.int32 if wide else np.int8)


def stream_estimate(collections: Sequence[str], num_reads: int) -> int:
    """``lime_tpu``'s estimate of the packed pair streams' device bytes
    for ``collections``, which sizes owner passes: from the ``.lcp``
    sizes, about 0.6 surviving rows per position, W/8 B of row id and
    0.925 B of bits and genome column per row, times 1.4 for the rows the
    owner split re-emits.  Knowingly high (about twice the smoke's
    resident streams), it is kept so that one ``LIME_STREAM_BUDGET``
    gives the same passes in both packages, and because one pass too
    many is cheaper than running out of device memory mid-run."""
    w = native.row_bits_for(num_reads)
    est = int(sum(os.path.getsize(c + ".lcp") // 4 * 0.6 * (w / 8 + 0.925)
                  for c in collections))
    return int(est * 1.4)


def block_rows(stack_budget: int, dense_bytes: int, row_bytes: int,
               block: int) -> int:
    """Reads per row block: ``lime_tpu``'s ``B``, which leaves half of
    ``stack_budget`` as slack, a multiple of the cascade ``block``; the
    resident dense chunks come out of that slack, so a stack and dense
    chunks over the budget shrink ``B`` (never below one ``block``)."""
    rows = min(stack_budget // (2 * row_bytes),
               (stack_budget - dense_bytes) // row_bytes)
    return max(block, rows // block * block)


def _owner_subset(pk_arrays, chunks, owner: int, row_bits: int):
    """One owner's chunks of a planner plan: its slices of the three
    buffers (row ids, bits, genome columns), concatenated, and the chunk
    metadata remapped onto them."""
    parts, meta2, at2 = ([], [], []), [], [0, 0, 0]
    for b, own, n_rows, wo, bo, go, gc in chunks:
        if own != owner:
            continue
        meta2.append((b, own, n_rows, *at2, gc))
        for k, (at, n) in enumerate(((wo, n_rows // 8 * (row_bits // 4)),
                                     (bo, n_rows // 8 * 5), (go, gc))):
            parts[k].append(pk_arrays[k][at:at + n])
            at2[k] += n
    return tuple(np.concatenate(p) if p else np.empty(0, dt) for p, dt in
                 zip(parts, (np.uint32, np.uint8, np.uint16))), meta2


def _run_fused_blocked(collections, num_reads: int, num_genomes: int,
                       lineage: Lineage, read_len: int, config: LimeConfig,
                       device: torch.device, timer: PhaseTimer,
                       stack_budget: int,
                       stream_budget: int | None) -> ClassifyResult:
    """Row-blocked fused pipeline for stacks beyond the device budget
    (``lime_tpu``'s ``_run_fused_blocked``).

    The packed pair streams and dense chunks upload once (or, in owner
    passes, the streams once per pass) and stay on the device; the
    ``(F, B, g_pad)`` stack is bounded by ``stack_budget`` and each row
    block replays every collection's pair chunks, dense chunks and host
    plane rows, adds its COO corrections, runs the cascade and fetches
    one ``(3, B)`` triplet.  A host share keeps its host planes only
    while all ``F`` fit ``LIME_HOST_MATRIX_CAP`` (32 GiB by default);
    past it the run is stream-only.  An all-host run plans with the light
    scan on two threads and offloads its pair-heavy clusters unless
    ``LIME_DENSE_OFFLOAD=0`` or ``wide_sim`` (``lime_tpu`` asks a link
    probe, which any link of 5 MB/s or more passes)."""
    F = len(collections)
    g_pad = _g_pad_for(num_genomes)
    wide = bool(config.wide_sim)
    block = _classify_block_for(num_reads)
    row_bytes = F * g_pad * (4 if wide else 1)
    est = stream_estimate(collections, num_reads)
    n_pass = 1 if stream_budget is None else \
        max(1, -(-est // max(stream_budget, 1)))
    rows_local = pair_rows_local(num_reads, n_pass) if n_pass > 1 \
        else num_reads + 1

    host_num = _host_split_for(config)
    cap = int(os.environ.get("LIME_HOST_MATRIX_CAP", 32 << 30))
    if F * num_reads * num_genomes * (4 if wide else 1) > cap:
        host_num = 0
    run = _Run("blocked", host_num, num_reads, num_genomes, config, device,
               timer, scan_threads=2 if host_num == 256 else 0,
               offload=not wide, dp=n_pass,
               rows_local=rows_local if n_pass > 1 else 0)
    keep = run.keep
    plans = []  # per collection: (buffers, chunks, windows, row_bits)
    # per collection: (device chunk, its read lanes, its sorted read rows)
    dense_dev = []
    dense_bytes = 0

    for fi, (lcp, da, ebwt) in _collections(collections, config, timer):
        plan = _plan(run, fi, lcp, da, ebwt)
        arrays, chunks, windows, row_bits = plan.pair or (None, [], 0, 0)
        if not chunks:
            arrays = None
        elif n_pass == 1:
            with timer.phase("dispatch", args=fi):
                arrays = pair_upload(arrays, chunks, device, keep)
        # else a host-resident plan; owner subsets upload per pass
        plans.append((arrays, chunks, windows, row_bits))
        d_chunks, lanes = _pack_dense(run, fi, plan, da, ebwt)
        dense_bytes += sum(a.nbytes for c in d_chunks for a in c)
        run.dense_chunks += len(d_chunks)
        dense_dev.append([])
        if d_chunks:
            with timer.phase("dispatch", args=fi):
                dense_dev[fi] = [(tuple(to_device(a, device, keep)
                                        for a in c), n, np.unique(c[3]))
                                 for c, n in zip(d_chunks, lanes)]
        if len(plan.rescue[0]):
            run.add_corrections(_rescue(run, fi, plan, da, ebwt), fi, None)
        lcp = da = ebwt = plan = None
        _release_done(keep)

    B = block_rows(stack_budget, dense_bytes, row_bytes, block)
    consts = _classify_constants(lineage, config, num_genomes, g_pad,
                                 read_len, device, keep)
    buf, stack = alloc_planes(F, B, g_pad,
                              torch.int32 if wide else torch.int8, device)
    outs = []  # per block: its (types, taxid, sim) rows

    # block_score's sub-phases end on a device sync, so block_pair,
    # block_dense and block_host are device time plus the host's work
    def do_block(base, plans_pass, hi_rows):
        with timer.phase("block_score"):
            stack.zero_()
            for fi in range(F):
                uploaded, chunks, windows, row_bits = plans_pass[fi]
                with timer.phase("block_pair"):
                    if chunks:
                        pair_score_packed_offset(stack, fi, uploaded,
                                                 chunks, windows, row_bits,
                                                 base)
                    _sync(device)
                with timer.phase("block_dense"):
                    for chunk, lanes, rows in dense_dev[fi]:
                        if _dense_chunk_offset(stack, fi, *chunk, base,
                                               B_BLK, C_BLK, PR, run.f_feat,
                                               g_pad, rows, run.status):
                            run.tally(lanes)
                    _sync(device)
                hi_r = min(base + B, num_reads)
                if fi in run.host_planes and hi_r > base:
                    with timer.phase("block_host"):
                        # pair streams bound the width at 65,536 genomes:
                        # the slice always compacts to a chain
                        _, chain, p24 = plane_corrections(
                            run.host_planes[fi][base:hi_r], num_genomes,
                            wide)
                        if chain is not None:
                            run.chain_bytes += _chain_bytes(chain, p24,
                                                            wide)
                            coo_scatter_into_stack(stack, chain, fi, keep,
                                                   packed24=p24)
                        _sync(device)
        with timer.phase("block_classify"):
            cfile, crows, ccols, cvals = _corrections(run.corr, wide, base,
                                                      B)
            packed = _classify_program_planes(
                buf, F, B, g_pad, *(to_device(a, device, keep)
                                    for a in (crows, ccols, cvals, cfile)),
                *consts, config.tax_rank, config.assign_higher, not wide,
                block)
            _sync(device)
        with timer.phase("block_fetch"):
            # clamp to the owner pass's row range: a block may overrun
            # it (B need not divide rows_local) and the overrun rows are
            # re-scored completely in the next pass
            hi = min(B, num_reads - base, hi_rows - base)
            if hi > 0:
                outs.append([a[:hi] for a in
                             _unpack_triplet(packed.cpu().numpy())])
        _release_done(keep)

    launches = [0, 0, 0]  # pair-kernel launches the plan implies
    blocks = 0
    stream_bytes = 0  # largest pass's resident pair streams
    for owner in range(n_pass):
        lo = owner * rows_local
        hi_rows = min((owner + 1) * rows_local, num_reads + 1)
        if lo >= hi_rows:
            continue
        if n_pass == 1:
            plans_pass = plans
        else:
            # upload only this owner's chunks; the previous pass's
            # buffers were released below, once its last block's cascade
            # had synchronised the device
            plans_pass = []
            for pk_arrays, chunks, windows, row_bits in plans:
                if not chunks:
                    plans_pass.append((None, [], windows, row_bits))
                    continue
                arrays2, meta2 = _owner_subset(pk_arrays, chunks, owner,
                                               row_bits)
                with timer.phase("dispatch"):
                    plans_pass.append((
                        pair_upload(arrays2, meta2, device, keep) if meta2
                        else None, meta2, windows, row_bits))
            logger.info("blocked sweep: owner pass %d/%d rows [%d, %d)",
                        owner + 1, n_pass, lo, hi_rows)
        stream_bytes = max(stream_bytes, sum(
            sum(t.numel() * t.element_size() for t in up)
            for up, chunks, _, _ in plans_pass if chunks))
        n_blocks = len(range(lo, hi_rows, B))
        blocks += n_blocks
        for _, chunks, _, _ in plans_pass:
            for c in chunks:
                launches[c[0]] += n_blocks
        for base in range(lo, hi_rows, B):
            do_block(base, plans_pass, hi_rows)
        plans_pass = None
    keep.clear()
    mem = device_memory_stats(device)
    del buf, stack
    run.finish(block, mem, B=B, blocks=blocks, n_pass=n_pass,
               launches_per_bucket=launches,
               resident_bytes={"pair_streams": stream_bytes,
                               "dense_chunks": dense_bytes})
    return ClassifyResult(*(np.concatenate(p) for p in zip(*outs)))
