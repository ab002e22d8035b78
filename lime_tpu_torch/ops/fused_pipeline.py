"""Fused serving pipeline on one device: collections -> per-read assignments.

Torch port of the device branches of
``lime_tpu/ops/fused_pipeline._run_fused_inner`` and
``_run_fused_blocked``: every cluster scored on the device (no host
split).  Per collection the native planner (C++, GIL released) scans the
index once and routes every alpha-cluster:

- sparse clusters -> packed pair streams (ops/pair_score.py), scored by
  the hand-written pair-hit kernels; or, with ``pair_stream=False`` or a
  run too wide for pair streams (over 2^28 reads or 65536 genomes), the
  banded engine: ``native.plan_native``'s compacted position stream
  scored by K3 (ops/banded_kernels.py), with density routing
  (``dense_threshold``) sending genome-sparse clusters to the host;
- genome-dense clusters -> the batched histogram matmul
  (ops/dense_score.py);
- IUPAC-degenerate, over-long and matmul-inexpressible clusters -> the
  exact host scorer, as COO corrections that ride the classify program
  (or, past a size cap, a delta-COO chain scattered into the plane).

Every launch is asynchronous on the current stream, so the planning of
collection i+1 overlaps the device's work on collection i, and a one-ahead
thread prefetches the next collection's index from disk.  A final classify
program fuses the counter wrap, normalisation, beta gate and the 4-stage
cascade; one packed (3, R_pad) triplet comes back.

Device memory.  A run's budget is the card's free memory less
``MEMORY_HEADROOM`` (none on the CPU), capped by ``LIME_HBM_BUDGET``.  A
pair-stream run whose ``(F, R_pad, G_pad)`` stack exceeds it runs in the
row-blocked mode (:func:`_run_fused_blocked`): the pair streams and dense
chunks upload once and stay on the card, and every row block of ``B``
reads re-scores them into an ``(F, B, G_pad)`` stack, runs the cascade
and fetches its triplet.  That mode splits the budget in two equal
halves: one for the stack (``B`` leaves half of its half as slack, as
``lime_tpu``'s formula does, and the resident dense chunks come out of
that slack), one for the resident pair streams; ``LIME_HBM_BUDGET`` and
``LIME_STREAM_BUDGET`` cap each half.  The cascade's and the chunks'
temporaries, which do not grow with ``B``, live in ``MEMORY_HEADROOM``.
Streams estimated over their half are planned per read-row owner and
swept in owner passes, each pass uploading only its owner's chunks.
The banded engine has no blocked
mode (nor has ``lime_tpu``'s): a stack over the card's budget raises
``MemoryError``, and ``LIME_HBM_BUDGET`` does not apply to it.

Modes of the JAX engine that are not ported yet (the host share of
hybrid, all-host and blocked runs) raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..config import LimeConfig
from ..constants import SYMBOL_RANK_LUT
from ..formats.arrays import open_da, open_ebwt, open_lcp
from ..formats.lineage import Lineage
from ..host import (_BLOCK, _COO_POSITION_CAP, _M_BIT, B_BLK, C_BLK, K,
                    PACK_EMIT_BIT, PR, _DEGENERATE_BYTE,
                    _classify_block_for, _dense_min_for,
                    _dense_threshold_for, _g_pad_for, _r_pad_for, _rescue,
                    _rescue_sparse, merge_coo_segments, pack_chunks,
                    pair_rows_local)
from ..utils.timing import PhaseTimer, device_memory_stats
from .banded_kernels import banded_sim_into
from .classify_ops import ClassifyResult
from .classify_torch import (_classify_program_planes, _unpack_triplet,
                             alloc_planes)
from .dense_score import _dense_chunk, _dense_chunk_offset
from .pair_score import (coo_scatter_into, pair_score_packed_into,
                         pair_score_packed_offset, pair_upload, to_device)

logger = logging.getLogger("lime_tpu_torch")

#: Device memory kept free beside the score planes: one collection's
#: packed streams and their unpacked int64 temporaries, the dense chunks'
#: feature tensors, and the cascade's per-block float32 tiles.
MEMORY_HEADROOM = 8 << 30

#: Statistics of the most recent run: per-bucket pair-chunk counts,
#: device memory and phase times (and, for a row-blocked run, its block
#: size, blocks, owner passes, resident bytes and the pair-kernel
#: launches its plan implies).  Read by chip_smoke.py and tests.
LAST_RUN: dict = {}

_warmed_paths: set = set()


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _refuse_unported(config: LimeConfig) -> None:
    env = os.environ.get("LIME_HOST_FRAC")
    if (config.host_frac not in (None, 0.0)
            or (env is not None and float(env) != 0.0)):
        raise NotImplementedError(
            "hybrid and all-host splits (host_frac / LIME_HOST_FRAC), in "
            "one block or row-blocked, are not ported yet: ROADMAP queue "
            "1, item 8")


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


def _doc_i32(doc: np.ndarray) -> np.ndarray:
    """The planner's u16 or u32 document ids as int32 (u32 by its bits;
    ids stay below 2^31)."""
    return doc.view(np.int32) if doc.dtype == np.uint32 else \
        doc.astype(np.int32)


def plan_banded(lcp, da, ebwt, num_reads: int, num_genomes: int,
                config: LimeConfig):
    """The banded engine's plan of one collection: ``native.plan_native``
    with the routing thresholds ``config`` sets, its stream padded to
    ``_BLOCK`` with pad document ``num_reads + num_genomes``."""
    return native.plan_native(
        lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE, (num_reads + num_genomes) < 0xFFFF,
        pad_block=_BLOCK, pad_doc=num_reads + num_genomes,
        g_dense=_dense_threshold_for(num_genomes, config),
        dense_min=_dense_min_for(num_genomes, config))


def banded_codes(packed):
    """The planner's position codes as K3 takes them (numpy or torch):
    only the run-mask bit and the symbol, and every position may emit
    (``lime_tpu``'s ``_score_program`` passes ``emit_ok=None``); genome
    positions never do."""
    return (packed & ((1 << _M_BIT) | 15)) | (1 << PACK_EMIT_BIT)


def _score_program(sim: torch.Tensor, packed: torch.Tensor,
                   doc: torch.Tensor, window: int,
                   num_reads: int) -> None:
    """Banded scores of one compacted planner stream into ``sim`` (the
    counterpart of ``lime_tpu``'s ``_score_program``)."""
    banded_sim_into(sim, banded_codes(packed), doc, window, num_reads)


def _collections(collections: Sequence[str], config: LimeConfig,
                 timer: PhaseTimer):
    """Yield ``(fi, (lcp, da, ebwt))`` per collection, memory-mapped, the
    next collection loaded by a one-ahead thread; waits for it count in
    the ``load`` phase."""

    def load(fasta):
        # memmaps: the planner's sequential scan faults pages in as it
        # goes; later consumers only gather slices
        lcp = open_lcp(fasta, mmap=True)
        da = open_da(fasta, mmap=True)
        ebwt = open_ebwt(fasta, mmap=True) if config.use_ebwt else None
        return lcp, da, ebwt

    nxt = {}

    def prefetch(fi):
        nxt[fi] = load(collections[fi])
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
    with timer.phase("load"):
        arrays = load(collections[0])
    for fi in range(len(collections)):
        if fi > 0:
            with timer.phase("load"):
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
                config: LimeConfig, dp: int = 1, rows_local: int = 0):
    """``native.plan_pairs_packed`` with the fused path's routing: every
    cluster on the device (``host_num=0``)."""
    dense_min = 16 if config.mxu_dense_min is None else config.mxu_dense_min
    return native.plan_pairs_packed(
        lcp, da, ebwt, num_reads, config.alpha, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE.astype(np.uint8), dense_min=dense_min,
        num_refs=num_genomes, host_num=0, dp=dp, rows_local=rows_local)


def run_fused(collections: Sequence[str], num_reads: int, num_genomes: int,
              lineage: Lineage, read_len: int, config: LimeConfig,
              device) -> ClassifyResult:
    """Classify every read of 2 or 4 collection indexes on ``device``."""
    timer = PhaseTimer("torch_fused_pipeline")
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("fused pipeline takes 2 or 4 collections")
    device = resolve_device(device)
    _refuse_unported(config)

    r_pad = _r_pad_for(num_reads)
    g_pad = _g_pad_for(num_genomes)
    block = _classify_block_for(num_reads)
    wide = bool(config.wide_sim)
    pair = (config.pair_stream is not False and num_reads <= (1 << 28)
            and num_genomes <= (1 << 16))
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
            "row-blocked mode (that mode scores pair streams: leave "
            "pair_stream unset)")
    f_feat = (4 if config.use_ebwt else 1) * K
    keep = []  # pinned staging buffers + their copies' events
    corr = []  # (file, rows, cols, vals) per rescued collection
    chunk_counts = [0, 0, 0]
    banded_windows = []  # per collection, 0 = nothing banded

    def release_done():
        keep[:] = [(p, ev) for p, ev in keep if not ev.query()]

    with timer.phase("score"):
        buf, planes = alloc_planes(F, r_pad, g_pad,
                                   torch.int32 if wide else torch.int8,
                                   device)
        taxd, rankd, validd, errord, normd, betad = _classify_constants(
            lineage, config, num_genomes, g_pad, read_len, device, keep)

        for fi, (lcp, da, ebwt) in _collections(collections, config, timer):
            timer.add_bytes("score",
                            len(lcp) * (9 if config.use_ebwt else 8))
            if pair:
                with timer.phase("plan"):
                    (pk_arrays, chunks, windows, row_bits, dense_start,
                     dense_len, bad_start, bad_len) = _plan_pairs(
                        lcp, da, ebwt, num_reads, num_genomes, config)
                for c in chunks:
                    chunk_counts[c[0]] += 1
                if chunks:
                    with timer.phase("dispatch", nbytes=sum(
                            a.nbytes for a in pk_arrays)):
                        pair_score_packed_into(planes[fi], pk_arrays,
                                               chunks, windows, row_bits,
                                               num_reads, keep)
            else:
                with timer.phase("plan"):
                    (packed, doc, nc, window, bad_start, bad_len,
                     dense_start, dense_len) = plan_banded(
                        lcp, da, ebwt, num_reads, num_genomes, config)
                banded_windows.append(window if nc else 0)
                if nc:
                    with timer.phase("dispatch",
                                     nbytes=packed.nbytes + doc.nbytes):
                        _score_program(planes[fi],
                                       to_device(packed, device, keep),
                                       to_device(_doc_i32(doc), device,
                                                 keep),
                                       window, num_reads)
                packed = doc = None
            if len(dense_start):
                with timer.phase("dense", nbytes=int(dense_len.sum()) * 5):
                    d_chunks, left_s, left_l = pack_chunks(
                        dense_start, dense_len, da, ebwt, num_reads,
                        num_genomes, g_pad)
                with timer.phase("dispatch"):
                    for ridx, gidx, cmap_c, rid_c in d_chunks:
                        _dense_chunk(planes[fi],
                                     to_device(ridx, device, keep),
                                     to_device(gidx, device, keep),
                                     to_device(cmap_c, device, keep),
                                     to_device(rid_c, device, keep),
                                     B_BLK, C_BLK, PR, f_feat, g_pad)
                if len(left_s):
                    bad_start = np.concatenate([bad_start, left_s])
                    bad_len = np.concatenate([bad_len, left_l])
            if len(bad_start):
                total = int(np.asarray(bad_len, np.int64).sum())
                with timer.phase("host_score", nbytes=total * 5):
                    kind, *res = _rescue(bad_start, bad_len, da, ebwt,
                                         num_reads, num_genomes, config)
                    if kind == "coo":
                        if len(res[0]):
                            corr.append((fi, *res))
                    else:
                        # the rescue set covers many positions: the host
                        # plane's nonzeros ship as one delta-COO chain
                        # (coo24, 3 B/entry, whenever columns fit 12 bits)
                        p24 = (not wide) and num_genomes < 4096
                        max_drow = 15 if p24 else 255
                        chain = merge_coo_segments(
                            native.coo_compact(res[0], num_reads,
                                               num_genomes, wide=wide,
                                               max_drow=max_drow),
                            max_drow=max_drow)
                        if chain is not None:
                            coo_scatter_into(planes[fi], chain, keep,
                                             packed24=p24)
            lcp = da = ebwt = None
            release_done()

    # every launch above is asynchronous: the device work they queued
    # completes here (otherwise the wait lands in the classify phase)
    with timer.phase("score_sync"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        keep.clear()
    with timer.phase("classify"):
        cfile, crows, ccols, cvals = _corrections(corr, wide)
        with timer.phase("classify_run"):
            packed = _classify_program_planes(
                buf, F, r_pad, g_pad, to_device(crows, device, keep),
                to_device(ccols, device, keep),
                to_device(cvals, device, keep),
                to_device(cfile, device, keep), taxd, rankd, validd,
                errord, normd, betad, config.tax_rank,
                config.assign_higher, not wide, block)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with timer.phase("classify_fetch", nbytes=packed.numel() * 4):
            t_h, x_h, s_h = _unpack_triplet(packed.cpu().numpy())
        keep.clear()
    mem = device_memory_stats(device)
    del buf, planes, packed
    LAST_RUN.clear()
    LAST_RUN.update({"engine": "pair" if pair else "banded",
                     "chunks_per_bucket": list(chunk_counts),
                     "banded_windows": banded_windows,
                     "memory": mem, "phases": dict(timer.phases)})
    logger.info("%s engine; pair chunks per bucket (caps 16/64/255): %s; "
                "banded windows: %s; device memory: %s",
                LAST_RUN["engine"], chunk_counts, banded_windows, mem)
    timer.report()
    return ClassifyResult(t_h[:num_reads], x_h[:num_reads], s_h[:num_reads])


def _corrections(corr, wide: bool, base: int = 0,
                 rows_in_block: int | None = None):
    """The COO corrections ``corr`` (file, rows, cols, vals per rescued
    collection) as the classify program's ``(cfile, crows, ccols, cvals)``
    numpy arrays; with ``rows_in_block``, only the rows in ``[base, base
    + rows_in_block)``, relative to ``base``.  Values enter pre-wrapped:
    int8 adds wrap mod 256."""
    parts = []
    for fi, rows, cols, vals in corr:
        if rows_in_block is not None:
            sel = (rows >= base) & (rows < base + rows_in_block)
            rows, cols, vals = rows[sel] - base, cols[sel], vals[sel]
        parts.append((np.full(len(rows), fi, np.int32),
                      rows.astype(np.int32), cols, vals))
    if not parts:
        empty = np.empty(0, np.int32)
        return (empty, empty, empty,
                np.empty(0, np.int32 if wide else np.int8))
    cfile, crows, ccols, cvals = (np.concatenate(p) for p in zip(*parts))
    return cfile, crows, ccols, cvals.astype(np.int32 if wide else np.int8)


def stream_estimate(collections: Sequence[str], num_reads: int) -> int:
    """``lime_tpu``'s estimate of the packed pair streams' device bytes
    for ``collections`` (from the ``.lcp`` sizes: about 0.6 surviving
    rows per position, W/8 B of row id and 0.925 B of bits and genome
    column per row), times 1.4 for the rows the owner split re-emits;
    owner passes are sized by it.

    The estimate is knowingly high (about twice the resident streams of
    the smoke's paper-shape dataset, PERF.md): it is kept as
    ``lime_tpu`` has it so that the same ``LIME_STREAM_BUDGET`` gives the
    same passes in both packages, and because an estimate under the real
    size would run out of device memory mid-run, where one over it costs
    one more pass."""
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
    buffers, concatenated, and the chunk metadata remapped onto them."""
    rows_all, bits_all, gcol_all = pk_arrays
    wpg = row_bits // 4
    rs, bs, gs_, meta2 = [], [], [], []
    wo2 = bo2 = go2 = 0
    for b, own, n_rows, wo, bo, go, gc in chunks:
        if own != owner:
            continue
        lw, lb = n_rows // 8 * wpg, n_rows // 8 * 5
        rs.append(rows_all[wo:wo + lw])
        bs.append(bits_all[bo:bo + lb])
        gs_.append(gcol_all[go:go + gc])
        meta2.append((b, own, n_rows, wo2, bo2, go2, gc))
        wo2 += lw
        bo2 += lb
        go2 += gc
    arrays2 = (
        np.concatenate(rs) if rs else np.empty(0, np.uint32),
        np.concatenate(bs) if bs else np.empty(0, np.uint8),
        np.concatenate(gs_) if gs_ else np.empty(0, np.uint16))
    return arrays2, meta2


def _run_fused_blocked(collections, num_reads: int, num_genomes: int,
                       lineage: Lineage, read_len: int, config: LimeConfig,
                       device: torch.device, timer: PhaseTimer,
                       stack_budget: int,
                       stream_budget: int | None) -> ClassifyResult:
    """Row-blocked fused pipeline for stacks beyond the device budget
    (the stream-only branch of ``lime_tpu``'s ``_run_fused_blocked``).

    The packed pair streams and dense chunks upload once (or, in owner
    passes, the streams once per pass) and stay on the device; the
    ``(F, B, g_pad)`` stack is bounded by ``stack_budget`` and the chunks
    are replayed per row block: score every collection's pair chunks,
    then its dense chunks, add the block's COO corrections, run the
    cascade and fetch one ``(3, B)`` triplet.  Host memory holds the
    planner buffers and the sparse corrections, never an (R, G) matrix.
    """
    F = len(collections)
    g_pad = _g_pad_for(num_genomes)
    wide = bool(config.wide_sim)
    block = _classify_block_for(num_reads)
    row_bytes = F * g_pad * (4 if wide else 1)
    f_feat = (4 if config.use_ebwt else 1) * K
    est = stream_estimate(collections, num_reads)
    n_pass = 1 if stream_budget is None else \
        max(1, -(-est // max(stream_budget, 1)))
    rows_local = pair_rows_local(num_reads, n_pass) if n_pass > 1 \
        else num_reads + 1

    keep = []  # pinned staging buffers + their copies' events
    plans = []  # per collection: (buffers, chunks, windows, row_bits)
    dense_dev = []  # per collection: its dense chunks on the device
    corr = []
    chunk_counts = [0, 0, 0]
    dense_bytes = 0

    def release_done():
        keep[:] = [(p, ev) for p, ev in keep if not ev.query()]

    for fi, (lcp, da, ebwt) in _collections(collections, config, timer):
        with timer.phase("plan"):
            (pk_arrays, chunks, windows, row_bits, den_s, den_l, bad_s,
             bad_l) = _plan_pairs(
                lcp, da, ebwt, num_reads, num_genomes, config, dp=n_pass,
                rows_local=rows_local if n_pass > 1 else 0)
        for c in chunks:
            chunk_counts[c[0]] += 1
        if n_pass == 1:
            with timer.phase("dispatch",
                             nbytes=sum(a.nbytes for a in pk_arrays)):
                plans.append((pair_upload(pk_arrays, chunks, device, keep),
                              chunks, windows, row_bits))
        else:  # host-resident plan; owner subsets upload per pass
            plans.append((pk_arrays, chunks, windows, row_bits))
        dense_dev.append([])
        if len(den_s):
            with timer.phase("dense", nbytes=int(den_l.sum()) * 5):
                d_chunks, left_s, left_l = pack_chunks(
                    den_s, den_l, da, ebwt, num_reads, num_genomes, g_pad)
            nb = sum(a.nbytes for c in d_chunks for a in c)
            dense_bytes += nb
            with timer.phase("dispatch", nbytes=nb):
                dense_dev[fi] = [tuple(to_device(a, device, keep) for a in c)
                                 for c in d_chunks]
            if len(left_s):
                bad_s = np.concatenate([bad_s, left_s])
                bad_l = np.concatenate([bad_l, left_l])
        if len(bad_s):
            total = int(np.asarray(bad_l, np.int64).sum())
            if total > (_COO_POSITION_CAP << 6):
                # the stream-only mode's memory promise is "no (R, G)
                # host matrix"; a pathologically degenerate index whose
                # rescue COO would approach that is refused with a
                # clear error rather than running out of memory mid-run
                raise ValueError(
                    f"{total} positions route to the exact host scorer "
                    "(IUPAC-degenerate or >255-row clusters) — beyond "
                    "the row-blocked mode's sparse-correction budget. "
                    "Classify this input with the staged host pipeline.")
            with timer.phase("host_score", nbytes=total * 5):
                rows, cols, vals = _rescue_sparse(
                    bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
                if len(rows):
                    corr.append((fi, rows, cols, vals))
        lcp = da = ebwt = None
        release_done()

    B = block_rows(stack_budget, dense_bytes, row_bytes, block)
    consts = _classify_constants(lineage, config, num_genomes, g_pad,
                                 read_len, device, keep)
    buf, stack = alloc_planes(F, B, g_pad,
                              torch.int32 if wide else torch.int8, device)
    out_t, out_x, out_s = [], [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # block_score's sub-phases end on a device sync, so block_pair and
    # block_dense are device time plus the host's launch gaps
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
                    sync()
                with timer.phase("block_dense"):
                    for ridx, gidx, cmap_c, rid_c in dense_dev[fi]:
                        _dense_chunk_offset(stack, fi, ridx, gidx, cmap_c,
                                            rid_c, base, B_BLK, C_BLK, PR,
                                            f_feat, g_pad)
                    sync()
        with timer.phase("block_classify"):
            cfile, crows, ccols, cvals = _corrections(corr, wide, base, B)
            packed = _classify_program_planes(
                buf, F, B, g_pad, to_device(crows, device, keep),
                to_device(ccols, device, keep),
                to_device(cvals, device, keep),
                to_device(cfile, device, keep), *consts, config.tax_rank,
                config.assign_higher, not wide, block)
            sync()
        with timer.phase("block_fetch", nbytes=packed.numel() * 4):
            # clamp to the owner pass's row range: a block may overrun
            # it (B need not divide rows_local) and the overrun rows are
            # re-scored completely in the next pass
            hi = min(B, num_reads - base, hi_rows - base)
            if hi > 0:
                t_h, x_h, s_h = _unpack_triplet(packed.cpu().numpy())
                out_t.append(t_h[:hi])
                out_x.append(x_h[:hi])
                out_s.append(s_h[:hi])
        release_done()

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
                arrays2, meta2 = _owner_subset(pk_arrays, chunks, owner,
                                               row_bits)
                with timer.phase("dispatch",
                                 nbytes=sum(a.nbytes for a in arrays2)):
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
    LAST_RUN.clear()
    LAST_RUN.update({"engine": "blocked", "B": B, "blocks": blocks,
                     "n_pass": n_pass,
                     "chunks_per_bucket": list(chunk_counts),
                     "launches_per_bucket": launches,
                     "banded_windows": [],
                     "resident_bytes": {"pair_streams": stream_bytes,
                                        "dense_chunks": dense_bytes},
                     "memory": mem, "phases": dict(timer.phases)})
    logger.info("blocked engine: B=%d, %d blocks, %d owner passes; pair "
                "chunks per bucket %s, launches %s; resident %s; device "
                "memory %s", B, blocks, n_pass, chunk_counts, launches,
                LAST_RUN["resident_bytes"], mem)
    timer.report()
    return ClassifyResult(np.concatenate(out_t), np.concatenate(out_x),
                          np.concatenate(out_s))
