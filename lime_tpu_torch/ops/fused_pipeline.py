"""Fused serving pipeline on one device: collections -> per-read assignments.

Torch port of the device branch of
``lime_tpu/ops/fused_pipeline._run_fused_inner``: every cluster scored on
the device (no host split), one block of rows.  Per collection the native
planner (C++, GIL released) scans the index once and routes every
alpha-cluster:

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

Modes of the JAX engine that are not ported yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Sequence

import numpy as np
import torch

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.constants import SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.formats.lineage import Lineage
from lime_tpu.ops.classify_ops import ClassifyResult
from lime_tpu.utils.timing import PhaseTimer

from ..host import (_BLOCK, _M_BIT, B_BLK, C_BLK, K, PACK_EMIT_BIT, PR,
                    _DEGENERATE_BYTE, _classify_block_for,
                    _dense_min_for, _dense_threshold_for, _g_pad_for,
                    _r_pad_for, _rescue, ensure_native, merge_coo_segments,
                    pack_chunks)
from ..timing import device_memory_stats
from .banded_kernels import banded_sim_into
from .classify_torch import (_classify_program_planes, _unpack_triplet,
                             alloc_planes)
from .dense_score import _dense_chunk
from .pair_score import coo_scatter_into, pair_score_packed_into, to_device

logger = logging.getLogger("lime_tpu_torch")

#: Device memory kept free beside the score planes: one collection's
#: packed streams and their unpacked int64 temporaries, the dense chunks'
#: feature tensors, and the cascade's per-block float32 tiles.
MEMORY_HEADROOM = 8 << 30

#: Statistics of the most recent run: per-bucket pair-chunk counts,
#: device memory and phase times.  Read by chip_smoke.py and tests.
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
            "hybrid and all-host splits (host_frac / LIME_HOST_FRAC) are "
            "not ported yet: ROADMAP queue 1, item 8")


def _check_memory(stack_bytes: int, device: torch.device,
                  pair: bool) -> None:
    """Refuse a stack the device cannot hold in one block.

    The budget is the device's free memory less MEMORY_HEADROOM (CUDA),
    capped by ``LIME_HBM_BUDGET`` when that is set (any device) on the
    pair-stream path, whose over-budget runs ``lime_tpu`` sends to the
    row-blocked mode; its banded path has no such mode or budget.
    """
    budget = None
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free - MEMORY_HEADROOM
    env = os.environ.get("LIME_HBM_BUDGET")
    if env is not None and pair:
        budget = int(env) if budget is None else min(budget, int(env))
    if budget is not None and stack_bytes > budget:
        raise NotImplementedError(
            f"the score planes need {stack_bytes} bytes, over the "
            f"{budget}-byte budget: the row-blocked mode is not ported "
            "yet (ROADMAP queue 1, item 9)")


def _doc_i32(doc: np.ndarray) -> np.ndarray:
    """The planner's u16 or u32 document ids as int32 (u32 by its bits;
    ids stay below 2^31)."""
    return doc.view(np.int32) if doc.dtype == np.uint32 else \
        doc.astype(np.int32)


def _score_program(sim: torch.Tensor, packed: torch.Tensor,
                   doc: torch.Tensor, window: int,
                   num_reads: int) -> None:
    """Banded scores of one compacted planner stream into ``sim`` (the
    counterpart of ``lime_tpu``'s ``_score_program``).  Like it, this
    reads only the planner's run-mask bit and symbol and lets every
    position emit (``emit_ok=None``); genome positions never do."""
    keep = (1 << _M_BIT) | 15
    banded_sim_into(sim, (packed & keep) | (1 << PACK_EMIT_BIT), doc,
                    window, num_reads)


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
    ensure_native()

    r_pad = _r_pad_for(num_reads)
    g_pad = _g_pad_for(num_genomes)
    block = _classify_block_for(num_reads)
    wide = bool(config.wide_sim)
    pair = (config.pair_stream is not False and num_reads <= (1 << 28)
            and num_genomes <= (1 << 16))
    _check_memory(F * r_pad * g_pad * (4 if wide else 1), device, pair)
    if pair:
        dense_min = (16 if config.mxu_dense_min is None
                     else config.mxu_dense_min)
    else:
        dense_min = _dense_min_for(num_genomes, config)
        g_dense = _dense_threshold_for(num_genomes, config)
        use_u16 = (num_reads + num_genomes) < 0xFFFF
    f_feat = (4 if config.use_ebwt else 1) * K
    keep = []  # pinned staging buffers + their copies' events
    corr = []  # (file, rows, cols, vals) per rescued collection
    chunk_counts = [0, 0, 0]
    banded_windows = []  # per collection, 0 = nothing banded

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

    def release_done():
        keep[:] = [(p, ev) for p, ev in keep if not ev.query()]

    with timer.phase("score"):
        buf, planes = alloc_planes(F, r_pad, g_pad,
                                   torch.int32 if wide else torch.int8,
                                   device)
        tax_h = np.zeros(g_pad, np.int64)
        tax_h[:num_genomes] = lineage.at_rank(config.tax_rank)
        rank_h = np.zeros((lineage.taxids.shape[0], g_pad), np.int64)
        rank_h[:, :num_genomes] = lineage.taxids
        taxd = to_device(tax_h, device, keep)
        rankd = to_device(rank_h, device, keep)
        validd = to_device(np.arange(g_pad) < num_genomes, device, keep)

        def scalar(v):
            return torch.tensor(np.float32(v), device=device)

        normd = scalar(np.uint32(read_len + 1 - config.alpha))
        errord = scalar(config.error_tolerance)
        betad = scalar(config.beta)

        th = None
        with timer.phase("load"):
            arrays = load(collections[0])
        for fi in range(F):
            if fi > 0:
                with timer.phase("load"):
                    th.join()
                arrays = nxt.pop(fi)
            if fi + 1 < F:
                th = threading.Thread(target=prefetch, args=(fi + 1,))
                th.start()
            lcp, da, ebwt = arrays
            timer.add_bytes("score",
                            len(lcp) * (9 if config.use_ebwt else 8))
            if pair:
                with timer.phase("plan"):
                    (pk_arrays, chunks, windows, row_bits, dense_start,
                     dense_len, bad_start, bad_len) = \
                        native.plan_pairs_packed(
                            lcp, da, ebwt, num_reads, config.alpha,
                            SYMBOL_RANK_LUT,
                            _DEGENERATE_BYTE.astype(np.uint8),
                            dense_min=dense_min, num_refs=num_genomes,
                            host_num=0)
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
                     dense_start, dense_len) = native.plan_native(
                        lcp, da, ebwt, num_reads, config.alpha,
                        SYMBOL_RANK_LUT, _DEGENERATE_BYTE, use_u16,
                        pad_block=_BLOCK, pad_doc=num_reads + num_genomes,
                        g_dense=g_dense, dense_min=dense_min)
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
            arrays = lcp = da = ebwt = None
            release_done()

    # every launch above is asynchronous: the device work they queued
    # completes here (otherwise the wait lands in the classify phase)
    with timer.phase("score_sync"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        keep.clear()
    with timer.phase("classify"):
        if corr:
            cfile = np.concatenate(
                [np.full(len(r), fi, np.int32) for fi, r, _, _ in corr])
            crows = np.concatenate([r for _, r, _, _ in corr])
            ccols = np.concatenate([c for _, _, c, _ in corr])
            # values enter pre-wrapped: int8 adds wrap mod 256
            cvals = np.concatenate([v for _, _, _, v in corr]).astype(
                np.int32 if wide else np.int8)
        else:
            cfile = crows = ccols = np.empty(0, np.int32)
            cvals = np.empty(0, np.int32 if wide else np.int8)
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
