"""The SPMD engines of ``lime_tpu/parallel/sharded.py`` on torch.distributed.

**Banded formulation.**  With every cluster bounded by ``window``
positions, any scoring pair (i-o, i) lies within ``o <= window``, and
"same cluster" for the pair is AND(m[k], k in (i-o, i]) where
m = lcp >= alpha.  Per position the occurrence index is the count of
earlier same-cluster positions, at most ``window`` back, with the same
(document, symbol); a (read, genome) pair scores once for every read
position and genome partner with equal (symbol, occurrence index).  See
``lime_tpu/ops/fused_pass.py`` for why that sum is the reference's
histogram score.  :func:`banded_partial_sim` hands one stream to K3
(:func:`lime_tpu_torch.ops.banded_kernels.banded_sim_into`), whose CUDA
kernel fuses the segment-sum and whose plain version on the CPU is the
XLA formulation in blocks.

**SPMD layout.**  One process per rank; rank ``c`` is shard
``c = sp_i * dp + dp_j`` of the (sp, dp) mesh (:mod:`.mesh`), one device
each.  Two engines:

- banded (:func:`make_sharded_pipeline`, :func:`run_sharded`): the
  (F, N) planner stream is range-sharded over the ranks; each rank
  all-gathers its neighbours' stream edges as its left and right halos
  (the reference's boundary-straddle protocol, src/ClusterLCP.cpp:
  196-264), runs K3 once per collection on the halo-extended shard with
  only its own positions emitting, adds its genome-dense chunks,
  reduce-scatters the (F, R_pad, G_pad) partial over dp (each dp rank
  keeps its read-row block), all-reduces over sp, and classifies its
  rows;
- pair (:func:`make_pair_sharded_pipeline`, :func:`run_sharded_pairs`):
  the packed planner's copy-aligned chunks, already split by read-row
  owner, go to the ranks of their owner's dp column; each rank scores its
  chunks into a local (F, rows_local, G_pad) block with the pair-hit
  kernel, and the one collective is an all-reduce over sp.

int8 partial sums wrap mod 256 through every reduction: the reference's
uchar counters (src/ClusterBWT_DA.cpp:183).  With more than one rank
each rank plans only its own position range (``multihost``); with one
(or no process group) the whole-file drivers run on a 1x1 mesh, with the
banded engine's density routing (dense chunks, the dense host
matrix).  Every rank issues the same collectives in the same order:
sizes are all-gathered before any padded gather, and no branch before a
collective depends on rank-local data.  Outputs are all-gathered; rank 0
writes the CSV.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import native
from ..config import DEFAULT_CONFIG
from ..constants import SYMBOL_RANK_LUT
from ..device import resolve_device
from ..formats.arrays import open_da, open_ebwt, open_lcp
from ..formats.lineage import read_lineage
from ..host import (_DEGENERATE_BYTE, _M_BIT, B_BLK, C_BLK, PR, K,
                    _dense_min_for, _dense_threshold_for, _g_pad_for,
                    _pair_dense_min_for, _rescue, _rescue_sparse,
                    classify_block_size, pack_chunks, pair_rows_local)
from ..ops.banded_kernels import banded_sim_into, pack_positions
from ..ops.banded_kernels import scatter_sim as _scatter_into
from ..ops.classify_ops import ClassifyResult
from ..ops.classify_torch import (_pack_triplet, _unpack_triplet,
                                  blockwise_cascade)
from ..ops import dense_kernels
from ..ops.dense_score import _dense_chunk
from ..ops.fused_pipeline import _plan_pairs, _plan_python, _planner
from ..ops.pair_kernels import BUCKET_CAPS
from ..ops.pair_score import _pair_packed_block_offset, to_device
from ..pipeline import CSV_HEADER, _write_csv_block
from ..utils.timing import PhaseTimer, device_memory_stats
from .mesh import Mesh, make_mesh
from .multihost import plan_host_range, plan_host_range_pairs

#: Statistics of the most recent sharded run on this rank: engine, mesh,
#: rank, planned chunks per bucket (pair) or dense chunks (banded), the
#: chunk exchange, device memory and the host-clock spans ``plan``,
#: ``score``, ``collective`` and ``classify`` (each device span ends on a
#: sync).  Read by chip_smoke.py and tests.
LAST_RUN: dict = {}


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


_HALO_L_SPMD = 512  # static halo capacity: 2*W_MAX occ lookback
_HALO_R_SPMD = 256  # forward partners; window itself is <= 255


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _f32(v, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=dev)


def _classify_tensors(tax, rank_matrix, valid_t, error, dev):
    """The cascade's per-run inputs on ``dev``: u32 taxids as int64
    (torch has no uint32 compare), the lane mask, ``error`` as float32."""
    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(dev)

    return (put(tax, np.int64), put(rank_matrix, np.int64),
            put(valid_t, bool), _f32(error, dev))


def _add_coo(sims: torch.Tensor, cfile, crows, ccols, cvals, row_base: int,
             keep: list) -> None:
    """Host-scored COO corrections for this rank's row block, added into
    ``sims`` (F, rows, G) in place; entries of other blocks and pad
    entries (file index >= F) are left out, as ``mode="drop"`` drops
    them.  Values wrap to the counters' dtype (int8: mod 256)."""
    F, rows, g = sims.shape
    cfile = np.asarray(cfile, np.int64)
    local = np.asarray(crows, np.int64) - row_base
    ok = (cfile >= 0) & (cfile < F) & (local >= 0) & (local < rows)
    if not ok.any():
        return
    flat = (cfile[ok] * rows + local[ok]) * g + np.asarray(ccols,
                                                           np.int64)[ok]
    vals = to_device(np.asarray(cvals, np.int32)[ok], sims.device, keep)
    sims.view(-1).index_add_(0, to_device(flat, sims.device, keep),
                             vals.to(sims.dtype))


def _add_host_block(sims: torch.Tensor, hostm: np.ndarray,
                    row_base: int) -> None:
    """This rank's row block of the dense host matrix (F, R, G) (u8 mod-256
    counters, or u32) added into ``sims`` by its bits."""
    lo = row_base
    hi = min(lo + sims.shape[1], hostm.shape[1])
    if hi <= lo:
        return
    bits = np.int8 if hostm.dtype == np.uint8 else np.int32
    blk = np.ascontiguousarray(hostm[:, lo:hi]).view(bits)
    sims[:, :hi - lo, :hostm.shape[2]] += torch.from_numpy(blk).to(
        sims.device)


def _halo_extend(mesh: Mesh, packed: torch.Tensor, doc: torch.Tensor,
                 fill_doc: int):
    """This rank's (F, n) stream with the previous rank's last
    ``_HALO_L_SPMD`` and the next rank's first ``_HALO_R_SPMD`` positions
    on either side (code 0 and document ``fill_doc`` past the ends): one
    all-gather of every rank's edge strips (``from_prev`` / ``from_next``
    of ``lime_tpu``, whose ppermutes follow the same flattened order)."""
    hl, hr = _HALO_L_SPMD, _HALO_R_SPMD
    F = packed.shape[0]
    dev = packed.device
    strips = torch.cat([packed[:, -hl:].to(torch.int32),
                        packed[:, :hr].to(torch.int32),
                        doc[:, -hl:], doc[:, :hr]], dim=1)
    every = mesh.all_gather(strips)  # (world, F, 2 * (hl + hr))
    if mesh.rank > 0:
        prev = every[mesh.rank - 1]
        tail_pk = prev[:, :hl].to(torch.uint8)
        tail_doc = prev[:, hl + hr:2 * hl + hr]
    else:
        tail_pk = torch.zeros((F, hl), dtype=torch.uint8, device=dev)
        tail_doc = torch.full((F, hl), fill_doc, dtype=torch.int32,
                              device=dev)
    if mesh.rank < mesh.world - 1:
        nxt = every[mesh.rank + 1]
        head_pk = nxt[:, hl:hl + hr].to(torch.uint8)
        head_doc = nxt[:, 2 * hl + hr:]
    else:
        head_pk = torch.zeros((F, hr), dtype=torch.uint8, device=dev)
        head_doc = torch.full((F, hr), fill_doc, dtype=torch.int32,
                              device=dev)
    return (torch.cat([tail_pk, packed, head_pk], dim=1),
            torch.cat([tail_doc, doc, head_doc], dim=1))


def make_sharded_pipeline(mesh: Mesh, num_files: int, num_reads: int,
                          num_refs: int, read_len: int, alpha: int,
                          beta: float, tax_rank: int, assign_higher: bool,
                          wide_sim: bool = False, dense_f: int = 32,
                          device="cuda"):
    """The banded engine's per-rank step over ``mesh`` (``shard_fn`` of
    ``lime_tpu``'s ``make_sharded_pipeline``).

    Returns ``step(packed, doc, window, cfile, crows, ccols, cvals, tax,
    rank_matrix, valid_t, error, hostm=None, dense=None, timer=None)``:

    - ``packed (F, n) u8`` / ``doc (F, n)``: this rank's shard of the
      planned streams (bit 6 = in-run mask with a cluster's first row
      cleared, bits 0..3 = symbol rank; pad documents >= num_reads +
      num_refs); ``n`` at least the halo capacity ``_HALO_L_SPMD`` (the
      halo comes from one neighbour);
    - ``window`` (<= 255): the longest banded cluster;
    - ``cfile, crows, ccols, cvals``: host-scored COO corrections (global
      rows, the same on every rank; file index >= F marks a pad entry);
    - ``tax``, ``rank_matrix``, ``valid_t``, ``error``: the cascade's
      inputs (G_pad lanes);
    - ``hostm``: the density-routed host matrix (F, R, G), or None;
    - ``dense``: this rank's genome-dense chunks, ``(file, ridx,
      gidx, cmap, rid)`` each (``host.pack_chunks``), or None.

    Returns (types, taxid, sim) of this rank's ``rows_local`` read rows
    (row block ``dp_j``; rows past ``num_reads`` are padding).
    """
    dev = resolve_device(device)
    dp = mesh.shape["dp"]
    g_pad = _g_pad_for(num_refs)
    block = classify_block_size(-(-(num_reads + 1) // dp))
    rows_local = pair_rows_local(num_reads, dp)
    r_pad = rows_local * dp
    acc = torch.int32 if wide_sim else torch.int8
    # norm is a float32 tensor on the device: x / norm must be a true
    # division for bit-parity (src/ClusterBWT_DA.cpp:404)
    norm = _f32(np.uint32(read_len + 1 - alpha), dev)
    beta_t = _f32(beta, dev)
    halo_l = _HALO_L_SPMD

    def step(packed, doc, window, cfile, crows, ccols, cvals, tax,
             rank_matrix, valid_t, error, hostm=None, dense=None,
             timer=None):
        timer = timer or PhaseTimer("sharded_step")
        F, n_local = packed.shape
        if n_local < halo_l:
            # the halo collects from ONE neighbour; a shard narrower than a
            # halo cannot supply it (the drivers pad to n_shards * halo_l)
            raise ValueError(
                f"per-shard stream ({n_local}) must be >= the halo "
                f"capacity ({halo_l}); pad the position stream")
        keep = []
        with timer.phase("score"):
            pk = to_device(np.asarray(packed, np.uint8), dev, keep)
            dc = to_device(np.asarray(doc, np.int32), dev, keep)
        with timer.phase("collective"):
            pk_e, da_e = _halo_extend(mesh, pk, dc, num_reads + num_refs)
        with timer.phase("score"):
            idx = torch.arange(pk_e.shape[1], device=dev)
            emit_ok = (idx >= halo_l) & (idx < halo_l + n_local)
            partial = torch.zeros((F, r_pad, g_pad), dtype=acc, device=dev)
            for f in range(F):
                code = pk_e[f]
                banded_sim_into(partial[f], pack_positions(
                    (code >> _M_BIT) & 1, emit_ok, code & 15).contiguous(),
                    da_e[f].contiguous(), int(window), num_reads)
            del pk_e, da_e
            # genome-dense clusters: the dense chunks; every pair is
            # emitted by exactly one rank, so the reductions below merge
            # them like the banded partials
            status = dense_kernels.new_status(dev)
            for fi, *chunk in dense or ():
                _dense_chunk(partial[fi], *(to_device(a, dev, keep)
                                            for a in chunk),
                             B_BLK, C_BLK, PR, dense_f, g_pad, status)
            _sync(dev)
            dense_kernels.take(status)  # raises on a fault in a chunk
        with timer.phase("collective"):
            # row-shard over dp, then merge position shards over sp
            sims = mesh.reduce_scatter_dp(partial)
            del partial
            mesh.all_reduce_sp(sims)
            _sync(dev)
        with timer.phase("classify"):
            row_base = mesh.dp_j * rows_local
            _add_coo(sims, cfile, crows, ccols, cvals, row_base, keep)
            if hostm is not None:
                _add_host_block(sims, hostm, row_base)
            out = blockwise_cascade(
                sims, *_classify_tensors(tax, rank_matrix, valid_t, error,
                                         dev),
                norm, beta_t, F, tax_rank, assign_higher, not wide_sim,
                block)
            _sync(dev)
        keep.clear()
        return out

    return step


def _classify_inputs(lineage_path: str, config, num_genomes: int,
                     g_pad: int):
    """(tax, rank_matrix, valid_t) over ``g_pad`` genome lanes."""
    lineage = read_lineage(lineage_path)
    tax = np.zeros(g_pad, np.uint32)
    tax[:num_genomes] = lineage.at_rank(config.tax_rank)
    rank_matrix = np.zeros((lineage.taxids.shape[0], g_pad), np.uint32)
    rank_matrix[:, :num_genomes] = lineage.taxids
    return tax, rank_matrix, np.arange(g_pad) < num_genomes


def _concat_corr(corr):
    """Per-collection COO corrections -> one (cfile, crows, ccols, cvals)
    of int32 arrays."""
    if not corr:
        empty = np.empty(0, np.int32)
        return empty, empty, empty, empty
    return (np.concatenate([np.full(len(r), fi, np.int32)
                            for fi, r, _, _ in corr]),
            *(np.concatenate([c[i] for c in corr]).astype(np.int32)
              for i in (1, 2, 3)))


def _gather_corr(mesh: Mesh, corr_local, num_files: int,
                 dev: torch.device):
    """Every rank's COO corrections, padded to a common power of two
    (file index ``num_files`` on padding), so every rank holds them all."""
    lf, lr, lc, lv = _concat_corr(corr_local)
    n_corr = int(mesh.allgather_np(np.array([len(lf)], np.int64),
                                   dev).max())
    if not n_corr:
        return lf, lr, lc, lv
    k = max(256, 1 << int(np.ceil(np.log2(max(n_corr, 2)))))
    return tuple(mesh.allgather_np(x, dev, k, fill).reshape(-1)
                 for x, fill in ((lf, num_files), (lr, 0), (lc, 0),
                                 (lv, 0)))


def _gather_result(mesh: Mesh, out, num_reads: int) -> ClassifyResult:
    """Every row block's (types, taxid, sim) from the ranks with sp_i 0,
    in dp order, on every rank."""
    every = mesh.all_gather(_pack_triplet(*out))  # (world, 3, rows_local)
    dp = mesh.shape["dp"]
    rows = every[:dp].permute(1, 0, 2).reshape(3, -1)
    t, x, s = _unpack_triplet(rows.cpu().numpy())
    return ClassifyResult(t[:num_reads], x[:num_reads], s[:num_reads])


def _finish(mesh: Mesh, out, num_reads: int, output_path: str,
            timer: PhaseTimer, dev: torch.device, stats: dict
            ) -> ClassifyResult:
    """Gather the outputs, write the CSV on rank 0, record LAST_RUN."""
    with timer.phase("collective"):
        res = _gather_result(mesh, out, num_reads)
    if output_path and mesh.rank == 0:
        with open(output_path, "w") as f:
            f.write(CSV_HEADER)
            _write_csv_block(f, 0, res)
    LAST_RUN.clear()
    LAST_RUN.update({"mesh": dict(mesh.shape), "rank": mesh.rank,
                     "world": mesh.world, "planner": _planner(), **stats,
                     "memory": device_memory_stats(dev),
                     "phases": dict(timer.phases)})
    timer.report()
    return res


def _check_files(collections) -> int:
    F = len(collections)
    if F not in (2, 4):
        raise ValueError("sharded run takes 2 or 4 collections")
    return F


def run_sharded(collections, output_path: str, num_reads: int,
                num_genomes: int, lineage_path: str, read_len: int,
                config=None, mesh: Optional[Mesh] = None, device="cuda"
                ) -> ClassifyResult:
    """End-to-end SPMD run of the banded engine: plan on the host,
    classify on the mesh.

    With more than one rank every rank plans only its own position range
    (:func:`_run_sharded_multiprocess`).  On one rank (or with no process
    group) the whole-file driver plans every collection with the density
    routing: genome-dense clusters to the dense chunks, IUPAC-degenerate
    and over-long ones to the host rescue (COO corrections, or a dense
    host matrix when they are many) — the reference's full input domain.

    Without the native library the whole-file driver plans with
    ``_plan_python`` (no density routing; the rescue as COO corrections
    from the numpy scorer), on every rank, each rank taking its shard of
    the planned streams: ``lime_tpu``'s one-process mesh, whose range
    planning (``plan_host_range``) needs the library.
    """
    config = config or DEFAULT_CONFIG
    dev = resolve_device(device)
    mesh = mesh or make_mesh()
    if mesh.world > 1 and native.available():
        return _run_sharded_multiprocess(collections, output_path,
                                         num_reads, num_genomes,
                                         lineage_path, read_len, config,
                                         mesh, dev)
    timer = PhaseTimer("torch_run_sharded")
    F = _check_files(collections)
    n_shards = mesh.shape["sp"] * mesh.shape["dp"]
    g_dense = _dense_threshold_for(num_genomes, config)
    dense_min = _dense_min_for(num_genomes, config)
    g_pad = _g_pad_for(num_genomes)

    packs, docs, windows, corr = [], [], [], []
    host_mats = {}
    dense_chunks = []  # (file, ridx, gidx, cmap, rid)
    with timer.phase("plan"):
        for fi, fasta in enumerate(collections):
            lcp = open_lcp(fasta, mmap=True)
            da = open_da(fasta, mmap=True)
            ebwt = open_ebwt(fasta, mmap=True) if config.use_ebwt else None
            if native.available():
                (packed, doc, nc, window, bad_s, bad_l, den_s,
                 den_l) = native.plan_native(
                    lcp, da, ebwt, num_reads, config.alpha,
                    SYMBOL_RANK_LUT, _DEGENERATE_BYTE, use_u16=False,
                    pad_block=1, pad_doc=num_reads + num_genomes,
                    g_dense=g_dense, dense_min=dense_min)
            else:
                packed, doc, window, bad_s, bad_l = _plan_python(
                    lcp, da, ebwt, num_reads, num_genomes, config,
                    use_u16=False)
                den_s = den_l = np.empty(0, np.int64)
            packs.append(packed)
            docs.append(doc.view(np.int32))
            windows.append(window)
            if len(den_s):
                chunks_f, left_s, left_l = pack_chunks(
                    den_s, den_l, da, ebwt, num_reads, num_genomes, g_pad)
                dense_chunks.extend((fi, *c) for c in chunks_f)
                if len(left_s):
                    bad_s = np.concatenate([bad_s, left_s])
                    bad_l = np.concatenate([bad_l, left_l])
            if len(bad_s):
                res = _rescue(bad_s, bad_l, da, ebwt, num_reads,
                              num_genomes, config)
                if res[0] == "dense":
                    host_mats[fi] = res[1]
                elif len(res[1]):
                    corr.append((fi, *res[1:]))

        # every shard must be at least one halo wide (see step's guard)
        n_p = max(max(len(p) for p in packs), n_shards * _HALO_L_SPMD)
        n_p = -(-n_p // n_shards) * n_shards
        packed = np.zeros((F, n_p), np.uint8)
        doc = np.full((F, n_p), num_reads + num_genomes, np.int32)
        for fi in range(F):
            packed[fi, :len(packs[fi])] = packs[fi]
            doc[fi, :len(docs[fi])] = docs[fi]
        packs = docs = None
        # this rank's shard of the streams (all of them on one rank; more
        # ranks only without the native library, which plans no dense
        # chunks and no host matrix)
        shard = n_p // n_shards
        packed = packed[:, mesh.rank * shard:(mesh.rank + 1) * shard]
        doc = doc[:, mesh.rank * shard:(mesh.rank + 1) * shard]
        hostm = None
        if host_mats:
            hostm = np.zeros((F, num_reads, num_genomes),
                             np.uint32 if config.wide_sim else np.uint8)
            for fi, mat in host_mats.items():
                hostm[fi] = mat

    step = make_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        wide_sim=config.wide_sim,
        dense_f=(4 if config.use_ebwt else 1) * K, device=dev)
    out = step(packed, doc, max(windows), *_concat_corr(corr),
               *_classify_inputs(lineage_path, config, num_genomes, g_pad),
               config.error_tolerance, hostm=hostm,
               dense=dense_chunks or None, timer=timer)
    return _finish(mesh, out, num_reads, output_path, timer, dev,
                   {"engine": "banded", "dense_chunks": len(dense_chunks),
                    "host_matrix": hostm is not None,
                    "window": max(windows)})


def _run_sharded_multiprocess(collections, output_path: str,
                              num_reads: int, num_genomes: int,
                              lineage_path: str, read_len: int, config,
                              mesh: Mesh, dev: torch.device
                              ) -> ClassifyResult:
    """Multi-rank run_sharded: per-rank range planning.

    Every rank memmaps and plans only its position range of each
    collection (straddle-extended at the boundaries, ``g_dense=0``: every
    cluster banded or rescued), host-rescues its own inexpressible
    clusters, and pads its stream to the common shard length.  The small
    COO corrections and windows are all-gathered so every rank holds the
    same ones.  Assignments are bit-identical to the one-rank run: the
    per-rank concatenated cluster set equals the whole-file plan and
    score accumulation commutes.
    """
    timer = PhaseTimer("torch_run_sharded")
    F = _check_files(collections)
    g_pad = _g_pad_for(num_genomes)
    packs, docs, corr_local = [], [], []
    windows = 1
    with timer.phase("plan"):
        for fi, fasta in enumerate(collections):
            packed, doc, window, bad_s, bad_l, _ = plan_host_range(
                fasta, num_reads, num_genomes, config.alpha, mesh.world,
                mesh.rank, use_ebwt=config.use_ebwt, g_dense=0,
                use_u16=False)
            packs.append(packed)
            docs.append(doc.astype(np.int32))
            windows = max(windows, window)
            if len(bad_s):
                da = open_da(fasta, mmap=True)
                ebwt = (open_ebwt(fasta, mmap=True) if config.use_ebwt
                        else None)
                rows, cols, vals = _rescue_sparse(
                    bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
                if len(rows):
                    corr_local.append((fi, rows, cols, vals))

    # agree on the global layout: the window max and a uniform shard
    # length; gather the (small) corrections so every rank holds them
    with timer.phase("collective"):
        sizes = mesh.allgather_np(
            np.array([max(len(p) for p in packs), windows], np.int64), dev)
        windows = int(sizes[:, 1].max())
        shard_len = max(_HALO_L_SPMD, int(sizes[:, 0].max()))
        corr = _gather_corr(mesh, corr_local, F, dev)
    packed = np.zeros((F, shard_len), np.uint8)
    doc = np.full((F, shard_len), num_reads + num_genomes, np.int32)
    for fi in range(F):
        packed[fi, :len(packs[fi])] = packs[fi]
        doc[fi, :len(docs[fi])] = docs[fi]

    step = make_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        wide_sim=config.wide_sim, device=dev)
    out = step(packed, doc, windows, *corr,
               *_classify_inputs(lineage_path, config, num_genomes, g_pad),
               config.error_tolerance, timer=timer)
    return _finish(mesh, out, num_reads, output_path, timer, dev,
                   {"engine": "banded", "dense_chunks": 0,
                    "host_matrix": False, "window": windows})


def pair_comm_model(mesh: Mesh, num_files: int, num_reads: int,
                    num_refs: int, wide_sim: bool = False) -> dict:
    """Per-rank collective volume of one dp-sliced pair SPMD step.

    The only collective is the sp all-reduce of the LOCAL (F, rows_local,
    g_pad) block — the term scales with rows_local = ceil(R / dp), not
    with the full read count.  Bytes follow the bidirectional-ring
    estimate 2 * (sp-1)/sp * bytes.
    """
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    g_pad = _g_pad_for(num_refs)
    rows_local = pair_rows_local(num_reads, dp)
    cell = 4 if wide_sim else 1
    block_bytes = num_files * rows_local * g_pad * cell
    return {
        "mesh": (sp, dp),
        "rows_local": rows_local,
        "per_device_hbm_bytes": block_bytes,
        "psum_axis": "sp",
        "psum_bytes_per_device": int(2 * (sp - 1) / sp * block_bytes)
        if sp > 1 else 0,
        "dp_collective_bytes": 0,  # ownership split at plan time
    }


def _pair_rows_local(num_reads: int, dp: int, g_pad: int) -> int:
    rows_local = pair_rows_local(num_reads, dp)
    if (rows_local + 1) * g_pad > 2**31 - 1:
        raise ValueError("rows_local * g_pad exceeds the int32 scatter "
                         "range; raise dp")
    return rows_local


def make_pair_sharded_pipeline(mesh: Mesh, num_files: int, num_reads: int,
                               num_refs: int, read_len: int, alpha: int,
                               beta: float, tax_rank: int,
                               assign_higher: bool, row_bits: int,
                               wide_sim: bool = False, device="cuda"):
    """The dp-sliced pair engine's per-rank step: chunk-parallel, no halos.

    The packed pair planner emits copy-aligned chunks (a cluster copy
    never straddles a chunk) already split by read-row ownership
    (``plan_pairs_packed``'s ``dp`` / ``rows_local``): a copy is re-emitted
    per dp owner holding at least one of its read documents, with only
    that owner's read rows plus the genome rows — occurrence matching is
    per document, so sub-copy scores are exact.  Rank (sp_i, dp_j) gets
    owner-j chunks only and accumulates a LOCAL (F, rows_local, g_pad)
    block; the only collective is an all-reduce over sp of that block, so
    both per-rank memory and traffic scale with rows_local = ceil(R / dp).

    Returns ``step(chunks, crows, ccols, cvals, corr_file, tax,
    rank_matrix, valid_t, error, timer=None)``: ``chunks`` is this rank's
    list of ``(file, bucket, window, rows_w u32, bits_b u8, gcol u16)``;
    each is decoded (``pair_score._decode_chunk``) and scored by the
    pair-hit kernel of its bucket's cap, its read rows inside the block
    scattered into file ``file``'s plane.  Returns (types, taxid, sim) of
    this rank's rows.
    """
    dev = resolve_device(device)
    dp = mesh.shape["dp"]
    g_pad = _g_pad_for(num_refs)
    block = classify_block_size(-(-(num_reads + 1) // dp))
    rows_local = _pair_rows_local(num_reads, dp, g_pad)
    acc = torch.int32 if wide_sim else torch.int8
    norm = _f32(np.uint32(read_len + 1 - alpha), dev)
    beta_t = _f32(beta, dev)

    def step(chunks, crows, ccols, cvals, corr_file, tax, rank_matrix,
             valid_t, error, timer=None):
        timer = timer or PhaseTimer("pair_sharded_step")
        keep = []
        row_base = mesh.dp_j * rows_local
        with timer.phase("score"):
            partial = torch.zeros((num_files, rows_local, g_pad), dtype=acc,
                                  device=dev)
            for fi, bucket, window, rows_w, bits_b, gcol in chunks:
                _pair_packed_block_offset(
                    partial, fi,
                    to_device(np.asarray(rows_w, np.uint32).view(np.int32),
                              dev, keep),
                    to_device(np.asarray(bits_b, np.uint8), dev, keep),
                    to_device(np.asarray(gcol, np.uint16).view(np.int16),
                              dev, keep),
                    window, row_base, row_bits, BUCKET_CAPS[bucket])
            _sync(dev)
        with timer.phase("collective"):
            # the ONLY collective: merge the sp chunk-shards of the block
            mesh.all_reduce_sp(partial)
            _sync(dev)
        with timer.phase("classify"):
            _add_coo(partial, corr_file, crows, ccols, cvals, row_base,
                     keep)
            out = blockwise_cascade(
                partial, *_classify_tensors(tax, rank_matrix, valid_t,
                                            error, dev),
                norm, beta_t, num_files, tax_rank, assign_higher,
                not wide_sim, block)
            _sync(dev)
        keep.clear()
        return out

    return step


def _plan_chunks(fi: int, arrays, plan, windows, row_bits: int):
    """A planner's chunks as ``(owner, (file, bucket, window, rows_w,
    bits_b, gcol))``: views of its three buffers."""
    rows_all, bits_all, gcol_all = arrays
    wpg = row_bits // 4
    return [(owner, (fi, b, windows[b],
                     rows_all[wo:wo + n_rows // 8 * wpg],
                     bits_all[bo:bo + n_rows // 8 * 5],
                     gcol_all[go:go + gc]))
            for b, owner, n_rows, wo, bo, go, gc in plan]


def _pair_stats(chunks, exchange: bool) -> dict:
    per_bucket = [0, 0, 0]
    for c in chunks:
        per_bucket[c[1]] += 1
    return {"engine": "pair", "chunks_per_bucket": per_bucket,
            "exchange": exchange}


def run_sharded_pairs(collections, output_path: str, num_reads: int,
                      num_genomes: int, lineage_path: str, read_len: int,
                      config=None, mesh: Optional[Mesh] = None,
                      device="cuda") -> ClassifyResult:
    """End-to-end SPMD run on the pair-stream engine (chunk-parallel).

    The packed planner's chunks are copy-aligned, so they go to their
    owner's ranks with no halo exchange; genome-dense and rescue clusters
    fold in as exact-host COO corrections.  Outputs are bit-identical to
    the banded engine and the host pipeline.  With more than one rank
    every rank plans only its own position range
    (:func:`_run_sharded_pairs_multiprocess`).
    """
    config = config or DEFAULT_CONFIG
    if not native.available():
        raise RuntimeError("pair engine requires the native planner")
    dev = resolve_device(device)
    mesh = mesh or make_mesh()
    if mesh.world > 1:
        return _run_sharded_pairs_multiprocess(
            collections, output_path, num_reads, num_genomes,
            lineage_path, read_len, config, mesh, dev)
    timer = PhaseTimer("torch_run_sharded_pairs")
    F = _check_files(collections)
    dp = mesh.shape["dp"]
    g_pad = _g_pad_for(num_genomes)
    rows_local = _pair_rows_local(num_reads, dp, g_pad)
    W = native.row_bits_for(num_reads)

    chunks, corr = [], []
    with timer.phase("plan"):
        for fi, fasta in enumerate(collections):
            lcp = open_lcp(fasta, mmap=True)
            da = open_da(fasta, mmap=True)
            ebwt = open_ebwt(fasta, mmap=True) if config.use_ebwt else None
            (arrays, plan, windows, w_f, den_s, den_l, bad_s,
             bad_l) = _plan_pairs(lcp, da, ebwt, num_reads, num_genomes,
                                  config, dp=dp, rows_local=rows_local)
            chunks += [c for _, c in _plan_chunks(fi, arrays, plan, windows,
                                                  W)]
            if len(den_s):  # genome-dense clusters: exact host COO here
                bad_s = np.concatenate([bad_s, den_s])
                bad_l = np.concatenate([bad_l, den_l])
            if len(bad_s):
                rows, cols, vals = _rescue_sparse(
                    bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
                if len(rows):
                    corr.append((fi, rows, cols, vals))

    step = make_pair_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        row_bits=W, wide_sim=config.wide_sim, device=dev)
    cfile, crows, ccols, cvals = _concat_corr(corr)
    out = step(chunks, crows, ccols, cvals, cfile,
               *_classify_inputs(lineage_path, config, num_genomes, g_pad),
               config.error_tolerance, timer=timer)
    return _finish(mesh, out, num_reads, output_path, timer, dev,
                   _pair_stats(chunks, False))


def _exchange_chunks(mesh: Mesh, own_chunks, row_bits: int,
                     dev: torch.device):
    """Every rank's chunk buffers all-gathered and rebuilt into per-owner
    lists in (rank, emission) order; returns this rank's share of the
    round-robin over the ranks of each owner's dp column.  Every rank
    then holds the whole stream (an all-to-all by owner would send each
    rank only its own chunks)."""
    dp = mesh.shape["dp"]
    wpg = row_bits // 4
    metas, rp, bp, gp = [], [], [], []
    for owner, oc in enumerate(own_chunks):
        for fi, b, win, r, bb, g in oc:
            metas.append((owner, fi, b, win, len(r) // wpg * 8, len(g)))
            rp.append(r)
            bp.append(bb)
            gp.append(g)
    meta_l = np.asarray(metas, np.int64).reshape(-1)
    r_l = np.concatenate(rp) if rp else np.empty(0, np.uint32)
    b_l = np.concatenate(bp) if bp else np.empty(0, np.uint8)
    g_l = np.concatenate(gp) if gp else np.empty(0, np.uint16)
    caps = mesh.allgather_np(np.array(
        [len(meta_l), len(r_l), len(b_l), len(g_l)], np.int64), dev)
    meta_g = mesh.allgather_np(meta_l, dev, int(caps[:, 0].max()) + 1, -1)
    r_g = mesh.allgather_np(r_l, dev, int(caps[:, 1].max()) + 1)
    b_g = mesh.allgather_np(b_l, dev, int(caps[:, 2].max()) + 1)
    g_g = mesh.allgather_np(g_l, dev, int(caps[:, 3].max()) + 1)
    glob = [[] for _ in range(dp)]
    for p in range(mesh.world):
        ro = bo = go = 0
        pm = meta_g[p]
        for x in range(0, len(pm), 6):
            if pm[x] < 0:
                break
            owner, fi, b, win, n_rows, lg = (int(v) for v in pm[x:x + 6])
            lr, lb = n_rows // 8 * wpg, n_rows // 8 * 5
            glob[owner].append((fi, b, win, r_g[p][ro:ro + lr],
                                b_g[p][bo:bo + lb], g_g[p][go:go + lg]))
            ro += lr
            bo += lb
            go += lg
    mine = []
    for owner, oc in enumerate(glob):
        cells = [c for c in range(mesh.world) if c % dp == owner]
        mine += [ch for k, ch in enumerate(oc)
                 if cells[k % len(cells)] == mesh.rank]
    return mine


def _run_sharded_pairs_multiprocess(collections, output_path, num_reads,
                                    num_genomes, lineage_path, read_len,
                                    config, mesh: Mesh, dev: torch.device
                                    ) -> ClassifyResult:
    """Multi-rank pair engine: per-rank range planning.

    Every rank plans only its index range (``plan_host_range_pairs``);
    copy-aligned chunks union across ranks with no stitching.  A rank
    holds one device, so with ``dp > 1`` (or ``LIME_FORCE_EXCHANGE=1``)
    no rank covers every dp owner, and the chunk buffers are exchanged
    (:func:`_exchange_chunks`); with ``dp == 1`` each rank scores its own
    chunks.  The COO corrections are all-gathered.
    """
    timer = PhaseTimer("torch_run_sharded_pairs")
    F = _check_files(collections)
    dp = mesh.shape["dp"]
    g_pad = _g_pad_for(num_genomes)
    rows_local = _pair_rows_local(num_reads, dp, g_pad)
    W = native.row_bits_for(num_reads)

    own_chunks = [[] for _ in range(dp)]
    corr_local = []
    with timer.phase("plan"):
        for fi, fasta in enumerate(collections):
            (arrays, plan, windows, w_f, den_s, den_l, bad_s,
             bad_l) = plan_host_range_pairs(
                fasta, num_reads, num_genomes, config.alpha, mesh.world,
                mesh.rank, use_ebwt=config.use_ebwt,
                dense_min=_pair_dense_min_for(config),
                dp=dp, rows_local=rows_local)
            for owner, c in _plan_chunks(fi, arrays, plan, windows, W):
                own_chunks[owner].append(c)
            if len(den_s):  # dense clusters: exact host COO in this engine
                bad_s = np.concatenate([bad_s, den_s])
                bad_l = np.concatenate([bad_l, den_l])
            if len(bad_s):
                da = open_da(fasta, mmap=True)
                ebwt = (open_ebwt(fasta, mmap=True) if config.use_ebwt
                        else None)
                rows, cols, vals = _rescue_sparse(
                    bad_s, bad_l, da, ebwt, num_reads, num_genomes, config)
                if len(rows):
                    corr_local.append((fi, rows, cols, vals))

    with timer.phase("collective"):
        # the exchange decision must be GLOBAL: divergent branches would
        # issue mismatched collective sequences (a deadlock)
        need = dp > 1 or os.environ.get("LIME_FORCE_EXCHANGE") == "1"
        exchange = bool(mesh.allgather_np(np.array([int(need)], np.int64),
                                          dev).any())
        if exchange:
            mine = _exchange_chunks(mesh, own_chunks, W, dev)
        else:
            mine = own_chunks[0]  # dp == 1: every chunk is owner 0's
        cfile, crows, ccols, cvals = _gather_corr(mesh, corr_local, F, dev)

    step = make_pair_sharded_pipeline(
        mesh, num_files=F, num_reads=num_reads, num_refs=num_genomes,
        read_len=read_len, alpha=config.alpha, beta=config.beta,
        tax_rank=config.tax_rank, assign_higher=config.assign_higher,
        row_bits=W, wide_sim=config.wide_sim, device=dev)
    out = step(mine, crows, ccols, cvals, cfile,
               *_classify_inputs(lineage_path, config, num_genomes, g_pad),
               config.error_tolerance, timer=timer)
    return _finish(mesh, out, num_reads, output_path, timer, dev,
                   _pair_stats(mine, exchange))
