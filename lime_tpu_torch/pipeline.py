"""Pipeline stages and end-to-end entry points on a torch device.

The counterparts of ``lime_tpu/pipeline.py``, with an explicit
``device``; each writes the same files as its original:

- :func:`cluster_lcp` detects alpha-clusters on the host (native C++):
  ``.<alpha>.clrs`` + ``.out``;
- :func:`cluster_bwt` scores clusters, with K3 on the device
  (``executor="tpu"``, the default) or the native exact scorer
  (``executor="host"``): ``.res.bin`` / ``.res.pos`` (or ``.res.txt``);
- :func:`classify` merges the ``.res`` files into the CSV, the cascade
  running on the device or, with ``executor="host"``, in numpy;
- :func:`run_paired` / :func:`run_single` dispatch as ``lime_tpu``'s do:
  ``LimeConfig(fused=True)`` runs the fused serving path
  (``ops/fused_pipeline.py``), anything else the staged stages, which
  write their checkpoints next to the collections.

Without the native library (``native.available()`` False) the stages
take ``lime_tpu``'s numpy fallbacks: ``find_clusters`` for the scan,
``score_clusters`` for the host executor and for K3's rescued clusters,
and a Python formatter for the CSV; ``LAST_RUN["planner"]`` says which.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

from . import native
from .config import DEFAULT_CONFIG, LimeConfig
from .constants import IUPAC_WATERFALL_PAIRS, MAX_CLUSTER_LEN, SYMBOL_RANK_LUT
from .device import resolve_device
from .formats.arrays import (AuxMetadata, aux_path_for, clusters_path_for,
                             open_da, open_ebwt, open_lcp, read_aux,
                             read_clusters, write_aux, write_clusters)
from .formats.lineage import read_lineage
from .formats.res import (dense_from_bin, read_results_bin,
                          read_results_txt, write_results_bin,
                          write_results_txt)
from .host import _DEGENERATE_BYTE
from .ops.classify_ops import _TYPE_CHARS, TYPE_A, TYPE_U, classify_reads
from .ops.classify_torch import classify_reads_torch
from .ops.cluster_scan import cluster_metadata, find_clusters
from .ops.fused_pass import score_clusters_tpu
from .ops.fused_pipeline import _planner, run_fused
from .ops.scoring import normalize_scores, score_clusters
from .utils import timing
from .utils.timing import PhaseTimer

__all__ = ["ClassifySummary", "cluster_lcp", "cluster_bwt", "classify",
           "run_paired", "run_single", "LAST_RUN"]

CSV_HEADER = "C/U/A/H,IdSeqRead,TaxID,maxSim\n"

#: The most recent staged run: {"planner": "native" or "numpy",
#: "phases": {stage: s}, "stages": {stage: {phase: s summed over
#: collections}}}.
LAST_RUN: dict = {}


@dataclasses.dataclass
class ClassifySummary:
    num_reads: int
    classified: int
    higher: int
    ambiguous: int
    unclassified: int


def _format_sim(x: float) -> str:
    """C++ ostream default float formatting (%g with 6 significant digits)."""
    return f"{float(x):g}"


def _write_csv_block(out, base: int, res) -> None:
    """Emit CSV rows matching the reference's output (src/Classify.cpp:
    722-731): the native formatter, or ``lime_tpu``'s Python loop without
    the native library."""
    if native.available():
        out.flush()
        out.buffer.write(native.format_csv(
            np.asarray(res.types), np.asarray(res.taxid),
            np.asarray(res.sim), base))
        return
    lines: List[str] = []
    for i, t in enumerate(res.types):
        rid = base + i
        if t == TYPE_U:
            lines.append(f"U,{rid},NA,0\n")
        elif t == TYPE_A:
            lines.append(f"A,{rid},NA,0\n")
        else:
            ch = _TYPE_CHARS[t]
            lines.append(
                f"{ch},{rid},{res.taxid[i]},{_format_sim(res.sim[i])}\n")
    out.write("".join(lines))


def write_csv(output_path: str, res) -> None:
    """The whole assignment CSV of one result."""
    with open(output_path, "w") as out:
        out.write(CSV_HEADER)
        _write_csv_block(out, 0, res)


# ---------------------------------------------------------------------------
# Step 1 — alpha-cluster detection
# ---------------------------------------------------------------------------

def cluster_lcp(fasta_path: str, num_reads: int, num_genomes: int,
                config: LimeConfig = DEFAULT_CONFIG) -> AuxMetadata:
    """Detect alpha-clusters; write ``.alpha.clrs`` + ``.out``."""
    timer = PhaseTimer(f"cluster_lcp[{os.path.basename(fasta_path)}]")
    with timer.phase("load"):
        lcp = open_lcp(fasta_path)
        da = open_da(fasta_path)
    with timer.phase("scan", nbytes=8 * len(lcp)):
        # the native scan honours config.threads (the reference's
        # ClusterLCP `threads` argument, src/ClusterLCP.cpp:139)
        if native.available():
            p_start, lens = native.plan_clusters(
                np.asarray(lcp), np.asarray(da), num_reads, config.alpha,
                threads=config.threads)
        else:
            p_start, lens = find_clusters(np.asarray(lcp), np.asarray(da),
                                          num_reads, config.alpha)
    with timer.phase("write"):
        write_clusters(clusters_path_for(fasta_path, config.alpha), p_start,
                       lens)
        meta = cluster_metadata(p_start, lens, num_reads, num_genomes,
                                config.alpha)
        write_aux(aux_path_for(fasta_path), meta)
    timer.report()
    return meta


# ---------------------------------------------------------------------------
# Step 2 — cluster scoring
# ---------------------------------------------------------------------------

def dump_sim(sim: np.ndarray) -> None:
    """The full similarity matrix on stdout, as ``lime_tpu``'s
    ``LIME_DUMP_SIM=1`` prints it: the runtime form of the original
    tool's ``SMALL=1`` build (src/ClusterBWT_DA.cpp:672-681), an
    inspection aid for tiny runs.  ``sim`` is the wrapped uint8 (uint32
    when wide) matrix either executor returns: never an int8 view, whose
    values would print negative."""
    w = sys.stdout.write
    w("***FINAL***\n")
    for row in np.asarray(sim):
        w("\t".join(str(int(v)) for v in row))
        w("\t\n")
    w("***********\n")


def cluster_bwt(fasta_path: str, read_len: int,
                config: LimeConfig = DEFAULT_CONFIG, device="cuda") -> str:
    """Score clusters; write ``.res.bin``/``.res.pos`` (or ``.res.txt``).

    With ``LIME_DUMP_SIM=1`` the scored matrix also goes to stdout
    (:func:`dump_sim`).  Returns the ``.res`` prefix path.
    """
    if config.executor == "tpu":
        device = resolve_device(device)
        timer = PhaseTimer(
            f"torch_cluster_bwt[{os.path.basename(fasta_path)}]")
    else:
        timer = PhaseTimer(f"cluster_bwt[{os.path.basename(fasta_path)}]")
    meta = read_aux(aux_path_for(fasta_path))
    if not config.wide_sim and read_len > 255:
        raise ValueError("read_len > 255 requires wide_sim=True "
                         "(the reference's dataTypeNumSim=1, Tools.h:51)")
    if meta.max_len > MAX_CLUSTER_LEN:
        raise ValueError(f"max cluster size {meta.max_len} exceeds "
                         f"{MAX_CLUSTER_LEN} (reference sizeMaxBuf guard)")
    with timer.phase("load"):
        p_start, lens = read_clusters(clusters_path_for(fasta_path,
                                                        meta.alpha))
        da = open_da(fasta_path)
        ebwt = open_ebwt(fasta_path) if config.use_ebwt else None
    with timer.phase("score"):
        if config.executor == "tpu":
            sim = score_clusters_tpu(p_start, lens, da, ebwt, meta.num_reads,
                                     meta.num_genomes, config,
                                     alpha=meta.alpha,
                                     lcp=open_lcp(fasta_path),
                                     device=device, timer=timer)
        elif native.available():
            # the SIMD scorer honours config.threads (the reference's
            # ClusterBWT_DA OpenMP argument, src/ClusterBWT_DA.cpp:630);
            # outputs do not depend on the thread count
            sim = native.score_clusters_native(
                np.asarray(p_start, np.int64), np.asarray(lens, np.int64),
                np.asarray(da), None if ebwt is None else np.asarray(ebwt),
                meta.num_reads, meta.num_genomes, SYMBOL_RANK_LUT,
                _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
                wide=config.wide_sim, threads=config.threads)
        else:
            sim = score_clusters(p_start, lens, np.asarray(da),
                                 None if ebwt is None else np.asarray(ebwt),
                                 meta.num_reads, meta.num_genomes, config)
    if os.environ.get("LIME_DUMP_SIM") == "1":
        dump_sim(sim)
    with timer.phase("write"):
        norm_rows = normalize_scores(sim, read_len, meta.alpha)
        res_prefix = fasta_path + ".res"
        if config.binary_results:
            write_results_bin(res_prefix, norm_rows, config.beta)
        else:
            write_results_txt(res_prefix, norm_rows, config.beta)
    timer.report()
    return res_prefix


# ---------------------------------------------------------------------------
# Step 3 — classification
# ---------------------------------------------------------------------------

def classify(res_prefixes: Sequence[str], num_reads: int, num_genomes: int,
             output_path: str, lineage_path: str,
             config: LimeConfig = DEFAULT_CONFIG,
             block_reads: int = 1 << 16, device="cuda") -> ClassifySummary:
    """Merge 2 or 4 ``.res`` files into the final assignment CSV."""
    if len(res_prefixes) not in (2, 4):
        raise ValueError("classify takes 2 (single-end) or 4 (paired-end) "
                         ".res files (reference src/Classify.cpp:334-338)")
    on_device = config.executor == "tpu"
    if on_device:
        device = resolve_device(device)
    timer = PhaseTimer("torch_classify" if on_device else "classify")
    lineage = read_lineage(lineage_path)
    if lineage.num_genomes != num_genomes:
        raise ValueError(
            f"lineage has {lineage.num_genomes} genomes, expected "
            f"{num_genomes}: poor taxonomy information to classify")
    tax = lineage.at_rank(config.tax_rank)
    rank_matrix = lineage.taxids if config.assign_higher else None

    with timer.phase("load"):
        if config.binary_results:
            files = [read_results_bin(p, num_reads,
                                      mmap=num_reads > (1 << 22))
                     for p in res_prefixes]
        else:
            txt = [read_results_txt(p) for p in res_prefixes]

    counts = {"U": 0, "C": 0, "A": 0, "H": 0}
    error = np.float32(config.error_tolerance)

    def _block(lo: int):
        hi = min(lo + block_reads, num_reads)
        with timer.phase("decode"):
            dense = np.zeros((hi - lo, len(res_prefixes), num_genomes),
                             dtype=np.float32)
            maxs = np.zeros((hi - lo, len(res_prefixes)), dtype=np.float32)
            for fi in range(len(res_prefixes)):
                if config.binary_results:
                    pos, recs = files[fi]
                    dense[:, fi], maxs[:, fi] = dense_from_bin(
                        pos, recs, num_reads, num_genomes, lo, hi)
                else:
                    for r in range(lo, hi):
                        for k, (sim_v, id_v) in enumerate(txt[fi][r]):
                            if k == 0:
                                maxs[r - lo, fi] = sim_v
                            else:
                                dense[r - lo, fi, id_v] = sim_v
        with timer.phase("cascade"):
            if on_device:
                return classify_reads_torch(dense, maxs, tax, rank_matrix,
                                            config.tax_rank, error,
                                            config.assign_higher, device)
            return classify_reads(dense, maxs, tax, rank_matrix,
                                  config.tax_rank, error,
                                  config.assign_higher)

    def _write(out, lo: int, res) -> None:
        with timer.phase("write"):
            for t, c in res.counts().items():
                counts[t] += c
            _write_csv_block(out, lo, res)

    blocks = list(range(0, num_reads, block_reads))
    with open(output_path, "w") as out:
        out.write(CSV_HEADER)
        if config.threads > 1 and len(blocks) > 1 and not on_device:
            # Read-parallel classification (the reference's `#pragma omp
            # parallel for` over reads, src/Classify.cpp:474-477): blocks
            # run on a thread pool (large-array numpy kernels release the
            # GIL) and results serialize in read order like the
            # reference's vOutput drain (Classify.cpp:722-734).
            with ThreadPoolExecutor(max_workers=config.threads) as ex:
                for lo, res in zip(blocks, ex.map(_block, blocks)):
                    _write(out, lo, res)
        else:
            for lo in blocks:
                _write(out, lo, _block(lo))
    timer.report()
    return ClassifySummary(num_reads=num_reads, classified=counts["C"],
                           higher=counts["H"], ambiguous=counts["A"],
                           unclassified=counts["U"])


# ---------------------------------------------------------------------------
# End-to-end runs (reference LiME_paired.sh)
# ---------------------------------------------------------------------------

def run_paired(collections: Sequence[str], output_path: str, num_reads: int,
               num_genomes: int, lineage_path: str, read_len: int,
               config: LimeConfig = DEFAULT_CONFIG,
               keep_results: bool = True,
               device="cuda") -> ClassifySummary:
    """Paired-end run over 4 collections in 1F, 1RC, 2F, 2RC order."""
    if len(collections) != 4:
        raise ValueError("paired-end run needs 4 collections: 1F, 1RC, 2F, 2RC")
    return _run(collections, output_path, num_reads, num_genomes,
                lineage_path, read_len, config, keep_results, device)


def run_single(collections: Sequence[str], output_path: str, num_reads: int,
               num_genomes: int, lineage_path: str, read_len: int,
               config: LimeConfig = DEFAULT_CONFIG,
               keep_results: bool = True,
               device="cuda") -> ClassifySummary:
    """Single-end run over 2 collections (F, RC)."""
    if len(collections) != 2:
        raise ValueError("single-end run needs 2 collections: F, RC")
    return _run(collections, output_path, num_reads, num_genomes,
                lineage_path, read_len, config, keep_results, device)


def _run(collections, output_path, num_reads, num_genomes, lineage_path,
         read_len, config, keep_results, device) -> ClassifySummary:
    if config.fused and config.executor == "tpu":
        return _run_fused(collections, output_path, num_reads, num_genomes,
                          lineage_path, read_len, config, device)
    timer = PhaseTimer("torch_staged")
    stages: dict = {}

    def stage(name, fn, *a, **kw):
        """Run one stage call; add its own phase times to ``stages``."""
        with timer.phase(name):
            out = fn(*a, **kw)
        inner = stages.setdefault(name, {})
        for k, v in timing.LAST_RUN.get("phases", {}).items():
            inner[k] = inner.get(k, 0.0) + v
        return out

    for c in collections:
        stage("cluster_lcp", cluster_lcp, c, num_reads, num_genomes, config)
    res_prefixes = [stage("cluster_bwt", cluster_bwt, c, read_len, config,
                          device) for c in collections]
    summary = stage("classify", classify, res_prefixes, num_reads,
                    num_genomes, output_path, lineage_path, config,
                    device=device)
    if not keep_results:
        for p in res_prefixes:
            for ext in (".bin", ".pos", ".txt"):
                try:
                    os.remove(p + ext)
                except FileNotFoundError:
                    pass
    LAST_RUN.clear()
    LAST_RUN.update({"planner": _planner(), "phases": dict(timer.phases),
                     "stages": stages})
    return summary


def _run_fused(collections, output_path, num_reads, num_genomes,
               lineage_path, read_len, config, device) -> ClassifySummary:
    """Serving path: no ``.clrs``/``.res`` artifacts."""
    lineage = read_lineage(lineage_path)
    if lineage.num_genomes != num_genomes:
        raise ValueError(
            f"lineage has {lineage.num_genomes} genomes, expected "
            f"{num_genomes}: poor taxonomy information to classify")
    res = run_fused(collections, num_reads, num_genomes, lineage, read_len,
                    config, device)
    write_csv(output_path, res)
    c = res.counts()
    return ClassifySummary(num_reads=num_reads, classified=c["C"],
                           higher=c["H"], ambiguous=c["A"],
                           unclassified=c["U"])
