"""Pipeline stages and end-to-end entry points on a torch device.

The counterparts of ``lime_tpu.pipeline`` with an explicit ``device``:

- :func:`cluster_lcp` is ``lime_tpu``'s own (host, jax-free);
- :func:`cluster_bwt` scores clusters with K3 and writes the same
  ``.res.bin`` / ``.res.pos`` (or ``.res.txt``) bytes;
- :func:`classify` merges the ``.res`` files into the same CSV bytes,
  the cascade running on the device;
- :func:`run_paired` / :func:`run_single` dispatch as ``lime_tpu``'s do:
  ``LimeConfig(fused=True)`` runs the fused serving path
  (``ops/fused_pipeline.py``), anything else the staged stages, which
  write their checkpoints next to the collections.  With
  ``executor="host"`` the scoring and classify stages are
  ``lime_tpu``'s jax-free host stages.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from lime_tpu import native
from lime_tpu import pipeline as host_pipeline
from lime_tpu.config import DEFAULT_CONFIG, LimeConfig
from lime_tpu.constants import MAX_CLUSTER_LEN
from lime_tpu.formats.arrays import (aux_path_for, clusters_path_for,
                                     open_da, open_ebwt, open_lcp, read_aux,
                                     read_clusters)
from lime_tpu.formats.lineage import read_lineage
from lime_tpu.formats.res import (dense_from_bin, read_results_bin,
                                  read_results_txt, write_results_bin,
                                  write_results_txt)
from lime_tpu.ops.scoring import normalize_scores
from lime_tpu.pipeline import ClassifySummary, _write_csv_block, cluster_lcp
from lime_tpu.utils import timing
from lime_tpu.utils.timing import PhaseTimer

from .host import ensure_native
from .ops.classify_torch import classify_reads_torch
from .ops.fused_pass import score_clusters_tpu
from .ops.fused_pipeline import resolve_device, run_fused

__all__ = ["cluster_lcp", "cluster_bwt", "classify", "run_paired",
           "run_single", "LAST_RUN"]

CSV_HEADER = "C/U/A/H,IdSeqRead,TaxID,maxSim\n"

#: Times of the most recent staged run: {"phases": {stage: s}, "stages":
#: {stage: {phase: s summed over collections}}}.
LAST_RUN: dict = {}


def write_csv(output_path: str, res) -> None:
    """Assignment CSV (src/Classify.cpp:722-731) via native.format_csv."""
    with open(output_path, "wb") as out:
        out.write(CSV_HEADER.encode())
        out.write(native.format_csv(res.types, res.taxid, res.sim, 0))


# ---------------------------------------------------------------------------
# Step 2 — cluster scoring
# ---------------------------------------------------------------------------

def cluster_bwt(fasta_path: str, read_len: int,
                config: LimeConfig = DEFAULT_CONFIG, device="cuda") -> str:
    """Score clusters; write ``.res.bin``/``.res.pos`` (or ``.res.txt``).

    Returns the ``.res`` prefix path.
    """
    if config.executor != "tpu":
        return host_pipeline.cluster_bwt(fasta_path, read_len, config)
    device = resolve_device(device)
    ensure_native()
    timer = PhaseTimer(f"torch_cluster_bwt[{os.path.basename(fasta_path)}]")
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
        sim = score_clusters_tpu(p_start, lens, da, ebwt, meta.num_reads,
                                 meta.num_genomes, config, alpha=meta.alpha,
                                 lcp=open_lcp(fasta_path), device=device,
                                 timer=timer)
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
    if config.executor != "tpu":
        return host_pipeline.classify(res_prefixes, num_reads, num_genomes,
                                      output_path, lineage_path, config,
                                      block_reads)
    if len(res_prefixes) not in (2, 4):
        raise ValueError("classify takes 2 (single-end) or 4 (paired-end) "
                         ".res files (reference src/Classify.cpp:334-338)")
    device = resolve_device(device)
    timer = PhaseTimer("torch_classify")
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
        return dense, maxs

    with open(output_path, "w") as out:
        out.write(CSV_HEADER)
        for lo in range(0, num_reads, block_reads):
            with timer.phase("decode"):
                dense, maxs = _block(lo)
            with timer.phase("cascade"):
                res = classify_reads_torch(dense, maxs, tax, rank_matrix,
                                           config.tax_rank, error,
                                           config.assign_higher, device)
            with timer.phase("write"):
                for t, c in res.counts().items():
                    counts[t] += c
                _write_csv_block(out, lo, res)
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
    ensure_native()
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
    LAST_RUN.update({"phases": dict(timer.phases), "stages": stages})
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
