"""A jax-free host reference for the fused serving path's CSV.

Per collection: ``native.plan_clusters`` -> ``native.score_clusters_native``
(the exact SIMD scorer, reference-exact u8 wrap / u32 counters) ->
normalise and beta-gate as the blockwise cascade does -> the numpy
cascade ``classify_ops.classify_reads`` in read blocks ->
``native.format_csv``.  This is the staged host executor's arithmetic
without its ``.clrs``/``.res`` files, so it runs where jax is absent (on
the GPU machine) and checks the port's CSV byte for byte.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from lime_tpu import native
from lime_tpu.config import DEFAULT_CONFIG, LimeConfig
from lime_tpu.constants import IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.formats.lineage import read_lineage
from lime_tpu.ops.classify_ops import ClassifyResult, classify_reads

from .host import _DEGENERATE_BYTE


def score_collection(fasta: str, num_reads: int, num_genomes: int,
                     config: LimeConfig) -> np.ndarray:
    """Dense (num_reads, num_genomes) similarity matrix of one collection
    (u8 mod-256 counters, or u32 with ``wide_sim``)."""
    lcp = open_lcp(fasta, mmap=True)
    da = open_da(fasta, mmap=True)
    ebwt = open_ebwt(fasta, mmap=True) if config.use_ebwt else None
    starts, lens = native.plan_clusters(lcp, da, num_reads, config.alpha,
                                        threads=0)
    return native.score_clusters_native(
        starts, lens, da, ebwt, num_reads, num_genomes, SYMBOL_RANK_LUT,
        _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS, wide=config.wide_sim,
        threads=0)


def classify_matrices(sims, read_len: int, tax: np.ndarray,
                      rank_matrix: np.ndarray, config: LimeConfig,
                      block: int = 1 << 14) -> ClassifyResult:
    """Normalise, beta-gate and classify per-file (R, G) count matrices.

    ``sims``: u8 (mod-256 counters) or u32 matrices, one per file;
    ``tax`` (G,) taxids at ``config.tax_rank``; ``rank_matrix``
    (NUM_RANKS, G) taxids per rank.
    """
    num_reads = sims[0].shape[0]
    norm = np.float32(np.uint32(read_len + 1 - config.alpha))
    beta = np.float32(config.beta)
    if not config.assign_higher:
        rank_matrix = None
    out = ClassifyResult(np.zeros(num_reads, np.int8),
                         np.zeros(num_reads, np.uint32),
                         np.zeros(num_reads, np.float32))
    for lo in range(0, num_reads, block):
        hi = min(lo + block, num_reads)
        dense = np.zeros((hi - lo, len(sims), sims[0].shape[1]), np.float32)
        maxs = np.zeros((hi - lo, len(sims)), np.float32)
        for fi, s in enumerate(sims):
            x = s[lo:hi].astype(np.float32) / norm
            rowmax = (x.max(axis=1) if x.shape[1]
                      else np.zeros(hi - lo, np.float32))
            q = rowmax > beta
            dense[:, fi] = np.where(q[:, None], x, np.float32(0))
            maxs[:, fi] = np.where(q, rowmax, np.float32(0))
        res = classify_reads(dense, maxs, tax, rank_matrix, config.tax_rank,
                             np.float32(config.error_tolerance),
                             config.assign_higher)
        out.types[lo:hi] = res.types
        out.taxid[lo:hi] = res.taxid
        out.sim[lo:hi] = res.sim
    return out


def reference_csv(collections: Sequence[str], output_path: str,
                  num_reads: int, num_genomes: int, lineage_path: str,
                  read_len: int, config: LimeConfig = DEFAULT_CONFIG
                  ) -> ClassifyResult:
    """Write the reference assignment CSV for 2 or 4 collections."""
    from .pipeline import write_csv

    lineage = read_lineage(lineage_path)
    if lineage.num_genomes != num_genomes:
        raise ValueError(f"lineage has {lineage.num_genomes} genomes, "
                         f"expected {num_genomes}")
    sims = [score_collection(c, num_reads, num_genomes, config)
            for c in collections]
    res = classify_matrices(sims, read_len, lineage.at_rank(config.tax_rank),
                            lineage.taxids, config)
    write_csv(output_path, res)
    return res


def accuracy(csv_path: str, origins: np.ndarray, taxid_of_genome):
    """Sensitivity/precision of an assignment CSV against planted origins
    (``origins[i]`` = genome of read i, -1 for negative controls), via
    ``lime_tpu.utils.evaluate``."""
    from lime_tpu.utils.evaluate import evaluate

    truth = {i: (None if g < 0 else int(taxid_of_genome[g]))
             for i, g in enumerate(origins)}
    return evaluate(csv_path, truth)
