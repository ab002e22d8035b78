"""End-to-end entry points (the reference's LiME_paired.sh) on a torch device.

``run_paired`` / ``run_single`` take ``lime_tpu.pipeline``'s arguments
plus ``device``; they always run the fused serving path (the port has no
staged executor yet) and write the same CSV bytes, through the same C
formatter, as the reference.
"""

from __future__ import annotations

from typing import Sequence

from lime_tpu import native
from lime_tpu.config import DEFAULT_CONFIG, LimeConfig
from lime_tpu.formats.lineage import read_lineage
from lime_tpu.pipeline import ClassifySummary

from .ops.fused_pipeline import run_fused

CSV_HEADER = "C/U/A/H,IdSeqRead,TaxID,maxSim\n"


def write_csv(output_path: str, res) -> None:
    """Assignment CSV (src/Classify.cpp:722-731) via native.format_csv."""
    with open(output_path, "wb") as out:
        out.write(CSV_HEADER.encode())
        out.write(native.format_csv(res.types, res.taxid, res.sim, 0))


def run_paired(collections: Sequence[str], output_path: str, num_reads: int,
               num_genomes: int, lineage_path: str, read_len: int,
               config: LimeConfig = DEFAULT_CONFIG,
               keep_results: bool = True,
               device="cuda") -> ClassifySummary:
    """Paired-end run over 4 collections in 1F, 1RC, 2F, 2RC order.

    ``keep_results`` is accepted for signature parity; the fused path
    writes no intermediate artifacts.
    """
    if len(collections) != 4:
        raise ValueError("paired-end run needs 4 collections: 1F, 1RC, 2F, 2RC")
    return _run(collections, output_path, num_reads, num_genomes,
                lineage_path, read_len, config, device)


def run_single(collections: Sequence[str], output_path: str, num_reads: int,
               num_genomes: int, lineage_path: str, read_len: int,
               config: LimeConfig = DEFAULT_CONFIG,
               keep_results: bool = True,
               device="cuda") -> ClassifySummary:
    """Single-end run over 2 collections (F, RC)."""
    if len(collections) != 2:
        raise ValueError("single-end run needs 2 collections: F, RC")
    return _run(collections, output_path, num_reads, num_genomes,
                lineage_path, read_len, config, device)


def _run(collections, output_path, num_reads, num_genomes, lineage_path,
         read_len, config, device) -> ClassifySummary:
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
