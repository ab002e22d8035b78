"""One run's sample and database, made from the seed: reads and genomes
(:mod:`.synth`), the lineage CSV, and the four merged collection indexes
(1F, 1RC, 2F, 2RC: one strand's reads followed by every genome) built on
the device (:mod:`.index_builder`) and written as the files the program
reads.  The same configuration, traffic and seed give the same bytes."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np

from .index_builder import build_index
from .synth import BASE, collections, lineage_csv, lineage_ids, synth_sequences


@dataclasses.dataclass
class Dataset:
    root: str
    collections: List[str]
    lineage_path: str
    num_reads: int
    num_genomes: int
    read_len: int
    positions: int  # per collection
    taxids: np.ndarray  # (6, num_genomes), species first
    truth: np.ndarray  # origin genome per read pair, -1 for a negative
    #: host seconds of set-up by step: ``synth``, ``build`` (on the
    #: device, with the copy back) and ``write`` (flushed to disk)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def taxa_at(self, rank: int) -> np.ndarray:
        """Each genome's taxid at ``rank`` (0: the genome itself)."""
        return (self.taxids[rank - 1] if rank
                else np.arange(self.num_genomes, dtype=np.int64))

    def truth_taxa(self, rank: int) -> np.ndarray:
        """The taxid each read pair came from at ``rank``, -1 for a
        negative control."""
        tax = self.taxa_at(rank)
        return np.where(self.truth >= 0, tax[np.maximum(self.truth, 0)], -1)


def rng_for(seed: int) -> np.random.Generator:
    """The run's generator: any whole number is a seed."""
    return np.random.default_rng(abs(int(seed)))


def _write(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        arr.tofile(f)
        f.flush()
        os.fsync(f.fileno())


def make_dataset(config: dict, traffic: dict, seed: int, root: str,
                 device) -> Dataset:
    """Synthesize the sample of ``traffic["pairs_per_job"]`` read pairs
    against ``config``'s database under ``root`` and build its indexes on
    ``device``.  Every file is flushed to disk before this returns, so the
    measured window does not pay the write-back."""
    seconds = dict.fromkeys(("synth", "build", "write"), 0.0)
    t0 = time.perf_counter()
    pairs = int(traffic["pairs_per_job"])
    G, glen, rlen = (int(config["genomes"]), int(config["genome_len"]),
                     int(config["read_len"]))
    flat, reads1, reads2, truth = synth_sequences(
        rng_for(seed), pairs, G, glen, rlen, int(config["insert_len"]),
        float(config["mutation_rate"]), float(config["negative_fraction"]),
        float(config["conserved_frac"]), int(config["group_size"]))
    os.makedirs(root, exist_ok=True)
    taxids = lineage_ids(G, config["taxa"])
    lineage_path = os.path.join(root, "LineageFile.csv")
    with open(lineage_path, "w") as f:
        f.write(lineage_csv(taxids))
    genomes = BASE[flat]
    lens = np.concatenate([np.full(pairs, rlen, np.int64),
                           np.full(G, glen, np.int64)])
    paths = []
    for tag, reads in collections(reads1, reads2):
        path = os.path.join(root, f"col_{tag}.fasta")
        with open(path, "w") as f:
            f.write(f">stub {tag}\nACGT\n")  # the program reads the arrays
        body = np.concatenate([BASE[reads.reshape(-1)], genomes])
        t1 = time.perf_counter()
        seconds["synth"] += t1 - t0
        ebwt, lcp, da = build_index(body, lens, device)
        del body
        t2 = time.perf_counter()
        seconds["build"] += t2 - t1
        _write(path + ".ebwt", ebwt)
        _write(path + ".lcp", lcp)
        _write(path + ".da", da)
        paths.append(path)
        t0 = time.perf_counter()
        seconds["write"] += t0 - t2
    return Dataset(root=root, collections=paths, lineage_path=lineage_path,
                   num_reads=pairs, num_genomes=G, read_len=rlen,
                   positions=len(ebwt), taxids=taxids, truth=truth,
                   seconds=seconds)
