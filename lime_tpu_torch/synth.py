"""Synthetic metagenomic datasets (the port's copy of ``tests/synth.py``).

Generates a miniature version of the reference's example/ workload (genomes +
paired reads + lineage CSV), builds the four per-collection merged indexes
(1F, 1RC, 2F, 2RC — reads of that strand followed by all genomes, the
document-id convention from reference src/ClusterLCP.cpp:20-23), and returns
all paths/metadata.  The reference's example/refs.fasta is a stripped large
blob, so tests must synthesize genomes anyway.

The port's SPMD dry run (``parallel/dryrun.py``) and the smoke run build
their datasets with it where the tests' copy cannot be imported;
``tests/test_torch_sharded.py`` holds its files byte-identical to the
tests' copy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

from .formats.fasta import reverse_complement, write_fasta
from .index.builder import build_index_files

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# A sprinkle of IUPAC-degenerate symbols to exercise the waterfall path.
DEGENERATE = np.frombuffer(b"NRYSWKM", dtype=np.uint8)


@dataclasses.dataclass
class SynthDataset:
    root: str
    collections: List[str]  # 4 fasta paths: 1F, 1RC, 2F, 2RC
    lineage_path: str
    num_reads: int
    num_genomes: int
    read_len: int
    genomes: List[bytes]
    reads1: List[bytes]
    reads2: List[bytes]
    origins: List[int | None] = None  # source genome per read pair
    # (None = shuffled negative control)

    @property
    def paired_collections(self) -> List[str]:
        return self.collections

    @property
    def single_collections(self) -> List[str]:
        return self.collections[:2]


def _random_genome(rng: np.random.Generator, length: int,
                   degenerate_rate: float) -> bytes:
    g = rng.choice(BASES, size=length)
    if degenerate_rate > 0:
        mask = rng.random(length) < degenerate_rate
        g[mask] = rng.choice(DEGENERATE, size=int(mask.sum()))
    return g.tobytes()


def _mutate(rng: np.random.Generator, seq: np.ndarray, rate: float) -> np.ndarray:
    out = seq.copy()
    mask = rng.random(len(seq)) < rate
    out[mask] = rng.choice(BASES, size=int(mask.sum()))
    return out


def make_dataset(root: str, num_pairs: int = 400, read_len: int = 100,
                 genome_lens: Sequence[int] = (9000, 7000, 5000),
                 seed: int = 7, mutation_rate: float = 0.01,
                 negative_fraction: float = 0.1,
                 degenerate_rate: float = 0.002,
                 insert_len: int = 250) -> SynthDataset:
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    genomes = [_random_genome(rng, L, degenerate_rate) for L in genome_lens]

    reads1: List[bytes] = []
    reads2: List[bytes] = []
    origins: List[int | None] = []
    n_negative = int(num_pairs * negative_fraction)
    for i in range(num_pairs):
        if i < num_pairs - n_negative:
            g = int(rng.integers(len(genomes)))
            origins.append(g)
            garr = np.frombuffer(genomes[g], dtype=np.uint8)
            start = int(rng.integers(0, len(garr) - insert_len))
            window = garr[start:start + insert_len].tobytes()
            # fragments come from either strand, like a real FR library —
            # this is what makes all four strand/mate collections match
            frag = np.frombuffer(
                reverse_complement(window) if rng.random() < 0.5 else window,
                dtype=np.uint8)
            r1 = _mutate(rng, frag[:read_len], mutation_rate)
            r2 = _mutate(rng, frag[-read_len:], mutation_rate)
            reads1.append(r1.tobytes())
            reads2.append(reverse_complement(r2.tobytes()))
        else:  # shuffled negative control — should classify U
            origins.append(None)
            reads1.append(rng.choice(BASES, size=read_len).tobytes())
            reads2.append(rng.choice(BASES, size=read_len).tobytes())

    lineage_path = os.path.join(root, "LineageFile.csv")
    _write_lineage(lineage_path, len(genomes))

    genome_names = [f"G{j:03d}" for j in range(len(genomes))]
    collections = []
    for tag, reads in (("1F", reads1),
                       ("1RC", [reverse_complement(r) for r in reads1]),
                       ("2F", reads2),
                       ("2RC", [reverse_complement(r) for r in reads2])):
        path = os.path.join(root, f"col_{tag}.fasta")
        names = [f"read_{i}/{tag}" for i in range(len(reads))] + genome_names
        write_fasta(path, names, list(reads) + genomes)
        build_index_files(path, list(reads) + genomes)
        collections.append(path)

    return SynthDataset(root=root, collections=collections,
                        lineage_path=lineage_path, num_reads=num_pairs,
                        num_genomes=len(genomes), read_len=read_len,
                        genomes=genomes, reads1=reads1, reads2=reads2,
                        origins=origins)


def _write_lineage(path: str, num_genomes: int) -> None:
    """Lineage with shared higher ranks so HIGHER=1 has work to do.

    Uses CRLF endings + trailing blank line like the shipped
    example/LineageFile.csv.
    """
    header = ("Acc_Num;Species_TaxID;Genus_TaxID;Family_TaxID;Order_TaxID;"
              "Class_TaxID;Phylum_TaxID")
    lines = [header]
    for j in range(num_genomes):
        species = 1000 + j
        genus = 2000 + j // 2  # genomes 0,1 share a genus
        family = 3000
        order = 4000
        clazz = 5000
        phylum = 6000
        lines.append(f"G{j:03d};{species};{genus};{family};{order};"
                     f"{clazz};{phylum}")
    with open(path, "wb") as f:
        f.write(("\r\n".join(lines) + "\r\n\r\n").encode())
