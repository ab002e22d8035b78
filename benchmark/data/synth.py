"""The benchmark's read and genome synthesis: a frozen copy of
``lime_tpu_torch/synth_big.py``'s ``_synth_sequences`` (rng draw order
and arithmetic unchanged), with the lineage drawn from a configuration's
taxon counts.  Imports nothing of the program.

- genomes: uniform random 2-bit codes; in every group of ``group_size``
  genomes a block of ``conserved_frac`` of the genome length is a mutated
  copy of the group's template (genus-level conserved regions, which make
  genome-dense alpha-clusters);
- reads: ``insert_len`` fragments from both strands, mate 1 from the
  fragment's start and mate 2 (reported on the forward strand) from its
  end, each base mutated with ``mutation_rate``; the last
  ``negative_fraction`` of the pairs are uniform random reads (the
  negative controls, which must classify U).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

COMP = np.zeros(4, np.uint8)
COMP[[0, 1, 2, 3]] = [3, 2, 1, 0]  # A<->T, C<->G in 2-bit code
BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

#: the lineage CSV's ranks, species first (genome identity is rank 0)
RANKS = ("species", "genus", "family", "order", "class", "phylum")


def _mutate(rng, arr2bit, rate):
    mask = rng.random(arr2bit.shape) < rate
    arr2bit[mask] = rng.integers(0, 4, size=int(mask.sum()), dtype=np.uint8)
    return arr2bit


def synth_sequences(rng, num_pairs, num_genomes, genome_len, read_len,
                    insert_len, mutation_rate, negative_fraction,
                    conserved_frac, group_size, chunk=1 << 16):
    """(genomes_flat_2bit, reads1, reads2, truth): ``truth[i]`` is the
    origin genome of read pair i, -1 for a negative control."""
    # --- genomes (2-bit codes) with group-conserved blocks -----------------
    genomes = rng.integers(0, 4, size=(num_genomes, genome_len),
                           dtype=np.uint8)
    block = int(genome_len * conserved_frac)
    if block >= 32:
        for g0 in range(0, num_genomes, group_size):
            g1 = min(num_genomes, g0 + group_size)
            template = rng.integers(0, 4, size=block, dtype=np.uint8)
            offs = rng.integers(0, genome_len - block, size=g1 - g0)
            for gi, off in zip(range(g0, g1), offs):
                copy = _mutate(rng, template.copy(), mutation_rate)
                genomes[gi, off:off + block] = copy

    # --- reads --------------------------------------------------------------
    n_pos = num_pairs - int(num_pairs * negative_fraction)
    reads1 = np.empty((num_pairs, read_len), np.uint8)
    reads2 = np.empty((num_pairs, read_len), np.uint8)
    truth = np.full(num_pairs, -1, np.int64)
    flat = genomes.reshape(-1)
    for lo in range(0, n_pos, chunk):
        hi = min(n_pos, lo + chunk)
        m = hi - lo
        origin = rng.integers(0, num_genomes, size=m)
        start = rng.integers(0, genome_len - insert_len, size=m)
        idx = (origin * genome_len + start)[:, None] + np.arange(insert_len)
        frag = flat[idx]
        flip = rng.random(m) < 0.5
        frag[flip] = COMP[frag[flip, ::-1]]
        r1 = _mutate(rng, frag[:, :read_len].copy(), mutation_rate)
        r2 = _mutate(rng, frag[:, -read_len:].copy(), mutation_rate)
        reads1[lo:hi] = r1
        reads2[lo:hi] = COMP[r2[:, ::-1]]  # mate 2 reported on F strand
        truth[lo:hi] = origin
    reads1[n_pos:] = rng.integers(0, 4, size=(num_pairs - n_pos, read_len),
                                  dtype=np.uint8)
    reads2[n_pos:] = rng.integers(0, 4, size=(num_pairs - n_pos, read_len),
                                  dtype=np.uint8)
    return flat, reads1, reads2, truth


def lineage_ids(num_genomes: int, taxa: Dict[str, int]) -> np.ndarray:
    """(6, num_genomes) taxids, species first: rank r puts its units into
    ``taxa[r]`` contiguous groups of the rank below (genomes for
    species), so the ranks nest.  Taxids are ``(r + 1) * 100000 +`` the
    group's index."""
    out = np.empty((len(RANKS), num_genomes), np.int64)
    below, n_below = np.arange(num_genomes, dtype=np.int64), num_genomes
    for r, name in enumerate(RANKS):
        n = int(taxa[name])
        if not 1 <= n <= n_below:
            raise ValueError(f"{name}: {n} taxa over {n_below} below")
        below = below * n // n_below
        n_below = n
        out[r] = (r + 1) * 100_000 + below
    return out


def lineage_csv(taxids: np.ndarray) -> str:
    """The lineage CSV (header and one ``;``-separated row per genome, in
    genome order) of :func:`lineage_ids`' matrix."""
    rows = ["Acc;Sp;Ge;Fa;Or;Cl;Ph"]
    for g in range(taxids.shape[1]):
        rows.append(f"G{g:05d};" + ";".join(str(int(t))
                                            for t in taxids[:, g]))
    return "\n".join(rows) + "\n"


def collections(reads1: np.ndarray, reads2: np.ndarray
                ) -> Sequence[tuple]:
    """The four strands' reads (2-bit, one row a read) in the paired run's
    order: 1F, 1RC, 2F, 2RC."""
    return (("1F", reads1), ("1RC", COMP[reads1[:, ::-1]]),
            ("2F", reads2), ("2RC", COMP[reads2[:, ::-1]]))
