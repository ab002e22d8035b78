"""Vectorized large-scale synthetic workload generator (copy of
``tests/synth_big.py`` on the port's own native library and formats).

Builds paper-scale fixtures (10^6 read pairs x ~10^3 genomes — the shape of
the reference's setB2 workload, reference README.md:137 / Datasets/README.md)
fast enough for benchmarking: all sequence synthesis is vectorized numpy and
the four collection indexes are built with the native SA-IS builder straight
from concatenated arrays (no FASTA round trip — the pipeline binaries never
read the FASTA, only ``<fasta>.ebwt/.lcp/.da``).

Biology knobs:

- ``conserved_frac``: a fraction of each genome is a mutated copy of its
  *group's* template (groups of ``group_size`` genomes), modeling conserved
  genus-level regions.  These create genome-dense alpha-clusters — the
  regime the TPU banded kernel is routed (density routing).
- reads are sampled from both strands with per-base mutations; a
  ``negative_fraction`` of shuffled reads must classify U (the reference
  benchmark's negative controls, Datasets/README.md:16).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from . import native
from .formats.arrays import write_index_arrays

_COMP = np.zeros(4, np.uint8)
_COMP[[0, 1, 2, 3]] = [3, 2, 1, 0]  # A<->T, C<->G in 2-bit code
_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

#: the generator's defaults, shared by :func:`make_big_dataset`,
#: :func:`compute_truth` and :func:`paper_1f_sequences`
SEED, INSERT_LEN, MUTATION_RATE, NEGATIVE_FRACTION = 17, 250, 0.01, 0.05
CONSERVED_FRAC, GROUP_SIZE, CHUNK = 0.1, 64, 1 << 16


#: host RAM per position of one native SA-IS build with the generator's
#: own arrays beside it: the index guard's 40 B
#: (``index.builder._check_build_memory``) and a margin; the paper
#: shape's four builds at once peak near 56 B a position
SAIS_BYTES_PER_POSITION = 64

#: the last :func:`make_big_dataset`'s index builds: ``workers`` (builds at
#: once), ``free_bytes`` (free RAM before them), ``need_bytes`` (one build's)
LAST_BUILD: dict = {}


def _build_workers(positions: int, builds: int) -> int:
    """How many SA-IS builds of ``positions`` positions each fit at once in
    90% of the free RAM (one at least, ``builds`` at most)."""
    need = positions * SAIS_BYTES_PER_POSITION
    try:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):  # pragma: no cover - platform dependent
        free = 0
    workers = max(1, min(builds, int(free * 0.9) // need))
    LAST_BUILD.update(workers=workers, free_bytes=free, need_bytes=need)
    return workers


@dataclasses.dataclass
class BigDataset:
    root: str
    collections: List[str]
    lineage_path: str
    num_reads: int
    num_genomes: int
    read_len: int
    positions_per_collection: int


def _mutate(rng, arr2bit, rate):
    mask = rng.random(arr2bit.shape) < rate
    arr2bit[mask] = rng.integers(0, 4, size=int(mask.sum()), dtype=np.uint8)
    return arr2bit


def _synth_sequences(rng, num_pairs, num_genomes, genome_len, read_len,
                     insert_len, mutation_rate, negative_fraction,
                     conserved_frac, group_size, chunk):
    """All sequence synthesis (shared rng-draw order with compute_truth).

    Returns (genomes_flat_2bit, reads1, reads2, truth) where truth[i] is
    the origin genome of positive read pair i and -1 for the shuffled
    negative controls.
    """
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
        frag[flip] = _COMP[frag[flip, ::-1]]
        r1 = _mutate(rng, frag[:, :read_len].copy(), mutation_rate)
        r2 = _mutate(rng, frag[:, -read_len:].copy(), mutation_rate)
        reads1[lo:hi] = r1
        reads2[lo:hi] = _COMP[r2[:, ::-1]]  # mate 2 reported on F strand
        truth[lo:hi] = origin
    reads1[n_pos:] = rng.integers(0, 4, size=(num_pairs - n_pos, read_len),
                                  dtype=np.uint8)
    reads2[n_pos:] = rng.integers(0, 4, size=(num_pairs - n_pos, read_len),
                                  dtype=np.uint8)
    return flat, reads1, reads2, truth


def compute_truth(root: str, num_pairs: int, num_genomes: int,
                  genome_len: int, read_len: int = 100,
                  insert_len: int = INSERT_LEN, seed: int = SEED,
                  mutation_rate: float = MUTATION_RATE,
                  negative_fraction: float = NEGATIVE_FRACTION,
                  conserved_frac: float = CONSERVED_FRAC,
                  group_size: int = GROUP_SIZE,
                  chunk: int = CHUNK) -> np.ndarray:
    """Ground-truth origins for a dataset, loading or replaying.

    Datasets generated before truth.npy existed are recovered by
    replaying the exact rng draw sequence of the generator (cheap — the
    expensive part of generation is index construction, which this
    skips); the result is cached next to the dataset.
    """
    path = os.path.join(root, "truth.npy")
    if os.path.exists(path):
        return np.load(path)
    rng = np.random.default_rng(seed)
    _, _, _, truth = _synth_sequences(
        rng, num_pairs, num_genomes, genome_len, read_len, insert_len,
        mutation_rate, negative_fraction, conserved_frac, group_size,
        chunk)
    np.save(path, truth)
    return truth


def make_big_dataset(root: str, num_pairs: int, num_genomes: int,
                     genome_len: int, read_len: int = 100,
                     insert_len: int = INSERT_LEN, seed: int = SEED,
                     mutation_rate: float = MUTATION_RATE,
                     negative_fraction: float = NEGATIVE_FRACTION,
                     conserved_frac: float = CONSERVED_FRAC,
                     group_size: int = GROUP_SIZE,
                     chunk: int = CHUNK) -> BigDataset:
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    flat, reads1, reads2, truth = _synth_sequences(
        rng, num_pairs, num_genomes, genome_len, read_len, insert_len,
        mutation_rate, negative_fraction, conserved_frac, group_size,
        chunk)
    np.save(os.path.join(root, "truth.npy"), truth)

    # --- lineage ------------------------------------------------------------
    lineage_path = os.path.join(root, "LineageFile.csv")
    with open(lineage_path, "w") as f:
        f.write("Acc;Sp;Ge;Fa;Or;Cl;Ph\n")
        for g in range(num_genomes):
            f.write(f"G{g:04d};{1000 + g};{20000 + g // 4};"
                    f"{30000 + g // 16};{40000 + g // 64};"
                    f"{50000 + g // 256};60000\n")

    # --- per-collection merged indexes (reads of one strand + genomes) -----
    # The SA-IS builds run side by side (each is single-threaded C++, and
    # ctypes releases the GIL for the call), as many as the free RAM holds.
    glens = np.full(num_genomes, genome_len, np.int64)
    gflat_ascii = _BASE[flat]
    lens = np.concatenate([np.full(num_pairs, read_len, np.int64), glens])

    def build(tag: str, reads: np.ndarray):
        path = os.path.join(root, f"col_{tag}.fasta")
        with open(path, "w") as f:
            f.write(f">stub {tag}\nACGT\n")  # binaries read only the arrays
        concat = np.concatenate([_BASE[reads.reshape(-1)], gflat_ascii])
        ebwt, lcp, da = native.build_index_native_concat(concat, lens)
        write_index_arrays(path, ebwt, lcp, da)
        return path, len(ebwt)

    strands = (("1F", reads1), ("1RC", _COMP[reads1[:, ::-1]]),
               ("2F", reads2), ("2RC", _COMP[reads2[:, ::-1]]))
    workers = _build_workers(int((lens + 1).sum()), len(strands))
    with ThreadPoolExecutor(workers) as pool:
        built = list(pool.map(lambda job: build(*job), strands))
    collections = [path for path, _ in built]
    n_positions = built[-1][1]

    return BigDataset(root=root, collections=collections,
                      lineage_path=lineage_path, num_reads=num_pairs,
                      num_genomes=num_genomes, read_len=read_len,
                      positions_per_collection=n_positions)


#: the paper shape: genomes, genome length and read length
#: (``bench.py``'s shape)
PAPER_GENOMES, PAPER_GENOME_LEN, PAPER_READ_LEN = 930, 8000, 100


def paper_dataset(build_dir: str, pairs: int = 1_000_000):
    """The paper-shape dataset of ``pairs`` read pairs (:data:`SEED`) under
    ``build_dir/paper_data`` (``paper_data_<pairs>`` for another size),
    made once and reused while its stamp file exists.  Returns
    ``(BigDataset, built)``."""
    root = os.path.join(build_dir, "paper_data" if pairs == 1_000_000
                        else f"paper_data_{pairs}")
    stamp = os.path.join(
        root, f"v1_{pairs}_{PAPER_GENOMES}_{PAPER_GENOME_LEN}.ok")
    built = not os.path.exists(stamp)
    if built:
        make_big_dataset(root, num_pairs=pairs, num_genomes=PAPER_GENOMES,
                         genome_len=PAPER_GENOME_LEN)
        with open(stamp, "w") as f:
            f.write("ok")
    return BigDataset(
        root=root, collections=[os.path.join(root, f"col_{t}.fasta")
                                for t in ("1F", "1RC", "2F", "2RC")],
        lineage_path=os.path.join(root, "LineageFile.csv"),
        num_reads=pairs, num_genomes=PAPER_GENOMES,
        read_len=PAPER_READ_LEN, positions_per_collection=0), built


def paper_sequences(pairs: int):
    """The mate-1 reads, mate-2 reads and genomes of
    ``paper_dataset(build_dir, pairs)`` as ASCII uint8 arrays ((pairs,
    100), (pairs, 100), (930, 8000)), replaying ``make_big_dataset``'s rng
    draws at its defaults (as :func:`compute_truth` does)."""
    flat, reads1, reads2, _ = _synth_sequences(
        np.random.default_rng(SEED), pairs, PAPER_GENOMES, PAPER_GENOME_LEN,
        PAPER_READ_LEN, INSERT_LEN, MUTATION_RATE, NEGATIVE_FRACTION,
        CONSERVED_FRAC, GROUP_SIZE, CHUNK)
    return (_BASE[reads1], _BASE[reads2],
            _BASE[flat].reshape(PAPER_GENOMES, PAPER_GENOME_LEN))


def paper_1f_sequences(pairs: int) -> List[bytes]:
    """The 1F collection of ``paper_dataset(build_dir, pairs)`` as the
    sequence list an index builder takes: the mate-1 reads, then the
    genomes."""
    reads1, _, genomes = paper_sequences(pairs)
    return [r.tobytes() for r in reads1] + [g.tobytes() for g in genomes]
