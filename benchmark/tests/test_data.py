"""The benchmark's data: the device index builder against a naive suffix
sort, and the same seed giving the same bytes."""

import filecmp
import os

import numpy as np
import pytest
import torch

from benchmark.data import dataset, index_builder, synth

from .tiny import tiny_config, tiny_traffic


def naive_index(seqs):
    """(ebwt, lcp, da) by sorting every suffix of the merged collection:
    the terminator of sequence i sorts below every byte and below the
    terminators of later sequences, and matches nothing."""
    text, doc = [], []
    for i, s in enumerate(seqs):
        text += [256 + c for c in s] + [i]  # bytes above every terminator
        doc += [i] * (len(s) + 1)
    n = len(text)
    term = [i for i, (t, d) in enumerate(zip(text, doc)) if t < 256]

    def key(p):
        out = []
        while True:
            out.append(text[p])
            if text[p] < 256:
                return out
            p += 1

    sa = sorted(range(n), key=key)
    lcp = [0] * n
    for k in range(1, n):
        a, b, m = sa[k - 1], sa[k], 0
        while text[a + m] == text[b + m] and text[a + m] >= 256:
            m += 1
        lcp[k] = m
    ends = set(term)
    ebwt = [ord("$") if p == 0 or (p - 1) in ends else text[p - 1] - 256
            for p in sa]
    return (np.array(ebwt, np.uint8), np.array(lcp, np.uint32),
            np.array([doc[p] for p in sa], np.uint32))


CASES = [
    [b"ACGT", b"ACGA", b"TTT"],
    [b"AAAAAAA", b"AAAA", b"AAAAAAA"],
    [b"ACGTACGTAC", b"GTACG", b"CGTAC", b"ACGTACGTAC"],
    [b"A", b"C", b"G", b"T", b"A"],
]


def _build(seqs, device="cpu"):
    body = np.frombuffer(b"".join(seqs), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    return index_builder.build_index(body, lens, device)


@pytest.mark.parametrize("seqs", CASES, ids=range(len(CASES)))
def test_builder_matches_naive_suffix_sort(seqs):
    for got, want in zip(_build(seqs), naive_index(seqs)):
        np.testing.assert_array_equal(got, want)


def test_builder_matches_naive_on_random_reads_and_genomes():
    rng = np.random.default_rng(5)
    seqs = ([bytes(synth.BASE[rng.integers(0, 4, 12)]) for _ in range(30)]
            + [bytes(synth.BASE[rng.integers(0, 4, 200)])
               for _ in range(3)])
    for got, want in zip(_build(seqs), naive_index(seqs)):
        np.testing.assert_array_equal(got, want)


def test_same_seed_same_bytes(tmp_path):
    config, traffic = tiny_config(), tiny_traffic("tiny_fused")
    a = dataset.make_dataset(config, traffic, 2**31 + 7, str(tmp_path / "a"),
                             "cpu")
    b = dataset.make_dataset(config, traffic, 2**31 + 7, str(tmp_path / "b"),
                             "cpu")
    c = dataset.make_dataset(config, traffic, 8, str(tmp_path / "c"), "cpu")
    names = sorted(os.listdir(tmp_path / "a"))
    assert len(names) == 4 * 4 + 1
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b",
                                               names, shallow=False)
    assert not mismatch and not errors
    assert not filecmp.cmp(a.collections[0] + ".lcp",
                           c.collections[0] + ".lcp", shallow=False)
    np.testing.assert_array_equal(a.truth, b.truth)
    assert a.positions == 400 * 101 + 24 * 3001


def test_lineage_ranks_nest_and_keep_the_source_counts():
    taxa = {"species": 686, "genus": 343, "family": 172, "order": 86,
            "class": 43, "phylum": 17}
    ids = synth.lineage_ids(930, taxa)
    for r, name in enumerate(synth.RANKS):
        assert len(np.unique(ids[r])) == taxa[name]
    for r in range(1, len(synth.RANKS)):
        # each taxon of a rank lies in one taxon of the rank above
        pairs = np.unique(np.stack([ids[r - 1], ids[r]]), axis=1)
        assert len(np.unique(pairs[0])) == pairs.shape[1]


@pytest.mark.cuda
def test_builder_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    seqs = ([bytes(synth.BASE[rng.integers(0, 4, 100)])
             for _ in range(2000)]
            + [bytes(synth.BASE[rng.integers(0, 4, 8000)])
               for _ in range(20)])
    for got, want in zip(_build(seqs, "cuda"), _build(seqs, "cpu")):
        np.testing.assert_array_equal(got, want)
