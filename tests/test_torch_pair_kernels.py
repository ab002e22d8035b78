"""Pair-hit kernels of the torch port against the JAX package.

The plain torch versions (the CPU side of ``pair_kernels.pair_hits``)
are held, exactly, against lime_tpu's Pallas kernels run in interpret
mode, the XLA band core and the vectorised numpy oracle.  A numpy model
of the CUDA kernel's segmented-count rule is held against the plain
version, and the planner's real chunks against the invariant the rule
rests on; the CUDA kernel itself is held against the plain version in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu.ops import pair_score as jps
from lime_tpu.ops.pallas_kernels import pair_hits_pallas
from lime_tpu.ops.pallas_kernels import (
    planner_shaped_stream as jax_planner_shaped_stream)
from lime_tpu_torch.ops import pair_kernels as pk
from lime_tpu_torch.ops import pair_score as tps

from .synth import make_dataset
from .test_torch_selfcontained import ensure_reference_native

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)


def _oracle_packed(codes):
    """5-bit codes -> the numpy oracle's byte layout (bit6 m, bit5 dr,
    bit4 gs, bits 0-3 sym)."""
    return ((codes & 3) | (((codes >> 3) & 1) << 5)
            | (((codes >> 4) & 1) << 4)
            | (((codes >> 2) & 1) << 6)).astype(np.uint8)


@pytest.mark.parametrize("cap,tiles", [(16, 2), (64, 2), (255, 1)])
def test_pair_hits_plain_matches_pallas_and_oracle(cap, tiles):
    """Exact (int32) on read rows against the Pallas kernel of the cap's
    bucket (interpret mode, as tests/test_pallas_kernel.py runs it) and
    the numpy oracle, on planner-shaped streams."""
    codes = pk.planner_shaped_stream(np.random.default_rng(300 + cap),
                                     tiles * pk.PAIR_TILE, cap)
    read = ((codes >> 4) & 1) == 0
    got = pk.pair_hits(torch.from_numpy(codes), cap, cap).numpy()
    pallas = np.asarray(pair_hits_pallas(jnp.asarray(codes), jnp.int32(cap),
                                         cap=cap, interpret=True))
    oracle = jps.pair_hits_host(_oracle_packed(codes))
    assert np.array_equal(got[read], pallas[read])
    assert np.array_equal(got[read], oracle[read])


@pytest.mark.parametrize("window", [1, 7, 40])
def test_pair_hits_core_matches_jax_on_every_row(window):
    """The plain band core equals lime_tpu's _pair_hits_core on every
    row (genome rows too) of arbitrary codes, chunk edges included."""
    rng = np.random.default_rng(window)
    codes = rng.integers(0, 32, size=4096).astype(np.uint8)
    m, dr, gs, sym = (((codes >> 2) & 1).astype(bool),
                      ((codes >> 3) & 1).astype(bool),
                      ((codes >> 4) & 1).astype(bool),
                      (codes & 3).astype(np.int8))
    want = np.asarray(jps._pair_hits_core(
        jnp.asarray(m), jnp.asarray(dr), jnp.asarray(gs), jnp.asarray(sym),
        jnp.int32(window)))
    got = tps._pair_hits_core(torch.from_numpy(m), torch.from_numpy(dr),
                              torch.from_numpy(gs),
                              torch.from_numpy(sym.astype(np.int32)),
                              window).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cap", [16, 64, 255])
def test_planner_shaped_stream_copy_matches(cap):
    a = pk.planner_shaped_stream(np.random.default_rng(9), 20000, cap)
    b = jax_planner_shaped_stream(np.random.default_rng(9), 20000, cap)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("row_bits", [20, 24, 28])
def test_unpack_ports_match(row_bits):
    """_unpack_bits5 / _unpack_rows equal lime_tpu's, all 32 word bits
    exercised (u32 words travel as int32 bits)."""
    rng = np.random.default_rng(row_bits)
    groups = 512
    bits_b = rng.integers(0, 256, size=groups * 5).astype(np.uint8)
    rows_w = rng.integers(0, 1 << 32, size=groups * row_bits // 4,
                          dtype=np.uint64).astype(np.uint32)
    want_b = np.asarray(jps._unpack_bits5(jnp.asarray(bits_b)))
    want_r = np.asarray(jps._unpack_rows(jnp.asarray(rows_w), row_bits))
    got_b = tps._unpack_bits5(torch.from_numpy(bits_b)).numpy()
    got_r = tps._unpack_rows(torch.from_numpy(rows_w.view(np.int32)),
                             row_bits).numpy()
    assert np.array_equal(got_b, want_b.astype(np.int64))
    assert np.array_equal(got_r, want_r.astype(np.int64))


@pytest.mark.parametrize("bad", ["dtype", "length", "cap", "window",
                                 "strided"])
def test_pair_hits_rejects_bad_input(bad):
    codes = torch.zeros(pk.PAIR_TILE, dtype=torch.uint8)
    window, cap = 16, 16
    if bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "length":
        codes = codes[:1000]
    elif bad == "cap":
        cap = 32
    elif bad == "window":
        window = 256
    else:
        codes = torch.zeros(2 * pk.PAIR_TILE, dtype=torch.uint8)[::2]
    with pytest.raises(ValueError):
        pk.pair_hits(codes, window, cap)


def test_cpu_tensor_takes_plain_version_without_launch():
    pk.reset_launches()
    codes = torch.from_numpy(pk.planner_shaped_stream(
        np.random.default_rng(3), pk.PAIR_TILE, 16))
    got = pk.pair_hits(codes, 16, 16)
    assert torch.equal(got, pk.pair_hits_plain(codes, 16, 16))
    assert pk.LAUNCHES == {"scan16": 0, "scan64": 0, "band": 0}



# ---------------------------------------------------------------------------
# The CUDA kernel's rule and the invariant it rests on
# ---------------------------------------------------------------------------

def _starts(flags):
    """Segment starts: rows whose flag is clear, and row 0."""
    s = flags == 0
    s[0] = True
    return s


def _count_model(codes):
    """The segmented-count rule of ``pair_hits_count_kernel`` in numpy: a
    read row of symbol s hits iff its inclusive count of s within its
    document run is at most the count of s at its copy's last row (the
    genome run's count, when the copy ends in one genome run)."""
    n = len(codes)
    sym = (codes & 3).astype(np.int64)
    run_start = _starts(codes & 8)
    run = np.cumsum(run_start) - 1
    csum = np.cumsum(sym[:, None] == np.arange(4), axis=0)
    before = np.vstack([np.zeros((1, 4), np.int64), csum])
    cnt = csum - before[np.flatnonzero(run_start)[run]]
    copy = np.cumsum(_starts(codes & 4)) - 1
    copy_end = np.append(np.flatnonzero((codes[1:] & 4) == 0), n - 1)
    rows = np.arange(n)
    tail = cnt[copy_end[copy], sym]
    return (((codes & 0x10) == 0) & (tail >= cnt[rows, sym])).astype(
        np.int32)


def _real_chunks(ds):
    """Per planner chunk of every collection of ``ds``: (cap, window,
    unpacked 5-bit codes), unpacked as ``_pair_packed_block`` does."""
    from lime_tpu_torch import native
    from lime_tpu_torch.constants import SYMBOL_RANK_LUT
    from lime_tpu_torch.formats.arrays import open_da, open_ebwt, open_lcp
    from lime_tpu_torch.host import _DEGENERATE_BYTE

    out = []
    for col in ds.collections:
        arrays, chunks, windows, row_bits = native.plan_pairs_packed(
            open_lcp(col), open_da(col), open_ebwt(col), ds.num_reads, 16,
            SYMBOL_RANK_LUT, _DEGENERATE_BYTE.astype(np.uint8),
            dense_min=16, num_refs=ds.num_genomes, host_num=0)[:4]
        for bucket, codes in tps.chunk_codes(arrays, chunks, row_bits,
                                             torch.device("cpu")):
            out.append((pk.BUCKET_CAPS[bucket], windows[bucket],
                        codes.numpy()))
    return out


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """Deep coverage of short genomes: chunks of all three buckets."""
    return make_dataset(str(tmp_path_factory.mktemp("deep")), num_pairs=800,
                        read_len=100, genome_lens=(500, 400), seed=11)


@pytest.mark.parametrize("cap", [16, 64, 255])
def test_count_model_matches_plain_on_planner_shaped_chunks(cap):
    codes = pk.planner_shaped_chunk(np.random.default_rng(400 + cap),
                                    2 * pk.PAIR_TILE, cap)
    read = ((codes >> 4) & 1) == 0
    want = pk.pair_hits_plain(torch.from_numpy(codes), cap, cap).numpy()
    got = _count_model(codes)
    assert want[read].sum() > 1000
    assert np.array_equal(got[read], want[read])


@pytest.mark.parametrize("which", ["dataset", "deep"])
def test_count_model_matches_plain_on_real_chunks(request, which):
    chunks = _real_chunks(request.getfixturevalue(which))
    assert chunks
    for cap, window, codes in chunks:
        read = ((codes >> 4) & 1) == 0
        want = pk.pair_hits_plain(torch.from_numpy(codes), window,
                                  cap).numpy()
        assert np.array_equal(_count_model(codes)[read], want[read])
    if which == "deep":
        assert {cap for cap, _, _ in chunks} == set(pk.BUCKET_CAPS)


@pytest.mark.parametrize("which", ["dataset", "deep"])
def test_real_chunks_hold_the_kernel_invariant(request, which):
    """Every copy of a planner chunk ends in exactly one genome document
    run, and no document run or copy is longer than its bucket's cap."""
    for cap, _, codes in _real_chunks(request.getfixturevalue(which)):
        assert len(codes) % pk.PAIR_TILE == 0
        gs = (codes & 0x10) != 0
        run_start = _starts(codes & 8)
        copy_start = _starts(codes & 4)
        assert np.all(run_start[copy_start])  # runs never cross copies
        run = np.cumsum(run_start) - 1
        # a run is all read rows or all genome rows
        assert np.array_equal(gs, gs[np.flatnonzero(run_start)][run])
        copy = np.cumsum(copy_start) - 1
        genome_runs = np.bincount(copy[run_start & gs],
                                  minlength=copy[-1] + 1)
        assert np.all(genome_runs == 1)
        copy_end = np.append(np.flatnonzero(copy_start[1:]), len(codes) - 1)
        assert np.all(gs[copy_end])  # the genome run is the last run
        assert np.diff(np.flatnonzero(run_start), append=len(codes)).max() \
            <= cap
        assert np.diff(np.flatnonzero(copy_start), append=len(codes)).max() \
            <= cap


def test_kernel_ab_loads_another_checkout():
    """kernel_ab imports another checkout's pair_kernels on its own: here
    this checkout's, whose plain results it must reproduce."""
    import os

    from lime_tpu_torch import kernel_ab

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = kernel_ab.load_other(root)
    assert other is not pk and other.__name__ == "_other.ops.pair_kernels"
    codes = torch.from_numpy(pk.planner_shaped_chunk(
        np.random.default_rng(3), pk.PAIR_TILE, 64))
    assert torch.equal(other.pair_hits(codes, 64, 64),
                       pk.pair_hits(codes, 64, 64))


def test_kernel_ab_loads_another_checkouts_replay_modules():
    """``kernel_ab --kernel replay`` imports another checkout's
    ``ops.pair_score`` with the package-relative imports it needs (here
    this checkout's), which must score a chunk into a row block as this
    one does."""
    import os

    from lime_tpu_torch import kernel_ab
    from lime_tpu_torch.ops import pair_score

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = kernel_ab.load_other(root, "pair_score")
    assert other is not pair_score
    assert other.__name__ == "_other.ops.pair_score"
    assert other.pair_hits is not pk.pair_hits
    rng = np.random.default_rng(5)
    codes = pk.planner_shaped_chunk(rng, pk.PAIR_TILE, 16)
    n, row_bits = codes.shape[0], 20
    rows = rng.integers(0, 300, n)
    words = np.zeros(n // 8 * (row_bits // 4), np.uint32)
    for j in range(8):  # pack 8 rows of row_bits per group
        off = row_bits * j
        a, sh = off >> 5, off & 31
        grp = words.reshape(-1, row_bits // 4)
        v = rows[j::8].astype(np.uint64)
        grp[:, a] |= ((v << np.uint64(sh)) & np.uint64(0xFFFFFFFF)).astype(
            np.uint32)
        if sh + row_bits > 32:
            grp[:, a + 1] |= (v >> np.uint64(32 - sh)).astype(np.uint32)
    bits = np.zeros(n // 8 * 5, np.uint8)
    for j in range(8):  # pack 8 codes of 5 bits per 5-byte group
        off = 5 * j
        a, sh = off >> 3, off & 7
        grp = bits.reshape(-1, 5)
        v = codes[j::8].astype(np.uint16)
        grp[:, a] |= ((v << sh) & 255).astype(np.uint8)
        if sh + 5 > 8:
            grp[:, a + 1] |= (v >> (8 - sh)).astype(np.uint8)
    args = (torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
            torch.zeros(4096, dtype=torch.int16), 16)
    assert torch.equal(pair_score._unpack_rows(args[0], row_bits),
                       torch.from_numpy(rows))
    stacks = [torch.zeros((2, 128, 8), dtype=torch.int8) for _ in range(2)]
    for mod, stack in zip((other, pair_score), stacks):
        mod._pair_packed_block_offset(stack, 1, *args, 100, row_bits, 16)
    assert stacks[1][1].any() and torch.equal(stacks[0], stacks[1])
