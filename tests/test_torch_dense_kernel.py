"""The dense kernel's formulation, on the CPU (``csrc/dense_pairs.cu``).

The kernel rests on what the native planner guarantees of a
``host.pack_chunks`` chunk: read triples strictly ascending (so by
entry), genome triples ascending by cluster, each (cluster, genome)
pair's triples contiguous with ascending features, no feature twice.
Those invariants are held here on real chunks at the three plane widths
of the benchmark's databases (G_pad 1,024, 3,456 and, past the plain
version's column tiles, 4,224).  A numpy model of the kernel's
arithmetic (a 32-bit mask per read lane and per (cluster, genome) run,
``popc`` of the two, zero scores skipped, int8 wrapping) is held equal to
the plain version (``dense_score._dense_rows`` and its row scatter) on
those chunks, on a row block, and on synthetic chunks whose sums wrap;
the plain version's cell count equals the model's.  The CUDA kernel is
held to the plain version on the card (``tests/test_torch_cuda.py``).

The file imports no jax: the CUDA tests import its helpers.
"""

import numpy as np
import pytest
import torch

from lime_tpu_torch import host, native
from lime_tpu_torch.constants import SYMBOL_RANK_LUT
from lime_tpu_torch.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu_torch.ops import dense_kernels
from lime_tpu_torch.ops import dense_score as tds
from lime_tpu_torch.synth_big import make_big_dataset

# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)

#: genome counts of the three widths (G_pad 1,024, 3,456 and 4,224)
WIDTHS = (930, 3423, 4200)
SHAPE = (host.B_BLK, host.C_BLK, host.PR)


def width_dataset(root: str, genomes: int):
    """A small sample against ``genomes`` short genomes whose conserved
    group blocks make genome-dense clusters."""
    return make_big_dataset(root, num_pairs=400, num_genomes=genomes,
                            genome_len=240, insert_len=150,
                            conserved_frac=0.25,
                            group_size=64, seed=genomes)


def dense_chunks(ds, use_ebwt: bool = True, fi: int = 0):
    """``(chunks, g_pad, f)``: ``pack_chunks``' dense chunks of collection
    ``fi``, as the fused path plans them."""
    col = ds.collections[fi]
    da = open_da(col)
    ebwt = open_ebwt(col) if use_ebwt else None
    out = native.plan_pairs_packed(
        open_lcp(col), da, ebwt, ds.num_reads, 16, SYMBOL_RANK_LUT,
        host._DEGENERATE_BYTE.astype(np.uint8), dense_min=4,
        num_refs=ds.num_genomes, host_num=0)
    g_pad = host._g_pad_for(ds.num_genomes)
    chunks = host.pack_chunks(out[4], out[5], da, ebwt, ds.num_reads,
                              ds.num_genomes, g_pad)[0]
    return chunks, g_pad, (4 if use_ebwt else 1) * host.K


def shrink(chunk, b_blk, c_blk, pr, f, g_pad):
    """The same chunk with ``b_blk`` and ``c_blk`` cut to the entries and
    clusters it uses (pads re-valued), so the plain version's feature
    tensors stay small on the CPU.  Returns ``(chunk, b_blk, c_blk)``."""
    ridx, gidx, cmap, rid = chunk
    real = ridx[ridx != b_blk * pr * f]
    b = int(real.max()) // (pr * f) + 1
    c = int(cmap[:b].max()) + 1
    ridx = np.where(ridx == b_blk * pr * f, b * pr * f, ridx)
    gidx = np.where(gidx == c_blk * g_pad * f, c * g_pad * f, gidx)
    return ((ridx.astype(np.int32), gidx.astype(np.int32),
             cmap[:b].copy(), rid[:b * pr].copy()), b, c)


def popcount_model(plane: np.ndarray, chunk, b_blk: int, c_blk: int,
                   pr: int, f: int, g_pad: int, row_base=None) -> int:
    """The kernel's arithmetic in numpy, into ``plane`` (int8 or int32, in
    place): per read lane the OR of its features' bits, per (cluster,
    genome) run of genome triples the OR of its bits, then for every
    lane that carries a read and every run of its entry's cluster
    ``popc(lane & run)`` added at (the lane's row, the genome's column)
    where it is nonzero; with ``row_base`` only lanes whose row falls in
    the ``plane.shape[0]`` rows from it.  Returns the cells scored
    (lanes times their cluster's runs)."""
    ridx, gidx, cmap, rid = (np.asarray(a, np.int64) for a in chunk)
    r = ridx[ridx != b_blk * pr * f]
    lane_mask = np.zeros(b_blk * pr, np.uint32)
    np.bitwise_or.at(lane_mask, r // f, (1 << (r % f)).astype(np.uint32))
    g = gidx[gidx != c_blk * g_pad * f]
    key = g // f
    head = np.ones(len(key), bool)
    head[1:] = key[1:] != key[:-1]
    run = np.cumsum(head) - 1
    run_mask = np.zeros(int(head.sum()), np.uint32)
    np.bitwise_or.at(run_mask, run, (1 << (g % f)).astype(np.uint32))
    run_cl, run_col = key[head] // g_pad, key[head] % g_pad
    rows = rid - (0 if row_base is None else row_base)
    active = (lane_mask != 0) & (rows >= 0) & (rows < plane.shape[0])
    wide = plane.astype(np.int64)
    cells = 0
    for e in np.flatnonzero(active.reshape(b_blk, pr).any(1)):
        lanes = e * pr + np.flatnonzero(active[e * pr:(e + 1) * pr])
        lo, hi = np.searchsorted(run_cl, [cmap[e], cmap[e] + 1])
        s = np.bitwise_and.outer(lane_mask[lanes], run_mask[lo:hi])
        s = np.unpackbits(s.view(np.uint8), axis=-1).reshape(
            len(lanes), hi - lo, 32).sum(-1)
        li, gi = np.nonzero(s)  # a zero score adds nothing
        np.add.at(wide, (rows[lanes][li], run_col[lo:hi][gi]), s[li, gi])
        cells += len(lanes) * (hi - lo)
    plane[...] = wide.astype(plane.dtype)  # int8 wraps mod 256
    return cells


def synthetic_chunk(rng, b_blk: int, c_blk: int, pr: int, f: int,
                    g_pad: int, num_genomes: int, rows: int,
                    max_genomes: int = 90, density: float = 0.3):
    """A chunk laid out as ``pack_chunks`` lays one out: clusters of 1 to
    3 entries, distinct reads per cluster (pad lanes on the drop row
    ``rows - 1``), each lane and each of up to ``max_genomes`` genomes
    (in no column order) a random non-empty feature set; the triples'
    pads to a power of two."""
    ridx, gidx = [], []
    cmap = np.zeros(b_blk, np.int32)
    rid = np.full(b_blk * pr, rows - 1, np.int32)

    def feats():
        got = np.flatnonzero(rng.random(f) < density)
        return got if len(got) else rng.integers(0, f, 1)

    e = 0
    for c in range(c_blk):
        n_ent = int(rng.integers(1, 4))
        if e + n_ent > b_blk:
            break
        n_reads = int(rng.integers((n_ent - 1) * pr + 1, n_ent * pr + 1))
        for i, read in enumerate(rng.choice(rows - 1, n_reads,
                                            replace=False)):
            ent, lane = e + i // pr, i % pr
            rid[ent * pr + lane] = read
            ridx.extend(ent * pr * f + lane * f + feats())
        cmap[e:e + n_ent] = c
        n_g = int(rng.integers(1, max_genomes + 1))
        for gcol in rng.choice(num_genomes, n_g, replace=False):
            gidx.extend(c * g_pad * f + gcol * f + feats())
        e += n_ent

    def padded(vals, pad):
        out = np.full(host._pad_p2(len(vals), 1 << 10), pad, np.int32)
        out[:len(vals)] = vals
        return out

    return (padded(ridx, b_blk * pr * f), padded(gidx, c_blk * g_pad * f),
            cmap, rid)


def wrapping_chunk(f: int, g_pad: int, rows: int, row: int = 3,
                   col: int = 5):
    """Clusters of one entry each whose lane 0 (read ``row``) and genome
    ``col`` carry all ``f`` features: ``256 // f + 1`` of them add more
    than 255 at (``row``, ``col``), which an int8 plane wraps.  Returns
    ``(chunk, b_blk, c_blk)``."""
    n = 256 // f + 1
    pr = host.PR
    ridx = np.concatenate([e * pr * f + np.arange(f) for e in range(n)])
    gidx = np.concatenate([c * g_pad * f + col * f + np.arange(f)
                           for c in range(n)])
    rid = np.full(n * pr, rows - 1, np.int32)
    rid[::pr] = row
    return ((ridx.astype(np.int32), gidx.astype(np.int32),
             np.arange(n, dtype=np.int32), rid), n, n)


def plain_plane(chunks, rows, g_pad, dtype, b_blk, c_blk, pr, f, status,
                row_base=None, init=None):
    """The plain version over ``chunks`` into a fresh CPU plane (a row
    block from ``row_base`` if given), starting from ``init``; its cell
    count into ``status``."""
    plane = torch.zeros((rows, g_pad), dtype=dtype) if init is None \
        else init.clone()
    for chunk in chunks:
        arrs = [torch.from_numpy(np.ascontiguousarray(a)) for a in chunk]
        if row_base is None:
            tds._dense_chunk(plane, *arrs, b_blk, c_blk, pr, f, g_pad,
                             status)
        else:
            tds._dense_chunk_offset(plane[None], 0, *arrs, row_base, b_blk,
                                    c_blk, pr, f, g_pad,
                                    np.unique(chunk[3]), status)
    return plane


@pytest.fixture(scope="module", params=WIDTHS,
                ids=[f"g{g}" for g in WIDTHS])
def width(request, tmp_path_factory):
    return width_dataset(str(tmp_path_factory.mktemp(
        f"dense_w{request.param}")), request.param)


@pytest.mark.parametrize("use_ebwt", [True, False], ids=["ebwt", "no_ebwt"])
def test_pack_chunks_keep_the_kernel_invariants(width, use_ebwt):
    """What the kernel's search and run walk rest on, on real chunks."""
    chunks, g_pad, f = dense_chunks(width, use_ebwt)
    assert chunks
    b_blk, c_blk, pr = SHAPE
    for ridx, gidx, cmap, rid in chunks:
        r_pad, g_pad_v = b_blk * pr * f, c_blk * g_pad * f
        real = ridx[ridx != r_pad]
        # pads only at the end; read triples strictly ascending, so no
        # (lane, s, k) feature twice and entries in order
        assert np.all(ridx[len(real):] == r_pad)
        assert np.all(np.diff(real.astype(np.int64)) > 0)
        g = gidx[gidx != g_pad_v].astype(np.int64)
        assert np.all(gidx[len(g):] == g_pad_v)
        # genome triples ascend by cluster
        assert np.all(np.diff(g // (g_pad * f)) >= 0)
        # a (cluster, genome) pair's triples are one run, features
        # ascending in it (so none twice)
        key = g // f
        head = np.ones(len(key), bool)
        head[1:] = key[1:] != key[:-1]
        assert head.sum() == len(np.unique(key))
        assert np.all(np.diff(g)[~head[1:]] > 0)
        # every entry that carries a read maps to a cluster with genomes
        lanes = np.unique(real // f)
        ents = np.unique(lanes // pr)
        assert np.all(np.isin(cmap[ents], np.unique(key // g_pad)))
        assert np.all(rid[lanes] < width.num_reads)
        pads = np.setdiff1d(np.arange(b_blk * pr), lanes)
        assert np.all(rid[pads] == width.num_reads)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32],
                         ids=["int8", "int32"])
def test_popcount_model_matches_plain(width, dtype):
    """The kernel's formulation equals ``_dense_rows`` + ``index_add_``
    on every chunk of a collection, planes and cell counts."""
    chunks, g_pad, f = dense_chunks(width)
    rows = width.num_reads + 1
    want = torch.zeros((rows, g_pad), dtype=dtype)
    got = np.zeros((rows, g_pad), want.numpy().dtype)
    cells = 0
    status = dense_kernels.new_status("cpu")
    for chunk in chunks:
        small, b, c = shrink(chunk, *SHAPE, f, g_pad)
        want = plain_plane([small], rows, g_pad, dtype, b, c, host.PR, f,
                           status, init=want)
        cells += popcount_model(got, small, b, c, host.PR, f, g_pad)
    assert dense_kernels.take(status) == cells
    assert np.any(got[:width.num_reads])
    assert np.array_equal(got, want.numpy())


def test_popcount_model_matches_plain_row_block(width):
    """A row block in the middle of the reads, lanes on both sides of
    both edges: the model drops the lanes outside it as the plain
    version does."""
    chunks, g_pad, f = dense_chunks(width)
    base, B = 100, 160
    got = np.zeros((B, g_pad), np.int8)
    want = torch.zeros((B, g_pad), dtype=torch.int8)
    status = dense_kernels.new_status("cpu")
    cells = 0
    for chunk in chunks:
        small, b, c = shrink(chunk, *SHAPE, f, g_pad)
        rows = small[3]
        assert np.any(rows < base) and np.any((rows >= base + B)
                                              & (rows < width.num_reads))
        want = plain_plane([small], B, g_pad, torch.int8, b, c, host.PR, f,
                           status, row_base=base, init=want)
        cells += popcount_model(got, small, b, c, host.PR, f, g_pad,
                                row_base=base)
    assert dense_kernels.take(status) == cells
    assert np.any(got)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("f", [32, 8])
def test_popcount_model_wraps_like_plain(f):
    """One cell past 255 (more clusters than 255 // f hit it): both wrap
    mod 256 in int8, int32 keeps the sum; nothing else is touched."""
    g_pad, rows = 128, 8
    chunk, b, c = wrapping_chunk(f, g_pad, rows)
    for dtype, total in ((torch.int8, ((256 // f + 1) * f) % 256),
                         (torch.int32, (256 // f + 1) * f)):
        status = dense_kernels.new_status("cpu")
        want = plain_plane([chunk], rows, g_pad, dtype, b, c, host.PR, f,
                           status)
        got = np.zeros((rows, g_pad), want.numpy().dtype)
        assert popcount_model(got, chunk, b, c, host.PR, f, g_pad) == b
        assert dense_kernels.take(status) == b
        assert np.array_equal(got, want.numpy())
        assert int(want[3, 5]) == total
        assert int(torch.count_nonzero(want)) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_popcount_model_matches_plain_synthetic(seed):
    """Synthetic planner-shaped chunks with up to 90 genomes a cluster
    (runs across the kernel's 32-triple windows), both feature widths
    and a drop row that starts non-zero and stays as it was."""
    rng = np.random.default_rng(seed)
    b_blk, c_blk, pr, g_pad, rows = 64, 32, host.PR, 384, 50
    for f in (32, 8):
        chunk = synthetic_chunk(rng, b_blk, c_blk, pr, f, g_pad, 300, rows)
        init = torch.zeros((rows, g_pad), dtype=torch.int8)
        init[rows - 1] = torch.arange(g_pad, dtype=torch.int8)
        status = dense_kernels.new_status("cpu")
        want = plain_plane([chunk], rows, g_pad, torch.int8, b_blk, c_blk,
                           pr, f, status, init=init)
        got = init.numpy().copy()
        assert popcount_model(got, chunk, b_blk, c_blk, pr, f,
                              g_pad) == dense_kernels.take(status)
        assert np.array_equal(got, want.numpy())
        assert torch.equal(want[rows - 1], init[rows - 1])
