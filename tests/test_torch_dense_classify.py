"""Dense histogram-matmul chunks and the classify program: torch port vs
JAX.  All comparisons are exact: int8/int32 counters, types and taxids
equal, float32 sims bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu import native
from lime_tpu.constants import NUM_RANKS, SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.ops import dense_score as jds
from lime_tpu.ops import fused_pipeline as jfp
from lime_tpu_torch import host
from lime_tpu_torch.ops import classify_torch as ct
from lime_tpu_torch.ops.dense_score import _dense_chunk

from .synth_big import make_big_dataset

# build and load the native library before any test, whatever the
# other test processes do (lime_tpu_torch.host.ensure_native)
host.ensure_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def conserved(tmp_path_factory):
    """Genomes sharing mutated group templates: genome-dense clusters."""
    root = tmp_path_factory.mktemp("conserved")
    return make_big_dataset(str(root), num_pairs=3000, num_genomes=12,
                            genome_len=3000, conserved_frac=0.3,
                            group_size=6, seed=3)


@pytest.mark.parametrize("use_ebwt", [True, False])
def test_dense_chunk_matches_jax(conserved, use_ebwt):
    ds = conserved
    col = ds.collections[0]
    ebwt = open_ebwt(col) if use_ebwt else None
    da = open_da(col)
    out = native.plan_pairs_packed(
        open_lcp(col), da, ebwt, ds.num_reads, 16, SYMBOL_RANK_LUT,
        host._DEGENERATE_BYTE.astype(np.uint8), dense_min=4,
        num_refs=ds.num_genomes, host_num=0)
    dense_start, dense_len = out[4], out[5]
    g_pad = host._g_pad_for(ds.num_genomes)
    r_pad = host._r_pad_for(ds.num_reads)
    chunks, _, _ = host.pack_chunks(dense_start, dense_len, da, ebwt,
                                    ds.num_reads, ds.num_genomes, g_pad)
    assert chunks
    f = (4 if use_ebwt else 1) * host.K
    want = jnp.zeros((r_pad, g_pad), jnp.int8)
    got = torch.zeros((r_pad, g_pad), dtype=torch.int8)
    for ridx, gidx, cmap, rid in chunks:
        want = jds._dense_chunk(want, jnp.asarray(ridx), jnp.asarray(gidx),
                                jnp.asarray(cmap), jnp.asarray(rid),
                                host.B_BLK, host.C_BLK, host.PR, f, g_pad)
        _dense_chunk(got, *(torch.from_numpy(a)
                            for a in (ridx, gidx, cmap, rid)),
                     host.B_BLK, host.C_BLK, host.PR, f, g_pad)
    want = np.asarray(want)
    assert np.any(want[:ds.num_reads])
    assert np.array_equal(got.numpy()[:ds.num_reads],
                          want[:ds.num_reads])


def test_dense_chunk_real_index_out_of_range_raises():
    """Pads land in the sink slot; an index past it is an error, not a
    silent drop."""
    b_blk, c_blk, pr, f, g_pad = 4, 2, 8, 8, 128
    ridx = torch.tensor([0, b_blk * pr * f + 1], dtype=torch.int32)
    gidx = torch.tensor([c_blk * g_pad * f], dtype=torch.int32)
    cmap = torch.zeros(b_blk, dtype=torch.int32)
    rid = torch.zeros(b_blk * pr, dtype=torch.int32)
    sim = torch.zeros((8, g_pad), dtype=torch.int8)
    with pytest.raises((IndexError, RuntimeError)):
        _dense_chunk(sim, ridx, gidx, cmap, rid, b_blk, c_blk, pr, f, g_pad)


def _random_planes(rng, F, r_pad, g_pad, num_genomes, wide):
    """Sparse counters with ties; int8 planes hold wrapped u8 bits."""
    planes = np.zeros((F, r_pad, g_pad), np.int32 if wide else np.int8)
    hi = 400 if wide else 256
    vals = rng.integers(0, hi, size=(F, r_pad, num_genomes))
    keep = rng.random((F, r_pad, num_genomes)) < 0.15
    body = np.where(keep, vals, 0)
    planes[:, :, :num_genomes] = body if wide else body.astype(np.uint8
                                                               ).view(np.int8)
    rows = np.arange(r_pad)
    tie = rng.integers(0, num_genomes - 3, size=r_pad)
    for j in (1, 2):
        planes[:, rows, tie + j] = planes[:, rows, tie]
    return planes


def _corrections(rng, F, num_reads, num_genomes, pads):
    k = 300
    cfile = rng.integers(0, F, size=k).astype(np.int32)
    crows = rng.integers(0, num_reads, size=k).astype(np.int32)
    ccols = rng.integers(0, num_genomes, size=k).astype(np.int32)
    cvals = rng.integers(0, 256, size=k).astype(np.int32)
    if pads:  # the JAX program's bucket padding: file index F
        cfile = np.pad(cfile, (0, pads), constant_values=F)
        crows = np.pad(crows, (0, pads))
        ccols = np.pad(ccols, (0, pads))
        cvals = np.pad(cvals, (0, pads))
    return cfile, crows, ccols, cvals


@pytest.mark.parametrize("F,assign_higher,wide,corr", [
    (4, False, False, False),
    (4, True, False, True),
    (2, True, False, True),
    (2, False, False, False),
    (4, True, True, True),
])
def test_classify_program_matches_jax(F, assign_higher, wide, corr):
    rng = np.random.default_rng(F * 10 + assign_higher * 2 + wide)
    num_reads, num_genomes = 1000, 37
    r_pad = host._r_pad_for(num_reads)
    g_pad = host._g_pad_for(num_genomes)
    block = host._classify_block_for(num_reads)
    read_len = 300 if wide else 100
    alpha, beta, error, tax_rank = 16, 0.25, 0.02, 1
    planes = _random_planes(rng, F, r_pad, g_pad, num_genomes, wide)
    tax = np.zeros(g_pad, np.int64)
    tax[:num_genomes] = 1000 + np.arange(num_genomes) // 3
    rank = np.zeros((NUM_RANKS, g_pad), np.int64)
    for lv in range(NUM_RANKS):
        rank[lv, :num_genomes] = 1000 + np.arange(num_genomes) // (3 << lv)
    cfile, crows, ccols, cvals = (
        _corrections(rng, F, num_reads, num_genomes, pads=212) if corr
        else (np.empty(0, np.int32),) * 4)
    norm = np.float32(np.uint32(read_len + 1 - alpha))

    want = np.asarray(jfp._classify_program_planes(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(crows),
        jnp.asarray(ccols), jnp.asarray(cvals), jnp.asarray(cfile),
        jnp.asarray(tax.astype(np.uint32)),
        jnp.asarray(rank.astype(np.uint32)),
        jnp.asarray(np.arange(g_pad) < num_genomes), jnp.float32(error),
        jnp.float32(norm), jnp.float32(beta), F, tax_rank, assign_higher,
        not wide, block))

    dev = torch.device("cpu")
    buf, stack = ct.alloc_planes(F, r_pad, g_pad,
                                 torch.int32 if wide else torch.int8, dev)
    for f, p in enumerate(ct.planes_from_numpy(list(planes), dev)):
        stack[f].copy_(p)
    assert all(np.array_equal(a, b) for a, b in
               zip(ct.planes_to_numpy(stack), planes))
    vdt = np.int32 if wide else np.int8
    got = ct._classify_program_planes(
        buf, F, r_pad, g_pad, torch.from_numpy(crows),
        torch.from_numpy(ccols), torch.from_numpy(cvals.astype(vdt)),
        torch.from_numpy(cfile), torch.from_numpy(tax),
        torch.from_numpy(rank), torch.arange(g_pad) < num_genomes,
        torch.tensor(np.float32(error)), torch.tensor(norm),
        torch.tensor(np.float32(beta)), tax_rank, assign_higher, not wide,
        block).numpy()
    wt, wx, ws = jfp._unpack_triplet(want)
    gt, gx, gs = ct._unpack_triplet(got)
    assert np.array_equal(gt[:num_reads], wt[:num_reads])
    assert np.array_equal(gx[:num_reads], wx[:num_reads])
    assert np.array_equal(gs[:num_reads].view(np.uint32),
                          ws[:num_reads].view(np.uint32))
    # the stages all ran: C, and A (or, with assign_higher, H) verdicts
    kinds = set(np.unique(gt[:num_reads]).tolist())
    assert {1, 3 if assign_higher else 2} <= kinds
    if corr:  # the pads went to the sink element, nowhere else
        assert buf[-1].item() == 0
