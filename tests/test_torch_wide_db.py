"""The port past 4,096 genomes, where the cascade's read block and the
dense products' genome-column tiles are derived from the plane width.

Up to G_pad 3,456 (a 3,423-genome database) the cascade walks 16,384-read
blocks and every dense product spans the whole width, as before; past it
the block shrinks and the products run in column tiles, so the
temporaries beside the score planes stay the size they have at 3,456
columns.  Here a 4,200-genome database (G_pad 4,224, two column tiles)
with genome-dense clusters is classified by the fused path, on the device,
hybrid, all-host and row-blocked, and held against lime_tpu's host
executor and fused run and against the benchmark's plain reference, byte
for byte; with the block and the tiles forced small, in one block and
row-blocked, every CSV is the same bytes.  The derivations are checked at today's widths (no
change) and at GTDB R89's 24,832.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.data.dataset import make_dataset
from benchmark.reference import plain
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu_torch import LimeConfig, host, native, run_paired
from lime_tpu_torch.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu_torch.ops import classify_torch as tct
from lime_tpu_torch.ops import dense_kernels
from lime_tpu_torch.ops import dense_score as tds
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.ops.classify_torch import cascade_block_for

from .test_torch_dense_kernel import popcount_model
from .test_torch_selfcontained import ensure_reference_native, jax_config

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE_GENOMES = 4200
FUSED = LimeConfig(fused=True)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _config():
    """setB2's sample shape against 4,200 short genomes; a fifth of each
    genome is its group's conserved block (40 bp), which makes the
    genome-dense clusters."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "setB2_930.json")) as f:
        config = json.load(f)
    config.update(genomes=WIDE_GENOMES, genome_len=200, insert_len=150,
                  conserved_frac=0.2,
                  taxa={"species": 4200, "genus": 1400, "family": 450,
                        "order": 150, "class": 50, "phylum": 20})
    return config


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """(dataset, the plain reference's CSV bytes); lime_tpu's host
    executor and fused run write the same bytes."""
    config = _config()
    root = str(tmp_path_factory.mktemp("wide"))
    ds = make_dataset(config, {"pairs_per_job": 300}, (1 << 31) + 77,
                      root, "cpu")
    planes = []
    for path in ds.collections:
        ebwt, lcp, da = plain.load_index(path, "cpu")
        p_start, lens = plain.find_clusters(lcp, da, ds.num_reads,
                                            int(config["alpha"]))
        planes.append(plain.score_matrix(ebwt, da, p_start, lens,
                                         ds.num_reads, ds.num_genomes))
    lines = plain.csv_lines(*plain.classify(
        planes, ds.read_len, int(config["alpha"]), config["beta"],
        config["error_tolerance"], ds.taxa_at(int(config["tax_rank"]))))
    want = ("\n".join(lines) + "\n").encode()
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    for name, cfg in (("host", LimeConfig(executor="host")),
                      ("fused", FUSED)):
        out = os.path.join(root, f"jax_{name}.csv")
        jax_run_paired(ds.collections, out, *args, jax_config(cfg))
        assert _read(out) == want, name
    return ds, want


@pytest.fixture(scope="module")
def wide_cells(wide):
    """``cells(host_num=0)``: the cells the dense kernel scores in a run
    (the plain version counts the same), lanes that carry a read times
    their cluster's genomes, from the numpy model of the kernel over
    every dense chunk of the four collections as the fused path plans
    them with ``host_num`` 256ths of the clusters on the host.  At 256
    that is the job shop's plan: the light scan, its pair-heavy clusters
    offloaded (under the run's ``LIME_DENSE_OFFLOAD_MIN``).  A row-blocked
    run plans as the one-block run of its host share, and each lane lies
    in one row block."""
    ds = wide[0]
    g_pad = host._g_pad_for(ds.num_genomes)
    f = 4 * host.K
    memo = {}

    def plan(col, da, ebwt, host_num):
        if host_num < 256:
            return tfp._plan_pairs(open_lcp(col), da, ebwt, ds.num_reads,
                                   ds.num_genomes, FUSED, host_num)[4:6]
        starts, lens, nrr = native.plan_clusters(
            open_lcp(col), da, ds.num_reads, FUSED.alpha, threads=1,
            return_nr=True)
        big = tfp._dense_offload(starts, lens, nrr)
        return starts[big], lens[big]

    def cells(host_num=0):
        if host_num in memo:
            return memo[host_num]
        n = 0
        for col in ds.collections:
            da, ebwt = open_da(col), open_ebwt(col)
            den_s, den_l = plan(col, da, ebwt, host_num)
            for chunk in host.pack_chunks(den_s, den_l, da, ebwt,
                                          ds.num_reads, ds.num_genomes,
                                          g_pad)[0]:
                plane = np.zeros((ds.num_reads + 1, g_pad), np.int32)
                n += popcount_model(plane, chunk, host.B_BLK, host.C_BLK,
                                    host.PR, f, g_pad)
        assert n > 0
        memo[host_num] = n
        return n

    return cells


def _status():
    return dense_kernels.new_status("cpu")


def _tiles(g_pad):
    """``(c0, w)`` of each genome-column tile of the dense products."""
    tile = tds.dense_tile_for(g_pad)
    return [(c0, min(tile, g_pad - c0)) for c0 in range(0, g_pad, tile)]


def _run(ds, out, cfg=FUSED):
    run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, cfg, device="cpu")
    return dict(tfp.LAST_RUN)


def test_wide_fused_matches_plain_reference(wide, wide_cells, tmp_path):
    ds, want = wide
    g_pad = host._g_pad_for(ds.num_genomes)
    assert g_pad == 4224
    out = str(tmp_path / "fused.csv")
    run = _run(ds, out)
    assert _read(out) == want
    assert run["engine"] == "pair" and run["dense_chunks"] > 0
    counts = run["counts"]
    lanes = run["dense_chunks"] * host.B_BLK * host.PR
    assert counts["dense_lanes_total"] == lanes
    # the plain version's two tiles of 2,176 columns, the second's last
    # 128 empty; the cells are the kernel's, whatever the tiles
    assert [w for _, w in _tiles(g_pad)] == [2176, 2048]
    assert counts["dense_cells"] == wide_cells()
    assert 0 < counts["dense_lanes"] < lanes
    # 301 rows: one 512-read block, within the 3,456-column tile bound
    assert counts["cascade_block"] == 512


@pytest.mark.parametrize("frac,budget", [
    (0.0, None),   # pair streams, dense chunks on the device
    (0.5, None),   # hybrid: the host share as sparse COO
    (1.0, None),   # all-host job shop, its dense offload forced on:
                   # dense chunks dispatched per job
    (0.0, "1"),    # row-blocked: dense chunks replayed per row block
    (0.5, "1"),    # row-blocked hybrid
], ids=["device", "hybrid", "all-host", "blocked", "blocked-hybrid"])
def test_wide_matches_jax_and_host(wide, wide_cells, tmp_path, monkeypatch,
                                   frac, budget):
    """Every engine of the fused path at G_pad 4,224 writes the bytes of
    lime_tpu's host executor and fused run (the fixture holds those to
    the plain reference's)."""
    ds, want = wide
    if budget is not None:
        monkeypatch.setenv("LIME_HBM_BUDGET", budget)
    if frac == 1.0:
        # a run this small keeps its dense clusters on the host unless
        # told, and its clusters are under the offload's pair minimum
        # (256): 128 offloads 38-119 of a collection's 8,300-8,900
        monkeypatch.setenv("LIME_DENSE_OFFLOAD", "1")
        monkeypatch.setenv("LIME_DENSE_OFFLOAD_MIN", "128")
    out = str(tmp_path / "torch.csv")
    run = _run(ds, out, FUSED.replace(host_frac=frac))
    assert _read(out) == want
    assert run["host_num"] == round(frac * 256)
    assert run["engine"] == ("blocked" if budget else
                             "all_host" if frac == 1.0 else "pair")
    assert run["dense_chunks"] > 0
    counts = run["counts"]
    assert counts["dense_cells"] == wide_cells(run["host_num"])
    # each lane that carries a read meets one to all genomes
    assert (0 < counts["dense_lanes"] <= counts["dense_cells"]
            <= counts["dense_lanes"] * ds.num_genomes)


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["one-block", "row-blocked"])
def test_wide_forced_small_tiles_are_byte_identical(wide, wide_cells,
                                                    tmp_path, monkeypatch,
                                                    blocked):
    """Cascade blocks of 128 reads (4 a 512-row block) and dense tiles of
    640 columns (6, then one of 384): the same CSV bytes."""
    ds, want = wide
    if blocked:
        monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    # the cascade's own clamp, and the counter that reports it
    monkeypatch.setattr(tct, "cascade_block_for", lambda block, g_pad: 128)
    monkeypatch.setattr(tfp, "cascade_block_for", lambda block, g_pad: 128)
    monkeypatch.setattr(tds, "dense_tile_for", lambda g_pad: 640)
    out = str(tmp_path / "forced.csv")
    run = _run(ds, out)
    assert _read(out) == want
    assert run["engine"] == ("blocked" if blocked else "pair")
    assert run.get("blocks", 1) == 1
    counts = run["counts"]
    assert counts["cascade_block"] == 128
    lanes = run["dense_chunks"] * host.B_BLK * host.PR
    assert counts["dense_lanes_total"] == lanes
    assert counts["dense_cells"] == wide_cells()


@pytest.mark.parametrize("g_pad", [128, 1024, 2048, 3456])
def test_block_and_tiles_unchanged_up_to_3456(g_pad):
    for shift in range(8, 15):
        assert cascade_block_for(1 << shift, g_pad) == 1 << shift
    assert tds.dense_tile_for(g_pad) == g_pad
    assert _tiles(g_pad) == [(0, g_pad)]


@pytest.mark.parametrize("g_pad,block,tiles", [
    (3584, 8192, 2), (4224, 8192, 2), (24832, 2048, 8), (65536, 512, 19)])
def test_block_and_tiles_past_3456(g_pad, block, tiles):
    """The cascade's float32 tiles and the dense products stay within
    their size at G_pad 3,456; the block divides every 16,384-read one."""
    got = cascade_block_for(1 << 14, g_pad)
    assert got == block and (1 << 14) % got == 0
    assert got * g_pad <= (1 << 14) * 3456 < 2 * got * g_pad
    cols = _tiles(g_pad)
    assert len(cols) == tiles
    assert [c0 for c0, _ in cols] == list(
        np.cumsum([0] + [w for _, w in cols[:-1]]))
    assert sum(w for _, w in cols) == g_pad
    assert all(w % 128 == 0 and w <= 3456 for _, w in cols)


def _random_chunk(rng, b_blk, c_blk, pr, f, g_pad, n_r, n_g, rows):
    """A chunk's arrays with pads: read and genome triples, each entry's
    cluster, each lane's read row (the drop row ``rows - 1`` for pads)."""
    ridx = np.full(n_r + 5, b_blk * pr * f, np.int32)
    ridx[:n_r] = rng.integers(0, b_blk * pr * f, n_r)
    gidx = np.full(n_g + 5, c_blk * g_pad * f, np.int32)
    gidx[:n_g] = rng.integers(0, c_blk * g_pad * f, n_g)
    cmap = rng.integers(0, c_blk, b_blk).astype(np.int32)
    rid = rng.integers(0, rows, b_blk * pr).astype(np.int32)
    rid[-pr:] = rows - 1
    return [torch.from_numpy(a) for a in (ridx, gidx, cmap, rid)]


@pytest.mark.parametrize("tile", [128, 384, 1280])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_dense_tiles_equal_whole_product(monkeypatch, tile, dtype):
    """Each column tile of a chunk (pads included, repeated triples, int8
    wrapping) is the whole product's, into the plane and into a row
    block of the stack."""
    b_blk, c_blk, pr, f, g_pad, rows = 16, 8, 8, 32, 1280, 40
    rng = np.random.default_rng(tile)
    chunk = _random_chunk(rng, b_blk, c_blk, pr, f, g_pad, 3000, 40000,
                          rows)
    rows_sorted, status = np.unique(chunk[3].numpy()), _status()
    want = torch.zeros((rows, g_pad), dtype=dtype)
    tds._dense_chunk(want, *chunk, b_blk, c_blk, pr, f, g_pad, status)
    want_blk = torch.zeros((2, 16, g_pad), dtype=dtype)
    tds._dense_chunk_offset(want_blk, 1, *chunk, 8, b_blk, c_blk, pr, f,
                            g_pad, rows_sorted, status)
    assert torch.any(want != 0) and torch.any(want_blk[1] != 0)
    monkeypatch.setattr(tds, "dense_tile_for", lambda g: tile)
    got = torch.zeros((rows, g_pad), dtype=dtype)
    tds._dense_chunk(got, *chunk, b_blk, c_blk, pr, f, g_pad, status)
    got_blk = torch.zeros((2, 16, g_pad), dtype=dtype)
    tds._dense_chunk_offset(got_blk, 1, *chunk, 8, b_blk, c_blk, pr, f,
                            g_pad, rows_sorted, status)
    assert torch.equal(got, want)
    assert torch.equal(got_blk, want_blk)


def test_tiled_real_index_out_of_range_raises(monkeypatch):
    """In a tile as in the whole product, a pad lands in the sink slot and
    an index past it is an error, not a silent drop."""
    monkeypatch.setattr(tds, "dense_tile_for", lambda g: 128)
    b_blk, c_blk, pr, f, g_pad = 4, 2, 8, 8, 384
    ridx = torch.tensor([0], dtype=torch.int32)
    cmap = torch.zeros(b_blk, dtype=torch.int32)
    rid = torch.zeros(b_blk * pr, dtype=torch.int32)
    sim = torch.zeros((8, g_pad), dtype=torch.int8)
    pad = c_blk * g_pad * f
    tds._dense_chunk(sim, ridx, torch.tensor([pad], dtype=torch.int32),
                     cmap, rid, b_blk, c_blk, pr, f, g_pad, _status())
    assert not torch.any(sim)
    with pytest.raises((IndexError, RuntimeError)):
        tds._dense_chunk(sim, ridx,
                         torch.tensor([pad + 1], dtype=torch.int32), cmap,
                         rid, b_blk, c_blk, pr, f, g_pad, _status())


def test_offset_chunk_outside_the_block_computes_nothing(monkeypatch):
    """A row block that holds no row of a chunk takes no product and no
    scatter; the replay reports it, and the counters leave it out."""
    b_blk, c_blk, pr, f, g_pad, rows = 16, 8, 8, 32, 1280, 40
    chunk = _random_chunk(np.random.default_rng(3), b_blk, c_blk, pr, f,
                          g_pad, 3000, 40000, rows)
    chunk[3] = torch.full_like(chunk[3], 5)  # every lane on read 5
    stack = torch.zeros((2, 16, g_pad), dtype=torch.int8)
    rows_sorted, status = np.unique(chunk[3].numpy()), _status()
    assert tds._dense_chunk_offset(stack, 1, *chunk, 0, b_blk, c_blk, pr,
                                   f, g_pad, rows_sorted, status)
    assert torch.any(stack[1, 5] != 0)
    assert dense_kernels.take(status) > 0

    def no_product(*args):
        raise AssertionError("a product for a block without its rows")

    monkeypatch.setattr(tds, "_dense_rows", no_product)
    stack.zero_()
    assert not tds._dense_chunk_offset(stack, 1, *chunk, 16, b_blk, c_blk,
                                       pr, f, g_pad, rows_sorted, status)
    assert not torch.any(stack)
    assert dense_kernels.take(status) == 0
