"""The port's row-blocked fused mode against lime_tpu's.

Mirrors tests/test_blocked_mode.py: ``LIME_HBM_BUDGET=1`` forces the
blocked runner (B = the cascade block, 16,384 rows: two blocks of the
20,000-read index), ``LIME_STREAM_BUDGET=65536`` forces owner passes.
Each CSV must be byte-identical to lime_tpu's blocked run and to its
host executor; the offset scatters of one chunk must leave int8 and
int32 stacks equal to lime_tpu's.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu import native
from lime_tpu.constants import SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import (open_da, open_ebwt, open_lcp,
                                     write_index_arrays)
from lime_tpu.ops import dense_score as jds
from lime_tpu.ops import pair_score as jps
from lime_tpu.parallel.sharded import pair_rows_local
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu.pipeline import run_single as jax_run_single
from lime_tpu_torch import LimeConfig, host, run_paired, run_single
from lime_tpu_torch.ops import dense_kernels
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.ops import pair_score as tps
from lime_tpu_torch.ops.dense_score import _dense_chunk_offset

from .synth import make_dataset
from .synth_big import make_big_dataset
from .test_torch_selfcontained import ensure_reference_native, jax_config

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)

FUSED = LimeConfig(fused=True)
HOST = LimeConfig(executor="host")
NUM_READS, NUM_GENOMES, N_POS = 20_000, 50, 200_000


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _write_collection(path, rng, deg_frac=0.0):
    """tests/test_blocked_mode.py's synthetic index, draw for draw."""
    n = N_POS
    lcp = rng.integers(0, 2 * 16, n).astype(np.uint32)
    run_at = rng.choice(n - 40, n // 40, replace=False)
    for s in run_at:
        w = rng.integers(2, 30)
        lcp[s:s + w] = rng.integers(16, 30)
    da = np.where(rng.random(n) < 0.6,
                  rng.integers(0, NUM_READS, n),
                  rng.integers(NUM_READS, NUM_READS + NUM_GENOMES, n)
                  ).astype(np.uint32)
    ebwt = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    if deg_frac:
        k = int(n * deg_frac)
        ebwt[rng.choice(n, k, replace=False)] = ord("N")
    with open(path, "w") as f:
        f.write(">synthetic index only\n")
    write_index_arrays(path, ebwt, lcp, da)


@pytest.fixture(scope="module")
def blocked_dataset(tmp_path_factory):
    """20,000 reads x 50 genomes x 200,000 positions per collection,
    IUPAC Ns in the first two collections."""
    root = tmp_path_factory.mktemp("blocked")
    rng = np.random.default_rng(99)
    cols = []
    for i, tag in enumerate(("1F", "1RC", "2F", "2RC")):
        path = str(root / f"col_{tag}.fasta")
        _write_collection(path, rng, deg_frac=0.002 if i < 2 else 0.0)
        cols.append(path)
    lineage = str(root / "LineageFile.csv")
    with open(lineage, "w") as f:
        f.write("Accession_number;Species;Genus;Family;Order;Class;"
                "Phylum\n")
        for g in range(NUM_GENOMES):
            f.write(f"ACC{g};{100 + g % 17};{200 + g % 7};{301};{401};"
                    f"{501};{601}\n")
    return cols, lineage


def _blocked_env(monkeypatch, stream_budget=None):
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    monkeypatch.setenv("LIME_HOST_FRAC", "0")  # stream-only, both engines
    if stream_budget is not None:
        monkeypatch.setenv("LIME_STREAM_BUDGET", str(stream_budget))


@pytest.mark.parametrize("variant", ["paired", "single", "wide", "ebwt0"])
def test_blocked_matches_jax_blocked_and_host(blocked_dataset, tmp_path,
                                              monkeypatch, variant):
    cols, lineage = blocked_dataset
    kw = {"wide": dict(wide_sim=True),
          "ebwt0": dict(use_ebwt=False)}.get(variant, {})
    single = variant == "single"
    if single:
        cols = cols[:2]
    run, jax_run = ((run_single, jax_run_single) if single
                    else (run_paired, jax_run_paired))
    args = (NUM_READS, NUM_GENOMES, lineage, 100)
    a, b, c = (str(tmp_path / f"{n}.csv") for n in ("torch", "jax", "host"))
    jax_run(cols, c, *args, jax_config(HOST.replace(**kw)))
    _blocked_env(monkeypatch)
    run(cols, a, *args, FUSED.replace(**kw), device="cpu")
    stats = dict(tfp.LAST_RUN)
    jax_run(cols, b, *args, jax_config(FUSED.replace(**kw)))
    assert _read(a) == _read(b) == _read(c)
    assert stats["engine"] == "blocked" and stats["n_pass"] == 1
    assert stats["B"] == 1 << 14 and stats["blocks"] >= 2
    assert stats["launches_per_bucket"] == [
        n * stats["blocks"] for n in stats["chunks_per_bucket"]]
    # the Ns' COO corrections (without the ebwt no symbol is degenerate)
    assert ("host_score" in stats["phases"]) == (variant != "ebwt0")


def test_blocked_owner_passes_match_jax_and_host(tmp_path, monkeypatch):
    ds = make_dataset(str(tmp_path), num_pairs=400, read_len=80,
                      genome_lens=(6000, 5000, 4000), seed=41)
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    a, b, c = (str(tmp_path / f"{n}.csv") for n in ("torch", "jax", "host"))
    jax_run_paired(ds.collections, c, *args, jax_config(HOST))
    _blocked_env(monkeypatch, stream_budget=65536)
    run_paired(ds.collections, a, *args, FUSED, device="cpu")
    stats = dict(tfp.LAST_RUN)
    jax_run_paired(ds.collections, b, *args, jax_config(FUSED))
    assert _read(a) == _read(b) == _read(c)
    assert stats["engine"] == "blocked"
    assert stats["n_pass"] >= 2 and stats["blocks"] >= 2
    # each owner's chunks replay once per block of its own pass only
    assert 0 < sum(stats["launches_per_bucket"]) < \
        sum(stats["chunks_per_bucket"]) * stats["blocks"]


def test_card_budget_routes_pair_runs_to_blocks(dataset, tmp_path,
                                                monkeypatch):
    """A stack over the card's free memory (here a pretend card of
    128 KiB) runs in blocks on the pair path and raises a plain
    MemoryError, naming no ROADMAP item, on the banded engine."""
    monkeypatch.setattr(tfp, "_device_memory", lambda device: 128 << 10)
    args = (dataset.num_reads, dataset.num_genomes, dataset.lineage_path,
            dataset.read_len)
    a, c = str(tmp_path / "torch.csv"), str(tmp_path / "host.csv")
    run_paired(dataset.collections, a, *args, FUSED, device="cpu")
    assert tfp.LAST_RUN["engine"] == "blocked"
    jax_run_paired(dataset.collections, c, *args, jax_config(HOST))
    assert _read(a) == _read(c)
    with pytest.raises(MemoryError, match="no row-blocked mode") as err:
        run_paired(dataset.collections, a, *args,
                   FUSED.replace(pair_stream=False), device="cpu")
    assert "ROADMAP" not in str(err.value)


def test_banded_engine_ignores_hbm_budget(dataset, tmp_path, monkeypatch):
    """lime_tpu's banded engine has no blocked mode: under
    LIME_HBM_BUDGET=1 both engines still run it in one block."""
    cfg = FUSED.replace(pair_stream=False, dense_threshold=0)
    args = (dataset.num_reads, dataset.num_genomes, dataset.lineage_path,
            dataset.read_len)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    _blocked_env(monkeypatch)
    run_paired(dataset.collections, a, *args, cfg, device="cpu")
    assert tfp.LAST_RUN["engine"] == "banded"
    jax_run_paired(dataset.collections, b, *args, jax_config(cfg))
    assert _read(a) == _read(b)


@pytest.mark.parametrize("stack_budget, dense_bytes, want", [
    (1, 0, 1 << 14),                    # LIME_HBM_BUDGET=1: one block
    (1 << 30, 0, 131_072),              # lime_tpu's B: half as slack
    (1 << 30, 269_705_216, 131_072),    # dense chunks fit in the slack
    (1 << 30, 800_000_000, 65_536),     # they do not: B shrinks
    (1 << 30, 2 << 30, 1 << 14),        # never below one cascade block
])
def test_block_rows(stack_budget, dense_bytes, want):
    """Paper shape: four int8 planes of 1,024 genome columns, 16,384-read
    cascade blocks; a stack and dense chunks over the budget shrink B."""
    row_bytes, block = 4 * 1024, 1 << 14
    B = tfp.block_rows(stack_budget, dense_bytes, row_bytes, block)
    assert B == want and B % block == 0
    if B > block:
        assert B * row_bytes + dense_bytes <= stack_budget
    # lime_tpu's formula wherever the dense chunks fit in the slack
    if dense_bytes <= stack_budget // 2:
        assert B == max(block, stack_budget // (2 * row_bytes)
                        // block * block)


def test_pair_rows_local_matches():
    for num_reads in list(range(0, 3000, 37)) + [16383, 16384, 20_000,
                                                 10**6, 2 * 10**6 + 1]:
        for dp in (1, 2, 3, 4, 5, 8):
            assert host.pair_rows_local(num_reads, dp) == \
                pair_rows_local(num_reads, dp), (num_reads, dp)


# ---------------------------------------------------------------------------
# One chunk into a row block, against lime_tpu's offset scatters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """Deep coverage of short genomes: all three pair buckets."""
    return make_dataset(str(tmp_path_factory.mktemp("deep")), num_pairs=800,
                        read_len=100, genome_lens=(500, 400), seed=11)


@pytest.fixture(scope="module")
def conserved(tmp_path_factory):
    """Genomes sharing mutated group templates: genome-dense clusters."""
    return make_big_dataset(str(tmp_path_factory.mktemp("conserved")),
                            num_pairs=3000, num_genomes=12, genome_len=3000,
                            conserved_frac=0.3, group_size=6, seed=3)


def _plan(ds, fi=0, dense_min=16):
    col = ds.collections[fi]
    return native.plan_pairs_packed(
        open_lcp(col), open_da(col), open_ebwt(col), ds.num_reads, 16,
        SYMBOL_RANK_LUT, host._DEGENERATE_BYTE.astype(np.uint8),
        dense_min=dense_min, num_refs=ds.num_genomes, host_num=0)


@pytest.mark.parametrize("wide", [False, True])
def test_pair_offset_stack_matches_jax(deep, wide):
    """Every pair chunk of one collection into plane 1 of a (2, 256,
    G_pad) stack whose block starts mid-range (reads 300-555 of 800): the
    chunks' rows straddle both edges of the block."""
    arrays, chunks, windows, row_bits = _plan(deep)[:4]
    assert {c[0] for c in chunks} == {0, 1, 2}
    g_pad = host._g_pad_for(deep.num_genomes)
    B, base = 256, 300
    jdt, tdt = (jnp.int32, torch.int32) if wide else (jnp.int8, torch.int8)
    want = jnp.zeros((2, B, g_pad), jdt)
    rows_all, bits_all = arrays[0], arrays[1]
    gcol_all = host._gcol_padded(arrays[2], chunks)
    wpg = row_bits // 4
    for bucket, _, n_rows, wo, bo, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        want = jps._pair_packed_block_offset_stack(
            want, jnp.asarray(rows_all[wo:wo + n_rows // 8 * wpg]),
            jnp.asarray(bits_all[bo:bo + n_rows // 8 * 5]),
            jnp.asarray(gcol_all[go:go + gcap]), jnp.int32(windows[bucket]),
            jnp.int32(base), 1, row_bits, jps.BUCKET_CAPS[bucket])
    got = torch.zeros((2, B, g_pad), dtype=tdt)
    tps.pair_score_packed_offset(
        got, 1, tps.pair_upload(arrays, chunks, torch.device("cpu"), []),
        chunks, windows, row_bits, base)
    want = np.asarray(want)
    assert want[1].any() and not want[0].any()
    assert np.array_equal(got.numpy(), want)
    rows = tps._unpack_rows(torch.from_numpy(rows_all.view(np.int32)),
                            row_bits).numpy()
    assert (rows < base).any() and ((rows >= base + B)
                                    & (rows < deep.num_reads)).any()


@pytest.mark.parametrize("wide", [False, True])
def test_dense_offset_chunk_matches_jax(conserved, wide):
    """Every dense chunk of one collection into plane 0 of a (2, 1024,
    G_pad) stack at reads 1,000-2,023 of 3,000."""
    ds = conserved
    out = _plan(ds, dense_min=4)
    col = ds.collections[0]
    g_pad = host._g_pad_for(ds.num_genomes)
    chunks = host.pack_chunks(out[4], out[5], open_da(col), open_ebwt(col),
                              ds.num_reads, ds.num_genomes, g_pad)[0]
    assert chunks
    B, base, f = 1024, 1000, 4 * host.K
    jdt, tdt = (jnp.int32, torch.int32) if wide else (jnp.int8, torch.int8)
    want = jnp.zeros((2, B, g_pad), jdt)
    got = torch.zeros((2, B, g_pad), dtype=tdt)
    status = dense_kernels.new_status("cpu")
    for ridx, gidx, cmap, rid in chunks:
        want = jds._dense_chunk_offset(
            want, jnp.asarray(ridx), jnp.asarray(gidx), jnp.asarray(cmap),
            jnp.asarray(rid), jnp.int32(base), host.B_BLK, host.C_BLK,
            host.PR, f, g_pad, 0)
        _dense_chunk_offset(got, 0, *(torch.from_numpy(a) for a in
                                      (ridx, gidx, cmap, rid)),
                            base, host.B_BLK, host.C_BLK, host.PR, f, g_pad,
                            np.unique(rid), status)
    real = np.concatenate([c[3] for c in chunks])
    real = real[real < ds.num_reads]
    assert (real < base).any() and (real >= base + B).any()
    want = np.asarray(want)
    assert want[0].any() and not want[1].any()
    assert np.array_equal(got.numpy(), want)
