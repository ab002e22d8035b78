"""The port's host share against lime_tpu's: byte-identical CSVs.

Mirrors tests/test_hybrid.py and test_edge_cases.py's wide-database
case: the hybrid and all-host splits (``host_frac`` / ``LIME_HOST_FRAC``)
in one block and row-blocked (``LIME_HBM_BUDGET=1`` on the 20,000-read
index of test_torch_blocked.py: two blocks; and in owner passes), wide
counters, the pair-heavy dense offload on and off, the host-matrix
cap's stream-only fallback, ``pair_stream=False`` (no host share),
``run_single``, and a database past 65,536 genomes.  Each CSV must equal
lime_tpu's fused run and its host executor.  Also the split rule, the
stack scatter of a delta-COO chain and a host plane's corrections.
Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu.formats.fasta import reverse_complement
from lime_tpu.index.builder import build_index_files
from lime_tpu.ops import fused_pipeline as jfp
from lime_tpu.ops import pair_score as jps
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu.pipeline import run_single as jax_run_single
from lime_tpu_torch import LimeConfig, host, run_paired, run_single
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.ops import pair_score as tps

from .synth import make_dataset
from .test_torch_blocked import (NUM_GENOMES, NUM_READS,  # noqa: F401
                                 blocked_dataset)
from .test_torch_selfcontained import ensure_reference_native, jax_config

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)

HOST = LimeConfig(executor="host")
FUSED = LimeConfig(fused=True)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _three(run, jax_run, cols, args, cfg, tmp_path, host_cfg=HOST):
    """(port, lime_tpu fused, host executor) CSV bytes of one config; the
    port's LAST_RUN as it stood after its run."""
    a, b, c = (str(tmp_path / f"{n}.csv") for n in ("torch", "jax", "host"))
    run(cols, a, *args, cfg, device="cpu")
    stats = dict(tfp.LAST_RUN)
    jax_run(cols, b, *args, jax_config(cfg))
    jax_run(cols, c, *args, jax_config(host_cfg))
    return _read(a), _read(b), _read(c), stats


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _args(ds):
    return (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)


@pytest.mark.parametrize("frac,host_num,engine", [
    (0.0, 0, "pair"), (0.5, 128, "pair"), (1.0, 256, "all_host")])
def test_hybrid_fractions_match_jax_and_host(dataset, tmp_path, frac,
                                             host_num, engine):
    a, b, c, stats = _three(run_paired, jax_run_paired, dataset.collections,
                            _args(dataset), FUSED.replace(host_frac=frac),
                            tmp_path)
    assert a == b == c
    assert stats["engine"] == engine and stats["host_num"] == host_num
    # the device keeps a share of the pair chunks until the split is all
    assert (sum(stats["chunks_per_bucket"]) > 0) == (host_num < 256)


def test_hybrid_wide_counters(dataset, tmp_path):
    """u32 counters: all-host runs the pair path with everything routed
    to the host plane, whose chain carries 7-byte entries."""
    kw = dict(wide_sim=True)
    a, b, c, stats = _three(run_paired, jax_run_paired, dataset.collections,
                            _args(dataset),
                            FUSED.replace(host_frac=1.0, **kw), tmp_path,
                            HOST.replace(**kw))
    assert a == b == c
    assert stats["engine"] == "pair" and stats["host_num"] == 256
    assert stats["chain_bytes"] > 0 and stats["chain_bytes"] % 7 == 0
    assert stats["chunks_per_bucket"] == [0, 0, 0]


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_hybrid_blocked_matches_jax_and_host(blocked_dataset, tmp_path,
                                             monkeypatch, frac):
    """Per row block the host planes' row slices scatter into the stack."""
    cols, lineage = blocked_dataset
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    a, b, c, stats = _three(run_paired, jax_run_paired, cols,
                            (NUM_READS, NUM_GENOMES, lineage, 100),
                            FUSED.replace(host_frac=frac), tmp_path)
    assert a == b == c
    assert stats["engine"] == "blocked" and stats["blocks"] >= 2
    assert stats["host_num"] == round(frac * 256)
    assert stats["host_plane_bytes"] == 4 * NUM_READS * NUM_GENOMES
    assert stats["chain_bytes"] > 0 and "block_host" in stats["phases"]
    assert stats["launches_per_bucket"] == [
        n * stats["blocks"] for n in stats["chunks_per_bucket"]]
    assert (sum(stats["chunks_per_bucket"]) == 0) == (frac == 1.0)


@pytest.mark.parametrize("frac", [0.5, 1.0])
def test_hybrid_owner_passes_match_jax_and_host(tmp_path, monkeypatch, frac):
    """The host share under owner passes (LIME_STREAM_BUDGET): an
    all-host plan has no chunks to upload in any pass."""
    ds = make_dataset(str(tmp_path / "ds"), num_pairs=400, read_len=80,
                      genome_lens=(6000, 5000, 4000), seed=41)
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    monkeypatch.setenv("LIME_STREAM_BUDGET", "65536")
    a, b, c, stats = _three(run_paired, jax_run_paired, ds.collections,
                            _args(ds), FUSED.replace(host_frac=frac),
                            tmp_path)
    assert a == b == c
    assert stats["engine"] == "blocked" and stats["n_pass"] >= 2
    assert stats["host_num"] == round(frac * 256)
    assert (sum(stats["launches_per_bucket"]) == 0) == (frac == 1.0)


@pytest.fixture(scope="module")
def pair_heavy(tmp_path_factory):
    """Deep coverage of two short genomes: pair-heavy clusters."""
    return make_dataset(str(tmp_path_factory.mktemp("pair_heavy")),
                        num_pairs=300, read_len=80, genome_lens=(5000, 4000),
                        seed=77)


@pytest.mark.parametrize("offload,use_ebwt,budget", [
    ("0", True, None), ("1", True, None), ("1", False, None),
    (None, True, "1")], ids=["off", "on", "on-no-ebwt", "blocked-default"])
def test_all_host_dense_offload_matches_jax_and_host(
        pair_heavy, tmp_path, monkeypatch, offload, use_ebwt, budget):
    """Pair-heavy clusters of an all-host run go to the dense matmul
    (``LIME_DENSE_OFFLOAD`` forces; a row-blocked run offloads by
    default) without changing a byte."""
    if offload is not None:
        monkeypatch.setenv("LIME_DENSE_OFFLOAD", offload)
    if budget is not None:
        monkeypatch.setenv("LIME_HBM_BUDGET", budget)
    monkeypatch.setenv("LIME_DENSE_OFFLOAD_MIN", "4")
    kw = dict(use_ebwt=use_ebwt)
    a, b, c, stats = _three(run_paired, jax_run_paired,
                            pair_heavy.collections, _args(pair_heavy),
                            FUSED.replace(host_frac=1.0, **kw), tmp_path,
                            HOST.replace(**kw))
    assert a == b == c
    assert stats["engine"] == ("blocked" if budget else "all_host")
    assert (stats["dense_chunks"] > 0) == (offload != "0")
    assert sum(stats["chunks_per_bucket"]) == 0


def test_host_matrix_cap_falls_back_to_streams(blocked_dataset, tmp_path,
                                               monkeypatch):
    """Host planes over LIME_HOST_MATRIX_CAP: the blocked run is
    stream-only, its host share dropped."""
    cols, lineage = blocked_dataset
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    monkeypatch.setenv("LIME_HOST_MATRIX_CAP", "1")
    a, b, c, stats = _three(run_paired, jax_run_paired, cols,
                            (NUM_READS, NUM_GENOMES, lineage, 100),
                            FUSED.replace(host_frac=0.5), tmp_path)
    assert a == b == c
    assert stats["engine"] == "blocked" and stats["host_num"] == 0
    assert stats["host_plane_bytes"] == 0 and stats["blocks"] >= 2


def test_banded_engine_ignores_host_frac(dataset, tmp_path):
    """Without pair streams there is no host share: the banded engine
    runs, as lime_tpu's does."""
    a, b, c, stats = _three(run_paired, jax_run_paired, dataset.collections,
                            _args(dataset),
                            FUSED.replace(host_frac=1.0, pair_stream=False),
                            tmp_path)
    assert a == b == c
    assert stats["engine"] == "banded" and stats["host_num"] == 0


def test_run_single_hybrid(dataset, tmp_path):
    a, b, c, stats = _three(run_single, jax_run_single,
                            dataset.single_collections, _args(dataset),
                            FUSED.replace(host_frac=0.5), tmp_path)
    assert a == b == c
    assert stats["host_num"] == 128


@pytest.mark.parametrize("frac,env", [
    *((f, None) for f in (None, 0.0, 0.05, 0.07, 0.5, 0.93, 0.95, 1.0)),
    (None, "0.3"), (1.0, "0"), (None, "1")])
def test_host_split_matches_jax(monkeypatch, frac, env):
    """The port's split equals lime_tpu's on a directly attached device
    with no link measurements (shares round at 18 and 238 of 256)."""
    jfp._bw_samples.clear()
    if env is not None:
        monkeypatch.setenv("LIME_HOST_FRAC", env)
    else:
        monkeypatch.delenv("LIME_HOST_FRAC", raising=False)
    cfg = LimeConfig(host_frac=frac)
    assert tfp._host_split_for(cfg) == jfp._host_split_for(
        jax_config(cfg), 1000, 100, False)


@pytest.mark.parametrize("num_genomes,wide", [
    (100, False), (5000, False), (100, True)],
    ids=["coo24", "plain", "wide"])
def test_coo_scatter_into_stack_matches_jax(num_genomes, wide):
    """A host plane's row slice as one chain into plane 1 of a (2, B,
    g_pad) stack already holding counts, against lime_tpu's scatter."""
    rng = np.random.default_rng(num_genomes + wide)
    B, base = 600, 300
    g_pad = host._g_pad_for(num_genomes)
    dt = np.uint32 if wide else np.uint8
    plane = np.where(rng.random((1200, num_genomes)) < 0.02,
                     rng.integers(1, 256, (1200, num_genomes)), 0).astype(dt)
    kind, chain, p24 = tfp.plane_corrections(plane[base:base + B],
                                             num_genomes, wide)
    assert kind == "chain" and p24 == (num_genomes < 4096 and not wide)
    start = rng.integers(-128, 128, (2, B, g_pad)).astype(
        np.int32 if wide else np.int8)
    want = jps.coo_scatter_into_stack(jnp.asarray(start), chain, 1,
                                      packed24=p24)
    got = torch.from_numpy(start.copy())
    tps.coo_scatter_into_stack(got, chain, 1, [], packed24=p24)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy()[1], start[1])
    assert np.array_equal(got.numpy()[0], start[0])


@pytest.mark.parametrize("shape", [(300, 65_537), (300, 3_423)])
def test_plane_corrections_rebuild_the_plane(shape):
    """Past 65,536 genomes the plane's nonzeros come back as plain COO,
    below as a delta-COO chain (coo24 under 4,096 columns); either
    rebuilds the plane exactly, and ``zero_after`` leaves it zeroed."""
    rng = np.random.default_rng(shape[1])
    plane = np.where(rng.random(shape) < 0.01,
                     rng.integers(1, 256, shape), 0).astype(np.uint8)
    plane[:40] = 0  # leading empty rows: the chain starts past row 0
    kind, *res = tfp.plane_corrections(plane, shape[1], False)
    rebuilt = np.zeros(shape, np.uint8)
    if kind == "coo":
        rows, cols, vals = res
        assert shape[1] > 65536
        np.add.at(rebuilt, (rows, cols), vals.astype(np.uint8))
    else:
        (base, drow, col, val), p24 = res
        assert p24 and shape[1] < 4096 and drow.max() <= 15
        rows = base + np.cumsum(drow.astype(np.int64))
        np.add.at(rebuilt, (rows, col.astype(np.int64)), val)
    assert np.array_equal(rebuilt, plane)
    again = plane.copy()
    assert _same(tfp.plane_corrections(again, shape[1], False,
                                       zero_after=True), (kind, *res))
    assert not again.any()


# ---------------------------------------------------------------------------
# Past 65,536 genomes: plain COO corrections instead of a chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_db(tmp_path_factory):
    """tests/test_edge_cases.py's 65,600-genome database, draw for draw,
    and its host executor's CSV."""
    root = tmp_path_factory.mktemp("wide_db")
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", np.uint8)
    n_genomes = 65600  # just past the u16 column range
    genomes = [bytes(bases[rng.integers(0, 4, 24)])
               for _ in range(n_genomes - 2)]
    genomes += [bytes(bases[rng.integers(0, 4, 3000)]) for _ in range(2)]
    reads1, reads2 = [], []
    read_len = 60
    for i in range(40):
        g = genomes[-1 - (i % 2)]
        p = int(rng.integers(0, len(g) - 150))
        frag = g[p:p + 150]
        reads1.append(frag[:read_len])
        reads2.append(reverse_complement(frag[-read_len:]))
    cols = []
    for tag, reads in (("1F", reads1),
                       ("1RC", [reverse_complement(r) for r in reads1]),
                       ("2F", reads2),
                       ("2RC", [reverse_complement(r) for r in reads2])):
        path = str(root / f"col_{tag}.fasta")
        build_index_files(path, reads + genomes)
        cols.append(path)
    lineage = str(root / "lineage.csv")
    with open(lineage, "w") as f:
        f.write("Accession_number;Species;Genus;Family;Order;Class;"
                "Phylum\n")
        for i in range(n_genomes):
            f.write(f"A{i};{100 + i};5;4;3;2;1\n")
    args = (len(reads1), n_genomes, lineage, read_len)
    host_csv = str(root / "host.csv")
    jax_run_paired(cols, host_csv, *args, jax_config(HOST))
    return cols, args, _read(host_csv)


@pytest.mark.parametrize("frac", [None, 1.0])
def test_wide_db_beyond_u16_columns(wide_db, tmp_path, monkeypatch, frac):
    """65,600 genomes: no pair streams (so no host share), and the
    banded engine's host plane, forced by a position cap of 1, returns
    as plain COO corrections (coo_compact's u16 column cannot express
    the width)."""
    cols, args, want = wide_db
    monkeypatch.setattr(host, "_COO_POSITION_CAP", 1)
    out = str(tmp_path / "wide.csv")
    run_paired(cols, out, *args, FUSED.replace(host_frac=frac),
               device="cpu")
    assert _read(out) == want
    stats = tfp.LAST_RUN
    assert stats["engine"] == "banded" and stats["host_num"] == 0
    assert stats["host_plane_bytes"] == args[0] * args[1]
    assert stats["chain_bytes"] == 0
