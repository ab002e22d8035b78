"""The path without the native library: torch port vs lime_tpu, exactly.

When the C++ library cannot be built, ``lime_tpu`` still classifies: the
numpy cluster scan (``find_clusters``), the numpy planner of the banded
engine (``_plan_python``), the numpy exact scorer (``score_clusters``,
with ``iupac_waterfall``) and a Python CSV writer.  The port has its own
copies and routes to them where ``native.available()`` is False.  Held
here, every comparison exact:

- each copy against its original on the test datasets and on random
  inputs (u8 wrap and ``wide_sim``, ``use_ebwt`` on and off,
  IUPAC-degenerate symbols), and the numpy scorer against the port's
  native scorer;
- the numpy plan's stream as K3's codes, through K3's plain version,
  against ``lime_tpu``'s banded scores of the same stream;
- with the library failed in both packages (the ``no_native`` fixture:
  ``available()`` False and every binding raising, so a site that calls
  the library without asking fails here): the fused, staged and host
  runs, paired and single, write ``lime_tpu``'s CSV and checkpoint
  bytes; the SPMD banded engine in one and in four gloo ranks writes
  ``lime_tpu``'s CSV; the pair engine, per-host planning, the native
  index engine and the external build raise ``lime_tpu``'s messages;
  ``build_index(engine="auto")`` builds with numpy; ``run-sharded
  --engine pair`` warns and runs the banded engine; the Python CSV
  writer equals ``native.format_csv`` byte for byte.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from lime_tpu import native as jnative
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.ops import cluster_scan as jcs
from lime_tpu.ops import fused_pipeline as jfp
from lime_tpu.ops import scoring as jsc
from lime_tpu.parallel import make_mesh as jax_make_mesh
from lime_tpu.parallel import multihost as jmh
from lime_tpu.parallel import sharded as jsh
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu.pipeline import run_single as jax_run_single
from lime_tpu_torch import LimeConfig, host, native, pipeline
from lime_tpu_torch import run_paired, run_single
from lime_tpu_torch.cli import main as torch_cli
from lime_tpu_torch.constants import IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT
from lime_tpu_torch.index import build_index
from lime_tpu_torch.index import external as texternal
from lime_tpu_torch.index.builder import build_index as build_index_ref
from lime_tpu_torch.ops import banded_kernels as bk
from lime_tpu_torch.ops import cluster_scan as tcs
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.ops import scoring as tsc
from lime_tpu_torch.ops.classify_ops import ClassifyResult
from lime_tpu_torch.parallel import multihost as tmh
from lime_tpu_torch.parallel import sharded as tsh

from .synth import make_dataset
from .test_torch_selfcontained import (ensure_reference_native, jax_config,
                                       run_ranks)

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers.
torch.set_num_threads(1)

_EXTS = (".16.clrs", ".out", ".res.bin", ".res.pos", ".res.txt")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _args(ds):
    return (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)


def _artifacts(cols):
    """Every stage checkpoint next to ``cols``, read and then removed."""
    out = {}
    for c in cols:
        for ext in _EXTS:
            if os.path.exists(c + ext):
                out[os.path.basename(c) + ext] = _read(c + ext)
                os.remove(c + ext)
    return out


@pytest.fixture
def no_native(monkeypatch):
    """Both packages as if their native library had failed to build:
    ``available()`` False, every binding raising (the port's) or
    finding no library (``lime_tpu``'s)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LOAD_ERROR", "no C++ toolchain (test)")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_failed", True)
    assert not native.available() and not jnative.available()
    monkeypatch.setattr(native, "_warned", False)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """Deep coverage of short genomes: clusters past 255 rows, which the
    numpy planner routes to the exact host scorer."""
    return make_dataset(str(tmp_path_factory.mktemp("deep")),
                        num_pairs=2400, read_len=100,
                        genome_lens=(600, 400), seed=11)


def _collections(request, which):
    ds = request.getfixturevalue(which)
    for col in ds.collections:
        yield ds, open_lcp(col), open_da(col), open_ebwt(col)


# ---------------------------------------------------------------------------
# The copies against their originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["dataset", "deep"])
@pytest.mark.parametrize("alpha", [16, 25])
def test_find_clusters_matches(request, which, alpha):
    n = 0
    for ds, lcp, da, _ in _collections(request, which):
        got = tcs.find_clusters(np.asarray(lcp), np.asarray(da),
                                ds.num_reads, alpha)
        want = jcs.find_clusters(np.asarray(lcp), np.asarray(da),
                                 ds.num_reads, alpha)
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want))
        # and the native scan's clusters
        nat = native.plan_clusters(lcp, da, ds.num_reads, alpha)
        assert all(np.array_equal(a, b) for a, b in zip(got, nat))
        n += len(got[0])
    assert n


@pytest.mark.parametrize("seed", range(4))
def test_find_clusters_edges_match(seed):
    """Random streams, one ending inside a run, and the empty stream."""
    rng = np.random.default_rng(seed)
    n = 5000
    lcp = rng.integers(0, 30, size=n).astype(np.uint32)
    if seed % 2:
        lcp[-40:] = 29  # a run to the end of the stream
    da = rng.integers(0, 60, size=n).astype(np.uint32)
    for alpha in (5, 20):
        got = tcs.find_clusters(lcp.copy(), da, 40, alpha)
        want = jcs.find_clusters(lcp.copy(), da, 40, alpha)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    empty = np.empty(0, np.uint32)
    assert all(len(a) == 0 for a in tcs.find_clusters(empty, empty, 4, 16))


def _random_clusters(rng, n_clusters=60, num_reads=6, num_refs=4):
    """Clusters over synthetic (da, ebwt) arrays with few documents, so a
    read's count in one cluster passes 255 and its sums wrap, and with
    IUPAC-degenerate bytes on both sides."""
    lens = rng.integers(2, 900, size=n_clusters)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]) + np.arange(
        n_clusters) * 3
    n = int(starts[-1] + lens[-1] + 3)
    da = rng.integers(0, num_reads + num_refs, size=n).astype(np.uint32)
    ebwt = rng.choice(np.frombuffer(b"ACGTACGTACGTRYKMSWN$", np.uint8),
                      size=n)
    return starts.astype(np.int64), lens.astype(np.int64), da, ebwt, \
        num_reads, num_refs


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("use_ebwt", [True, False])
@pytest.mark.parametrize("pair_chunk", [1 << 19, 97])
def test_score_clusters_matches_on_random_clusters(wide, use_ebwt,
                                                   pair_chunk):
    rng = np.random.default_rng(int(wide) * 2 + int(use_ebwt))
    starts, lens, da, ebwt, R, G = _random_clusters(rng)
    cfg = LimeConfig(wide_sim=wide, use_ebwt=use_ebwt)
    got = tsc.score_clusters(starts, lens, da, ebwt, R, G, cfg,
                             pair_chunk=pair_chunk)
    want = jsc.score_clusters(starts, lens, da, ebwt, R, G, jax_config(cfg),
                              pair_chunk=pair_chunk)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if not wide:
        # the u8 counters wrapped: the wide counts differ from them
        full = jsc.score_clusters(starts, lens, da, ebwt, R, G,
                                  jax_config(cfg.replace(wide_sim=True)))
        assert (full > 255).any()
        assert np.array_equal(got, (full % 256).astype(np.uint8))


@pytest.mark.parametrize("top", [100, 300, 40_000])
@pytest.mark.parametrize("wide", [False, True])
def test_score_clusters_matches_at_every_histogram_width(top, wide):
    """One read and one genome document repeating a symbol ``top``
    times in one cluster, beside random clusters: histograms gathered as
    int8, int16 and int64, the read counter past 255 wrapping (u8) and
    the genome counter saturating."""
    rng = np.random.default_rng(top)
    starts, lens, da, ebwt, R, G = _random_clusters(rng, n_clusters=20)
    n = len(da)
    heavy = np.r_[np.zeros(top, np.uint32), np.full(top, R, np.uint32),
                  np.full(top // 2, R + 1, np.uint32)]
    da = np.concatenate([da, heavy])
    ebwt = np.concatenate([ebwt, np.full(len(heavy), ord("A"), np.uint8)])
    ebwt[n + top - 3:n + top] = ord("N")
    starts = np.append(starts, n)
    lens = np.append(lens, len(heavy))
    cfg = LimeConfig(wide_sim=wide)
    got = tsc.score_clusters(starts, lens, da, ebwt, R, G, cfg)
    want = jsc.score_clusters(starts, lens, da, ebwt, R, G, jax_config(cfg))
    assert np.array_equal(got, want)
    assert want[0, 0] > 0


@pytest.mark.parametrize("which", ["dataset", "deep"])
@pytest.mark.parametrize("kw", [dict(), dict(wide_sim=True),
                                dict(use_ebwt=False)])
def test_score_clusters_matches_lime_tpu_and_native(request, which, kw):
    """On every collection's clusters: equal to ``lime_tpu``'s numpy
    scorer and to the port's native scorer; the session dataset's
    IUPAC-degenerate symbols reach the waterfall."""
    cfg = LimeConfig(**kw)
    degenerate = 0
    for ds, lcp, da, ebwt in _collections(request, which):
        starts, lens = native.plan_clusters(lcp, da, ds.num_reads, cfg.alpha)
        eb = ebwt if cfg.use_ebwt else None
        got = tsc.score_clusters(starts, lens, da, eb, ds.num_reads,
                                 ds.num_genomes, cfg, pair_chunk=1000)
        want = jsc.score_clusters(starts, lens, da, eb, ds.num_reads,
                                  ds.num_genomes, jax_config(cfg))
        nat = native.score_clusters_native(
            starts, lens, da, eb, ds.num_reads, ds.num_genomes,
            SYMBOL_RANK_LUT, host._DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
            wide=cfg.wide_sim)
        assert got.dtype == want.dtype == nat.dtype
        assert np.array_equal(got, want) and np.array_equal(got, nat)
        assert got.any()
        cid, gpos = tsc._expand_positions(starts, lens)
        degenerate += int(host._DEGENERATE_BYTE[np.asarray(ebwt)[gpos]].sum())
    assert degenerate > 0 or which == "deep"


@pytest.mark.parametrize("seed", range(3))
def test_iupac_waterfall_matches(seed):
    """The leftover matching and its in-place updates of ``u`` and ``v``,
    the reference's first-block quirk included."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 4, size=(500, 16)).astype(np.int64)
    v = rng.integers(0, 4, size=(500, 16)).astype(np.int64)
    u2, v2 = u.copy(), v.copy()
    got = tsc.iupac_waterfall(u, v)
    want = jsc.iupac_waterfall(u2, v2)
    assert np.array_equal(got, want) and got.any()
    assert np.array_equal(u, u2) and np.array_equal(v, v2)


@pytest.mark.parametrize("which", ["dataset", "deep"])
@pytest.mark.parametrize("use_u16", [True, False])
@pytest.mark.parametrize("use_ebwt", [True, False])
def test_plan_python_matches(request, which, use_u16, use_ebwt):
    cfg = LimeConfig(use_ebwt=use_ebwt)
    bad = 0
    for ds, lcp, da, ebwt in _collections(request, which):
        got = tfp._plan_python(lcp, da, ebwt, ds.num_reads, ds.num_genomes,
                               cfg, use_u16)
        want = jfp._plan_python(lcp, da, ebwt, ds.num_reads, ds.num_genomes,
                                jax_config(cfg), use_u16)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b)
        bad += len(got[3])
    # the deep set has clusters past 255 rows; the session dataset has
    # IUPAC-degenerate ones (routed only with use_ebwt)
    assert bad > 0 or not (which == "deep" or use_ebwt)


def test_plan_banded_routes_to_the_numpy_plan(deep, no_native):
    """Without the library ``plan_banded`` is ``_plan_python`` with one
    stream and no dense lists; ``_dense_min_for`` is 0, ``_rescue`` takes
    the sparse branch, and the pair engine is off in ``run_fused``."""
    cfg = LimeConfig(fused=True)
    col = deep.collections[0]
    lcp, da, ebwt = open_lcp(col), open_da(col), open_ebwt(col)
    got = tfp.plan_banded(lcp, da, ebwt, deep.num_reads, deep.num_genomes,
                          cfg)
    want = tfp._plan_python(lcp, da, ebwt, deep.num_reads, deep.num_genomes,
                            cfg, True)
    assert got[2] == 1 and got[3] == want[2]
    for a, b in zip(got[:2] + got[4:6], want[:2] + want[3:]):
        assert np.array_equal(a, b)
    assert len(got[6]) == len(got[7]) == 0
    assert host._dense_min_for(deep.num_genomes, cfg) == 0
    assert host._dense_min_for(100_000, cfg.replace(mxu_dense_min=7)) == 0
    big = (np.array([0]), np.array([len(lcp)]))
    assert host._rescue(*big, da, ebwt, deep.num_reads, deep.num_genomes,
                        cfg)[0] == "coo"


@pytest.mark.parametrize("which,n_cols", [("dataset", 4), ("deep", 1)])
def test_banded_codes_of_the_numpy_plan_match_lime_tpu(request, which,
                                                       n_cols):
    """``banded_codes`` turns ``_plan_python``'s bytes into K3's codes (m
    at bit 6, the symbol in the low bits, emit set), and K3's plain
    version on them equals ``lime_tpu``'s banded scores of the stream
    (the deep set's window near 255 costs the CPU most: one stream)."""
    import jax.numpy as jnp

    cfg = LimeConfig(fused=True)
    streams = 0
    for ds, lcp, da, ebwt in list(_collections(request, which))[:n_cols]:
        R, G = ds.num_reads, ds.num_genomes
        packed, doc, window, _, _ = tfp._plan_python(
            lcp, da, ebwt, R, G, cfg, (R + G) < 0xFFFF)
        codes = tfp.banded_codes(packed)
        assert np.array_equal(codes >> bk.PACK_M_BIT, packed >> 6)
        assert np.array_equal(codes & 15, packed & 15)
        assert np.all((codes >> bk.PACK_EMIT_BIT) & 1 == 1)
        g_pad = host._g_pad_for(G)
        sim = torch.zeros((R + 1, g_pad), dtype=torch.int32)
        bk.banded_sim_plain(sim, torch.from_numpy(codes),
                            torch.from_numpy(tfp._doc_i32(doc)), window, R)
        want = np.asarray(jfp._score_program(
            jnp.asarray(packed), jnp.asarray(doc), jnp.int32(window), R, G,
            R + 1, True))
        assert np.array_equal(sim.numpy()[:R, :G], want[:R, :G])
        assert want[:R, :G].any()
        streams += 1
    assert streams == n_cols


# ---------------------------------------------------------------------------
# Whole runs with the library failed in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,single", [
    ("dataset", False), ("dataset", True), ("deep", True)])
def test_fused_run_matches_lime_tpu(request, tmp_path, no_native, which,
                                    single):
    """The fused entry point falls to the banded engine on the numpy
    plan, K3's plain version scoring it here (the deep set's >255-row
    clusters through the numpy rescue; single-end, for the CPU's
    time)."""
    ds = request.getfixturevalue(which)
    cols = ds.single_collections if single else ds.collections
    fn, jfn = (run_single, jax_run_single) if single else \
        (run_paired, jax_run_paired)
    cfg = LimeConfig(fused=True)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    s_j = jfn(cols, b, *_args(ds), jax_config(cfg))
    s = fn(cols, a, *_args(ds), cfg, device="cpu")
    assert _read(a) == _read(b)
    assert dataclasses.asdict(s) == dataclasses.asdict(s_j)
    run = tfp.LAST_RUN
    assert run["planner"] == "numpy" and run["engine"] == "banded"
    assert run["chunks_per_bucket"] == [0, 0, 0] and not run["dense_chunks"]
    assert all(run["banded_windows"]) and len(run["banded_windows"]) == \
        len(cols)


@pytest.mark.parametrize("single,kw", [
    (False, dict()),
    (True, dict()),
    (False, dict(executor="host")),
    (False, dict(wide_sim=True, binary_results=False)),
    (False, dict(use_ebwt=False)),
])
def test_staged_run_matches_lime_tpu(dataset, tmp_path, no_native, single,
                                     kw):
    """``find_clusters``, K3 (plain here) with the numpy rescue, or the
    numpy scorer for ``executor="host"``: CSV and every checkpoint
    byte-identical to lime_tpu's run without its library."""
    cfg = LimeConfig(**kw)
    cols = dataset.single_collections if single else dataset.collections
    fn, jfn = (run_single, jax_run_single) if single else \
        (run_paired, jax_run_paired)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    _artifacts(cols)
    jfn(cols, b, *_args(dataset), jax_config(cfg))
    want = _artifacts(cols)
    fn(cols, a, *_args(dataset), cfg, device="cpu")
    got = _artifacts(cols)
    assert _read(a) == _read(b)
    assert got == want and any(k.endswith(".clrs") for k in want)
    assert pipeline.LAST_RUN["planner"] == "numpy"


def test_staged_deep_run_matches_lime_tpu(deep, tmp_path, no_native):
    """The deep set's >255-row clusters go through the numpy rescue."""
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    _artifacts(deep.collections)
    jax_run_paired(deep.collections, b, *_args(deep),
                   jax_config(LimeConfig()))
    want = _artifacts(deep.collections)
    run_paired(deep.collections, a, *_args(deep), LimeConfig(),
               device="cpu")
    assert _read(a) == _read(b) and _artifacts(deep.collections) == want


def test_planner_is_native_with_the_library(dataset, tmp_path):
    assert native.available()
    run_paired(dataset.collections, str(tmp_path / "f.csv"),
               *_args(dataset), LimeConfig(fused=True), device="cpu")
    assert tfp.LAST_RUN["planner"] == "native"
    run_paired(dataset.collections, str(tmp_path / "s.csv"),
               *_args(dataset), LimeConfig(), keep_results=False,
               device="cpu")
    assert pipeline.LAST_RUN["planner"] == "native"


def test_failed_library_is_cached_logged_once_and_raises(no_native,
                                                         caplog):
    with caplog.at_level(logging.WARNING, logger="lime_tpu_torch"):
        assert not native.available()
        assert not native.available()
    warned = [r for r in caplog.records
              if "native library unavailable" in r.getMessage()]
    assert len(warned) == 1 and "no C++ toolchain" in warned[0].getMessage()
    for call in (native._load,
                 lambda: native.format_csv(np.zeros(1, np.uint8),
                                           np.zeros(1, np.uint32),
                                           np.zeros(1, np.float32), 0),
                 lambda: native.build_index_native([b"ACGT"])):
        with pytest.raises(RuntimeError, match="no C\\+\\+ toolchain"):
            call()


def test_python_csv_writer_matches_native_format_csv(tmp_path, monkeypatch):
    """Every type (U, C, A, H), sims of many magnitudes, a row base."""
    rng = np.random.default_rng(3)
    n = 4000
    res = ClassifyResult(
        rng.integers(0, 4, size=n).astype(np.int8),
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32),
        (rng.random(n) * 10.0 ** rng.integers(-7, 3, size=n)).astype(
            np.float32))
    res.sim[:8] = [0, 1, 0.5, 1e-5, 123456.7, 1 / 3, 2 / 3, 0.1]
    paths = {}
    for label in ("native", "python"):
        if label == "python":
            monkeypatch.setattr(native, "available", lambda: False)
        paths[label] = str(tmp_path / f"{label}.csv")
        with open(paths[label], "w") as out:
            out.write(pipeline.CSV_HEADER)
            pipeline._write_csv_block(out, 0, res)
            pipeline._write_csv_block(out, 77, res)
    assert _read(paths["python"]) == _read(paths["native"])


# ---------------------------------------------------------------------------
# The SPMD engines, index construction and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def sharded_reference(dataset, tmp_path, no_native):
    """lime_tpu's run_sharded CSV without its library (the numpy plan on
    its 8-device virtual mesh)."""
    path = str(tmp_path / "jax_sharded.csv")
    jsh.run_sharded(dataset.collections, path, *_args(dataset),
                    jax_config(LimeConfig()), mesh=jax_make_mesh(8))
    return _read(path)


def test_run_sharded_world1_matches_lime_tpu(dataset, sharded_reference,
                                             tmp_path):
    out = str(tmp_path / "torch.csv")
    tsh.run_sharded(dataset.collections, out, *_args(dataset), LimeConfig(),
                    device="cpu")
    assert _read(out) == sharded_reference
    assert tsh.LAST_RUN["planner"] == "numpy"
    assert tsh.LAST_RUN["engine"] == "banded"


@pytest.mark.parametrize("mesh", [[2, 2], [1, 3]])
def test_run_sharded_ranks_match_lime_tpu(dataset, sharded_reference,
                                          tmp_path, mesh):
    """Every gloo rank plans the whole files with the numpy planner and
    scores its own shard of the streams."""
    ds = dataset
    outs = run_ranks(tmp_path / "ranks", {
        "task": "run", "engine": "banded", "mesh": mesh, "no_native": True,
        "csv": str(tmp_path / "out.csv"),
        "ds": {"collections": ds.collections, "num_reads": ds.num_reads,
               "num_genomes": ds.num_genomes,
               "lineage_path": ds.lineage_path, "read_len": ds.read_len}},
        mesh[0] * mesh[1])
    assert _read(tmp_path / "out.csv") == sharded_reference
    for o in outs:
        assert o["last_run"]["planner"] == "numpy"
        assert o["blocked"] == ["jax", "lime_tpu"]


def test_pair_engine_and_range_planning_raise(dataset, no_native):
    args = (dataset.collections, None, *_args(dataset))
    with pytest.raises(RuntimeError,
                       match="pair engine requires the native planner"):
        jsh.run_sharded_pairs(*args, jax_config(LimeConfig()))
    with pytest.raises(RuntimeError,
                       match="pair engine requires the native planner"):
        tsh.run_sharded_pairs(*args, LimeConfig(), device="cpu")
    col = dataset.collections[0]
    plan = (col, dataset.num_reads, dataset.num_genomes, 16, 2, 1)
    msg = "per-host planning requires the native library"
    with pytest.raises(RuntimeError, match=msg):
        jmh.plan_host_range(*plan)
    with pytest.raises(RuntimeError, match=msg):
        tmh.plan_host_range(*plan)
    # the pair planner has no check of its own: its binding fails
    with pytest.raises(Exception):
        jmh.plan_host_range_pairs(*plan)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tmh.plan_host_range_pairs(*plan)


def test_index_engines_without_the_library(tmp_path, no_native):
    from lime_tpu.index import builder as jbuilder
    from lime_tpu.index import external as jexternal

    rng = np.random.default_rng(5)
    seqs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()
            for n in (300, 41, 170)]
    want = build_index_ref(seqs, engine="numpy")
    got = build_index(seqs, engine="auto")
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))
    assert all(np.array_equal(a, b) for a, b in
               zip(got, jbuilder.build_index(seqs, engine="auto")))
    msg = "native index builder unavailable \\(no C\\+\\+ toolchain\\)"
    for build in (build_index, jbuilder.build_index):
        with pytest.raises(RuntimeError, match=msg):
            build(seqs, engine="native")
    msg = "external build requires the native runtime"
    for ext in (texternal, jexternal):
        with pytest.raises(RuntimeError, match=msg):
            ext.build_index_files_external(str(tmp_path / "x.fasta"), seqs)


def test_cli_run_sharded_pair_falls_back_to_banded(dataset, tmp_path,
                                                   sharded_reference,
                                                   capsys):
    out = str(tmp_path / "cli.csv")
    rc = torch_cli(["run-sharded", *dataset.collections, out,
                    str(dataset.num_reads), str(dataset.num_genomes),
                    dataset.lineage_path, str(dataset.read_len),
                    "--engine", "pair", "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 0
    assert ("warning: native runtime unavailable — falling back to the "
            "banded SPMD engine") in err
    assert _read(out) == sharded_reference
    assert tsh.LAST_RUN["engine"] == "banded"
