"""The port's SPMD layer against lime_tpu's, in one process (world size 1)
and, for the 4x1 mesh and the CLI, in gloo ranks.

``lime_tpu_torch.parallel`` runs ``lime_tpu/parallel`` on torch.distributed,
one process per rank.  Here: the whole-file drivers on a 1x1 mesh (the
density-routed and dense-matmul cases of tests/test_sharded.py), each CSV
byte-identical to lime_tpu's ``run_sharded`` / ``run_sharded_pairs`` on
its 8-device virtual mesh and to ``executor="host"``; the multihost range
functions and ``pair_comm_model`` against lime_tpu's; the pinned
``host._rescue`` and the port's dataset maker against their originals;
``run-sharded`` through the port's CLI; the dry run's ``entry``.
tests/test_torch_distributed.py has the other meshes and the step-level
comparisons.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch

from lime_tpu import native as jnative
from lime_tpu.config import LimeConfig as JaxConfig
from lime_tpu.ops.fused_pipeline import _rescue as jax_rescue
from lime_tpu.parallel import make_mesh as jax_make_mesh
from lime_tpu.parallel import multihost as jmh
from lime_tpu.parallel.sharded import pair_comm_model as jax_comm_model
from lime_tpu.parallel.sharded import run_sharded as jax_run_sharded
from lime_tpu.parallel.sharded import run_sharded_pairs as jax_run_pairs
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu_torch import LimeConfig, host
from lime_tpu_torch import synth as port_synth
from lime_tpu_torch.cli import main as cli_main
from lime_tpu_torch.formats.arrays import open_da, open_ebwt
from lime_tpu_torch.parallel import dryrun, mesh as tmesh
from lime_tpu_torch.parallel import multihost as tmh
from lime_tpu_torch.parallel import sharded as tsh

from . import synth as tests_synth
from .test_torch_selfcontained import (ensure_reference_native, jax_config,
                                       run_ranks)

ensure_reference_native()
torch.set_num_threads(1)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _ds_spec(ds):
    return {"collections": ds.collections, "num_reads": ds.num_reads,
            "num_genomes": ds.num_genomes, "lineage_path": ds.lineage_path,
            "read_len": ds.read_len}


@pytest.fixture(scope="module")
def host_csv(dataset, tmp_path_factory):
    """``executor="host"``'s CSV of the session dataset, per config."""
    root = tmp_path_factory.mktemp("sharded_host")
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            path = str(root / f"host_{len(cache)}.csv")
            jax_run_paired(dataset.collections, path, dataset.num_reads,
                           dataset.num_genomes, dataset.lineage_path,
                           dataset.read_len, JaxConfig(executor="host",
                                                       **kw))
            cache[key] = _read(path)
        return cache[key]

    return get


# (config, the key of its host run): the cases of tests/test_sharded.py
CASES = {
    "default": ({}, {}),
    "density_all_host": ({"dense_threshold": 10**9}, {}),
    "density_3": ({"dense_threshold": 3}, {}),
    "mxu_dense": ({"mxu_dense_min": 1, "dense_threshold": 1 << 62}, {}),
    "higher": ({"assign_higher": True, "tax_rank": 1},
               {"assign_higher": True, "tax_rank": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_sharded_world1_matches_lime_tpu(dataset, host_csv, tmp_path,
                                             case):
    """The whole-file banded driver on a 1x1 mesh (no process group):
    byte-identical to lime_tpu's run_sharded on the 8-device mesh and to
    the host executor, with its density routing (host matrix, dense
    matmul chunks) where the config asks for it."""
    kw, host_kw = CASES[case]
    ds = dataset
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    jax_csv = str(tmp_path / "jax.csv")
    jax_run_sharded(ds.collections, jax_csv, *args, JaxConfig(**kw),
                    mesh=jax_make_mesh(8))
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"sp": 1, "dp": 1} and not mesh.distributed
    out = str(tmp_path / "torch.csv")
    tsh.run_sharded(ds.collections, out, *args, LimeConfig(**kw),
                    mesh=mesh, device="cpu")
    assert _read(out) == _read(jax_csv) == host_csv(**host_kw)
    st = tsh.LAST_RUN
    assert st["engine"] == "banded" and st["world"] == 1
    if case == "mxu_dense":
        assert st["dense_chunks"] > 0
    if case.startswith("density"):
        assert st["host_matrix"]


def test_run_sharded_pairs_world1_matches_lime_tpu(dataset, host_csv,
                                                   tmp_path):
    ds = dataset
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    jax_csv = str(tmp_path / "jax.csv")
    jax_run_pairs(ds.collections, jax_csv, *args, mesh=jax_make_mesh(8))
    out = str(tmp_path / "torch.csv")
    res = tsh.run_sharded_pairs(ds.collections, out, *args, device="cpu")
    assert _read(out) == _read(jax_csv) == host_csv()
    assert tsh.LAST_RUN["engine"] == "pair"
    assert not tsh.LAST_RUN["exchange"]
    assert sum(tsh.LAST_RUN["chunks_per_bucket"]) > 0
    assert len(res.types) == ds.num_reads


def test_run_sharded_4x1_matches_host(dataset, host_csv, tmp_path):
    """Four gloo ranks, one position range each, on the banded engine."""
    outs = run_ranks(tmp_path / "ranks", {
        "task": "run", "engine": "banded", "mesh": [4, 1],
        "csv": str(tmp_path / "out.csv"), "ds": _ds_spec(dataset)}, 4)
    assert _read(tmp_path / "out.csv") == host_csv()
    assert [o["sp_dp"] for o in outs] == [[0, 0], [1, 0], [2, 0], [3, 0]]
    assert all(o["last_run"]["world"] == 4 for o in outs)


@pytest.mark.parametrize("engine", ["banded", "pair"])
def test_cli_run_sharded_in_process(dataset, host_csv, tmp_path, capsys,
                                    engine):
    ds = dataset
    out = str(tmp_path / "cli.csv")
    rc = cli_main(["run-sharded", *ds.collections, out, str(ds.num_reads),
                   str(ds.num_genomes), ds.lineage_path, str(ds.read_len),
                   "--engine", engine, "--device", "cpu"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("mesh {'sp': 1, 'dp': 1}: C=")
    assert line.endswith(f"/ {ds.num_reads}")
    assert _read(out) == host_csv()


def test_cli_run_sharded_two_ranks(dataset, host_csv, tmp_path):
    """``run-sharded`` in two processes started by ``init_distributed``
    from the ``LIME_*`` variables, mesh 2x1, pair engine."""
    ds = dataset
    out = str(tmp_path / "cli.csv")
    argv = ["run-sharded", *ds.collections, out, str(ds.num_reads),
            str(ds.num_genomes), ds.lineage_path, str(ds.read_len),
            "--engine", "pair", "--mesh", "2x1", "--device", "cpu"]
    outs = run_ranks(tmp_path / "ranks", {"task": "cli", "argv": argv}, 2)
    assert [o["rc"] for o in outs] == [0, 0]
    assert [o["last_run"]["mesh"] for o in outs] == [{"sp": 2, "dp": 1}] * 2
    assert _read(out) == host_csv()


# ---------------------------------------------------------------------------
# Mesh, process group, comm model
# ---------------------------------------------------------------------------

def test_make_mesh_without_a_process_group():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"sp": 1, "dp": 1}
    assert (mesh.rank, mesh.world, mesh.sp_i, mesh.dp_j) == (0, 1, 0, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(shape=(2, 1))
    x = torch.arange(6, dtype=torch.int8).view(1, 2, 3)
    assert mesh.reduce_scatter_dp(x) is x
    assert torch.equal(mesh.all_gather(x)[0], x)


@pytest.mark.parametrize("n", range(1, 9))
def test_default_shape_matches_lime_tpu(n):
    jm = jax_make_mesh(n)
    assert tmesh.default_shape(n) == (jm.shape["sp"], jm.shape["dp"])


def test_init_distributed_single_process(monkeypatch):
    for var in ("LIME_COORDINATOR", "LIME_NUM_PROCESSES", "RANK",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.init_distributed(device="cpu") == (0, 1)
    assert jmh.init_distributed() == (0, 1)


def test_init_distributed_nccl_rank_without_its_card_raises(monkeypatch):
    """An NCCL rank whose LOCAL_RANK names no visible card raises before
    any process group starts."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="needs CUDA device 3"):
        tmh.init_distributed("nccl", "127.0.0.1:1", 2, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (2, 4), (4, 2), (3, 2),
                                   (1, 6)])
@pytest.mark.parametrize("wide", [False, True])
def test_pair_comm_model_matches_lime_tpu(shape, wide):
    sp, dp = shape
    fake = types.SimpleNamespace(shape={"sp": sp, "dp": dp})
    mesh = tmesh.Mesh({"sp": sp, "dp": dp}, 0, sp * dp)
    for reads, refs in ((400, 3), (100_000, 2), (1_000_000, 930)):
        assert tsh.pair_comm_model(mesh, 4, reads, refs, wide) == \
            jax_comm_model(fake, 4, reads, refs, wide)


def test_pair_engine_int32_scatter_range_raises():
    mesh = tmesh.Mesh({"sp": 1, "dp": 1}, 0, 1)
    with pytest.raises(ValueError, match="int32 scatter range"):
        tsh.make_pair_sharded_pipeline(mesh, 4, 3_000_000, 1000, 100, 16,
                                       0.25, 1, False, 24, device="cpu")


def test_banded_step_refuses_a_shard_narrower_than_the_halo():
    mesh = tmesh.Mesh({"sp": 1, "dp": 1}, 0, 1)
    step = tsh.make_sharded_pipeline(mesh, 2, 10, 3, 100, 16, 0.25, 1,
                                     False, device="cpu")
    z = np.zeros((2, 100), np.int32)
    with pytest.raises(ValueError, match="halo capacity"):
        step(z.astype(np.uint8), z, 4, z[0, :0], z[0, :0], z[0, :0],
             z[0, :0], np.zeros(128, np.uint32),
             np.zeros((6, 128), np.uint32), np.ones(128, bool), 0.0)


# ---------------------------------------------------------------------------
# Multihost range planning (tests/test_multihost.py's cases)
# ---------------------------------------------------------------------------

def test_host_position_range_matches_lime_tpu():
    for n in (0, 1, 17, 1000):
        for k in (1, 2, 3, 8):
            spans = [tmh.host_position_range(n, k, i) for i in range(k)]
            assert spans == [jmh.host_position_range(n, k, i)
                             for i in range(k)]
            assert spans[0][0] == 0 and spans[-1][1] == n
    with pytest.raises(ValueError):
        tmh.host_position_range(10, 2, 2)


def test_extend_range_straddle_matches_lime_tpu():
    lcp = np.array([0, 20, 20, 3, 20, 20, 20, 2, 0], np.uint32)
    cases = {(1, 4): (3, 7), (4, 6): (7, 7), (3, 5): (3, 7), (3, 8): (3, 8),
             (0, 9): (0, 9)}
    for (lo, hi), want in cases.items():
        assert tmh.extend_range_to_cluster_boundaries(lcp, lo, hi, 16) \
            == jmh.extend_range_to_cluster_boundaries(lcp, lo, hi, 16) \
            == want


def _same(a, b):
    """Equal values, arrays equal in dtype too, through tuples and
    lists."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("num_hosts", [1, 3, 8])
def test_plan_host_range_matches_lime_tpu(dataset, num_hosts):
    fasta = dataset.collections[0]
    args = (dataset.num_reads, dataset.num_genomes, 16, num_hosts)
    prev_hi = 0
    for h in range(num_hosts):
        got = tmh.plan_host_range(fasta, *args, h)
        _same(got, jmh.plan_host_range(fasta, *args, h))
        assert got[5][0] == prev_hi
        prev_hi = got[5][1]
    assert prev_hi == len(np.asarray(open_da(fasta)))


@pytest.mark.parametrize("num_hosts,dp", [(1, 1), (3, 1), (3, 2), (8, 4)])
def test_plan_host_range_pairs_matches_lime_tpu(dataset, num_hosts, dp):
    fasta = dataset.collections[1]
    rows_local = host.pair_rows_local(dataset.num_reads, dp)
    for h in range(num_hosts):
        kw = dict(dense_min=16, dp=dp, rows_local=rows_local)
        got = tmh.plan_host_range_pairs(fasta, dataset.num_reads,
                                        dataset.num_genomes, 16, num_hosts,
                                        h, **kw)
        want = jmh.plan_host_range_pairs(fasta, dataset.num_reads,
                                         dataset.num_genomes, 16, num_hosts,
                                         h, **kw)
        _same(got, want)


# ---------------------------------------------------------------------------
# Pinned copies: the host rescue and the dataset maker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True])
def test_rescue_matches_lime_tpu(dataset, wide):
    """COO for a small rescue set, the dense matrix for a large one."""
    fasta = dataset.collections[0]
    da = np.asarray(open_da(fasta))
    ebwt = np.asarray(open_ebwt(fasta))
    starts, lens = jnative.plan_clusters(
        np.fromfile(fasta + ".lcp", np.uint32), da, dataset.num_reads, 16)
    cfg = LimeConfig(wide_sim=wide)
    nr, ng = dataset.num_reads, dataset.num_genomes
    kinds = []
    # the first clusters up to 70 positions (COO: under R * G / 16); every
    # cluster (the dense matrix)
    few = int(np.searchsorted(np.cumsum(lens), 70))
    for sel in (slice(0, few), slice(None)):
        got = host._rescue(starts[sel], lens[sel], da, ebwt, nr, ng, cfg)
        want = jax_rescue(starts[sel], lens[sel], da, ebwt, nr, ng,
                          jax_config(cfg))
        kinds.append(got[0])
        assert got[0] == want[0]
        _same(list(got[1:]), list(want[1:]))
    assert kinds == ["coo", "dense"]


@pytest.mark.parametrize("seed", [3, 11])
def test_port_synth_matches_tests_copy(tmp_path, seed):
    kw = dict(num_pairs=120, read_len=64, genome_lens=(3000, 2000),
              seed=seed, degenerate_rate=0.01)
    a = port_synth.make_dataset(str(tmp_path / "port"), **kw)
    b = tests_synth.make_dataset(str(tmp_path / "tests"), **kw)
    files = sorted(os.listdir(b.root))
    assert files == sorted(os.listdir(a.root))
    assert "LineageFile.csv" in files and len(files) == 1 + 4 * 4
    for f in files:
        assert _read(os.path.join(a.root, f)) == \
            _read(os.path.join(b.root, f)), f
    paths = ("root", "collections", "lineage_path")
    assert ({k: v for k, v in dataclasses.asdict(a).items()
             if k not in paths}
            == {k: v for k, v in dataclasses.asdict(b).items()
                if k not in paths})


def test_dryrun_entry_matches_lime_tpu():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, jargs = graft.entry()
    fn, args = dryrun.entry(device="cpu")
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = fn(*args).numpy()
    assert got.shape == want.shape == (256, 128)
    assert np.array_equal(got, want) and got.sum() > 0


def test_dryrun_multichip_world1_in_process(tmp_path, monkeypatch):
    """The dry run without a process group: a 1x1 mesh, its dataset in a
    temporary directory it removes, every check passing."""
    made = []
    real = dryrun.tempfile.mkdtemp

    def mkdtemp(**kw):
        made.append(real(dir=str(tmp_path), **kw))
        return made[-1]

    monkeypatch.setattr(dryrun.tempfile, "mkdtemp", mkdtemp)
    res = dryrun.dryrun_multichip(device="cpu", num_pairs=1500)
    assert res["mesh"] == [1, 1] and res["dataset"] == [1500, 2]
    assert res["rescued"][0] > 0 and res["rescued"][1] > 255
    assert set(res["engines"]) == {"banded", "pair"}
    assert res["engines"]["banded"]["counts"] == \
        res["engines"]["pair"]["counts"]
    assert len(made) == 1 and not os.path.exists(made[0])
