"""The port's SPMD engines in gloo ranks, one process each, on the CPU.

Each run spawns ``tests/_torch_dist_worker.py`` once per rank (every rank
killed after its timeout) with ``jax`` and ``lime_tpu`` blocked.  Every
CSV must be byte-identical to lime_tpu's ``run_sharded`` /
``run_sharded_pairs`` on its 8-device virtual mesh and to
``executor="host"``; the step-level tests feed the inputs lime_tpu's
whole-file driver built for a 2x2 mesh to the port's per-rank steps and
require lime_tpu's (types, taxid, sim) on every read row.  The dry run
(``lime_tpu_torch.parallel.dryrun``) runs at a small size in 4 ranks.
tests/test_torch_sharded.py has the world-size-1 cases.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lime_tpu.config import LimeConfig as JaxConfig
from lime_tpu.parallel import make_mesh as jax_make_mesh
from lime_tpu.parallel import sharded as jsh
from lime_tpu.pipeline import run_paired as jax_run_paired

from .test_torch_selfcontained import ROOT, ensure_reference_native, \
    run_ranks

ensure_reference_native()
torch.set_num_threads(1)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def reference(dataset, tmp_path_factory):
    """(host executor CSV, lime_tpu run_sharded CSV, lime_tpu
    run_sharded_pairs CSV) of the session dataset; all three agree."""
    root = tmp_path_factory.mktemp("dist_ref")
    ds = dataset
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    paths = [str(root / f) for f in ("host.csv", "banded.csv", "pair.csv")]
    jax_run_paired(ds.collections, paths[0], *args,
                   JaxConfig(executor="host"))
    jsh.run_sharded(ds.collections, paths[1], *args, JaxConfig(),
                    mesh=jax_make_mesh(8))
    jsh.run_sharded_pairs(ds.collections, paths[2], *args, JaxConfig(),
                          mesh=jax_make_mesh(8))
    want = [_read(p) for p in paths]
    assert want[0] == want[1] == want[2]
    return want[0]


def _ds_spec(ds):
    return {"collections": ds.collections, "num_reads": ds.num_reads,
            "num_genomes": ds.num_genomes, "lineage_path": ds.lineage_path,
            "read_len": ds.read_len}


@pytest.mark.parametrize("mesh", [[2, 2], [1, 4]])
def test_run_sharded_ranks_match_lime_tpu(dataset, reference, tmp_path,
                                          mesh):
    sp, dp = mesh
    outs = run_ranks(tmp_path / "ranks", {
        "task": "run", "engine": "banded", "mesh": mesh,
        "csv": str(tmp_path / "out.csv"), "ds": _ds_spec(dataset)}, sp * dp)
    assert _read(tmp_path / "out.csv") == reference
    assert [o["sp_dp"] for o in outs] == [[c // dp, c % dp]
                                          for c in range(sp * dp)]


@pytest.mark.parametrize("mesh,env,exchange", [
    ([2, 2], {}, True),
    ([2, 3], {}, True),   # 6 ranks: dp = 3, the exchange path
    ([2, 1], {"LIME_FORCE_EXCHANGE": "1"}, True),
], ids=["2x2", "2x3", "2x1_forced_exchange"])
def test_run_sharded_pairs_ranks_match_lime_tpu(dataset, reference,
                                                tmp_path, mesh, env,
                                                exchange):
    sp, dp = mesh
    outs = run_ranks(tmp_path / "ranks", {
        "task": "run", "engine": "pair", "mesh": mesh, "env": env,
        "csv": str(tmp_path / "out.csv"), "ds": _ds_spec(dataset)}, sp * dp)
    assert _read(tmp_path / "out.csv") == reference
    for o in outs:
        assert o["last_run"]["exchange"] is exchange
        # the ranks ran the port alone
        assert o["blocked"] == ["jax", "lime_tpu"]
    # every chunk was scored by exactly one rank
    per_rank = [sum(o["last_run"]["chunks_per_bucket"]) for o in outs]
    assert sum(per_rank) > 0


def _capture(monkeypatch, name):
    """Record the arguments and outputs of the step lime_tpu's driver
    builds with ``jsh.<name>``."""
    box = {}
    make = getattr(jsh, name)

    def wrapped_make(*a, **kw):
        step = make(*a, **kw)
        box["make"] = kw

        def wrapped(*args, **kwargs):
            out = step(*args, **kwargs)
            box["args"], box["kwargs"] = args, kwargs
            box["out"] = [np.asarray(o) for o in out]
            return out

        return wrapped

    monkeypatch.setattr(jsh, name, wrapped_make)
    return box


def _check_rows(outs, tmp_path, box, num_reads, dp):
    """Every rank's rows equal lime_tpu's rows of its dp block."""
    types, taxid, sim = box["out"]
    rows = len(types) // dp
    for r, o in enumerate(outs):
        got = np.load(tmp_path / "ranks" / f"out.{r}.npz")
        j = o["sp_dp"][1]
        lo, hi = j * rows, min((j + 1) * rows, num_reads)
        n = hi - lo
        assert np.array_equal(got["types"][:n], types[lo:hi])
        assert np.array_equal(got["taxid"][:n].astype(np.int64),
                              taxid[lo:hi].astype(np.int64))
        assert np.array_equal(got["sim"][:n].view(np.uint32),
                              sim[lo:hi].view(np.uint32))


def _spec(box, ds, task, path, **extra):
    mk = box["make"]
    return {"task": task, "mesh": [2, 2], "inputs": path,
            "num_files": mk["num_files"], "num_reads": ds.num_reads,
            "num_refs": ds.num_genomes, "read_len": ds.read_len,
            "alpha": mk["alpha"], "beta": mk["beta"],
            "tax_rank": mk["tax_rank"], "assign_higher": mk["assign_higher"],
            "wide_sim": mk.get("wide_sim", False), **extra}


@pytest.mark.parametrize("kw", [{}, {"mxu_dense_min": 1}],
                         ids=["banded_stream", "dense_chunks"])
def test_banded_step_matches_lime_tpu(dataset, tmp_path, monkeypatch, kw):
    """lime_tpu's make_sharded_pipeline on a 2x2 virtual mesh and the
    port's step on 4 gloo ranks, on the same inputs: COO corrections (the
    dataset's IUPAC-degenerate clusters) with the banded streams, or with
    genome-dense matmul chunks (``mxu_dense_min=1`` routes every cluster
    with a genome position to them)."""
    ds = dataset
    box = _capture(monkeypatch, "make_sharded_pipeline")
    jsh.run_sharded(ds.collections, "", ds.num_reads, ds.num_genomes,
                    ds.lineage_path, ds.read_len,
                    JaxConfig(assign_higher=True, **kw),
                    mesh=jax_make_mesh(4, shape=(2, 2)))
    (packed, doc, window, cfile, crows, ccols, cvals, tax, rank_matrix,
     valid_t, error) = box["args"]
    assert box["make"]["max_corr"]
    arrays = dict(packed=packed, doc=doc, window=window, cfile=cfile,
                  crows=crows, ccols=ccols, cvals=cvals, tax=tax,
                  rank_matrix=rank_matrix, valid_t=valid_t,
                  error=np.float32(error))
    if kw:
        d_ridx, d_gidx, d_cmap, d_rid, d_file = box["kwargs"]["dense"]
        assert (np.asarray(d_file) < 4).sum() >= 4
        arrays.update(d_ridx=d_ridx, d_gidx=d_gidx, d_cmap=d_cmap,
                      d_rid=d_rid, d_file=d_file)
    else:
        assert box["kwargs"]["dense"] is None
        assert window > 1 and (np.asarray(packed) >> 6 & 1).any()
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **arrays)
    outs = run_ranks(tmp_path / "ranks", _spec(
        box, ds, "step", path, dense_f=box["make"]["dense_f"]), 4)
    _check_rows(outs, tmp_path, box, ds.num_reads, 2)


def test_pair_step_matches_lime_tpu(dataset, tmp_path, monkeypatch):
    """lime_tpu's make_pair_sharded_pipeline on a 2x2 virtual mesh and the
    port's pair step on 4 gloo ranks, on the same owner-split chunks and
    corrections."""
    ds = dataset
    box = _capture(monkeypatch, "make_pair_sharded_pipeline")
    jsh.run_sharded_pairs(ds.collections, "", ds.num_reads, ds.num_genomes,
                          ds.lineage_path, ds.read_len,
                          JaxConfig(assign_higher=True),
                          mesh=jax_make_mesh(4, shape=(2, 2)))
    (rows_w, bits_b, gcol, cfile, cwin, crows, ccols, cvals, corr_file,
     tax, rank_matrix, valid_t, error) = box["args"]
    assert box["make"]["max_corr"] and (np.asarray(cfile) < 4).sum() > 4
    path = str(tmp_path / "inputs.npz")
    np.savez(path, rows_w=rows_w, bits_b=bits_b, gcol=gcol, cfile=cfile,
             cwin=cwin, crows=crows, ccols=ccols, cvals=cvals,
             corr_file=corr_file, tax=tax, rank_matrix=rank_matrix,
             valid_t=valid_t, error=np.float32(error))
    outs = run_ranks(tmp_path / "ranks", _spec(
        box, ds, "pair_step", path, row_bits=box["make"]["row_bits"]), 4)
    _check_rows(outs, tmp_path, box, ds.num_reads, 2)


def test_dryrun_multichip_in_four_ranks(tmp_path):
    """The dry run's own launcher: 4 gloo ranks on a 2x2 mesh, both
    engines, the forced row-blocked run and the host reference agreeing
    on a 3,000-pair dataset with planted >255-row runs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "lime_tpu_torch.parallel.dryrun", "--world",
         "4", "--mesh", "2x2", "--backend", "gloo", "--device", "cpu",
         "--pairs", "3000", "--root", str(tmp_path / "dry"), "--timeout",
         "240"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    res = [json.loads(line[len("DRYRUN "):])
           for line in out.stdout.splitlines() if line.startswith("DRYRUN ")]
    assert sorted(r["rank"] for r in res) == [0, 1, 2, 3]
    r0 = next(r for r in res if r["rank"] == 0)
    assert r0["rescued"][0] > 0 and r0["rescued"][1] > 255
    assert set(r0["engines"]) == {"banded", "pair"} and "blocked_s" in r0
    assert r0["comm_model"]["mesh"] == [2, 2]


def test_gloo_int8_reductions_wrap(tmp_path):
    """100 + 101 through gloo's int8 all_reduce and the mesh's
    reduce-scatter: -55, the low byte of 201 (the uchar counters)."""
    outs = run_ranks(tmp_path / "ranks", {"task": "wrap", "mesh": [1, 2]}, 2)
    for o in outs:
        assert o["all_reduce"] == [-55] * 8
        assert o["reduce_scatter"] == [-55] * 8
