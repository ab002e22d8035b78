"""The torch port end to end: byte-identical CSVs against lime_tpu.

``lime_tpu_torch.run_paired(device="cpu")`` must write the same bytes as
lime_tpu's fused (JAX) serving run and its staged host executor; the
jax-free host reference (lime_tpu_torch/reference.py) must too.  Also
pinned here: the port imports without jax, each copied host helper equals
its original, and unported modes raise instead of running something else
(the banded engine, ``pair_stream=False``, is held in
test_torch_staged.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.constants import SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.ops import classify_tpu, dense_score, fused_pass
from lime_tpu.ops import fused_pipeline as jfp
from lime_tpu.ops import pair_score as jps
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu.pipeline import run_single as jax_run_single
from lime_tpu_torch import host, run_paired, run_single
from lime_tpu_torch import cli as torch_cli
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.reference import reference_csv

from .synth import make_dataset
from .synth_big import make_big_dataset

# build and load the native library before any test, whatever the
# other test processes do (lime_tpu_torch.host.ensure_native)
host.ensure_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)

HOST = LimeConfig(executor="host")
FUSED = LimeConfig(fused=True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _args(ds):
    return (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)


def test_run_paired_matches_jax_fused_and_host(dataset, tmp_path):
    a, b, c = (str(tmp_path / f"{n}.csv") for n in ("torch", "jax", "host"))
    s = run_paired(dataset.collections, a, *_args(dataset), FUSED,
                   device="cpu")
    s_j = jax_run_paired(dataset.collections, b, *_args(dataset), FUSED)
    jax_run_paired(dataset.collections, c, *_args(dataset), HOST)
    assert _read(a) == _read(b) == _read(c)
    assert s == s_j
    assert tfp.LAST_RUN["chunks_per_bucket"][0] > 0


def test_run_single_higher_matches_jax_fused_and_host(dataset, tmp_path):
    cfg = dict(assign_higher=True, tax_rank=1)
    a, b, c = (str(tmp_path / f"{n}.csv") for n in ("torch", "jax", "host"))
    run_single(dataset.single_collections, a, *_args(dataset),
               FUSED.replace(**cfg), device="cpu")
    jax_run_single(dataset.single_collections, b, *_args(dataset),
                   FUSED.replace(**cfg))
    jax_run_single(dataset.single_collections, c, *_args(dataset),
                   HOST.replace(**cfg))
    assert _read(a) == _read(b) == _read(c)


@pytest.mark.parametrize("kw", [dict(use_ebwt=False), dict(wide_sim=True)])
def test_run_paired_variants_match_host(dataset, tmp_path, kw):
    a, c = str(tmp_path / "torch.csv"), str(tmp_path / "host.csv")
    run_paired(dataset.collections, a, *_args(dataset), FUSED.replace(**kw),
               device="cpu")
    jax_run_paired(dataset.collections, c, *_args(dataset),
                   HOST.replace(**kw))
    assert _read(a) == _read(c)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """Deep coverage of short genomes: all three pair buckets, and a
    rescue set big enough for the dense-plane (delta-COO) branch."""
    root = tmp_path_factory.mktemp("deep")
    return make_dataset(str(root), num_pairs=800, read_len=100,
                        genome_lens=(500, 400), seed=11)


@pytest.fixture(scope="module")
def conserved(tmp_path_factory):
    root = tmp_path_factory.mktemp("conserved")
    return make_big_dataset(str(root), num_pairs=3000, num_genomes=12,
                            genome_len=3000, conserved_frac=0.3,
                            group_size=6, seed=3)


@pytest.mark.parametrize("which,kw", [("deep", {}),
                                      ("conserved", dict(mxu_dense_min=4))])
def test_all_device_paths_match_host(request, tmp_path, which, kw):
    """Buckets 0-2, the dense matmul and both rescue branches."""
    ds = request.getfixturevalue(which)
    a, c = str(tmp_path / "torch.csv"), str(tmp_path / "host.csv")
    run_paired(ds.collections, a, *_args(ds), FUSED.replace(**kw),
               device="cpu")
    phases = dict(tfp.LAST_RUN["phases"])
    jax_run_paired(ds.collections, c, *_args(ds), HOST)
    assert _read(a) == _read(c)
    if which == "deep":
        assert all(tfp.LAST_RUN["chunks_per_bucket"])
        assert "host_score" in phases
    else:
        assert "dense" in phases


def test_reference_matches_host(dataset, tmp_path):
    a, c = str(tmp_path / "ref.csv"), str(tmp_path / "host.csv")
    reference_csv(dataset.collections, a, *_args(dataset), FUSED)
    jax_run_paired(dataset.collections, c, *_args(dataset), HOST)
    assert _read(a) == _read(c)


def test_cli_run_paired_cpu(dataset, tmp_path):
    a, c = str(tmp_path / "cli.csv"), str(tmp_path / "host.csv")
    rc = torch_cli.main(["run-paired", *dataset.collections, a,
                         *map(str, _args(dataset)), "--device", "cpu"])
    jax_run_paired(dataset.collections, c, *_args(dataset), HOST)
    assert rc == 0 and _read(a) == _read(c)


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; import lime_tpu_torch; "
            "from lime_tpu_torch import run_paired; "
            "import lime_tpu_torch.cli, lime_tpu_torch.reference; "
            "assert sys.modules['jax'] is None")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


@pytest.mark.parametrize("kw,env", [
    (dict(host_frac=0.5), {}),
    (dict(host_frac=1.0), {}),
    ({}, {"LIME_HOST_FRAC": "0.3"}),
    ({}, {"LIME_HBM_BUDGET": "1"}),
])
def test_unported_modes_raise(dataset, tmp_path, monkeypatch, kw, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_paired(dataset.collections, str(tmp_path / "x.csv"),
                   *_args(dataset), FUSED.replace(**kw), device="cpu")


def test_cuda_without_card_raises(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: covered by the cuda tests")
    with pytest.raises(RuntimeError, match="is_available"):
        run_paired(dataset.collections, str(tmp_path / "x.csv"),
                   *_args(dataset), FUSED, device="cuda")


# ---------------------------------------------------------------------------
# host.py copies against their originals
# ---------------------------------------------------------------------------

def _plan(ds, fi=0, dense_min=16):
    col = ds.collections[fi]
    return native.plan_pairs_packed(
        open_lcp(col), open_da(col), open_ebwt(col), ds.num_reads, 16,
        SYMBOL_RANK_LUT, host._DEGENERATE_BYTE.astype(np.uint8),
        dense_min=dense_min, num_refs=ds.num_genomes, host_num=0)


def _chain(wide, max_drow):
    rng = np.random.default_rng(2)
    mat = np.where(rng.random((2000, 200)) < 0.02,
                   rng.integers(1, 256, size=(2000, 200)), 0).astype(
        np.uint32 if wide else np.uint8)
    return native.coo_compact(mat, 2000, 200, wide=wide, threads=4,
                              max_drow=max_drow)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return a == b


def test_host_constants_match():
    assert np.array_equal(host._DEGENERATE_BYTE, fused_pass._DEGENERATE_BYTE)
    for name in ("K", "PR", "MAX_ENT", "B_BLK", "C_BLK", "RT_CAP", "GT_CAP"):
        assert getattr(host, name) == getattr(dense_score, name), name
    assert host._COO_POSITION_CAP == jfp._COO_POSITION_CAP


@pytest.mark.parametrize("name,orig", [
    ("classify_block_size", classify_tpu.classify_block_size),
    ("pad_rows_for", classify_tpu.pad_rows_for),
    ("_g_pad_for", jfp._g_pad_for),
    ("_r_pad_for", jfp._r_pad_for),
    ("_classify_block_for", jfp._classify_block_for),
])
def test_host_shape_helpers_match(name, orig):
    for n in list(range(0, 3000, 7)) + [16383, 16384, 16385, 10**6, 10**7]:
        assert getattr(host, name)(n) == orig(n), n


def test_host_stream_helpers_match(dataset):
    arrays, chunks = _plan(dataset)[:2]
    assert _same(host._gcol_padded(arrays[2], chunks),
                 jps._gcol_padded(arrays[2], chunks))
    for wide, max_drow in ((False, 15), (False, 255), (True, 255)):
        segs = _chain(wide, max_drow)
        chain = host.merge_coo_segments(segs, max_drow=max_drow)
        assert _same(chain, jps.merge_coo_segments(segs, max_drow=max_drow))
        if not wide and max_drow == 15:
            assert _same(host._pack24(chain), jps._pack24(chain))


def test_host_pack_chunks_matches(conserved):
    ds = conserved
    out = _plan(ds, dense_min=4)
    da, ebwt = open_da(ds.collections[0]), open_ebwt(ds.collections[0])
    args = (out[4], out[5], da, ebwt, ds.num_reads, ds.num_genomes, 128)
    got = host.pack_chunks(*args)
    assert got[0] and _same(got, dense_score.pack_chunks(*args))


@pytest.mark.parametrize("name", ["_rescue_sparse", "_rescue"])
def test_host_rescue_matches(dataset, deep, name):
    for ds in (dataset, deep):
        out = _plan(ds)
        bad_start, bad_len = out[6], out[7]
        assert len(bad_start)
        col = ds.collections[0]
        args = (bad_start, bad_len, open_da(col), open_ebwt(col),
                ds.num_reads, ds.num_genomes, FUSED)
        assert _same(getattr(host, name)(*args), getattr(jfp, name)(*args))

