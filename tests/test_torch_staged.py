"""The staged executor and the fused banded engine: torch port vs lime_tpu.

``lime_tpu_torch.run_paired(..., LimeConfig())`` runs cluster_lcp ->
cluster_bwt (K3 on the device; its plain version here) -> classify, as
``lime_tpu.run_paired(..., LimeConfig())`` does, and must write the same
CSV, ``.clrs``, ``.res.bin`` / ``.res.pos`` (or ``.res.txt``) bytes.
Also held exactly: the staged device ops against their JAX originals,
the fused ``pair_stream=False`` engine, the stage subcommands of the
CLI, the pinned copies of the banded engine's host helpers, and the
native library's recovery from a half-written file.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.ops import classify_tpu
from lime_tpu.ops import fused_pass as jfpass
from lime_tpu.ops import fused_pipeline as jfp
from lime_tpu.ops import pallas_kernels as jpk
from lime_tpu.pipeline import run_paired as jax_run_paired
from lime_tpu.pipeline import run_single as jax_run_single
from lime_tpu_torch import cli as torch_cli
from lime_tpu_torch import host, run_paired, run_single
from lime_tpu_torch.host import ensure_native
from lime_tpu_torch.ops import banded_kernels as bk
from lime_tpu_torch.ops import fused_pass as tfpass
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.ops.classify_torch import classify_reads_torch

# build and load the native library before any test, whatever the
# other test processes do (lime_tpu_torch.host.ensure_native)
ensure_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXTS = (".16.clrs", ".out", ".res.bin", ".res.pos", ".res.txt")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _args(ds):
    return (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)


def _artifacts(cols):
    """Every stage checkpoint next to ``cols``, read and then removed, so
    the next run starts from none."""
    out = {}
    for c in cols:
        for ext in _EXTS:
            if os.path.exists(c + ext):
                out[os.path.basename(c) + ext] = _read(c + ext)
                os.remove(c + ext)
    return out


# ---------------------------------------------------------------------------
# Device ops against their JAX originals
# ---------------------------------------------------------------------------

def test_find_clusters_matches(dataset):
    for col in dataset.collections[:2]:
        lcp, da = open_lcp(col), open_da(col)
        want = jfpass.find_clusters_tpu(lcp, da, dataset.num_reads, 16,
                                        block=5000)
        got = tfpass.find_clusters_tpu(lcp, da, dataset.num_reads, 16,
                                       block=5000, device="cpu")
        assert len(want[0]) and all(np.array_equal(g, w)
                                    for g, w in zip(got, want))


@pytest.mark.parametrize("kw,with_lcp", [
    (dict(), True),
    (dict(use_ebwt=False), True),
    (dict(wide_sim=True), True),
    (dict(), False),
])
def test_score_clusters_matches(dataset, kw, with_lcp):
    """Banded scores plus the host rescue (the dataset's IUPAC-degenerate
    clusters) equal lime_tpu's matrix in dtype and value; without lcp the
    run mask is rebuilt from the cluster list."""
    cfg = LimeConfig(**kw)
    col = dataset.collections[1]
    lcp, da = open_lcp(col), open_da(col)
    ebwt = open_ebwt(col) if cfg.use_ebwt else None
    starts, lens = native.plan_clusters(lcp, da, dataset.num_reads, 16)
    extra = dict(alpha=16, lcp=lcp) if with_lcp else {}
    want = jfpass.score_clusters_tpu(starts, lens, da, ebwt,
                                     dataset.num_reads, dataset.num_genomes,
                                     cfg, **extra)
    got = tfpass.score_clusters_tpu(starts, lens, da, ebwt,
                                    dataset.num_reads, dataset.num_genomes,
                                    cfg, device="cpu", **extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and want.any()
    if cfg.use_ebwt:  # the rescue ran
        assert len(host._bad_cluster_mask(starts, lens, ebwt, 255, True,
                                          len(da))[1])


@pytest.mark.parametrize("F,assign_higher", [(4, False), (2, True)])
def test_classify_reads_matches(F, assign_higher):
    rng = np.random.default_rng(F)
    B, T = 700, 37
    dense = np.where(rng.random((B, F, T)) < 0.2,
                     rng.integers(0, 86, (B, F, T)) / np.float32(85),
                     0).astype(np.float32)
    dense[:100] = 0                                   # unclassified
    dense[::3, :, T - 1] = dense[::3].max(axis=2)     # cross-taxon ties
    max_sim = dense.max(axis=2)
    tax = (100 + np.arange(T) // 3).astype(np.uint32)
    rank = np.stack([(100 + np.arange(T) // (3 << lv)).astype(np.uint32)
                     for lv in range(6)])
    err = np.float32(0.02)
    want = classify_tpu.classify_reads_tpu(dense, max_sim, tax, rank, 1,
                                           err, assign_higher)
    got = classify_reads_torch(dense, max_sim, tax, rank, 1, err,
                               assign_higher, "cpu")
    assert np.array_equal(got.types, want.types)
    assert np.array_equal(got.taxid, want.taxid)
    assert np.array_equal(got.sim.view(np.uint32), want.sim.view(np.uint32))
    assert {0, 1, 3 if assign_higher else 2} <= set(want.types.tolist())


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("single,kw", [
    (False, dict()),
    (True, dict()),
    (False, dict(assign_higher=True)),
    (False, dict(use_ebwt=False)),
    (False, dict(binary_results=False)),
    (True, dict(wide_sim=True, binary_results=False)),
])
def test_staged_run_matches_jax(dataset, tmp_path, single, kw):
    """The default entry point: CSV and every checkpoint byte-identical
    to lime_tpu's staged run."""
    cfg = LimeConfig(**kw)
    cols = dataset.single_collections if single else dataset.collections
    fn, jfn = (run_single, jax_run_single) if single else \
        (run_paired, jax_run_paired)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    _artifacts(cols)
    s_j = jfn(cols, b, *_args(dataset), cfg)
    want = _artifacts(cols)
    bk.reset_launches()
    s = fn(cols, a, *_args(dataset), cfg, device="cpu")
    got = _artifacts(cols)
    assert bk.LAUNCHES["banded"] == 0  # CPU tensors take the plain version
    assert _read(a) == _read(b)
    assert s == s_j
    assert got == want
    assert any(k.endswith(".res.txt" if not cfg.binary_results
                          else ".res.pos") for k in want)


def test_staged_keep_results_false_removes_res(dataset, tmp_path):
    cols = dataset.single_collections
    run_single(cols, str(tmp_path / "a.csv"), *_args(dataset),
               LimeConfig(), keep_results=False, device="cpu")
    left = _artifacts(cols)
    assert left and not any(".res." in k for k in left)


@pytest.mark.parametrize("dense_threshold", [None, 3])
def test_fused_banded_matches_jax(dataset, tmp_path, dense_threshold):
    cfg = LimeConfig(fused=True, pair_stream=False,
                     dense_threshold=dense_threshold)
    a, b = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    jax_run_paired(dataset.collections, b, *_args(dataset), cfg)
    run_paired(dataset.collections, a, *_args(dataset), cfg, device="cpu")
    assert _read(a) == _read(b)
    assert tfp.LAST_RUN["engine"] == "banded"
    windows = tfp.LAST_RUN["banded_windows"]
    assert all(windows) if dense_threshold is None else not any(windows)


def test_cli_stages_match_jax(dataset, tmp_path):
    """cluster-lcp, cluster-bwt and classify subcommands write what
    lime_tpu's staged run writes."""
    cols = dataset.collections
    b = str(tmp_path / "jax.csv")
    _artifacts(cols)
    jax_run_paired(cols, b, *_args(dataset), LimeConfig())
    want = _artifacts(cols)
    n, g = str(dataset.num_reads), str(dataset.num_genomes)
    for c in cols:
        assert torch_cli.main(["cluster-lcp", c, n, g, "--device",
                               "cpu"]) == 0
        assert torch_cli.main(["cluster-bwt", c, str(dataset.read_len),
                               "--device", "cpu"]) == 0
    a = str(tmp_path / "torch.csv")
    assert torch_cli.main(["classify", "4", *[c + ".res" for c in cols], n,
                           g, a, dataset.lineage_path, "1", "--device",
                           "cpu"]) == 0
    assert _artifacts(cols) == want
    assert _read(a) == _read(b)


# ---------------------------------------------------------------------------
# host.py copies against their originals; the native library's recovery
# ---------------------------------------------------------------------------

def test_banded_host_helpers_match(dataset):
    assert host._BLOCK == jfpass._BLOCK == jfp._BLOCK
    assert host._M_BIT == jfp._M_BIT
    assert (host.PACK_M_BIT, host.PACK_EMIT_BIT) == (jpk.PACK_M_BIT,
                                                     jpk.PACK_EMIT_BIT)
    rng = np.random.default_rng(0)
    m, emit = rng.random(999) < 0.5, rng.random(999) < 0.5
    sym = rng.integers(0, 16, 999)
    got = host.pack_stream(m, emit, sym)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jpk.pack_stream(m, emit, sym))
    assert np.array_equal(
        bk.pack_positions(torch.from_numpy(m), torch.from_numpy(emit),
                          torch.from_numpy(sym)).numpy(), got)
    assert np.array_equal(np.asarray(jpk.pack_stream(
        jnp.asarray(m), jnp.asarray(emit), jnp.asarray(sym))), got)
    for col in dataset.collections:
        lcp, da, ebwt = open_lcp(col), open_da(col), open_ebwt(col)
        starts, lens = native.plan_clusters(lcp, da, dataset.num_reads, 16)
        for window, use_ebwt in ((255, True), (int(lens.max()) - 1, True),
                                 (255, False)):
            args = (starts, lens, ebwt, window, use_ebwt, len(da))
            ok, bad = host._bad_cluster_mask(*args)
            ok_j, bad_j = jfpass._bad_cluster_mask(*args)
            assert np.array_equal(ok, ok_j) and np.array_equal(bad, bad_j)
    for g in (1, 100, 128, 200, 256, 257, 930, 5000):
        for cfg in (LimeConfig(), LimeConfig(dense_threshold=3),
                    LimeConfig(mxu_dense_min=4)):
            assert host._dense_threshold_for(g, cfg) == \
                jfp._dense_threshold_for(g, cfg)
            assert host._dense_min_for(g, cfg) == jfp._dense_min_for(g, cfg)


def test_ensure_native_recovers_from_truncated_library(tmp_path):
    """A half-written library marks lime_tpu.native failed for the
    process; ensure_native rebuilds it under its lock and loads it.  The
    library is pointed at a private directory: the shared one is never
    touched."""
    code = f"""
import os
from lime_tpu import native
d = {str(tmp_path)!r}
native._LIB_DIR = d
native._LIB = os.path.join(d, "liblime_native.so")
with open(native._LIB, "wb") as f:
    f.write(b"\\x7fELF" + bytes(4092))
assert not native.available() and native._failed
from lime_tpu_torch.host import ensure_native
ensure_native()
assert native.available() and not native._failed
print("recovered")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert "recovered" in out.stdout
    assert os.path.exists(tmp_path / "liblime_native.so.ok")
