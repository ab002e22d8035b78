"""K3's plain version and the banded core: torch port vs lime_tpu.

``lime_tpu_torch.parallel.sharded.banded_partial_sim`` on the CPU runs
the plain version of K3 (``ops/banded_kernels.banded_sim_plain``, the
XLA formulation in position blocks).  It is held exactly against
lime_tpu's XLA ``banded_partial_sim`` and against ``_pallas_partial_sim``
running the Pallas kernel in interpret mode, on the random streams of
``tests/test_pallas_kernel.py``.  The CUDA kernel is held against the
plain version in ``test_torch_cuda.py``.

The CUDA kernel computes K3 by its run rule (``csrc/banded_pairs.cu``):
in a run no longer than ``window + 1`` an emitting read position of
symbol s and occurrence rank k adds 1 for each genome position of its
run with symbol s and rank k; longer runs keep the band walk.
:func:`_run_model` is a numpy model of that rule, held here equal to the
plain version and to lime_tpu's formulations on random streams and on
the real streams of the staged path and the fused banded engine, where
no run longer than ``window + 1`` holds both an emitting read and a
genome position.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu.parallel import sharded as jsh
from lime_tpu_torch import LimeConfig, host, native
from lime_tpu_torch.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu_torch.ops import banded_kernels as bk
from lime_tpu_torch.ops import fused_pass as tfpass
from lime_tpu_torch.ops import fused_pipeline as tfp
from lime_tpu_torch.parallel import sharded as tsh

from .synth import make_dataset
from .test_pallas_kernel import _rand_stream
from .test_torch_selfcontained import ensure_reference_native

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax(m, doc, sym, num_reads, num_refs, window, emit, **kw):
    return np.asarray(jsh.banded_partial_sim(
        jnp.asarray(m), jnp.asarray(doc), jnp.asarray(sym), num_reads,
        num_refs, jnp.int32(window),
        emit_ok=None if emit is None else jnp.asarray(emit), **kw))


def _pallas(m, doc, sym, num_reads, num_refs, window, emit, **kw):
    emit = np.ones(len(m), bool) if emit is None else emit
    return np.asarray(jsh._pallas_partial_sim(
        jnp.asarray(m), jnp.asarray(doc), jnp.asarray(sym), num_reads,
        num_refs, jnp.int32(window), jnp.asarray(emit), interpret=True,
        **kw))


def _torch(m, doc, sym, num_reads, num_refs, window, emit, **kw):
    return tsh.banded_partial_sim(
        _t(m), _t(doc), _t(sym), num_reads, num_refs, window,
        emit_ok=None if emit is None else _t(emit), **kw).numpy()


@pytest.mark.parametrize("num_refs", [5, 130, 300])
@pytest.mark.parametrize("window", [1, 7, 64, 255])
def test_banded_partial_sim_matches_xla_and_pallas(num_refs, window):
    rng = np.random.default_rng(window * 1000 + num_refs)
    num_reads, n = 300, 5000
    m, doc, sym = _rand_stream(rng, n, num_reads, num_refs, 4, window)
    emit = (rng.random(n) < 0.7) if window in (7, 255) else None
    args = (m, doc, sym, num_reads, num_refs, window, emit)
    got = _torch(*args)
    assert got.shape == (num_reads, num_refs)
    assert np.array_equal(got, _jax(*args))
    assert np.array_equal(got, _pallas(*args))
    if window > 1:
        assert got.any()


@pytest.mark.parametrize("block", [700, 2048, None])
def test_block_and_tile_boundaries(block):
    """Clusters straddling the plain version's position blocks, the
    Pallas kernel's 2048-position tiles and its 2048-position HBM
    blocks all score exactly."""
    rng = np.random.default_rng(17)
    num_reads, num_refs, window, n = 400, 10, 40, 9000
    m, doc, sym = _rand_stream(rng, n, num_reads, num_refs, 4, window)
    for start in (2048 - 20, 4096 - 3, 6144 - 39):  # 40-position clusters
        m[start] = m[start + 40] = False
        m[start + 1:start + 40] = True
    want = _jax(m, doc, sym, num_reads, num_refs, window, None)
    assert np.array_equal(want, _pallas(m, doc, sym, num_reads, num_refs,
                                        window, None, block=2048))
    g_pad = 128
    sim = torch.zeros((num_reads + 1, g_pad), dtype=torch.int32)
    bk.banded_sim_plain(sim, bk.pack_positions(_t(m), _t(np.ones(n, bool)),
                                               _t(sym)),
                        _t(doc), window, num_reads, block=block)
    assert np.array_equal(sim.numpy()[:num_reads, :num_refs], want)


@pytest.mark.parametrize("acc", ["int8", "int32"])
def test_out_rows_and_counter_wrap(acc):
    """The raw (out_rows, G_pad) accumulator: int8 wraps mod 256 on
    counts past 255 (three reads, five genomes, long runs), int32 does
    not; the drop row and the rows past it stay zero."""
    rng = np.random.default_rng(3)
    num_reads, num_refs, window, n = 3, 5, 64, 30000
    m, doc, sym = _rand_stream(rng, n, num_reads, num_refs, 2, window)
    emit = rng.random(n) < 0.9
    out_rows = 8
    jacc, tacc = {"int8": (jnp.int8, torch.int8),
                  "int32": (jnp.int32, torch.int32)}[acc]
    want = _jax(m, doc, sym, num_reads, num_refs, window, emit,
                out_rows=out_rows, acc_dtype=jacc)
    got = _torch(m, doc, sym, num_reads, num_refs, window, emit,
                 out_rows=out_rows, acc_dtype=tacc)
    assert got.shape == want.shape == (out_rows, 128)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert not got[num_reads:].any()
    wide = _jax(m, doc, sym, num_reads, num_refs, window, emit)
    assert wide.max() > 255
    if acc == "int8":
        assert np.array_equal(got[:num_reads, :num_refs].view(np.uint8),
                              (wide % 256).astype(np.uint8))


def test_banded_fused_step_matches():
    rng = np.random.default_rng(8)
    num_reads, num_refs, alpha, window, n = 200, 12, 4, 9, 4096
    lcp = rng.integers(0, alpha + 3, size=n).astype(np.int32)
    run = 0
    for i in range(n):  # runs shorter than the window
        run = run + 1 if lcp[i] >= alpha else 0
        if run >= window:
            lcp[i], run = 0, 0
    doc = rng.integers(0, num_reads + num_refs, size=n).astype(np.int32)
    sym = rng.integers(0, 4, size=n).astype(np.int32)
    want = np.asarray(jsh.banded_fused_step(
        jnp.asarray(lcp), jnp.asarray(doc), jnp.asarray(sym), num_reads,
        num_refs, alpha, window))
    got = tsh.banded_fused_step(_t(lcp), _t(doc), _t(sym), num_reads,
                                num_refs, alpha, window).numpy()
    assert want.any() and np.array_equal(got, want)


@pytest.mark.parametrize("acc", ["int8", "int32"])
def test_scatter_sim_matches(acc):
    rng = np.random.default_rng(4)
    num_reads, L, G = 50, 3000, 128
    v = rng.integers(0, 3, size=(L, G)).astype(np.int16)
    rows = np.where(rng.random(L) < 0.8, rng.integers(0, num_reads, L),
                    num_reads).astype(np.int32)
    jacc, tacc = {"int8": (jnp.int8, torch.int8),
                  "int32": (jnp.int32, torch.int32)}[acc]
    want = np.asarray(jsh._scatter_sim(jnp.asarray(v), jnp.asarray(rows),
                                       num_reads, acc_dtype=jacc))
    got = tsh._scatter_sim(_t(v), _t(rows), num_reads,
                           acc_dtype=tacc).numpy()
    assert np.array_equal(got, want)


def test_real_row_out_of_range_raises():
    """The scatter drops nothing: a row index past the accumulator raises
    instead of vanishing, and K3 refuses an accumulator without the drop
    row."""
    v = torch.ones((4, 128), dtype=torch.int16)
    with pytest.raises((IndexError, RuntimeError)):
        tsh._scatter_sim(v, torch.tensor([0, 1, 2, 11]), 10)
    packed = torch.zeros(16, dtype=torch.uint8)
    doc = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="drop row"):
        bk.banded_sim_into(torch.zeros((10, 128), dtype=torch.int32),
                           packed, doc, 4, 10)


@pytest.mark.parametrize("bad", ["packed", "doc", "sim", "window",
                                 "shape"])
def test_banded_sim_into_rejects_bad_input(bad):
    packed = torch.zeros(64, dtype=torch.uint8)
    doc = torch.zeros(64, dtype=torch.int32)
    sim = torch.zeros((11, 128), dtype=torch.int32)
    window = 8
    if bad == "packed":
        packed = packed.to(torch.int32)
    elif bad == "doc":
        doc = doc.to(torch.int64)
    elif bad == "sim":
        sim = sim.to(torch.int16)
    elif bad == "window":
        window = 256
    else:
        doc = doc[:32]
    with pytest.raises(ValueError):
        bk.banded_sim_into(sim, packed, doc, window, 10)


def test_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.default_rng(9)
    m, doc, sym = _rand_stream(rng, 3000, 100, 7, 4, 12)
    before = bk.LAUNCHES["banded"]
    got = _torch(m, doc, sym, 100, 7, 12, None)
    assert bk.LAUNCHES["banded"] == before
    assert np.array_equal(got, _jax(m, doc, sym, 100, 7, 12, None))


# ---------------------------------------------------------------------------
# K3's run rule: a numpy model, random and real streams
# ---------------------------------------------------------------------------

def _runs(packed):
    """Per position its run index; per run its start and length.  A run
    is a position with m = 0 (or the stream's first) and every m = 1
    position after it."""
    start = ((packed >> bk.PACK_M_BIT) & 1) == 0
    start[0] = True
    starts = np.flatnonzero(start)
    return np.cumsum(start) - 1, starts, np.diff(starts, append=len(packed))


def _roles(packed, doc, num_reads, g_cols):
    """(emitting read, counted genome partner) per position."""
    doc = doc.astype(np.int64)
    read = (((packed >> bk.PACK_EMIT_BIT) & 1) == 1) & (doc >= 0) & (
        doc < num_reads)
    return read, (doc >= num_reads) & (doc - num_reads < g_cols)


def _run_occ(packed, doc):
    """Each position's rank among its run's earlier positions of the same
    (document, symbol)."""
    run = _runs(packed)[0]
    n = len(packed)
    order = np.lexsort((np.arange(n), packed & 15, doc, run))
    key = np.stack([run, doc.astype(np.int64), packed & 15])[:, order]
    new = np.ones(n, bool)
    new[1:] = np.any(key[:, 1:] != key[:, :-1], axis=0)
    first = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    occ = np.empty(n, np.int64)
    occ[order] = np.arange(n) - first
    return occ


def _band_walk(sim, packed, doc, window, num_reads, lo, hi):
    """The band formulation on one run [lo, hi): occ looks back at most
    ``window`` positions, partners lie within ``window`` either way."""
    sym, doc = (packed[lo:hi] & 15).astype(np.int64), doc[lo:hi]
    read, genome = _roles(packed[lo:hi], doc, num_reads, sim.shape[1])
    L = hi - lo
    occ = np.array([np.sum((doc[max(0, i - window):i] == doc[i])
                           & (sym[max(0, i - window):i] == sym[i]))
                    for i in range(L)])
    for i in np.flatnonzero(read):
        for j in range(max(0, i - window), min(L, i + window + 1)):
            if j != i and genome[j] and sym[j] == sym[i] \
                    and occ[j] == occ[i]:
                sim[doc[i], doc[j] - num_reads] += 1


def _run_model(packed, doc, window, num_reads, g_cols):
    """K3's counts by its run rule: an int64 ``(num_reads + 1, g_cols)``
    accumulator."""
    sim = np.zeros((num_reads + 1, g_cols), np.int64)
    run, starts, lens = _runs(packed)
    short = lens[run] <= window + 1
    read, genome = _roles(packed, doc, num_reads, g_cols)
    occ, sym, doc64 = _run_occ(packed, doc), packed & 15, doc.astype(np.int64)

    def key(i):
        return (run[i] * 16 + sym[i]) * 256 + occ[i]

    rd = np.flatnonzero(short & read)
    gn = np.flatnonzero(short & genome)
    order = np.argsort(key(gn), kind="stable")
    gkey, gcol = key(gn)[order], doc64[gn][order] - num_reads
    lo = np.searchsorted(gkey, key(rd), "left")
    cnt = np.searchsorted(gkey, key(rd), "right") - lo
    first = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
    np.add.at(sim, (np.repeat(doc64[rd], cnt),
                    gcol[first + np.arange(cnt.sum())]), 1)
    for r in np.flatnonzero(lens > window + 1):
        _band_walk(sim, packed, doc, window, num_reads, starts[r],
                   starts[r] + lens[r])
    return sim


def _long_runs_that_score(packed, doc, window, num_reads, g_cols):
    """Runs longer than ``window + 1`` that hold both an emitting read
    and a counted genome position."""
    run, _, lens = _runs(packed)
    read, genome = _roles(packed, doc, num_reads, g_cols)
    both = (np.bincount(run, read, len(lens)) > 0) & (
        np.bincount(run, genome, len(lens)) > 0)
    return np.flatnonzero(both & (lens > window + 1))


def _plain(packed, doc, window, num_reads, g_cols):
    sim = torch.zeros((num_reads + 1, g_cols), dtype=torch.int32)
    bk.banded_sim_plain(sim, torch.from_numpy(packed),
                        torch.from_numpy(doc), window, num_reads)
    return sim.numpy()


def _run_stream(rng, window, num_reads, num_refs, n):
    """Runs of random lengths in [1, window + 2], with runs of exactly
    window, window + 1 and window + 2 among them, random documents (few
    enough to repeat in a run), symbols and emit gates; m[0] False."""
    lens = [window, window + 1, window + 2] * 2
    while sum(lens) < n:
        lens.append(int(rng.integers(1, window + 3)))
    rng.shuffle(lens)
    m = np.ones(sum(lens), bool)
    m[np.cumsum([0] + lens[:-1])] = False
    n = len(m)
    doc = rng.integers(0, num_reads + num_refs, size=n).astype(np.int32)
    sym = rng.integers(0, 4, size=n).astype(np.int32)
    emit = rng.random(n) < 0.7
    return m, doc, sym, emit


@pytest.mark.parametrize("window,num_reads,num_refs", [
    (7, 40, 6), (64, 30, 8), (255, 12, 5)])
def test_run_model_matches_plain_xla_and_pallas(window, num_reads, num_refs):
    """The run rule equals the plain version, lime_tpu's XLA formulation
    and the Pallas kernel (interpret mode) with ``_scatter_sim``, on runs
    of every length up to window + 2 with repeated documents (occ > 0)
    and a random emit gate."""
    rng = np.random.default_rng(window)
    m, doc, sym, emit = _run_stream(rng, window, num_reads, num_refs, 4000)
    packed = host.pack_stream(m, emit, sym)
    g_cols = 128
    want = _run_model(packed, doc, window, num_reads, g_cols)
    assert want.any() and _run_occ(packed, doc).max() > 0
    assert len(_long_runs_that_score(packed, doc, window, num_reads, g_cols))
    assert np.array_equal(_plain(packed, doc, window, num_reads, g_cols),
                          want)
    args = (m, doc, sym, num_reads, num_refs, window, emit)
    assert np.array_equal(_jax(*args), want[:num_reads, :num_refs])
    assert np.array_equal(_pallas(*args), want[:num_reads, :num_refs])


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """Deep coverage of short genomes: runs past 255 positions, routed to
    the host scorer."""
    return make_dataset(str(tmp_path_factory.mktemp("deep")), num_pairs=800,
                        read_len=100, genome_lens=(500, 400), seed=11)


def _real_streams(ds, kind):
    """Per collection of ``ds``: (codes, document ids, window) of the
    stream K3 scores on the staged path or in the fused banded engine."""
    cfg = LimeConfig(fused=True, pair_stream=False, dense_threshold=0) \
        if kind == "planner" else LimeConfig()
    for col in ds.collections:
        lcp, da, ebwt = open_lcp(col), open_da(col), open_ebwt(col)
        if kind == "staged":
            starts, lens = native.plan_clusters(lcp, da, ds.num_reads,
                                                cfg.alpha)
            packed, doc, window, _ = tfpass.staged_stream(
                starts, lens, da, ebwt, cfg, cfg.alpha, lcp)
            yield packed, doc, window
        else:
            packed, doc, nc, window = tfp.plan_banded(
                lcp, da, ebwt, ds.num_reads, ds.num_genomes, cfg)[:4]
            if nc:
                yield tfp.banded_codes(packed), tfp._doc_i32(doc), window


@pytest.mark.parametrize("kind", ["staged", "planner"])
@pytest.mark.parametrize("which", ["dataset", "deep"])
def test_run_model_matches_plain_on_real_streams(request, which, kind):
    """On every collection's real stream the run rule equals the plain
    version, and no run longer than window + 1 holds both an emitting read
    and a genome position: the kernel's long-run path is off these
    paths."""
    ds = request.getfixturevalue(which)
    g_cols = host._g_pad_for(ds.num_genomes)
    n_streams = 0
    for packed, doc, window in _real_streams(ds, kind):
        n_streams += 1
        want = _run_model(packed, doc, window, ds.num_reads, g_cols)
        assert want.any()
        assert np.array_equal(
            _plain(packed, doc, window, ds.num_reads, g_cols), want)
        assert not len(_long_runs_that_score(packed, doc, window,
                                             ds.num_reads, g_cols))
    assert n_streams == len(ds.collections)


def test_kernel_ab_finds_another_checkouts_banded_build(tmp_path):
    """``kernel_ab --kernel banded`` builds the other checkout's K3 with
    that checkout's own ``cuda_build``: from its source into its own
    ``build/``."""
    import os
    import shutil

    from lime_tpu_torch import kernel_ab

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = tmp_path / "other"
    shutil.copytree(os.path.join(root, "lime_tpu_torch", "ops"),
                    other / "lime_tpu_torch" / "ops")
    shutil.copytree(os.path.join(root, "lime_tpu_torch", "csrc"),
                    other / "lime_tpu_torch" / "csrc")
    cb = kernel_ab.load_other(str(other), "cuda_build")
    assert cb.__name__ == "_other.ops.cuda_build"
    assert cb.lib_path("banded_pairs") == str(
        other / "build" / "lime_tpu_torch" / "libbanded_pairs.so")
    assert os.path.exists(cb.source_path("banded_pairs"))
