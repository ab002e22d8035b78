"""K3's plain version and the banded core: torch port vs lime_tpu.

``lime_tpu_torch.parallel.sharded.banded_partial_sim`` on the CPU runs
the plain version of K3 (``ops/banded_kernels.banded_sim_plain``, the
XLA formulation in position blocks).  It is held exactly against
lime_tpu's XLA ``banded_partial_sim`` and against ``_pallas_partial_sim``
running the Pallas kernel in interpret mode, on the random streams of
``tests/test_pallas_kernel.py``.  The CUDA kernel is held against the
plain version in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu.parallel import sharded as jsh
from lime_tpu_torch.host import ensure_native
from lime_tpu_torch.ops import banded_kernels as bk
from lime_tpu_torch.parallel import sharded as tsh

from .test_pallas_kernel import _rand_stream

# build and load the native library before any test, whatever the
# other test processes do (lime_tpu_torch.host.ensure_native)
ensure_native()
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
