"""Pair-hit kernels of the torch port against the JAX package.

The plain torch versions (the CPU side of ``pair_kernels.pair_hits``)
are held, exactly, against lime_tpu's Pallas kernels run in interpret
mode, the XLA band core and the vectorised numpy oracle.  The CUDA
kernels are held against the plain versions in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu.ops import pair_score as jps
from lime_tpu.ops.pallas_kernels import pair_hits_pallas
from lime_tpu.ops.pallas_kernels import (
    planner_shaped_stream as jax_planner_shaped_stream)
from lime_tpu_torch.host import ensure_native
from lime_tpu_torch.ops import pair_kernels as pk
from lime_tpu_torch.ops import pair_score as tps

# build and load the native library before any test, whatever the
# other test processes do (lime_tpu_torch.host.ensure_native)
ensure_native()
# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)


def _oracle_packed(codes):
    """5-bit codes -> the numpy oracle's byte layout (bit6 m, bit5 dr,
    bit4 gs, bits 0-3 sym)."""
    return ((codes & 3) | (((codes >> 3) & 1) << 5)
            | (((codes >> 4) & 1) << 4)
            | (((codes >> 2) & 1) << 6)).astype(np.uint8)


@pytest.mark.parametrize("cap,tiles", [(16, 2), (64, 2), (255, 1)])
def test_pair_hits_plain_matches_pallas_and_oracle(cap, tiles):
    """Exact (int32) on read rows against the Pallas kernel of the cap's
    bucket (interpret mode, as tests/test_pallas_kernel.py runs it) and
    the numpy oracle, on planner-shaped streams."""
    codes = pk.planner_shaped_stream(np.random.default_rng(300 + cap),
                                     tiles * pk.PAIR_TILE, cap)
    read = ((codes >> 4) & 1) == 0
    got = pk.pair_hits(torch.from_numpy(codes), cap, cap).numpy()
    pallas = np.asarray(pair_hits_pallas(jnp.asarray(codes), jnp.int32(cap),
                                         cap=cap, interpret=True))
    oracle = jps.pair_hits_host(_oracle_packed(codes))
    assert np.array_equal(got[read], pallas[read])
    assert np.array_equal(got[read], oracle[read])


@pytest.mark.parametrize("window", [1, 7, 40])
def test_pair_hits_core_matches_jax_on_every_row(window):
    """The plain band core equals lime_tpu's _pair_hits_core on every
    row (genome rows too) of arbitrary codes, chunk edges included."""
    rng = np.random.default_rng(window)
    codes = rng.integers(0, 32, size=4096).astype(np.uint8)
    m, dr, gs, sym = (((codes >> 2) & 1).astype(bool),
                      ((codes >> 3) & 1).astype(bool),
                      ((codes >> 4) & 1).astype(bool),
                      (codes & 3).astype(np.int8))
    want = np.asarray(jps._pair_hits_core(
        jnp.asarray(m), jnp.asarray(dr), jnp.asarray(gs), jnp.asarray(sym),
        jnp.int32(window)))
    got = tps._pair_hits_core(torch.from_numpy(m), torch.from_numpy(dr),
                              torch.from_numpy(gs),
                              torch.from_numpy(sym.astype(np.int32)),
                              window).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cap", [16, 64, 255])
def test_planner_shaped_stream_copy_matches(cap):
    a = pk.planner_shaped_stream(np.random.default_rng(9), 20000, cap)
    b = jax_planner_shaped_stream(np.random.default_rng(9), 20000, cap)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("row_bits", [20, 24, 28])
def test_unpack_ports_match(row_bits):
    """_unpack_bits5 / _unpack_rows equal lime_tpu's, all 32 word bits
    exercised (u32 words travel as int32 bits)."""
    rng = np.random.default_rng(row_bits)
    groups = 512
    bits_b = rng.integers(0, 256, size=groups * 5).astype(np.uint8)
    rows_w = rng.integers(0, 1 << 32, size=groups * row_bits // 4,
                          dtype=np.uint64).astype(np.uint32)
    want_b = np.asarray(jps._unpack_bits5(jnp.asarray(bits_b)))
    want_r = np.asarray(jps._unpack_rows(jnp.asarray(rows_w), row_bits))
    got_b = tps._unpack_bits5(torch.from_numpy(bits_b)).numpy()
    got_r = tps._unpack_rows(torch.from_numpy(rows_w.view(np.int32)),
                             row_bits).numpy()
    assert np.array_equal(got_b, want_b.astype(np.int64))
    assert np.array_equal(got_r, want_r.astype(np.int64))


@pytest.mark.parametrize("bad", ["dtype", "length", "cap", "window",
                                 "strided"])
def test_pair_hits_rejects_bad_input(bad):
    codes = torch.zeros(pk.PAIR_TILE, dtype=torch.uint8)
    window, cap = 16, 16
    if bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "length":
        codes = codes[:1000]
    elif bad == "cap":
        cap = 32
    elif bad == "window":
        window = 256
    else:
        codes = torch.zeros(2 * pk.PAIR_TILE, dtype=torch.uint8)[::2]
    with pytest.raises(ValueError):
        pk.pair_hits(codes, window, cap)


def test_cpu_tensor_takes_plain_version_without_launch():
    pk.reset_launches()
    codes = torch.from_numpy(pk.planner_shaped_stream(
        np.random.default_rng(3), pk.PAIR_TILE, 16))
    got = pk.pair_hits(codes, 16, 16)
    assert torch.equal(got, pk.pair_hits_plain(codes, 16, 16))
    assert pk.LAUNCHES == {"scan16": 0, "scan64": 0, "band": 0}

