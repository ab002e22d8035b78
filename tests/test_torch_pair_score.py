"""Packed pair-stream scoring and delta-COO scatters: torch port vs JAX.

Planes must be int8 (or int32 with wide counters) exact on every real
read row; the drop row past them is scratch in both engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lime_tpu import native
from lime_tpu.constants import SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu.ops import pair_score as jps
from lime_tpu_torch import host
from lime_tpu_torch.ops import pair_score as tps

from .synth import make_dataset

# Many small CPU ops: intra-op threads would only contend with the other
# test workers (oversubscribed barriers cost orders of magnitude).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def deep_dataset(tmp_path_factory):
    """Short genomes under deep coverage: copies longer than 16 and 64
    rows, so the planner fills all three buckets."""
    root = tmp_path_factory.mktemp("deep")
    return make_dataset(str(root), num_pairs=800, read_len=100,
                        genome_lens=(500, 400), seed=11)


def _plan(ds, fi):
    col = ds.collections[fi]
    return native.plan_pairs_packed(
        open_lcp(col), open_da(col), open_ebwt(col), ds.num_reads, 16,
        SYMBOL_RANK_LUT, host._DEGENERATE_BYTE.astype(np.uint8),
        dense_min=16, num_refs=ds.num_genomes, host_num=0)


def _planes(ds, fi, wide):
    arrays, chunks, windows, row_bits = _plan(ds, fi)[:4]
    r_pad = host._r_pad_for(ds.num_reads)
    g_pad = host._g_pad_for(ds.num_genomes)
    jdt, tdt = (jnp.int32, torch.int32) if wide else (jnp.int8, torch.int8)
    want = np.asarray(jps.pair_score_packed_into(
        jnp.zeros((r_pad, g_pad), jdt), arrays, chunks, windows, row_bits,
        ds.num_reads, g_pad))
    got = torch.zeros((r_pad, g_pad), dtype=tdt)
    tps.pair_score_packed_into(got, arrays, chunks, windows, row_bits,
                               ds.num_reads, keep=[])
    return want, got.numpy(), {c[0] for c in chunks}


@pytest.mark.parametrize("fi", [0, 1, 2, 3])
def test_pair_plane_matches_jax(dataset, fi):
    want, got, _ = _planes(dataset, fi, wide=False)
    n = dataset.num_reads
    assert np.any(want[:n])
    assert np.array_equal(got[:n], want[:n])


@pytest.mark.parametrize("wide", [False, True])
def test_pair_plane_all_buckets_matches_jax(deep_dataset, wide):
    want, got, buckets = _planes(deep_dataset, 0, wide=wide)
    assert buckets == {0, 1, 2}
    n = deep_dataset.num_reads
    assert np.array_equal(got[:n], want[:n])


@pytest.mark.parametrize("packed24,wide", [(True, False), (False, False),
                                           (False, True)])
def test_coo_scatter_matches_jax(packed24, wide):
    """Both delta-COO formats (coo24, and the plain chain with u8 or u32
    values) land the same counters as lime_tpu's scatters."""
    rng = np.random.default_rng(4)
    R, G, r_pad, g_pad = 3000, 300, 3072, 384
    dt = np.uint32 if wide else np.uint8
    mat = np.where(rng.random((R, G)) < 0.01,
                   rng.integers(1, 256, size=(R, G)), 0).astype(dt)
    max_drow = 15 if packed24 else 255
    chain = host.merge_coo_segments(
        native.coo_compact(mat, R, G, wide=wide, threads=3,
                           max_drow=max_drow), max_drow=max_drow)
    jdt, tdt = (jnp.int32, torch.int32) if wide else (jnp.int8, torch.int8)
    want = np.asarray(jps.coo_scatter_into(
        jnp.zeros((r_pad, g_pad), jdt), chain, packed24=packed24))
    got = torch.zeros((r_pad, g_pad), dtype=tdt)
    tps.coo_scatter_into(got, chain, keep=[], packed24=packed24)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[:R, :G].view(dt) if not wide
                          else got.numpy()[:R, :G].astype(dt), mat)


def test_pair_chunk_length_must_be_tile_multiple():
    with pytest.raises(ValueError):
        tps._hits_dispatch(torch.zeros(1000, dtype=torch.int32), 16, 16)
