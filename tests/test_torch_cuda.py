"""The port's CUDA path on the card: each kernel and device step against
its plain version on the CPU, and end to end against the jax-free host
reference.  All comparisons are exact.

Every test needs an NVIDIA GPU (and nvcc to build the pair kernels) and
skips without one.  The file imports no jax, so it also runs on a machine
without it, where the suite's conftest (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.constants import NUM_RANKS, SYMBOL_RANK_LUT
from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu_torch import host, reference, run_paired, run_single
from lime_tpu_torch.ops import classify_torch as ct
from lime_tpu_torch.ops import pair_kernels as pk
from lime_tpu_torch.ops import pair_score as tps
from lime_tpu_torch.ops.dense_score import _dense_chunk

from .synth import make_dataset
from .synth_big import make_big_dataset

pytestmark = pytest.mark.cuda

FUSED = LimeConfig(fused=True)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def deep(cuda, tmp_path_factory):
    """Short genomes under deep coverage: all three pair buckets and the
    host rescue."""
    return make_dataset(str(tmp_path_factory.mktemp("deep")), num_pairs=800,
                        read_len=100, genome_lens=(500, 400), seed=11)


@pytest.fixture(scope="module")
def conserved(cuda, tmp_path_factory):
    """Genomes sharing mutated group templates: genome-dense clusters."""
    return make_big_dataset(str(tmp_path_factory.mktemp("conserved")),
                            num_pairs=3000, num_genomes=12, genome_len=3000,
                            conserved_frac=0.3, group_size=6, seed=3)


def _plan(ds, fi=0, dense_min=16, use_ebwt=True):
    col = ds.collections[fi]
    return native.plan_pairs_packed(
        open_lcp(col), open_da(col), open_ebwt(col) if use_ebwt else None,
        ds.num_reads, 16, SYMBOL_RANK_LUT,
        host._DEGENERATE_BYTE.astype(np.uint8), dense_min=dense_min,
        num_refs=ds.num_genomes, host_num=0)


@pytest.mark.parametrize("cap", [16, 64, 255])
def test_cuda_kernel_matches_plain(cuda, cap):
    """Each CUDA kernel equals the plain version on read rows, and counts
    exactly one launch."""
    codes_np = pk.planner_shaped_stream(np.random.default_rng(cap),
                                        8 * pk.PAIR_TILE, cap)
    codes = torch.from_numpy(codes_np).to(cuda)
    name = {16: "scan16", 64: "scan64", 255: "band"}[cap]
    before = pk.LAUNCHES[name]
    got = pk.pair_hits(codes, cap, cap).cpu().numpy()
    assert pk.LAUNCHES[name] == before + 1
    want = pk.pair_hits_plain(codes, cap, cap).cpu().numpy()
    read = ((codes_np >> 4) & 1) == 0
    assert np.array_equal(got[read], want[read])


@pytest.mark.parametrize("wide", [False, True])
def test_pair_plane_cuda_matches_cpu(cuda, deep, wide):
    arrays, chunks, windows, row_bits = _plan(deep)[:4]
    assert {c[0] for c in chunks} == {0, 1, 2}
    shape = (host._r_pad_for(deep.num_reads),
             host._g_pad_for(deep.num_genomes))
    dt = torch.int32 if wide else torch.int8
    planes = []
    for dev in (CPU, cuda):
        sim = torch.zeros(shape, dtype=dt, device=dev)
        keep = []
        tps.pair_score_packed_into(sim, arrays, chunks, windows, row_bits,
                                   deep.num_reads, keep)
        planes.append(sim.cpu().numpy()[:deep.num_reads])
    assert np.any(planes[0])
    assert np.array_equal(planes[1], planes[0])


def test_dense_chunk_cuda_matches_cpu(cuda, conserved):
    ds = conserved
    out = _plan(ds, dense_min=4)
    da, ebwt = open_da(ds.collections[0]), open_ebwt(ds.collections[0])
    g_pad = host._g_pad_for(ds.num_genomes)
    chunks = host.pack_chunks(out[4], out[5], da, ebwt, ds.num_reads,
                              ds.num_genomes, g_pad)[0]
    assert chunks
    planes = []
    for dev in (CPU, cuda):
        sim = torch.zeros((host._r_pad_for(ds.num_reads), g_pad),
                          dtype=torch.int8, device=dev)
        for arrs in chunks:
            _dense_chunk(sim, *(torch.from_numpy(a).to(dev) for a in arrs),
                         host.B_BLK, host.C_BLK, host.PR, 4 * host.K, g_pad)
        planes.append(sim.cpu().numpy()[:ds.num_reads])
    assert np.any(planes[0])
    assert np.array_equal(planes[1], planes[0])


@pytest.mark.parametrize("assign_higher", [False, True])
def test_cascade_cuda_bit_equal_to_classify_ops(cuda, assign_higher):
    """The CUDA classify program against the numpy cascade fed the same
    normalised, beta-gated rows: types and taxids exact, sims bit-equal
    (a reciprocal-multiply division would differ by one ulp)."""
    rng = np.random.default_rng(21 + assign_higher)
    F, R, G, g_pad, read_len = 4, 4096, 300, 384, 100
    cfg = LimeConfig(assign_higher=assign_higher, tax_rank=1)
    planes_h = np.zeros((F, R, g_pad), np.uint8)
    planes_h[:, :, :G] = np.where(rng.random((F, R, G)) < 0.05,
                                  rng.integers(0, 256, size=(F, R, G)), 0)
    rows = np.arange(R)
    tie = rng.integers(0, G - 4, size=R)
    for j in (1, 2):
        planes_h[:, rows, tie + j] = planes_h[:, rows, tie]
    tax = (1000 + np.arange(G) // 3).astype(np.int64)
    rank = np.stack([(1000 + np.arange(G) // (3 << lv)).astype(np.int64)
                     for lv in range(NUM_RANKS)])
    want = reference.classify_matrices(
        [planes_h[f, :, :G] for f in range(F)], read_len, tax, rank, cfg)

    buf, stack = ct.alloc_planes(F, R, g_pad, torch.int8, cuda)
    stack.copy_(torch.from_numpy(planes_h.view(np.int8)).to(cuda))
    tax_p = np.zeros(g_pad, np.int64)
    tax_p[:G] = tax
    rank_p = np.zeros((NUM_RANKS, g_pad), np.int64)
    rank_p[:, :G] = rank

    def f32(v):
        return torch.tensor(np.float32(v), device=cuda)

    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    packed = ct._classify_program_planes(
        buf, F, R, g_pad, empty, empty, empty.to(torch.int8), empty,
        torch.from_numpy(tax_p).to(cuda), torch.from_numpy(rank_p).to(cuda),
        torch.arange(g_pad, device=cuda) < G, f32(cfg.error_tolerance),
        f32(np.uint32(read_len + 1 - cfg.alpha)), f32(cfg.beta),
        cfg.tax_rank, assign_higher, True, 1024)
    t_h, x_h, s_h = ct._unpack_triplet(packed.cpu().numpy())
    assert np.array_equal(t_h, want.types.astype(np.uint8))
    assert np.array_equal(x_h, want.taxid)
    assert np.array_equal(s_h.view(np.uint32), want.sim.view(np.uint32))
    assert {1, 3 if assign_higher else 2} <= set(np.unique(t_h).tolist())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("single,kw", [
    (False, {}),
    (True, dict(assign_higher=True, tax_rank=1)),
    (False, dict(use_ebwt=False)),
    (False, dict(wide_sim=True)),
])
def test_run_cuda_matches_reference(cuda, deep, tmp_path, single, kw):
    """End to end on the card: the CSV equals the jax-free host
    reference byte for byte, and every pair kernel ran."""
    cfg = FUSED.replace(**kw)
    cols = deep.single_collections if single else deep.collections
    args = (deep.num_reads, deep.num_genomes, deep.lineage_path,
            deep.read_len, cfg)
    a, c = str(tmp_path / "torch.csv"), str(tmp_path / "ref.csv")
    pk.reset_launches()
    (run_single if single else run_paired)(cols, a, *args, device=cuda)
    launches = dict(pk.LAUNCHES)
    reference.reference_csv(cols, c, *args)
    assert _read(a) == _read(c)
    assert all(launches.values()), launches
