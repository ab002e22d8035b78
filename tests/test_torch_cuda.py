"""The port's CUDA path on the card: each kernel and device step against
its plain version on the CPU, and end to end against the jax-free host
reference.  All comparisons are exact.

Every test needs an NVIDIA GPU (and nvcc to build the pair kernels) and
skips without one.  The file imports no jax, so it also runs on a machine
without it, where the suite's conftest (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from lime_tpu_torch import (LimeConfig, host, native, pipeline, reference,
                            run_paired, run_single)
from lime_tpu_torch.constants import NUM_RANKS, SYMBOL_RANK_LUT
from lime_tpu_torch.formats.arrays import open_da, open_ebwt, open_lcp
from lime_tpu_torch.ops import banded_kernels as bk
from lime_tpu_torch.ops import dense_kernels
from lime_tpu_torch.ops import classify_torch as ct
from lime_tpu_torch.ops import fused_pipeline
from lime_tpu_torch.ops import pair_kernels as pk
from lime_tpu_torch.ops import pair_score as tps
from lime_tpu_torch.ops.dense_score import (_dense_chunk, _dense_chunk_offset,
                                            dense_score_into)
from lime_tpu_torch.parallel import sharded
from lime_tpu_torch.synth_big import make_big_dataset
from lime_tpu_torch.utils.memory import MemoryProfiler, memory_report
from lime_tpu_torch.utils.timing import (pair_kernel_launches, read_trace,
                                         trace_summary)

from . import test_torch_dense_kernel as tdk
from .synth import make_dataset
from .test_torch_selfcontained import ensure_reference_native

pytestmark = pytest.mark.cuda
# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()

FUSED = LimeConfig(fused=True)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def planner_is_native(request):
    """Every run of this file plans with the C++ planner (a failed native
    build cannot pass on the numpy path unseen), except the runs of the
    ``no_native`` tests, which set the library aside."""
    runs = (fused_pipeline.LAST_RUN, pipeline.LAST_RUN, sharded.LAST_RUN)
    for run in runs:
        run.clear()
    yield
    if "no_native" not in request.node.name:
        assert all(run.get("planner", "native") == "native" for run in runs)


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
    codes_np = pk.planner_shaped_chunk(np.random.default_rng(cap),
                                       8 * pk.PAIR_TILE, cap)
    codes = torch.from_numpy(codes_np).to(cuda)
    name = {16: "scan16", 64: "scan64", 255: "band"}[cap]
    before = pk.LAUNCHES[name]
    got = pk.pair_hits(codes, cap, cap).cpu().numpy()
    assert pk.LAUNCHES[name] == before + 1
    want = pk.pair_hits_plain(codes, cap, cap).cpu().numpy()
    read = ((codes_np >> 4) & 1) == 0
    assert np.array_equal(got[read], want[read])


def _copy(read_runs, genome_run):
    """5-bit codes of one copy: its read document runs, then one genome
    run (lists of symbols)."""
    rows = []
    for run in read_runs:
        rows += [s | (8 if j else 0) for j, s in enumerate(run)]
    rows += [s | 0x10 | (8 if j else 0) for j, s in enumerate(genome_run)]
    return np.array([c | (4 if i else 0) for i, c in enumerate(rows)],
                    np.uint8)


def _random_copy(rng, length):
    g = int(rng.integers(1, length))  # genome rows; one read row at least
    cuts = np.sort(rng.choice(np.arange(1, length - g), size=min(
        3, length - g - 1), replace=False)) if length - g > 1 else []
    bounds = [0, *cuts, length - g]
    return _copy([list(rng.integers(0, 4, bounds[i + 1] - bounds[i]))
                  for i in range(len(bounds) - 1)],
                 list(rng.integers(0, 4, g)))


def _edge_stream(kind, cap, n=2 * pk.PAIR_TILE):
    """Planner-shaped codes that press on the kernel's edges; everything
    not placed is pad rows (0x10), as the planner pads a chunk."""
    rng = np.random.default_rng(cap)
    codes = np.full(n, 0x10, np.uint8)
    halo = (cap - 1 + 15) // 16 * 16
    edges = sorted({e for step in (4096 - 2 * halo, 4096)
                    for e in range(step, n, step)})
    long_run = 255 if cap == 255 else cap - 1
    end = 0
    if kind == "pads":  # copies between runs of pad rows
        while True:
            end += int(rng.integers(0, 40))
            c = _random_copy(rng, int(rng.integers(2, cap + 1)))
            if end + len(c) > n:
                break
            codes[end:end + len(c)] = c
            end += len(c)
        return codes
    for i, e in enumerate(edges):
        if kind == "straddle":  # a copy of cap rows across each tile edge
            c = _random_copy(rng, cap)
        elif kind == "long_run":  # a run of one symbol: counter at its max
            s = int(rng.integers(0, 4))
            c = (_copy([[s] * long_run], [s] * int(rng.integers(1, 3)))
                 if i % 2 else _copy([[s]], [s] * long_run))
            c = c[:cap + 1]
        else:  # "chunk_end": copies back to back up to the chunk's last row
            break
        start = e - len(c) // 2
        if start >= end and start + len(c) <= n:
            codes[start:start + len(c)] = c
            end = start + len(c)
    if kind == "chunk_end":
        while end + 2 * cap <= n:
            c = _random_copy(rng, int(rng.integers(2, cap + 1)))
            codes[end:end + len(c)] = c
            end += len(c)
        codes[n - cap:] = _random_copy(rng, cap)
    return codes


@pytest.mark.parametrize("cap", [16, 64, 255])
@pytest.mark.parametrize("kind", ["straddle", "long_run", "pads",
                                  "chunk_end"])
def test_cuda_kernel_edges_match_plain(cuda, kind, cap):
    """On read rows the kernel equals the plain version: copies of the
    cap's length across the kernel's tile edges, one-symbol document runs
    that drive a byte counter to its maximum (255 at cap 255), runs of
    pad rows, and a copy that ends on the chunk's last row."""
    codes_np = _edge_stream(kind, cap)
    codes = torch.from_numpy(codes_np).to(cuda)
    window = min(cap + 1, 255)
    got = pk.pair_hits(codes, window, cap).cpu().numpy()
    want = pk.pair_hits_plain(codes, window, cap).cpu().numpy()
    read = ((codes_np >> 4) & 1) == 0
    assert want[read].sum() > 0
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
    planes, cells = [], []
    for dev in (CPU, cuda):
        sim = torch.zeros((host._r_pad_for(ds.num_reads), g_pad),
                          dtype=torch.int8, device=dev)
        status = dense_kernels.new_status(dev)
        for arrs in chunks:
            _dense_chunk(sim, *(torch.from_numpy(a).to(dev) for a in arrs),
                         host.B_BLK, host.C_BLK, host.PR, 4 * host.K, g_pad,
                         status)
        cells.append(dense_kernels.take(status))
        planes.append(sim.cpu().numpy()[:ds.num_reads])
    assert np.any(planes[0])
    assert np.array_equal(planes[1], planes[0])
    assert cells[1] == cells[0] > 0


def _launch_total():
    return sum(pk.LAUNCHES.values())


@pytest.mark.parametrize("wide", [False, True])
def test_pair_offset_stack_cuda_matches_cpu(cuda, deep, wide):
    """Every pair chunk of one collection into plane 1 of a row-block
    stack at reads 300-555 of 800 (the chunks' rows straddle both edges
    of the block): the card's stack equals the CPU's, one launch per
    chunk."""
    arrays, chunks, windows, row_bits = _plan(deep)[:4]
    g_pad = host._g_pad_for(deep.num_genomes)
    B, base = 256, 300
    stacks = []
    for dev in (CPU, cuda):
        stack = torch.zeros((2, B, g_pad), dtype=torch.int32 if wide
                            else torch.int8, device=dev)
        keep = []
        before = _launch_total()
        tps.pair_score_packed_offset(
            stack, 1, tps.pair_upload(arrays, chunks, dev, keep), chunks,
            windows, row_bits, base)
        stacks.append(stack.cpu().numpy())
        assert _launch_total() == before + (len(chunks) if dev == cuda
                                            else 0)
    assert stacks[0][1].any() and not stacks[0][0].any()
    assert np.array_equal(stacks[1], stacks[0])


@pytest.mark.parametrize("wide", [False, True])
def test_dense_offset_chunk_cuda_matches_cpu(cuda, conserved, wide):
    """Every dense chunk of one collection into plane 0 of a row-block
    stack at reads 1,000-2,023 of 3,000."""
    ds = conserved
    out = _plan(ds, dense_min=4)
    col = ds.collections[0]
    g_pad = host._g_pad_for(ds.num_genomes)
    chunks = host.pack_chunks(out[4], out[5], open_da(col), open_ebwt(col),
                              ds.num_reads, ds.num_genomes, g_pad)[0]
    assert chunks
    B, base = 1024, 1000
    stacks = []
    for dev in (CPU, cuda):
        stack = torch.zeros((2, B, g_pad), dtype=torch.int32 if wide
                            else torch.int8, device=dev)
        status = dense_kernels.new_status(dev)
        for arrs in chunks:
            _dense_chunk_offset(stack, 0, *(torch.from_numpy(a).to(dev)
                                            for a in arrs),
                                base, host.B_BLK, host.C_BLK, host.PR,
                                4 * host.K, g_pad, np.unique(arrs[3]),
                                status)
        dense_kernels.take(status)
        stacks.append(stack.cpu().numpy())
    assert stacks[0][0].any() and not stacks[0][1].any()
    assert np.array_equal(stacks[1], stacks[0])


@pytest.mark.parametrize("path", ["pair", "dense"])
def test_offset_scatters_past_2_31_cells_cuda(cuda, deep, conserved, path):
    """A row-block plane of over 2^31 cells, as at 24,832 genome columns
    with a row block of 180,224 reads: a block no chunk row falls in
    takes nothing and raises nothing (torch's CUDA index_add_ into such a
    plane launches an empty grid for an empty selection, an error), and
    the block at read 0 holds what a small stack gets on the CPU."""
    ds = deep if path == "pair" else conserved
    out = _plan(ds) if path == "pair" else _plan(ds, dense_min=4)
    g_pad = host._g_pad_for(ds.num_genomes)
    r_pad = host._r_pad_for(ds.num_reads)
    big = -(-((1 << 31) + 1) // g_pad)
    if path == "dense":
        col = ds.collections[0]
        chunks = host.pack_chunks(out[4], out[5], open_da(col),
                                  open_ebwt(col), ds.num_reads,
                                  ds.num_genomes, g_pad)[0]
        assert chunks

    def score(stack, base):
        dev = stack.device
        if path == "pair":
            keep = []
            tps.pair_score_packed_offset(
                stack, 0, tps.pair_upload(out[0], out[1], dev, keep),
                out[1], out[2], out[3], base)
        else:
            status = dense_kernels.new_status(dev)
            for arrs in chunks:
                _dense_chunk_offset(stack, 0, *(torch.from_numpy(a).to(dev)
                                                for a in arrs),
                                    base, host.B_BLK, host.C_BLK, host.PR,
                                    4 * host.K, g_pad, np.unique(arrs[3]),
                                    status)
            dense_kernels.take(status)

    stack = torch.zeros((1, big, g_pad), dtype=torch.int8, device=cuda)
    score(stack, r_pad)
    torch.cuda.synchronize()
    assert not stack.any()
    score(stack, 0)
    want = torch.zeros((1, r_pad, g_pad), dtype=torch.int8)
    score(want, 0)
    assert want.any()
    assert torch.equal(stack[:, :r_pad].cpu(), want)
    assert not stack[:, r_pad:].any()
    del stack
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The dense kernel (csrc/dense_pairs.cu) against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=tdk.WIDTHS,
                ids=[f"g{g}" for g in tdk.WIDTHS])
def dense_width(cuda, request, tmp_path_factory):
    """Genome-dense clusters at G_pad 1,024, 3,456 and 4,224."""
    return tdk.width_dataset(str(tmp_path_factory.mktemp(
        f"dense_w{request.param}")), request.param)


def _kernel_plane(chunks, dev, shape, dtype, f, g_pad, status, row_base=None,
                  init=None):
    """Every chunk into a fresh plane (or row block) on ``dev``."""
    plane = (torch.zeros(shape, dtype=dtype) if init is None
             else init.clone()).to(dev)
    for chunk in chunks:
        arrs = [torch.from_numpy(a).to(dev) for a in chunk]
        if row_base is None:
            _dense_chunk(plane, *arrs, *tdk.SHAPE, f, g_pad, status)
        else:
            _dense_chunk_offset(plane[None], 0, *arrs, row_base, *tdk.SHAPE,
                                f, g_pad, np.unique(chunk[3]), status)
    return plane.cpu()


def _plain_plane(chunks, shape, dtype, f, g_pad, status, row_base=None):
    """The plain version over the same chunks, each cut to the entries
    and clusters it uses (the same scores, smaller feature tensors)."""
    want = torch.zeros(shape, dtype=dtype)
    for chunk in chunks:
        small, b, c = tdk.shrink(chunk, *tdk.SHAPE, f, g_pad)
        want = tdk.plain_plane([small], shape[0], g_pad, dtype, b, c,
                               host.PR, f, status, row_base=row_base,
                               init=want)
    return want


def _statuses(cuda):
    return dense_kernels.new_status(cuda), dense_kernels.new_status(CPU)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32],
                         ids=["int8", "int32"])
@pytest.mark.parametrize("use_ebwt", [True, False], ids=["ebwt", "no_ebwt"])
def test_dense_kernel_matches_plain_at_width(cuda, dense_width, use_ebwt,
                                             dtype):
    """Every dense chunk of a collection at the three widths (F 32 and
    8), int8 and int32: the kernel's plane is the plain version's, one
    launch a chunk, and its cell count is the plain version's."""
    ds = dense_width
    chunks, g_pad, f = tdk.dense_chunks(ds, use_ebwt)
    assert chunks
    shape = (ds.num_reads + 1, g_pad)
    st, st_cpu = _statuses(cuda)
    before = dense_kernels.LAUNCHES["dense"]
    got = _kernel_plane(chunks, cuda, shape, dtype, f, g_pad, st)
    assert dense_kernels.LAUNCHES["dense"] == before + len(chunks)
    want = _plain_plane(chunks, shape, dtype, f, g_pad, st_cpu)
    assert dense_kernels.take(st) == dense_kernels.take(st_cpu) > 0
    assert torch.any(want[:ds.num_reads] != 0)
    assert torch.equal(got, want)


def test_dense_kernel_row_block_at_width(cuda, dense_width):
    """A row block of reads 100-259 of 400, lanes on both sides of both
    edges: the kernel drops the lanes outside it as the plain version
    does."""
    ds = dense_width
    chunks, g_pad, f = tdk.dense_chunks(ds)
    base, shape = 100, (160, g_pad)
    for chunk in chunks:
        assert np.any(chunk[3] < base)
        assert np.any((chunk[3] >= base + shape[0])
                      & (chunk[3] < ds.num_reads))
    st, st_cpu = _statuses(cuda)
    got = _kernel_plane(chunks, cuda, shape, torch.int8, f, g_pad, st, base)
    want = _plain_plane(chunks, shape, torch.int8, f, g_pad, st_cpu, base)
    assert dense_kernels.take(st) == dense_kernels.take(st_cpu) > 0
    assert torch.any(want != 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("f", [32, 8])
def test_dense_kernel_wraps_int8(cuda, f):
    """One cell hit by enough clusters that its sum passes 255: the int8
    byte wraps mod 256 with no carry into its neighbours, int32 keeps
    the sum."""
    g_pad, rows = 128, 8
    chunk, b, c = tdk.wrapping_chunk(f, g_pad, rows)
    for dtype in (torch.int8, torch.int32):
        st, st_cpu = _statuses(cuda)
        got = torch.zeros((rows, g_pad), dtype=dtype, device=cuda)
        _dense_chunk(got, *(torch.from_numpy(a).to(cuda) for a in chunk),
                     b, c, host.PR, f, g_pad, st)
        want = tdk.plain_plane([chunk], rows, g_pad, dtype, b, c, host.PR, f,
                               status=st_cpu)
        assert dense_kernels.take(st) == dense_kernels.take(st_cpu) == b
        assert torch.equal(got.cpu(), want)
        assert int(want[3, 5]) == (b * f if dtype == torch.int32
                                   else (b * f) % 256)
        assert int(torch.count_nonzero(want)) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_kernel_synthetic_matches_plain(cuda, seed):
    """Planner-shaped synthetic chunks with up to 90 genomes a cluster
    and dense feature sets (genome runs across the kernel's 32-triple
    windows), F 32 and 8, int8 and int32, into a plane whose drop row
    starts non-zero: equal to the plain version, drop row untouched."""
    rng = np.random.default_rng(seed)
    b_blk, c_blk, pr, g_pad, rows = 256, 96, host.PR, 1024, 300
    for f in (32, 8):
        chunk = tdk.synthetic_chunk(rng, b_blk, c_blk, pr, f, g_pad, 930,
                                    rows, density=0.9 if seed else 0.3)
        for dtype in (torch.int8, torch.int32):
            st, st_cpu = _statuses(cuda)
            init = torch.zeros((rows, g_pad), dtype=dtype)
            init[rows - 1] = torch.arange(1, g_pad + 1).to(dtype)
            got = init.clone().to(cuda)
            _dense_chunk(got, *(torch.from_numpy(a).to(cuda)
                                for a in chunk), b_blk, c_blk, pr, f, g_pad,
                         st)
            want = tdk.plain_plane([chunk], rows, g_pad, dtype, b_blk,
                                   c_blk, pr, f, init=init, status=st_cpu)
            assert dense_kernels.take(st) == dense_kernels.take(st_cpu) > 0
            assert torch.equal(got.cpu(), want)
            assert torch.equal(want[rows - 1], init[rows - 1])


def test_dense_kernel_full_plane_past_2_31_cells(cuda, conserved):
    """A whole plane of over 2^31 cells whose chunk rows sit past its
    2^31st cell: 64-bit addressing, and nothing below them written."""
    ds = conserved
    chunks, g_pad, f = tdk.dense_chunks(ds)
    r_pad = host._r_pad_for(ds.num_reads)
    shift = -(-((1 << 31) + 1) // g_pad)
    big = torch.zeros((shift + r_pad, g_pad), dtype=torch.int8, device=cuda)
    st, st_cpu = _statuses(cuda)
    for chunk in chunks:
        _dense_chunk(big, *(torch.from_numpy(a).to(cuda) for a in
                            (*chunk[:3], chunk[3] + shift)),
                     *tdk.SHAPE, f, g_pad, st)
    want = _plain_plane(chunks, (r_pad, g_pad), torch.int8, f, g_pad, st_cpu)
    assert dense_kernels.take(st) == dense_kernels.take(st_cpu) > 0
    assert torch.any(want != 0)
    assert torch.equal(big[shift:].cpu(), want)
    assert not big[:shift].any()
    del big
    torch.cuda.empty_cache()


def test_dense_kernel_counts_one_launch_per_replay(cuda, conserved):
    """Row-block replays over 3,000 reads in blocks of 1,024: one launch
    for each (chunk, block) the chunk's rows reach, none for the
    others."""
    ds = conserved
    chunks, g_pad, f = tdk.dense_chunks(ds)
    B = 1024
    stack = torch.zeros((1, B, g_pad), dtype=torch.int8, device=cuda)
    st = dense_kernels.new_status(cuda)
    want = 0
    before = dense_kernels.LAUNCHES["dense"]
    for base in range(0, ds.num_reads + 1, B):
        for chunk in chunks:
            rows = np.unique(chunk[3])
            reach = bool(np.any((rows >= base) & (rows < base + B)))
            want += reach
            assert _dense_chunk_offset(
                stack, 0, *(torch.from_numpy(a).to(cuda) for a in chunk),
                base, *tdk.SHAPE, f, g_pad, rows, st) == reach
    assert dense_kernels.LAUNCHES["dense"] == before + want > len(chunks)
    assert dense_kernels.take(st) > 0


@pytest.mark.parametrize("fault", ["read_past", "read_order", "genome_past",
                                   "genome_order", "cluster", "row"])
def test_dense_kernel_fault_raises(cuda, fault):
    """Each index the torch version would refuse, and triples out of the
    order the kernel searches, raise at the next ``take``, every time;
    nothing is written outside the plane."""
    g_pad, rows, f = 128, 8, 32
    chunk, b, c = tdk.wrapping_chunk(f, g_pad, rows)
    ridx, gidx, cmap, rid = (a.copy() for a in chunk)
    if fault == "read_past":
        ridx[-1] = b * host.PR * f + 1
    elif fault == "read_order":
        ridx[[0, 1]] = ridx[[1, 0]]
    elif fault == "genome_past":
        gidx[-1] = c * g_pad * f + 1
    elif fault == "genome_order":
        gidx[[0, -1]] = gidx[[-1, 0]]
    elif fault == "cluster":
        cmap[0] = c
    else:
        rid[0] = rows
    buf = torch.zeros((rows + 2, g_pad), dtype=torch.int8, device=cuda)
    arrs = [torch.from_numpy(a).to(cuda) for a in (ridx, gidx, cmap, rid)]
    st = dense_kernels.new_status(cuda)
    _dense_chunk(buf[1:rows + 1], *arrs, b, c, host.PR, f, g_pad, st)
    with pytest.raises(RuntimeError, match="dense_pairs"):
        dense_kernels.take(st)
    assert dense_kernels.take(st) == 0  # the fault was reset
    _dense_chunk(buf[1:rows + 1], *arrs, b, c, host.PR, f, g_pad, st)
    with pytest.raises(RuntimeError, match="dense_pairs"):
        dense_kernels.take(st)
    assert not buf[0].any() and not buf[rows + 1].any()


def test_fused_run_dense_counters_cuda_match_cpu(cuda, dense_width,
                                                 tmp_path):
    """The fused path end to end at each width: the card's CSV is the
    CPU's and the jax-free host reference's, its dense chunks all went
    through the kernel, one launch each (``dense_launches``), and
    ``dense_cells`` is the plain version's count."""
    ds = dense_width
    runs = {}
    for dev in (CPU, cuda):
        out = str(tmp_path / f"{dev.type}.csv")
        before = dense_kernels.LAUNCHES["dense"]
        run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
                   ds.lineage_path, ds.read_len, FUSED, device=dev)
        runs[dev.type] = (_read(out), dict(fused_pipeline.LAST_RUN),
                          dense_kernels.LAUNCHES["dense"] - before)
    (csv_c, run_c, n_c), (csv_g, run_g, n_g) = runs["cpu"], runs["cuda"]
    ref = str(tmp_path / "reference.csv")
    reference.reference_csv(ds.collections, ref, ds.num_reads,
                            ds.num_genomes, ds.lineage_path, ds.read_len,
                            FUSED)
    assert csv_g == csv_c == _read(ref)
    assert n_c == run_c["counts"]["dense_launches"] == 0
    assert n_g == run_g["counts"]["dense_launches"] == run_g[
        "dense_chunks"] > 0
    for key in ("dense_cells", "dense_lanes", "dense_lanes_total"):
        assert run_g["counts"][key] == run_c["counts"][key], key
    assert run_g["counts"]["dense_cells"] >= run_g["counts"]["dense_lanes"]


@pytest.fixture(scope="module")
def two_blocks(cuda, tmp_path_factory):
    """16,500 read pairs: two row blocks of 16,384 reads; short genomes
    for all three pair buckets."""
    return make_dataset(str(tmp_path_factory.mktemp("two_blocks")),
                        num_pairs=16_500, read_len=100,
                        genome_lens=(500, 400), seed=11)


@pytest.mark.parametrize("stream_budget", [None, 8 << 20],
                         ids=["one_pass", "owner_passes"])
def test_blocked_run_cuda_matches_cpu(cuda, two_blocks, tmp_path,
                                      monkeypatch, stream_budget):
    """A row-blocked run on the card (LIME_HBM_BUDGET=1; with a stream
    budget, in owner passes) writes the CSV of the CPU run and of the
    jax-free host reference; the pair kernel launched once per chunk per
    row block of its pass, every bucket."""
    ds = two_blocks
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len,
            FUSED)
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    if stream_budget:
        monkeypatch.setenv("LIME_STREAM_BUDGET", str(stream_budget))
    a, b, c = (str(tmp_path / f"{n}.csv") for n in ("cuda", "cpu", "ref"))
    pk.reset_launches()
    run_paired(ds.collections, a, *args, device=cuda)
    launches = [pk.LAUNCHES[k] for k in ("scan16", "scan64", "band")]
    stats = dict(fused_pipeline.LAST_RUN)
    run_paired(ds.collections, b, *args, device="cpu")
    reference.reference_csv(ds.collections, c, *args)
    assert _read(a) == _read(b) == _read(c)
    assert stats["engine"] == "blocked" and stats["blocks"] >= 2
    assert stats["n_pass"] == (3 if stream_budget else 1)
    assert launches == stats["launches_per_bucket"] and all(launches)
    if not stream_budget:
        assert launches == [n * stats["blocks"]
                            for n in stats["chunks_per_bucket"]]


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


# ---------------------------------------------------------------------------
# K3 (banded) and the staged / fused-banded paths
# ---------------------------------------------------------------------------

def _banded_stream(rng, n, num_reads, num_refs, max_run, emit_frac=0.8):
    """Random packed stream: runs (clusters) shorter than ``max_run``
    positions, random documents, symbols and emit gates."""
    m = rng.random(n) < 0.9
    run = 0
    for i in range(n):
        run = run + 1 if m[i] else 0
        if run >= max_run:
            m[i] = False
            run = 0
    m[0] = False
    doc = rng.integers(0, num_reads + num_refs, size=n).astype(np.int32)
    sym = rng.integers(0, 4, size=n)
    emit = rng.random(n) < emit_frac
    return host.pack_stream(m, emit, sym), doc


@pytest.mark.parametrize("acc,num_reads,num_refs", [
    (torch.int32, 3000, 300),
    (torch.int8, 3000, 300),
    (torch.int8, 3, 5),      # few documents: counts past 255 wrap
    (torch.int32, 3, 5),
])
def test_banded_kernel_matches_plain(cuda, acc, num_reads, num_refs):
    """K3 equals its plain version at window 255 on a stream whose
    clusters cross the kernel's tiles and the plain version's blocks; one
    launch is counted."""
    rng = np.random.default_rng(num_reads + num_refs)
    n = 12 * 1024 + 77
    packed_h, doc_h = _banded_stream(rng, n, num_reads, num_refs, 255)
    g_pad = host._g_pad_for(num_refs)
    sims = []
    for dev in (CPU, cuda):
        sim = torch.zeros((num_reads + 1, g_pad), dtype=acc, device=dev)
        before = bk.LAUNCHES["banded"]
        if dev.type == "cuda":
            bk.banded_sim_into(sim, torch.from_numpy(packed_h).to(dev),
                               torch.from_numpy(doc_h).to(dev), 255,
                               num_reads)
            assert bk.LAUNCHES["banded"] == before + 1
        else:
            bk.banded_sim_plain(sim, torch.from_numpy(packed_h),
                                torch.from_numpy(doc_h), 255, num_reads,
                                block=2000)
        sims.append(sim.cpu().numpy())
    assert np.any(sims[0])
    assert np.array_equal(sims[1], sims[0])
    if num_reads == 3:
        wide = sims[0] if acc == torch.int32 else None
        assert wide is None or wide.max() > 255


def _k3_runs(runs, n, rng, num_reads, num_refs, window, pad_doc):
    """Packed codes and document ids of ``n`` positions: short random runs
    (at most ``window + 1`` long) everywhere except where ``runs`` places
    a run, given as (start, documents, symbols); pad positions (code 0,
    ``pad_doc``, as the planner pads) fill what ``pad_doc`` leaves."""
    packed_h, doc_h = _banded_stream(rng, n, num_reads, num_refs,
                                     window + 1)
    last = 0
    for start, docs, syms in runs:
        L = len(docs)
        if start < last:  # runs do not overlap
            continue
        last = start + L
        end = min(n, start + L)
        codes = host.pack_stream(np.arange(L) > 0, rng.random(L) < 0.8,
                                 syms)
        packed_h[start:end], doc_h[start:end] = codes[:end - start], \
            docs[:end - start]
        if end < n:  # the next position starts a run
            packed_h[end] &= ~np.uint8(1 << host.PACK_M_BIT)
    if pad_doc is not None:
        packed_h[n - 100:] = 0
        doc_h[n - 100:] = pad_doc
    return packed_h, doc_h


def _k3_case(kind, rng):
    """(packed, doc, num_reads, num_refs, window) of one edge case."""
    tile = bk.TILE
    num_reads, num_refs, window, n = 300, 20, 255, 6 * tile + 77
    genome = num_reads + rng.integers(0, num_refs, size=8)
    runs = []

    def mixed(L, docs=None):
        docs = rng.choice(np.concatenate([rng.integers(0, num_reads, 8),
                                          genome]) if docs is None else
                          docs, size=L).astype(np.int32)
        return docs, rng.integers(0, 4, size=L)

    if kind == "tile_edges":  # short runs across every tile edge
        for e in range(tile, n, tile):
            L = int(rng.integers(2, window + 2))
            runs.append((e - L // 2, *mixed(L)))
    elif kind == "last_position":  # window + 1 long from a tile's last
        for e in range(tile, n - window, tile):
            runs.append((e - 1, *mixed(window + 1)))
    elif kind == "long_mixed":  # the long-run walk, one over 1,280 long
        window = 64
        for i, e in enumerate(range(tile, n - 3000, tile)):
            L = 3000 if i == 0 else int(rng.integers(window + 2, 600))
            runs.append((e - L // 3, *mixed(L)))
    elif kind == "one_symbol":  # one read and one genome, one symbol
        num_reads, num_refs = 3, 5
        for i, start in enumerate(range(0, n - 256, 256)):
            L = int(rng.integers(255, 257))
            # the read's run half or nearly all of it (occ up to 254)
            cut = int(rng.integers(L // 2 - 20, L // 2 + 20) if i % 2
                      else rng.integers(L - 3, L))
            docs = np.full(L, rng.integers(0, num_reads), np.int32)
            docs[cut:] = num_reads
            runs.append((start, docs, np.full(L, int(rng.integers(0, 4)))))
    elif kind == "short_padded":  # below one tile, planner pads, and
        # num_refs not a multiple of 4; genome ids past G_pad count nothing
        num_refs, n = 7, 1001
        genome = num_reads + rng.integers(0, host._g_pad_for(num_refs) + 9,
                                          size=8)
        runs.append((100, *mixed(window + 1)))
    packed_h, doc_h = _k3_runs(runs, n, rng, num_reads, num_refs, window,
                               num_reads + num_refs
                               if kind == "short_padded" else None)
    return packed_h, doc_h, num_reads, num_refs, window


@pytest.mark.parametrize("acc", [torch.int32, torch.int8])
@pytest.mark.parametrize("kind", ["tile_edges", "last_position",
                                  "long_mixed", "one_symbol",
                                  "short_padded", "unaligned"])
def test_banded_kernel_edges_match_plain(cuda, kind, acc):
    """K3 equals its plain version on runs across its tile edges, a
    window + 1 run from a tile's last position, long mixed runs (the
    long-run walk), 255- and 256-position runs of one read and one genome
    in one symbol (occ up to 254; int8 counts wrap), a padded stream
    shorter than one tile with num_refs = 7, and inputs that are not
    16-byte aligned; each call counts one launch."""
    rng = np.random.default_rng(len(kind))
    base = "tile_edges" if kind == "unaligned" else kind
    packed_h, doc_h, num_reads, num_refs, window = _k3_case(base, rng)
    g_pad = host._g_pad_for(num_refs)
    sims = []
    for dev in (CPU, cuda):
        packed = torch.from_numpy(packed_h).to(dev)
        doc = torch.from_numpy(doc_h).to(dev)
        if kind == "unaligned":
            packed, doc = packed[1:], doc[1:]
        sim = torch.zeros((num_reads + 1, g_pad), dtype=acc, device=dev)
        before = bk.LAUNCHES["banded"]
        bk.banded_sim_into(sim, packed, doc, window, num_reads)
        assert bk.LAUNCHES["banded"] == before + (dev.type == "cuda")
        sims.append(sim.cpu().numpy())
    assert sims[0].any()
    assert np.array_equal(sims[1], sims[0])
    if kind == "one_symbol" and acc == torch.int32:
        assert sims[0].max() > 255


def test_banded_kernel_refuses_missing_drop_row(cuda):
    packed_h, doc_h = _banded_stream(np.random.default_rng(0), 4096, 100,
                                     20, 64)
    sim = torch.zeros((100, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="drop row"):
        bk.banded_sim_into(sim, torch.from_numpy(packed_h).to(cuda),
                           torch.from_numpy(doc_h).to(cuda), 64, 100)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(wide_sim=True, binary_results=False),
    dict(fused=True, pair_stream=False, dense_threshold=0),
])
def test_banded_paths_cuda_match_host(cuda, deep, tmp_path, kw):
    """The staged executor and the fused banded engine on the card: CSV
    byte-identical to lime_tpu's jax-free host stages (the text .res
    format rounds scores, so the staged text run is held against the
    staged host run), K3 launched."""
    cfg = LimeConfig(**kw)
    args = (deep.num_reads, deep.num_genomes, deep.lineage_path,
            deep.read_len)
    a, c = str(tmp_path / "torch.csv"), str(tmp_path / "host.csv")
    bk.reset_launches()
    run_paired(deep.collections, a, *args, cfg, device=cuda)
    launches = bk.LAUNCHES["banded"]
    run_paired(deep.collections, c, *args, cfg.replace(executor="host"))
    assert _read(a) == _read(c)
    assert launches >= (1 if cfg.fused else 4)


# ---------------------------------------------------------------------------
# The host share: hybrid, all-host and row-blocked hybrid runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac,env", [
    (0.5, {}),
    (1.0, {"LIME_DENSE_OFFLOAD": "1", "LIME_DENSE_OFFLOAD_MIN": "4"}),
    (0.5, {"LIME_HBM_BUDGET": "1"}),
], ids=["hybrid", "all_host", "hybrid_blocked"])
def test_host_share_cuda_matches_reference(cuda, two_blocks, tmp_path,
                                           monkeypatch, frac, env):
    """A host share on the card writes the jax-free host reference's
    CSV: the hybrid's host plane scatters as a coo24 chain (one block) or
    per row block, the all-host job shop offloads dense chunks; the pair
    kernel launches once per planned chunk (per block, blocked), never
    in an all-host run, and K3 never."""
    ds = two_blocks
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = FUSED.replace(host_frac=frac)
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len, cfg)
    a, c = str(tmp_path / "cuda.csv"), str(tmp_path / "ref.csv")
    pk.reset_launches()
    bk.reset_launches()
    run_paired(ds.collections, a, *args, device=cuda)
    launches = [pk.LAUNCHES[k] for k in ("scan16", "scan64", "band")]
    stats = dict(fused_pipeline.LAST_RUN)
    reference.reference_csv(ds.collections, c, *args)
    assert _read(a) == _read(c)
    assert bk.LAUNCHES["banded"] == 0
    assert stats["host_num"] == round(frac * 256)
    if "LIME_HBM_BUDGET" in env:
        assert stats["engine"] == "blocked" and stats["blocks"] >= 2
        assert launches == stats["launches_per_bucket"] and any(launches)
    elif frac == 1.0:
        assert stats["engine"] == "all_host" and launches == [0, 0, 0]
        assert stats["dense_chunks"] > 0
    else:
        assert launches == stats["chunks_per_bucket"] and any(launches)
    if frac < 1.0:
        assert stats["chain_bytes"] > 0


@pytest.fixture(scope="module")
def srr_width(cuda, tmp_path_factory):
    """tests/test_srr_width.py's 3,423-genome dataset."""
    rng = np.random.default_rng(99)
    lens = [int(v) for v in rng.integers(180, 260, 3423)]
    return make_dataset(str(tmp_path_factory.mktemp("srr_width")),
                        num_pairs=1500, read_len=60, genome_lens=lens,
                        seed=99, mutation_rate=0.01, negative_fraction=0.1,
                        degenerate_rate=0.001, insert_len=150)


def test_width_cuda_matches_reference(cuda, srr_width, tmp_path,
                                      monkeypatch):
    """3,423 genomes on the card (g_pad 3,456, u16 genome columns): all on
    the device, then a hybrid whose host plane (forced by a position cap
    of 1) ships as a coo24 chain with 12-bit columns; both CSVs equal
    the host reference's."""
    ds = srr_width
    monkeypatch.setattr(host, "_COO_POSITION_CAP", 1)
    c = str(tmp_path / "ref.csv")
    reference.reference_csv(ds.collections, c, ds.num_reads, ds.num_genomes,
                            ds.lineage_path, ds.read_len, FUSED)
    for frac in (0.0, 0.5):
        a = str(tmp_path / f"cuda_{frac}.csv")
        pk.reset_launches()
        run_paired(ds.collections, a, ds.num_reads, ds.num_genomes,
                   ds.lineage_path, ds.read_len,
                   FUSED.replace(host_frac=frac), device=cuda)
        assert _read(a) == _read(c), frac
        assert sum(pk.LAUNCHES.values()) > 0
        assert fused_pipeline.LAST_RUN["chain_bytes"] > 0


# ---------------------------------------------------------------------------
# Index construction on the card
# ---------------------------------------------------------------------------

def test_index_builder_cuda_matches_numpy(cuda):
    """The device builder on the card: a random 200,010-position
    collection (990 reads sampled from 20 genomes of 5,000 bases, then
    the genomes) equals the numpy builder byte for byte."""
    from lime_tpu_torch.index import build_index
    from lime_tpu_torch.index import torch_builder

    rng = np.random.default_rng(21)
    base = np.frombuffer(b"ACGT", np.uint8)
    genomes = [base[rng.integers(0, 4, 5000)].tobytes() for _ in range(20)]
    starts = rng.integers(0, 4900, 990)
    reads = [genomes[i % 20][p:p + 100] for i, p in enumerate(starts)]
    seqs = reads + genomes
    got = build_index(seqs, engine="tpu", device=cuda)
    assert torch_builder.LAST_RUN["positions"] == 200_010
    for a, b in zip(got, build_index(seqs, engine="numpy"), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_preprocess_fused_cuda_matches_host(cuda, deep, tmp_path):
    """FASTA to CSV with the port alone: ``lime-tpu-torch preprocess``,
    then the fused run on the card, byte-identical to the host executor's
    CSV on the same collections."""
    from lime_tpu_torch.cli import main
    from lime_tpu_torch.formats.fasta import write_fasta

    files = [str(tmp_path / f) for f in ("r1.fasta", "r2.fasta", "g.fasta")]
    write_fasta(files[0], [f"r{i}/1" for i in range(deep.num_reads)],
                deep.reads1)
    write_fasta(files[1], [f"r{i}/2" for i in range(deep.num_reads)],
                deep.reads2)
    write_fasta(files[2], [f"G{j}" for j in range(deep.num_genomes)],
                deep.genomes)
    out_dir = str(tmp_path / "idx")
    assert main(["preprocess", files[0], files[2], "--reads2", files[1],
                 "--out-dir", out_dir]) == 0
    cols = [f"{out_dir}/col_{t}.fasta" for t in ("1F", "1RC", "2F", "2RC")]
    for col, want in zip(cols, deep.collections):
        for ext in (".ebwt", ".lcp", ".da"):
            assert _read(col + ext) == _read(want + ext), col + ext
    args = (deep.num_reads, deep.num_genomes, deep.lineage_path,
            deep.read_len)
    a, c = str(tmp_path / "cuda.csv"), str(tmp_path / "host.csv")
    run_paired(cols, c, *args, LimeConfig(executor="host"))
    pk.reset_launches()
    run_paired(cols, a, *args, FUSED, device=cuda)
    assert _read(a) == _read(c)
    assert sum(pk.LAUNCHES.values()) > 0


def _nccl_world1():
    """A one-rank NCCL process group on this process."""
    import datetime

    import torch.distributed as dist

    from lime_tpu_torch.parallel.dryrun import free_port

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(minutes=5))
    return dist


@pytest.mark.parametrize("engine", ["banded", "pair"])
def test_sharded_engines_nccl_world1_match_reference(cuda, two_blocks,
                                                     tmp_path, engine):
    """Both SPMD engines at world size 1 on NCCL, on the card: the
    reference CSV; K3 once per collection (banded), the pair kernel once
    per planned chunk (pair)."""
    from lime_tpu_torch.parallel import make_mesh, sharded

    ds = two_blocks
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len)
    ref = str(tmp_path / "ref.csv")
    reference.reference_csv(ds.collections, ref, *args)
    dist = _nccl_world1()
    try:
        runner = (sharded.run_sharded if engine == "banded"
                  else sharded.run_sharded_pairs)
        pk.reset_launches()
        bk.reset_launches()
        out = str(tmp_path / "out.csv")
        runner(ds.collections, out, *args, mesh=make_mesh(), device=cuda)
    finally:
        dist.destroy_process_group()
    assert _read(out) == _read(ref)
    pair = [pk.LAUNCHES[k] for k in ("scan16", "scan64", "band")]
    if engine == "banded":
        assert bk.LAUNCHES["banded"] == 4 and not any(pair)
    else:
        assert pair == sharded.LAST_RUN["chunks_per_bucket"] and all(pair)
        assert not bk.LAUNCHES["banded"]


@pytest.mark.parametrize("engine,mesh", [("banded", [1, 2]),
                                         ("pair", [2, 1])])
def test_sharded_two_gloo_ranks_on_one_card(cuda, two_blocks, tmp_path,
                                            engine, mesh):
    """Two ranks on cuda:0 with gloo between them (NCCL refuses two ranks
    on one device): the reference CSV, kernels launched in both ranks
    (banded: dp = 2, the reduce-scatter; pair: sp = 2, each rank's own
    position range; the reads past 16,384 of a dp = 2 split are this
    set's negative controls, which plan no pair chunk)."""
    from .test_torch_selfcontained import run_ranks

    ds = two_blocks
    ref = str(tmp_path / "ref.csv")
    reference.reference_csv(ds.collections, ref, ds.num_reads,
                            ds.num_genomes, ds.lineage_path, ds.read_len)
    out = str(tmp_path / "out.csv")
    outs = run_ranks(tmp_path / "ranks", {
        "task": "run", "engine": engine, "mesh": mesh, "device": "cuda",
        "csv": out, "ds": {"collections": ds.collections,
                           "num_reads": ds.num_reads,
                           "num_genomes": ds.num_genomes,
                           "lineage_path": ds.lineage_path,
                           "read_len": ds.read_len}}, 2, timeout=600)
    assert _read(out) == _read(ref)
    for o in outs:
        assert o["last_run"]["memory"]["peak_bytes_in_use"] > 0
        if engine == "banded":
            assert o["launches"]["banded"] == 4
        else:
            assert sum(o["launches"][k] for k in ("scan16", "scan64",
                                                  "band")) > 0


def test_gloo_int8_reductions_wrap_on_cuda(cuda, tmp_path):
    """gloo's int8 all_reduce and the mesh's reduce-scatter of CUDA
    tensors wrap mod 256: 100 + 101 -> -55."""
    from .test_torch_selfcontained import run_ranks

    outs = run_ranks(tmp_path / "ranks", {"task": "wrap", "mesh": [1, 2],
                                          "device": "cuda"}, 2)
    for o in outs:
        assert o["all_reduce"] == [-55] * 8
        assert o["reduce_scatter"] == [-55] * 8


# ---------------------------------------------------------------------------
# The one-byte-per-row pair path, dense_score_into, the profiler trace and
# the memory profiler
# ---------------------------------------------------------------------------

def _random_index(rng, n, num_reads, num_genomes, symbols=b"ACGT"):
    """Random (lcp, da, ebwt) with plausible alpha-runs (alpha 16): the
    inputs of tests/test_pair_score.py's ``_random_index``, which this
    jax-free file cannot import."""
    lcp = rng.integers(0, 2 * 16, n).astype(np.uint32)
    for s in rng.choice(n - 40, n // 40, replace=False):
        w = rng.integers(2, 30)
        lcp[s:s + w] = rng.integers(16, 30)
    da = np.where(rng.random(n) < 0.6,
                  rng.integers(0, num_reads, n),
                  rng.integers(num_reads, num_reads + num_genomes, n)
                  ).astype(np.uint32)
    syms = np.frombuffer(symbols, np.uint8)
    return lcp, da, syms[rng.integers(0, len(syms), n)].copy()


@pytest.mark.parametrize("kind,wide", [("deep", False), ("deep", True),
                                       ("terminators", False)])
def test_unpacked_pair_score_cuda_matches_cpu(cuda, deep, kind, wide):
    """``pair_score_into`` on the card (reorder, re-encode, the pair-hit
    kernel once per chunk) equals the CPU plane; the terminator case
    routes its copies holding ``'\\0'`` (rank 15) to the host."""
    if kind == "deep":
        col = deep.collections[0]
        lcp, da, ebwt = open_lcp(col), open_da(col), open_ebwt(col)
        R, G = deep.num_reads, deep.num_genomes
    else:
        lcp, da, ebwt = _random_index(np.random.default_rng(31), 20000,
                                      100, 20, symbols=b"ACGT$\x00")
        R, G = 100, 20
    g_pad = host._g_pad_for(G)
    buckets = native.plan_pairs(lcp, da, ebwt, R, 16, g_pad, SYMBOL_RANK_LUT,
                                host._DEGENERATE_BYTE.astype(np.uint8))[0]
    planes, runs = [], []
    for dev in (CPU, cuda):
        pk.reset_launches()
        sim = torch.zeros((R + 1, g_pad), device=dev,
                          dtype=torch.int32 if wide else torch.int8)
        tps.pair_score_into(sim, buckets, R, g_pad)
        planes.append(sim.cpu().numpy()[:R])
        runs.append(dict(tps.LAST_RUN))
    assert runs[0] == runs[1]
    assert dict(pk.LAUNCHES) == runs[1]["chunks"]
    assert sum(runs[1]["chunks"].values()) >= len(buckets)
    assert (runs[1]["host_copies"] > 0) == (kind == "terminators")
    assert np.any(planes[0]) and np.array_equal(planes[1], planes[0])


def test_dense_score_into_cuda_matches_cpu(cuda, conserved):
    ds = conserved
    out = _plan(ds, dense_min=4)
    da, ebwt = open_da(ds.collections[0]), open_ebwt(ds.collections[0])
    g_pad = host._g_pad_for(ds.num_genomes)
    planes, lefts = [], []
    for dev in (CPU, cuda):
        sim = torch.zeros((host._r_pad_for(ds.num_reads), g_pad),
                          dtype=torch.int8, device=dev)
        _, left_s, left_l = dense_score_into(sim, out[4], out[5], da, ebwt,
                                             ds.num_reads, ds.num_genomes,
                                             g_pad)
        planes.append(sim.cpu().numpy()[:ds.num_reads])
        lefts.append((left_s, left_l))
    assert np.any(planes[0]) and np.array_equal(planes[1], planes[0])
    for a, b in zip(*lefts):
        assert np.array_equal(a, b)


def test_profile_trace_counts_the_pair_kernel(cuda, deep, tmp_path,
                                              monkeypatch):
    """``LIME_PROFILE_DIR`` on the card: the CSV is unchanged and the
    trace holds the pair-hit kernel exactly as often as the launch
    counts say, per cap."""
    args = (deep.num_reads, deep.num_genomes, deep.lineage_path,
            deep.read_len, FUSED)
    plain, traced = str(tmp_path / "plain.csv"), str(tmp_path / "traced.csv")
    run_paired(deep.collections, plain, *args, device=cuda)
    monkeypatch.setenv("LIME_PROFILE_DIR", str(tmp_path / "trace"))
    pk.reset_launches()
    run_paired(deep.collections, traced, *args, device=cuda)
    assert _read(traced) == _read(plain)
    summary = trace_summary(read_trace(str(tmp_path / "trace"))[1])
    want = {cap: pk.LAUNCHES[name]
            for cap, name in pk._KERNEL_FOR_CAP.items() if pk.LAUNCHES[name]}
    assert want and pair_kernel_launches(summary["kernels"]) == want
    assert 0 < summary["busy_share"] <= 1


def test_memory_profiler_reads_device_memory(cuda):
    with MemoryProfiler(interval=0.01, track_hbm=True) as prof:
        x = torch.ones(64 << 20, dtype=torch.uint8, device=cuda)
        time.sleep(0.05)
    assert max(s[2] for s in prof.series()) >= 64 << 20
    assert "hbm peak" in prof.report()
    assert "cuda:0 hbm=" in memory_report()
    del x


# ---------------------------------------------------------------------------
# Without the native library
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def long_clusters(cuda, tmp_path_factory):
    """Deep enough for mixed clusters past 255 rows, which the numpy
    planner sends to the numpy rescue."""
    return make_dataset(str(tmp_path_factory.mktemp("long")),
                        num_pairs=2400, read_len=100,
                        genome_lens=(600, 400), seed=11)


@pytest.mark.parametrize("kw", [dict(fused=True), dict()],
                         ids=["fused", "staged"])
def test_no_native_runs_on_the_card(cuda, long_clusters, tmp_path,
                                    monkeypatch, kw):
    """The library set aside (``available()`` False, every binding
    raising): the fused entry point falls to the banded engine on the
    numpy plan and the staged one to ``find_clusters``, both with the
    numpy rescue and K3 on the card; CSV byte-identical to the host
    reference, K3 launched once per collection, ``planner`` numpy."""
    ds = long_clusters
    cfg = LimeConfig(**kw)
    args = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len, cfg)
    a, c = str(tmp_path / "torch.csv"), str(tmp_path / "ref.csv")
    reference.reference_csv(ds.collections, c, *args)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LOAD_ERROR", "set aside (test)")
    assert not native.available()
    pk.reset_launches()
    bk.reset_launches()
    run_paired(ds.collections, a, *args, keep_results=False, device=cuda)
    run = fused_pipeline.LAST_RUN if cfg.fused else pipeline.LAST_RUN
    assert _read(a) == _read(c)
    assert run["planner"] == "numpy"
    assert bk.LAUNCHES["banded"] == len(ds.collections)
    assert not any(pk.LAUNCHES.values())


def test_planner_is_native_with_the_library(cuda, deep, tmp_path):
    assert native.available()
    args = (deep.num_reads, deep.num_genomes, deep.lineage_path,
            deep.read_len)
    run_paired(deep.collections, str(tmp_path / "f.csv"), *args, FUSED,
               device=cuda)
    assert fused_pipeline.LAST_RUN["planner"] == "native"
    run_paired(deep.collections, str(tmp_path / "s.csv"), *args,
               LimeConfig(), keep_results=False, device=cuda)
    assert pipeline.LAST_RUN["planner"] == "native"
