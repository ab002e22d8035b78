#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--pairs N]

Phases, one line each (with its time); any failure raises and the exit
code is non-zero:

1. device: the card's name, and nvidia-smi's name and power limit;
2. build: compile (one nvcc per CUDA source, sm_90a, all at once) and
   load the pair-hit kernel, the banded kernel K3 and the dense kernel;
3. cascade: the classify program on random (4, 65536, 1024) int8 planes,
   bit-equal to the numpy cascade on the same normalised rows;
4. e2e: the paper-shape dataset (N read pairs x 930 genomes of 8 kbp,
   100 bp reads; default N = 1,000,000), its host reference CSV, and the
   fused serving path ``run_paired(LimeConfig(fused=True),
   device="cuda")``: byte-identical, the pair-hit kernel launched for
   every bucket (scan16, scan64, band) and the dense kernel once per
   dense chunk;
5. kernels: the pair-hit kernel of each bucket against its plain torch
   version, read rows exact, on a planner-shaped chunk (1M rows, seed 1,
   tiled to 32M) and on every pair chunk of the dataset's four
   collections (the chunks ``[e2e]`` launched it on, one launch each);
   device times per call (CUDA events around the call, as the plain
   versions are timed) and as CUDA-graph replays of back-to-back
   launches, beside the bound (1 B in + 4 B out per row at 3.35 TB/s);
6. kernels (banded): K3 on the first 4M positions of the dataset's real
   1F stream at G_pad 1024, int32 and int8 accumulators exact against
   the plain version (which walks V in ~1 GB position blocks), both
   timed as above; then K3 alone on the whole staged stream of each
   collection (the four launches of ``[staged]``), with the stream's
   runs by length, its pair count, the (read, genome) cells it touches
   and its bound (5 B per position, 8 B per touched int32 cell, at
   3.35 TB/s); then on each collection's planner stream, the launches of
   ``[banded]`` (2 B per touched int8 cell); K3's registers and shared
   memory come from ``-Xptxas -v`` in ``[build]``;
7. kernels (dense): the dense kernel on every dense chunk of the four
   collections as ``[e2e]`` planned them (one launch each there): its
   int8 plane exact against the plain version's torch chain run on the
   card (``_dense_rows`` and a row scatter-add, the path it replaced),
   and for the 1F collection against the plain version on the CPU, cell
   counts equal; both timed per call (all of a collection's chunks in
   one timing) and the kernel as a CUDA-graph replay, beside the bound
   (4 B per real triple, ``cmap`` and ``rid``, 2 B per nonzero
   (lane, genome) add, at 3.35 TB/s);
8. staged: ``run_paired(LimeConfig(), device="cuda")``, the default
   entry point (cluster_lcp -> cluster_bwt with K3 -> classify, through
   the .clrs/.res checkpoints): byte-identical, K3 launched per
   collection;
9. banded: the fused banded engine, ``LimeConfig(fused=True,
   pair_stream=False, dense_threshold=0)``: byte-identical, K3 launched;
10. blocked: the fused serving path in the row-blocked mode, forced by
   ``LIME_HBM_BUDGET`` = 1 GiB (B = 131,072 reads: 8 blocks), once in
   one pass and once with ``LIME_STREAM_BUDGET`` at half the streams'
   estimate (2 owner passes): byte-identical, the pair-hit kernel
   launched once per chunk per row block of its pass in every bucket,
   the dense kernel once per dense chunk per row block it reaches;
   B, blocks, passes, the resident stream and dense-chunk bytes and the
   peak device memory beside ``[e2e]``'s;
11. host_share: the host share of the fused serving path on the same
   dataset: ``[hybrid]`` (``host_frac=0.5``), ``[all_host]``
   (``host_frac=1.0``, the job shop) and ``[hybrid_blocked]``
   (``host_frac=0.5`` under ``LIME_HBM_BUDGET`` = 1 GiB): byte-identical;
   the pair-hit kernel launched once per planned chunk (per row block in
   ``[hybrid_blocked]``) and never in ``[all_host]``, which must offload
   dense chunks; K3 never; the dense kernel once per dense chunk (per
   row block it reaches in ``[hybrid_blocked]``); the delta-COO chain
   and host-plane bytes and the peak device memory beside ``[e2e]``'s;
12. index: the device index builder at the paper shape: the 1F
   collection's sequences (replayed from the dataset's seed), built by
   ``index.build_index(engine="tpu", device="cuda")``, byte-identical to
   the ``.ebwt``/``.lcp``/``.da`` the native SA-IS wrote for ``[e2e]``;
   positions, doubling rounds, the phase times (setup, doubling, LCP
   descent, extraction with the download), peak device memory, the
   host's available RAM, and the native SA-IS build of the same
   collection timed in the same run;
13. preprocess: FASTA to CSV with the port alone: the reads and genomes
   of a smaller dataset (``--preprocess-pairs``, default 50,000) written
   as FASTA, ``lime-tpu-torch preprocess`` on them, its four collections
   byte-identical to ``synth_big.paper_dataset``'s (built from arrays,
   no FASTA), then the fused ``run_paired`` on them: CSV byte-identical
   to ``executor="host"``'s on the same collections, the pair-hit kernel
   launched;
14. sharded: the SPMD engines at world size 1 on NCCL (a one-rank
   process group on ``tcp://127.0.0.1``), at the paper shape:
   ``run_sharded`` (banded engine, ``dense_threshold=0``: K3 on every
   collection, genome-dense clusters on the dense kernel) and
   ``run_sharded_pairs``, ``device="cuda"``: byte-identical to the host
   reference, K3 launched once per collection by the banded engine and
   the pair-hit kernel once per planned chunk by the pair engine; walls,
   spans and peak device memory;
15. sharded_ranks: several ranks on the one card, gloo between them
   (NCCL refuses two ranks on one device), every rank on ``cuda:0``: the
   dry run (``lime_tpu_torch.parallel.dryrun``) in 4 ranks as a 2x2 mesh
   (both engines, on its 100,000-pair dataset with planted >255-row runs,
   byte-identical to the host reference and to the forced row-blocked
   fused run), then the pair engine alone in 3 ranks as a 1x3 mesh (dp =
   3: the chunk exchange); each rank's kernel launches come back, every
   rank must launch, and a rank that fails or outlives its timeout fails
   the phase.  gloo takes the CUDA tensors directly (torch 2.11);
16. profile: ``[e2e]``'s fused run again, under ``LIME_PROFILE_DIR`` (a
   temporary directory) and a ``MemoryProfiler(interval=0.5,
   track_hbm=True)``: byte-identical; the trace's pair-hit kernel events
   per cap equal the launch counts; the trace's size and export time,
   the ten kernels with the most device time, the device's busy share
   over the traced window (the union of kernel and copy intervals), the
   wall beside ``[e2e]``'s and the memory profile;
17. unpacked: the 1F collection through the one-byte-per-row path:
   ``native.plan_pairs``, ``pair_score_into`` (the pair-hit kernel once
   per chunk, after the reorder and re-encode on the card),
   ``dense_score_into`` and the exact host scorer on what is left, into
   one int8 ``(R + 1, G_pad)`` plane on the card; its first R rows and G
   columns equal ``native.score_clusters_native`` on every cluster of
   the collection, and every chunk's kernel equals the plain version on
   read rows;
18. dump_sim: ``LIME_DUMP_SIM=1`` on a 40-pair dataset (read length 60,
   genomes of 2,000 and 1,500, seed 13): ``cluster_bwt`` with K3 on the
   card prints the host executor's dump byte for byte, K3 launched once.
19. no_native: the port as if its native library had failed to build
   (``native.available()`` False and every binding raising, restored
   afterwards), on the paper-shape dataset: K3 on each collection's
   numpy-planned stream (``_plan_python``: every mixed cluster of at most
   255 rows without an IUPAC-degenerate symbol, genome-dense ones
   included), exact against the plain version on the 1F stream's first
   positions, with the stream's runs by length, its window, and K3's
   time beside the bytes bound; then ``run_paired(LimeConfig(fused=True))``
   (the banded engine on that plan, the numpy rescue, the Python CSV
   writer: K3 once per collection, the pair-hit kernel never) and
   ``run_paired(LimeConfig())`` (``find_clusters``, K3, the numpy
   rescue), each byte-identical with ``planner == "numpy"``; then the
   oracle on the 1F collection of ``[preprocess]``'s dataset (cut from
   the paper shape's pairs to ``--preprocess-pairs``, the cut printed):
   the numpy ``score_clusters`` plane equal, cell for cell, to
   ``native.score_clusters_native``'s and to the port's K3 plane
   (``score_clusters_tpu`` without the library).  Every other phase's
   run must report ``planner == "native"``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Nothing of jax or ``lime_tpu`` is
imported, here or in the spawned ranks.
"""

from __future__ import annotations

import sys

# the port must run where jax and the JAX package are absent
sys.modules["jax"] = None
sys.modules["lime_tpu"] = None

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import datetime  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from lime_tpu_torch import LimeConfig, host, native, reference  # noqa: E402
from lime_tpu_torch import run_paired  # noqa: E402
from lime_tpu_torch import cli  # noqa: E402
from lime_tpu_torch import pipeline as staged_pipeline  # noqa: E402
from lime_tpu_torch.formats.arrays import (  # noqa: E402
    open_da, open_ebwt, open_lcp, read_docs)
from lime_tpu_torch.formats.fasta import write_fasta  # noqa: E402
from lime_tpu_torch.index import build_index  # noqa: E402
from lime_tpu_torch.index import torch_builder  # noqa: E402
from lime_tpu_torch.host import (  # noqa: E402
    B_BLK, C_BLK, K, PACK_EMIT_BIT, PACK_M_BIT, PR)
from lime_tpu_torch.ops import banded_kernels as bk  # noqa: E402
from lime_tpu_torch.ops import cuda_build  # noqa: E402
from lime_tpu_torch.ops import dense_kernels  # noqa: E402
from lime_tpu_torch.ops import fused_pipeline  # noqa: E402
from lime_tpu_torch.ops import pair_kernels as pk  # noqa: E402
from lime_tpu_torch.ops import pair_score as tps  # noqa: E402
from lime_tpu_torch.constants import (  # noqa: E402
    IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT)
from lime_tpu_torch.ops.dense_score import (  # noqa: E402
    _dense_chunk, _dense_rows, dense_score_into)
from lime_tpu_torch.ops.classify_torch import (  # noqa: E402
    _classify_program_planes, _unpack_triplet, alloc_planes)
from lime_tpu_torch.ops.cluster_scan import find_clusters  # noqa: E402
from lime_tpu_torch.ops.fused_pass import (  # noqa: E402
    score_clusters_tpu, staged_stream)
from lime_tpu_torch.ops.scoring import score_clusters  # noqa: E402
from lime_tpu_torch.parallel import make_mesh  # noqa: E402
from lime_tpu_torch.parallel import sharded  # noqa: E402
from lime_tpu_torch.parallel.dryrun import free_port, spawn_ranks  # noqa: E402
from lime_tpu_torch import synth_big  # noqa: E402
from lime_tpu_torch.synth_big import (  # noqa: E402
    PAPER_GENOME_LEN, PAPER_GENOMES, PAPER_READ_LEN, compute_truth,
    paper_1f_sequences, paper_dataset, paper_sequences)
from lime_tpu_torch.synth import make_dataset  # noqa: E402
from lime_tpu_torch.utils.memory import (  # noqa: E402
    MemoryProfiler, host_memory_stats, memory_report)
from lime_tpu_torch.utils.timing import (  # noqa: E402
    event_ms, graph_ms, pair_kernel_launches, read_trace, trace_summary)

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_GENOMES, GENOME_LEN, READ_LEN = (PAPER_GENOMES, PAPER_GENOME_LEN,
                                     PAPER_READ_LEN)

#: the Pallas kernel each CUDA kernel replaces (body's first line)
REPLACES = {"scan16": "lime_tpu/ops/pallas_kernels.py:311",
            "scan64": "lime_tpu/ops/pallas_kernels.py:311",
            "band": "lime_tpu/ops/pallas_kernels.py:225",
            "banded": "lime_tpu/ops/pallas_kernels.py:73"}
SOURCE = {"scan16": "pair_hits", "scan64": "pair_hits", "band": "pair_hits",
          "banded": "banded_pairs"}
CAP_OF = {"scan16": 16, "scan64": 64, "band": 255}
#: the kernels whose launches ``[blocked]`` and ``[host_share]`` count:
#: the Pallas kernels' and the dense kernel, which replaces XLA ops
KERNELS = (*REPLACES, "dense")
#: the H100 SXM's device-memory rate (NVIDIA's data sheet)
HBM_BYTES_PER_MS = 3.35e12 / 1e3


def bytes_bound_ms(nbytes: int) -> float:
    """Least time the card needs to move ``nbytes`` of device memory."""
    return nbytes / HBM_BYTES_PER_MS


def share(bound: float, ms: float) -> str:
    """``bound`` as a share of a measured ``ms``."""
    return f"{bound / ms:.1%}" if ms else "n/a"


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    return name, smi


def ptxas_usage(ptxas: str) -> dict:
    """``-Xptxas -v`` output -> {mangled kernel name: its registers,
    shared memory and spills}."""
    usage, name = {}, None
    for line in ptxas.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "bytes spill" in line:
            usage[name] = line
        elif name and line.startswith("ptxas info") and "Used" in line:
            usage[name] = f"{line.split(':', 1)[1].strip()}; " + usage.get(
                name, "")
            name = None
    return usage


def phase_build():
    t0 = time.perf_counter()
    for name, ptxas in cuda_build.compile_all(
            ["pair_hits", "banded_pairs", "dense_pairs"],
            verbose=True).items():
        log(f"[build] {name}: {ptxas.strip()}")
        for kernel, use in ptxas_usage(ptxas).items():
            for base, what in (("banded_sim_kernel", "K3 banded_sim_kernel"),
                               ("dense_pairs_kernel", "dense_pairs_kernel")):
                if base in kernel:
                    acc = "int8_t" if f"{base}Ia" in kernel else "int32_t"
                    log(f"[build] {what}<{acc}>: {use}")
    pk.build()
    bk.build()
    dense_kernels.build()
    log(f"[build] pair-hit kernels, K3 and the dense kernel built and "
        f"loaded in "
        f"{time.perf_counter() - t0:.2f} s ({cuda_build.BUILD_DIR})")


def _check_pair(name, codes, window, cap):
    """The kernel against the plain version on read rows of ``codes``;
    returns (max abs error, hit count)."""
    got = pk.pair_hits(codes, window, cap)
    want = pk.pair_hits_plain(codes, window, cap)
    read = ((codes >> 4) & 1) == 0
    err = int((got - want).abs()[read].max().item())
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain on read rows "
                             f"(max abs err {err})")
    return err, int(got[read].sum().item())


def _plan_codes(fasta: str, ds, dev):
    """One collection's pair chunks as ``run_fused`` plans them: (per
    chunk ``(bucket, codes)`` unpacked on ``dev``, windows per bucket)."""
    arrays, chunks, windows, row_bits = fused_pipeline._plan_pairs(
        open_lcp(fasta, mmap=True), open_da(fasta, mmap=True),
        open_ebwt(fasta, mmap=True), ds.num_reads, ds.num_genomes,
        LimeConfig(fused=True))[:4]
    return tps.chunk_codes(arrays, chunks, row_bits, dev), windows


def phase_kernels(ds, card: str, dev: torch.device, launches: dict):
    """Each bucket's kernel on the 32M-row planner-shaped stream, then on
    every pair chunk of the four collections: the chunks ``[e2e]``
    launched the kernel on, one launch each."""
    records = {}
    for name, cap in CAP_OF.items():
        base = pk.planner_shaped_chunk(np.random.default_rng(1), 1 << 20,
                                       cap)
        codes = torch.from_numpy(np.tile(base, 32)).to(dev)
        n = codes.shape[0]
        err, n_hits = _check_pair(name, codes, cap, cap)
        ms = event_ms(lambda: pk.pair_hits(codes, cap, cap))
        g_ms = graph_ms([lambda: pk.pair_hits(codes, cap, cap)])
        plain_ms = event_ms(lambda: pk.pair_hits_plain(codes, cap, cap))
        bound = bytes_bound_ms(5 * n)
        log(f"[kernels] {name}: {n} rows, cap {cap}: exact on read rows "
            f"({n_hits} hits); kernel {ms:.4f} ms per call "
            f"({bound / ms:.1%} of the {bound:.4f} ms bound), {g_ms:.4f} ms "
            f"in a graph ({bound / g_ms:.1%}); plain {plain_ms:.3f} ms "
            f"({card})")
        records[name] = {"max_abs_err": err, "ms": round(ms, 4),
                         "graph_ms": round(g_ms, 4),
                         "plain_ms": round(plain_ms, 4),
                         "bound_ms": round(bound, 6), "bound_by": "bytes",
                         "library_ms": None}
        del codes
    main = {name: {"chunks": 0, "rows": 0, "ms": 0.0, "graph_ms": 0.0}
            for name in CAP_OF}
    names = list(CAP_OF)
    for fasta in ds.collections:
        per_chunk, windows = _plan_codes(fasta, ds, dev)
        calls = {name: [] for name in CAP_OF}
        for bucket, c in per_chunk:
            name, window = names[bucket], windows[bucket]
            cap = CAP_OF[name]
            rec, m = records[name], main[name]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     _check_pair(name, c, window, cap)[0])
            call = (lambda c=c, w=window, k=cap: pk.pair_hits(c, w, k))
            m["chunks"] += 1
            m["rows"] += c.shape[0]
            m["ms"] += event_ms(call)
            calls[name].append(call)
        for name, bucket_calls in calls.items():
            if bucket_calls:
                main[name]["graph_ms"] += graph_ms(bucket_calls)
        del per_chunk, calls
    for name, m in main.items():
        if m["chunks"] != launches[name]:
            raise AssertionError(f"{name}: {m['chunks']} planned chunks, "
                                 f"{launches[name]} launches on [e2e]")
        bound = bytes_bound_ms(5 * m["rows"])
        log(f"[kernels] {name} on the main path's chunks (four "
            f"collections): {m['chunks']} chunks, {m['rows']} rows: exact "
            f"on read rows; kernel {m['ms']:.4f} ms summed per call "
            f"({share(bound, m['ms'])} of the {bound:.6f} ms bound), "
            f"{m['graph_ms']:.4f} ms in graphs "
            f"({share(bound, m['graph_ms'])}) ({card})")
        records[name].update({"main_path_ms": round(m["ms"], 4),
                              "main_path_graph_ms": round(m["graph_ms"], 4),
                              "main_path_bound_ms": round(bound, 6)})
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return records


def phase_cascade(dev: torch.device, R: int = 65536):
    rng = np.random.default_rng(5)
    F, G, g_pad = 4, NUM_GENOMES, 1024
    cfg = LimeConfig(assign_higher=True, tax_rank=1)
    # sparse counters with ties: most cells 0, a few of each read's
    # genomes share one count, the rest random (wrapped int8 bits)
    vals = rng.integers(0, 256, size=(F, R, G))
    keep = rng.random((F, R, G)) < 0.01
    planes_h = np.zeros((F, R, g_pad), np.uint8)
    planes_h[:, :, :G] = np.where(keep, vals, 0)
    tie = rng.integers(0, G - 8, size=R)
    for j in range(4):
        planes_h[:, np.arange(R), tie + j] = planes_h[:, np.arange(R), tie]
    tax = (1000 + np.arange(G) // 3).astype(np.int64)
    rank = np.stack([(1000 + np.arange(G) // (3 << lv)).astype(np.int64)
                     for lv in range(6)])
    want = reference.classify_matrices(
        [planes_h[f, :, :G] for f in range(F)], READ_LEN, tax, rank, cfg)

    buf, planes = alloc_planes(F, R, g_pad, torch.int8, dev)
    planes.copy_(torch.from_numpy(planes_h.view(np.int8)).to(dev))
    tax_p = np.zeros(g_pad, np.int64)
    tax_p[:G] = tax
    rank_p = np.zeros((6, g_pad), np.int64)
    rank_p[:, :G] = rank

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    empty = torch.empty(0, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    packed = _classify_program_planes(
        buf, F, R, g_pad, empty, empty, empty.to(torch.int8), empty,
        torch.from_numpy(tax_p).to(dev), torch.from_numpy(rank_p).to(dev),
        torch.arange(g_pad, device=dev) < G, f32(cfg.error_tolerance),
        f32(np.uint32(READ_LEN + 1 - cfg.alpha)), f32(cfg.beta),
        cfg.tax_rank, cfg.assign_higher, True, 1 << 14)
    t_h, x_h, s_h = _unpack_triplet(packed.cpu().numpy())
    dt = time.perf_counter() - t0
    if not (np.array_equal(t_h, want.types.astype(np.uint8))
            and np.array_equal(x_h, want.taxid)
            and np.array_equal(s_h.view(np.uint32),
                               want.sim.view(np.uint32))):
        bad = np.flatnonzero((t_h != want.types.astype(np.uint8))
                             | (x_h != want.taxid)
                             | (s_h.view(np.uint32)
                                != want.sim.view(np.uint32)))
        raise AssertionError(f"cascade differs from classify_ops on "
                             f"{len(bad)} reads, first {bad[:5]}")
    counts = {c: int((t_h == t).sum()) for t, c in enumerate("UCAH")}
    log(f"[cascade] (4, {R}, {g_pad}) int8 planes: types, taxids exact and "
        f"sims bit-equal to classify_ops; {counts}; {dt:.2f} s incl. "
        "download")
    del buf, planes, packed


def dataset(pairs: int):
    t0 = time.perf_counter()
    ds, built = paper_dataset(os.path.join(ROOT, "build"), pairs)
    log(f"[e2e] dataset {'built' if built else 'reused'}: {pairs} pairs x "
        f"{NUM_GENOMES} genomes in {time.perf_counter() - t0:.1f} s "
        f"({ds.root})")
    if built:
        b = synth_big.LAST_BUILD
        log(f"[e2e] index builds: {b['workers']} at once, each needing "
            f"~{b['need_bytes']} B of the {b['free_bytes']} B of host RAM "
            f"free before them; peak host RSS "
            f"{host_memory_stats()['peak_rss_bytes']} B after them")
    return ds


#: each drive()'s wall by its label
WALLS = {}


def drive(label: str, ds, cfg, ref_csv: str, card: str, dev, counters,
          planner: str = "native"):
    """Run ``run_paired`` on ``dev`` with every launch count set to 0
    just before; return (launches, CSV path) after checking the CSV
    byte-identical to ``ref_csv`` and that ``planner`` planned the run
    (the C++ planner everywhere but ``[no_native]``: a failed native
    build cannot pass on the numpy path unseen)."""
    out_csv = os.path.join(ds.root, f"torch_{label}.csv")
    shape = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len, cfg)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    summary = run_paired(ds.collections, out_csv, *shape,
                         keep_results=False, device=dev)
    wall = time.perf_counter() - t0
    WALLS[label] = wall
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = (fused_pipeline.LAST_RUN if cfg.fused
             else staged_pipeline.LAST_RUN)
    phases = " ".join(f"{k}={v:.3f}s" for k, v in stats["phases"].items())
    if cfg.fused:
        extra = (f"; pair chunks per bucket (caps 16/64/255) "
                 f"{stats['chunks_per_bucket']}; banded windows "
                 f"{stats['banded_windows']}")
    else:
        extra = "; " + "; ".join(
            f"{st}: " + " ".join(f"{k}={v:.3f}s" for k, v in ph.items())
            for st, ph in stats["stages"].items())
    if stats["planner"] != planner:
        raise AssertionError(f"[{label}] planner {stats['planner']}, "
                             f"{planner} expected")
    if (dense_kernels in counters and cfg.fused
            and launches["dense"] != stats["counts"]["dense_launches"]):
        raise AssertionError(f"[{label}] {launches['dense']} dense kernel "
                             f"launches, the run counted "
                             f"{stats['counts']['dense_launches']}")
    log(f"[{label}] run_paired(device='{dev}'): {wall:.3f} s wall = "
        f"{ds.num_reads / wall:.0f} reads/s; planner {planner}; "
        f"phases: {phases}; peak "
        f"device memory {peak} B{extra}; launches {launches}; "
        f"C={summary.classified} H={summary.higher} A={summary.ambiguous} "
        f"U={summary.unclassified} ({card})")
    with open(ref_csv, "rb") as a, open(out_csv, "rb") as b:
        ref_bytes, out_bytes = a.read(), b.read()
    if ref_bytes != out_bytes:
        raise AssertionError(f"[{label}] port CSV differs from the host "
                             f"reference ({len(out_bytes)} vs "
                             f"{len(ref_bytes)} B)")
    log(f"[{label}] CSV byte-identical to the host reference "
        f"({len(out_bytes)} B)")
    return launches, out_csv


def phase_e2e(pairs: int, card: str, dev: torch.device):
    ds = dataset(pairs)
    ref_csv = os.path.join(ds.root, "reference.csv")
    t0 = time.perf_counter()
    reference.reference_csv(ds.collections, ref_csv, ds.num_reads,
                            ds.num_genomes, ds.lineage_path, ds.read_len,
                            LimeConfig())
    log(f"[e2e] host reference CSV in {time.perf_counter() - t0:.1f} s")
    launches, out_csv = drive("e2e", ds, LimeConfig(fused=True), ref_csv,
                              card, dev, [pk, dense_kernels])
    for name in launches:
        if dev.type == "cuda" and launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "fused serving path")
    dense_chunks = fused_pipeline.LAST_RUN["dense_chunks"]
    if dev.type == "cuda" and launches["dense"] != dense_chunks:
        raise AssertionError(f"{launches['dense']} dense kernel launches "
                             f"for {dense_chunks} dense chunks")
    origins = compute_truth(ds.root, ds.num_reads, ds.num_genomes,
                            GENOME_LEN)
    acc = reference.accuracy(out_csv, origins,
                             1000 + np.arange(ds.num_genomes))
    log(f"[e2e] accuracy {acc.summary()}")
    return ds, ref_csv, launches


def _k3_bound_ms(n: int, acc: torch.Tensor) -> tuple:
    """(touched cells, bound) of K3 on ``n`` positions that left the
    int32 accumulator ``acc``: 5 B per position (code and document id
    read once) and 8 B per touched cell (read once, written once)."""
    touched = int(torch.count_nonzero(acc).item())
    return touched, bytes_bound_ms(5 * n + 8 * touched)


def _staged_codes(fasta: str, ds, cfg, dev):
    """One collection's staged stream, the stream ``cluster_bwt`` hands
    K3: (packed codes, document ids) on ``dev``, its window, and the
    host copies."""
    lcp, da = open_lcp(fasta), open_da(fasta)
    starts, lens = native.plan_clusters(lcp, da, ds.num_reads, cfg.alpha,
                                        threads=0)
    packed_h, doc_h, window, _ = staged_stream(
        starts, lens, da, open_ebwt(fasta), cfg, cfg.alpha, lcp)
    return (torch.from_numpy(packed_h).to(dev),
            torch.from_numpy(doc_h).to(dev), window, packed_h, doc_h)


#: run-length buckets of the K3 stream statistics (upper edges)
RUN_BUCKETS = (1, 16, 64, 128, 256)


def run_stats(packed: np.ndarray, doc: np.ndarray, num_reads: int,
              g_cols: int, window: int) -> str:
    """What K3's work depends on in one stream: runs and positions by run
    length, the positions in runs holding both an emitting read and a
    counted genome position (the runs that score), the genome positions
    per such run, and the runs longer than ``window + 1`` (K3's long-run
    walk) that score."""
    start = (packed & (1 << PACK_M_BIT)) == 0
    start[0] = True
    starts = np.flatnonzero(start)
    del start
    lens = np.diff(starts, append=len(packed))
    read = (((packed >> PACK_EMIT_BIT) & 1) == 1) & (doc >= 0) & (
        doc < num_reads)
    reads = np.add.reduceat(read.view(np.uint8), starts, dtype=np.int64)
    del read
    genome = (doc >= num_reads) & (doc.astype(np.int64) - num_reads < g_cols)
    genomes = np.add.reduceat(genome.view(np.uint8), starts, dtype=np.int64)
    del genome
    both = (reads > 0) & (genomes > 0)
    bucket = np.searchsorted(np.array(RUN_BUCKETS), lens)
    names = [f"<={RUN_BUCKETS[0]}"] + [
        f"{a + 1}-{b}" for a, b in zip(RUN_BUCKETS, RUN_BUCKETS[1:])] + [
        f">{RUN_BUCKETS[-1]}"]
    hist = " ".join(
        f"{name}: {int(np.sum(bucket == i))} runs/"
        f"{int(lens[bucket == i].sum())} pos"
        for i, name in enumerate(names))
    g_per = genomes[both]
    g_hist = np.bincount(np.minimum(g_per, 17), minlength=18)
    long_ = lens > window + 1
    return (f"{len(lens)} runs ({hist}); scoring runs {int(both.sum())} "
            f"holding {int(lens[both].sum())} positions, genome positions "
            f"per scoring run mean {g_per.mean() if len(g_per) else 0:.3f} "
            f"max {int(g_per.max()) if len(g_per) else 0} (1: "
            f"{int(g_hist[1])}, 2: {int(g_hist[2])}, 3-16: "
            f"{int(g_hist[3:17].sum())}, 17+: {int(g_hist[17])}); runs over "
            f"window + 1 = {window + 1}: {int(long_.sum())}, scoring "
            f"{int((long_ & both).sum())}")


def _banded_planner_codes(fasta: str, ds, cfg, dev):
    """One collection's compacted planner stream as ``[banded]`` hands it
    to K3 (``fused_pipeline._run_fused_inner``): (codes, document ids) on
    ``dev`` and its window, or None when nothing is banded."""
    packed, doc, nc, window = fused_pipeline.plan_banded(
        open_lcp(fasta), open_da(fasta), open_ebwt(fasta), ds.num_reads,
        ds.num_genomes, cfg)[:4]
    if not nc:
        return None
    return (torch.from_numpy(fused_pipeline.banded_codes(packed)).to(dev),
            torch.from_numpy(fused_pipeline._doc_i32(doc)).to(dev), window)


def phase_banded_kernel(ds, card: str, dev: torch.device, n: int = 1 << 22):
    """K3 against its plain version on the first ``n`` positions of the
    1F collection's staged stream; then K3 alone on the whole stream of
    each collection (the four launches of ``[staged]``), with the
    stream's run statistics; then on each collection's planner stream
    (the launches of ``[banded]``)."""
    cfg = LimeConfig()
    R = ds.num_reads
    g_pad = fused_pipeline._g_pad_for(ds.num_genomes)
    packed_all, doc_all, window, packed_h, doc_h = _staged_codes(
        ds.collections[0], ds, cfg, dev)
    packed, doc = packed_all[:n], doc_all[:n]
    sims = {}
    for name, dt in (("kernel32", torch.int32), ("kernel8", torch.int8),
                     ("plain32", torch.int32)):
        sims[name] = torch.zeros((R + 1, g_pad), dtype=dt, device=dev)
    bk.banded_sim_into(sims["kernel32"], packed, doc, window, R)
    bk.banded_sim_into(sims["kernel8"], packed, doc, window, R)
    bk.banded_sim_plain(sims["plain32"], packed, doc, window, R)
    err = int((sims["kernel32"] - sims["plain32"]).abs().max().item())
    # int8 adds wrap mod 256: the plain int32 counts' low byte
    err8 = int((sims["kernel8"].view(torch.uint8).to(torch.int32)
                - (sims["plain32"] & 255)).abs().max().item())
    pairs = int(sims["plain32"].sum().item())
    if err or err8:
        raise AssertionError(f"banded: kernel != plain (max abs err int32 "
                             f"{err}, int8 {err8})")
    touched, bound = _k3_bound_ms(n, sims["plain32"])
    del sims["kernel8"], sims["plain32"]
    acc = sims.pop("kernel32")
    ms = event_ms(lambda: bk.banded_sim_into(acc, packed, doc, window, R))
    g_ms = graph_ms(
        [lambda: bk.banded_sim_into(acc, packed, doc, window, R)])
    plain_ms = event_ms(
        lambda: bk.banded_sim_plain(acc, packed, doc, window, R), reps=1)
    log(f"[kernels] banded: {n} positions of the 1F stream, G_pad {g_pad}, "
        f"window {window}: int32 and int8 exact ({pairs} pair counts, "
        f"{touched} cells); kernel {ms:.4f} ms per call ({bound / ms:.1%} "
        f"of the {bound:.4f} ms bound), {g_ms:.4f} ms in a graph "
        f"({bound / g_ms:.1%}); plain {plain_ms:.3f} ms ({card})")
    del packed, doc
    main = {"ms": 0.0, "graph_ms": 0.0, "bound_ms": 0.0}
    for i, fasta in enumerate(ds.collections):
        if i:
            packed_all, doc_all, window, packed_h, doc_h = _staged_codes(
                fasta, ds, cfg, dev)
        log(f"[kernels] banded runs of the {os.path.basename(fasta)} "
            f"staged stream: {run_stats(packed_h, doc_h, R, g_pad, window)}")
        del packed_h, doc_h
        n_all = packed_all.shape[0]
        acc.zero_()
        bk.banded_sim_into(acc, packed_all, doc_all, window, R)
        pairs_all = int(acc.sum().item())
        touched_all, bound_all = _k3_bound_ms(n_all, acc)

        def call():
            bk.banded_sim_into(acc, packed_all, doc_all, window, R)

        ms_all, g_all = event_ms(call), graph_ms([call])
        main["ms"] += ms_all
        main["graph_ms"] += g_all
        main["bound_ms"] += bound_all
        log(f"[kernels] banded on the whole {os.path.basename(fasta)} "
            f"stream: {n_all} positions, window {window}, {pairs_all} pair "
            f"counts, {touched_all} (read, genome) cells: kernel "
            f"{ms_all:.4f} ms per call, {g_all:.4f} ms in a graph "
            f"({bound_all / g_all:.1%} of the {bound_all:.4f} ms bound: "
            f"positions {bytes_bound_ms(5 * n_all):.4f} ms, cells "
            f"{bytes_bound_ms(8 * touched_all):.4f} ms) ({card})")
        del packed_all, doc_all
    planner = {"streams": 0, "ms": 0.0, "graph_ms": 0.0, "bound_ms": 0.0}
    banded_cfg = LimeConfig(fused=True, pair_stream=False, dense_threshold=0)
    plane = torch.zeros((fused_pipeline._r_pad_for(R), g_pad),
                        dtype=torch.int8, device=dev)
    for fasta in ds.collections:
        codes = _banded_planner_codes(fasta, ds, banded_cfg, dev)
        if codes is None:
            continue
        packed_p, doc_p, window_p = codes
        n_p = packed_p.shape[0]
        acc.zero_()  # counts in int32 for the touched cells
        bk.banded_sim_into(acc, packed_p, doc_p, window_p, R)
        pairs_p = int(acc.sum().item())
        touched_p = int(torch.count_nonzero(acc).item())
        # the int8 plane [banded] adds into: 2 B per touched cell
        bound_p = bytes_bound_ms(5 * n_p + 2 * touched_p)

        def call_p():
            bk.banded_sim_into(plane, packed_p, doc_p, window_p, R)

        ms_p, g_p = event_ms(call_p), graph_ms([call_p])
        planner["streams"] += 1
        planner["ms"] += ms_p
        planner["graph_ms"] += g_p
        planner["bound_ms"] += bound_p
        log(f"[kernels] banded on the {os.path.basename(fasta)} planner "
            f"stream ([banded]): {n_p} positions, window {window_p}, "
            f"{pairs_p} pair counts, {touched_p} cells, int8 plane: kernel "
            f"{ms_p:.4f} ms per call, {g_p:.4f} ms in a graph "
            f"({share(bound_p, g_p)} of the {bound_p:.4f} ms bound) ({card})")
        del packed_p, doc_p
    del acc, plane
    log(f"[kernels] banded summed: four staged streams {main['ms']:.4f} ms "
        f"per call, {main['graph_ms']:.4f} ms in graphs "
        f"({share(main['bound_ms'], main['graph_ms'])} of "
        f"{main['bound_ms']:.4f} ms); {planner['streams']} planner streams "
        f"{planner['ms']:.4f} ms per call, {planner['graph_ms']:.4f} ms in "
        f"graphs ({share(planner['bound_ms'], planner['graph_ms'])} of "
        f"{planner['bound_ms']:.4f} ms) ({card})")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": round(ms, 4),
            "graph_ms": round(g_ms, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(bound, 6), "bound_by": "bytes",
            "library_ms": None, "main_path_ms": round(main["ms"], 4),
            "main_path_graph_ms": round(main["graph_ms"], 4),
            "main_path_bound_ms": round(main["bound_ms"], 6),
            "banded_path_ms": round(planner["ms"], 4),
            "banded_path_graph_ms": round(planner["graph_ms"], 4),
            "banded_path_bound_ms": round(planner["bound_ms"], 6)}


def _dense_plan(fasta: str, ds, g_pad: int) -> list:
    """One collection's dense chunks as ``run_fused`` plans and packs
    them (host arrays)."""
    da, ebwt = open_da(fasta), open_ebwt(fasta)
    den_s, den_l = fused_pipeline._plan_pairs(
        open_lcp(fasta), da, ebwt, ds.num_reads, ds.num_genomes,
        LimeConfig(fused=True))[4:6]
    return host.pack_chunks(den_s, den_l, da, ebwt, ds.num_reads,
                            ds.num_genomes, g_pad)[0]


def _dense_chain(plane, chunk, f: int, g_pad: int, nonzero=None) -> None:
    """The plain version's torch chain on ``chunk`` into ``plane``, on
    their device: :func:`_dense_rows` and one row scatter-add a column
    tile, the path the dense kernel replaced on the card.  Each tile's
    nonzero scores (the kernel's adds) are appended to ``nonzero`` as
    device counts."""
    ridx, gidx, cmap, rid = chunk
    for c0, add in _dense_rows(ridx, gidx, cmap, B_BLK, C_BLK, PR, f,
                               g_pad):
        plane[:, c0:c0 + add.shape[1]].index_add_(0, rid,
                                                  add.to(plane.dtype))
        if nonzero is not None:
            nonzero.append(torch.count_nonzero(add))


def phase_dense_kernel(ds, card: str, dev: torch.device,
                       launches: dict) -> dict:
    """The dense kernel on every dense chunk of the four collections (the
    chunks ``[e2e]`` launched it on, one launch each): its int8 plane
    against the plain version's chain on the card and, for the 1F
    collection, against the plain version on the CPU; then both timed
    beside the bound."""
    cfg = LimeConfig(fused=True)
    R = ds.num_reads
    g_pad = fused_pipeline._g_pad_for(ds.num_genomes)
    f = (4 if cfg.use_ebwt else 1) * K
    shape = (fused_pipeline._r_pad_for(R), g_pad)
    plane = torch.zeros(shape, dtype=torch.int8, device=dev)
    chain = torch.zeros(shape, dtype=torch.int8, device=dev)
    status = dense_kernels.new_status(dev)
    pads = (B_BLK * PR * f, C_BLK * g_pad * f)
    tot = {"chunks": 0, "cells": 0, "nonzero": 0, "bytes": 0, "ms": 0.0,
           "graph_ms": 0.0, "plain_ms": 0.0}
    cpu_ms = None
    for i, fasta in enumerate(ds.collections):
        name = os.path.basename(fasta)
        host_chunks = _dense_plan(fasta, ds, g_pad)
        chunks = [tuple(torch.from_numpy(a).to(dev) for a in c)
                  for c in host_chunks]
        plane.zero_()
        chain.zero_()
        nonzero = []
        for c in chunks:
            _dense_chunk(plane, *c, B_BLK, C_BLK, PR, f, g_pad, status)
            _dense_chain(chain, c, f, g_pad, nonzero)
        cells = dense_kernels.take(status)
        nnz = int(torch.stack(nonzero).sum().item()) if nonzero else 0
        if not torch.equal(plane, chain):
            bad = int(torch.count_nonzero(plane != chain).item())
            raise AssertionError(f"[kernels] dense on {name}: the kernel's "
                                 f"plane differs from the chain's in {bad} "
                                 "cells")
        if i == 0:
            cpu = torch.zeros(shape, dtype=torch.int8)
            st_cpu = dense_kernels.new_status(torch.device("cpu"))
            t0 = time.perf_counter()
            for c in host_chunks:
                _dense_chunk(cpu, *(torch.from_numpy(a) for a in c), B_BLK,
                             C_BLK, PR, f, g_pad, st_cpu)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            cpu_cells = dense_kernels.take(st_cpu)
            if not torch.equal(plane.cpu(), cpu) or cpu_cells != cells:
                raise AssertionError(f"[kernels] dense on {name}: the "
                                     f"kernel's plane or its {cells} cells "
                                     f"differ from the CPU plain version's "
                                     f"({cpu_cells} cells)")
            del cpu
        # 4 B a real triple, cmap and rid; 2 B a nonzero add (read and
        # written once)
        triples = sum(int(np.count_nonzero(c[0] != pads[0]))
                      + int(np.count_nonzero(c[1] != pads[1]))
                      for c in host_chunks)
        nbytes = 4 * (triples + len(chunks) * (B_BLK + B_BLK * PR)) \
            + 2 * nnz

        def run(chunks=chunks):
            for c in chunks:
                _dense_chunk(plane, *c, B_BLK, C_BLK, PR, f, g_pad, status)

        def run_chain(chunks=chunks):
            for c in chunks:
                _dense_chain(chain, c, f, g_pad)

        ms, g_ms = event_ms(run), graph_ms([run])
        plain_ms = event_ms(run_chain, reps=1)
        dense_kernels.take(status)
        bound = bytes_bound_ms(nbytes)
        for key, v in (("chunks", len(chunks)), ("cells", cells),
                       ("nonzero", nnz), ("bytes", nbytes), ("ms", ms),
                       ("graph_ms", g_ms), ("plain_ms", plain_ms)):
            tot[key] += v
        cpu_note = (f"; CPU plain version equal, {cpu_ms:.1f} ms"
                    if i == 0 else "")
        log(f"[kernels] dense on {name}: {len(chunks)} chunks at G_pad "
            f"{g_pad}, {cells} cells scored, {nnz} nonzero adds, {triples} "
            f"triples: exact against the chain on the card{cpu_note}; "
            f"kernel {ms:.4f} ms per call ({share(bound, ms)} of the "
            f"{bound:.6f} ms bound), {g_ms:.4f} ms in a graph "
            f"({share(bound, g_ms)}); chain {plain_ms:.3f} ms ({card})")
        del chunks
    if dev.type == "cuda" and tot["chunks"] != launches["dense"]:
        raise AssertionError(f"dense: {tot['chunks']} planned chunks, "
                             f"{launches['dense']} launches on [e2e]")
    bound = bytes_bound_ms(tot["bytes"])
    log(f"[kernels] dense summed over the four collections: "
        f"{tot['chunks']} chunks, kernel {tot['ms']:.4f} ms per call, "
        f"{tot['graph_ms']:.4f} ms in graphs ({share(bound, tot['graph_ms'])}"
        f" of the {bound:.6f} ms bound); chain {tot['plain_ms']:.3f} ms "
        f"({card})")
    del plane, chain
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"max_abs_err": 0, "ms": round(tot["ms"], 4),
            "graph_ms": round(tot["graph_ms"], 4),
            "plain_ms": round(tot["plain_ms"], 4),
            "cpu_plain_1f_ms": round(cpu_ms, 1),
            "bound_ms": round(bound, 6), "bound_by": "bytes",
            "library_ms": None, "chunks": tot["chunks"],
            "cells": tot["cells"], "nonzero_adds": tot["nonzero"]}


@contextlib.contextmanager
def environ(env: dict):
    """Set the variables ``env`` for the ``with`` body, then restore."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def phase_blocked(ds, ref_csv: str, card: str, dev: torch.device,
                  e2e_peak: int) -> dict:
    """The row-blocked fused mode at the paper shape, in one pass and in
    owner passes; returns each kernel's launches per run, counted from 0
    just before it (K3 must stay at 0: the mode scores pair streams)."""
    est = fused_pipeline.stream_estimate(ds.collections, ds.num_reads)
    runs = {"blocked": {"LIME_HBM_BUDGET": str(1 << 30)},
            "blocked_passes": {"LIME_HBM_BUDGET": str(1 << 30),
                               "LIME_STREAM_BUDGET": str(est // 2 + 1)}}
    out = {name: {} for name in KERNELS}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        log(f"[blocked] card memory {total} B, {free} B free before the "
            f"runs; the automatic budget would be "
            f"{max(free - fused_pipeline.MEMORY_HEADROOM, 0)} B ({card})")
    for label, env in runs.items():
        with environ(env):
            launches, _ = drive(label, ds, LimeConfig(fused=True), ref_csv,
                                card, dev, [pk, bk, dense_kernels])
        st = fused_pipeline.LAST_RUN
        want = dict(zip(CAP_OF, st["launches_per_bucket"]))
        pair = {name: launches[name] for name in CAP_OF}
        passes = label == "blocked_passes"
        if (st["engine"] != "blocked" or (st["n_pass"] >= 2) != passes
                or pair != want or not all(pair.values())
                or launches["banded"]
                or not 0 < st["dense_chunks"] <= launches["dense"]
                <= st["dense_chunks"] * st["blocks"]
                or (not passes and list(want.values()) != [
                    n * st["blocks"] for n in st["chunks_per_bucket"]])):
            raise AssertionError(
                f"[{label}] engine {st['engine']}, {st['n_pass']} passes, "
                f"{st.get('blocks')} blocks, chunks "
                f"{st.get('chunks_per_bucket')}, dense chunks "
                f"{st['dense_chunks']}: launches {launches}, the plan "
                f"implies {want}, no K3 and each dense chunk once per row "
                f"block it reaches")
        mem, res = st["memory"], st["resident_bytes"]
        stack = len(ds.collections) * st["B"] * fused_pipeline._g_pad_for(
            ds.num_genomes)
        peak = mem.get("peak_bytes_in_use", 0)
        rest = peak - stack - res["pair_streams"] - res["dense_chunks"]
        log(f"[{label}] B={st['B']} reads, {st['blocks']} blocks, "
            f"{st['n_pass']} owner passes (streams estimated at {est} B); "
            f"pair-kernel launches {pair} = chunks "
            f"{st['chunks_per_bucket']} x blocks of their pass; K3 "
            f"launches 0; dense kernel launches {launches['dense']} "
            f"({st['dense_chunks']} dense chunks, {st['blocks']} blocks); "
            f"stack {stack} B; resident pair "
            f"streams {res['pair_streams']} B (largest pass), dense chunks "
            f"{res['dense_chunks']} B; peak device memory {peak} B, "
            f"[e2e] {e2e_peak} B ({peak - e2e_peak:+d} B); peak less stack, "
            f"streams and dense chunks {rest} B ({card})")
        for name in KERNELS:
            out[name]["owner_passes" if passes else "one_pass"] = \
                launches[name]
    return out


def phase_host_share(ds, ref_csv: str, card: str, dev: torch.device,
                     e2e_chunks: list, e2e_peak: int) -> dict:
    """The host share of the fused serving path at the paper shape: a
    hybrid split in one block and row-blocked, and the all-host job
    shop; returns each kernel's launches per run, counted from 0 just
    before it."""
    runs = {"hybrid": (0.5, {}), "all_host": (1.0, {}),
            "hybrid_blocked": (0.5, {"LIME_HBM_BUDGET": str(1 << 30)})}
    out = {name: {} for name in KERNELS}
    for label, (frac, env) in runs.items():
        with environ(env):
            launches, _ = drive(label, ds,
                                LimeConfig(fused=True, host_frac=frac),
                                ref_csv, card, dev, [pk, bk, dense_kernels])
        st = fused_pipeline.LAST_RUN
        pair = [launches[name] for name in CAP_OF]
        planned = st["chunks_per_bucket"]
        if label == "hybrid":
            # once per planned chunk, in each bucket the plan has, and
            # fewer chunks than the all-device run
            ok = (st["engine"] == "pair" and pair == planned
                  and 0 < sum(planned) < sum(e2e_chunks))
        elif label == "all_host":
            ok = (st["engine"] == "all_host" and pair == [0, 0, 0]
                  and st["dense_chunks"] > 0)
        else:
            ok = (st["engine"] == "blocked" and st["blocks"] >= 2
                  and pair == st["launches_per_bucket"] and any(pair))
        # each dense chunk once, or once per row block it reaches
        dense_ok = (launches["dense"] == st["dense_chunks"]
                    if st["engine"] != "blocked" else st["dense_chunks"]
                    <= launches["dense"] <= st["dense_chunks"] * st["blocks"])
        if (not ok or not dense_ok or launches["banded"]
                or st["host_num"] != round(frac * 256)):
            raise AssertionError(
                f"[{label}] engine {st['engine']}, host share "
                f"{st['host_num']}/256, chunks {planned} ([e2e] "
                f"{e2e_chunks}), dense chunks {st['dense_chunks']}, blocks "
                f"{st.get('blocks')}: launches {launches}")
        peak = st["memory"].get("peak_bytes_in_use", 0)
        blocked = (f"; B={st['B']} reads, {st['blocks']} blocks, launches "
                   f"per bucket {st['launches_per_bucket']}"
                   if st["engine"] == "blocked" else "")
        log(f"[{label}] host share {st['host_num']}/256, engine "
            f"{st['engine']}: pair-kernel launches {pair} (chunks {planned}"
            f", [e2e] {e2e_chunks}), K3 0{blocked}; dense chunks "
            f"{st['dense_chunks']}, dense kernel launches "
            f"{launches['dense']}; delta-COO chains {st['chain_bytes']} B, "
            f"host planes {st['host_plane_bytes']} B; peak device memory "
            f"{peak} B, [e2e] {e2e_peak} B ({peak - e2e_peak:+d} B) ({card})")
        for name in KERNELS:
            out[name][label] = launches[name]
    return out


def host_ram(positions: int) -> str:
    """The host RAM the device builder's guard reads (free pages, as
    ``index.builder._check_build_memory`` reads them) beside what it needs
    for ``positions`` (260 B each, within 90% of the free pages), and
    ``MemAvailable`` (free pages plus reclaimable cache)."""
    free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    return (f"host RAM free {free} B (the build guard needs "
            f"{positions * 260 / 0.9:.0f} B of it), MemAvailable {avail} B")


def _same_index(got, want) -> list:
    """Names of the arrays of ``got`` that differ from ``want`` in dtype
    or bytes, in the order ebwt, lcp, da."""
    return [name for name, a, b in zip(("ebwt", "lcp", "da"), got, want)
            if a.dtype != b.dtype or not np.array_equal(a, b)]


def phase_index(ds, card: str, dev: torch.device) -> None:
    """The device builder on the 1F collection of ``[e2e]``'s dataset,
    against the native SA-IS's files and its build timed here."""
    fasta = ds.collections[0]
    t0 = time.perf_counter()
    seqs = paper_1f_sequences(ds.num_reads)
    n = sum(len(s) + 1 for s in seqs)
    log(f"[index] 1F collection replayed: {len(seqs)} sequences, {n} "
        f"positions in {time.perf_counter() - t0:.1f} s; {host_ram(n)}")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = build_index(seqs, engine="tpu", device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    st = torch_builder.LAST_RUN
    bad = _same_index(got, (open_ebwt(fasta), open_lcp(fasta),
                            open_da(fasta)))
    if st["positions"] != n or bad:
        raise AssertionError(f"[index] device build differs from the SA-IS "
                             f"files in {bad} ({st['positions']} positions)")
    phases = " ".join(f"{k}={v:.3f}s" for k, v in st["phases"].items())
    log(f"[index] build_index(engine='tpu', device='{dev}'): {n} positions, "
        f"{st['rounds']} doubling rounds, max LCP {int(got[1].max())}: "
        f"{wall:.3f} s wall ({phases}); peak device memory {peak} B; "
        f"ebwt, lcp, da byte-identical to {os.path.basename(fasta)}'s "
        f"SA-IS files ({card})")
    del got
    concat = np.frombuffer(b"".join(seqs), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    del seqs
    t0 = time.perf_counter()
    sais = native.build_index_native_concat(concat, lens)
    t_sais = time.perf_counter() - t0
    bad = _same_index(sais, (open_ebwt(fasta), open_lcp(fasta),
                             open_da(fasta)))
    if bad:
        raise AssertionError(f"[index] SA-IS rebuild differs in {bad}")
    log(f"[index] native SA-IS (host yardstick) on the same collection: "
        f"{t_sais:.3f} s, {t_sais / wall:.2f}x the device build's wall "
        f"({card})")
    if cuda:
        torch.cuda.empty_cache()


def phase_preprocess(pairs: int, card: str, dev: torch.device) -> dict:
    """``lime-tpu-torch preprocess`` from FASTA against
    ``synth_big.paper_dataset``'s arrays, then the fused run on its
    collections against the host executor's CSV; returns each kernel's
    launches in the fused run, counted from 0 just before it."""
    root = os.path.join(ROOT, "build", f"preprocess_{pairs}")
    shutil.rmtree(root, ignore_errors=True)
    fasta_dir, out_dir = os.path.join(root, "fasta"), os.path.join(root,
                                                                   "idx")
    os.makedirs(fasta_dir)
    t0 = time.perf_counter()
    reads1, reads2, genomes = paper_sequences(pairs)
    files = []
    for name, rows, title in (("reads_1", reads1, "r{}/1"),
                              ("reads_2", reads2, "r{}/2"),
                              ("refs", genomes, "G{:04d}")):
        path = os.path.join(fasta_dir, f"{name}.fasta")
        write_fasta(path, [title.format(i) for i in range(len(rows))],
                    [r.tobytes() for r in rows])
        files.append(path)
    del reads1, reads2, genomes
    t_fasta = time.perf_counter() - t0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["preprocess", files[0], files[2], "--reads2",
                       files[1], "--out-dir", out_dir])
    t_pre = time.perf_counter() - t0
    cols = printed.getvalue().split()
    want_cols = [os.path.join(out_dir, f"col_{t}.fasta")
                 for t in ("1F", "1RC", "2F", "2RC")]
    if rc != 0 or cols != want_cols:
        raise AssertionError(f"[preprocess] exit {rc}, printed {cols}")
    t0 = time.perf_counter()
    ref, _ = paper_dataset(os.path.join(ROOT, "build"), pairs)
    t_ref = time.perf_counter() - t0
    for col, ref_col in zip(cols, ref.collections):
        for ext in (".ebwt", ".lcp", ".da"):
            with open(col + ext, "rb") as a, open(ref_col + ext, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"[preprocess] {col}{ext} differs "
                                         f"from {ref_col}{ext}")
        if read_docs(col) != pairs + PAPER_GENOMES:
            raise AssertionError(f"[preprocess] {col}.docs holds "
                                 f"{read_docs(col)}")
    log(f"[preprocess] {pairs} pairs x {PAPER_GENOMES} genomes: FASTA "
        f"written in {t_fasta:.1f} s; `lime-tpu-torch preprocess` in "
        f"{t_pre:.1f} s; its four collections' ebwt, lcp and da "
        f"byte-identical to synth_big's (built from arrays in "
        f"{t_ref:.1f} s), .docs {pairs + PAPER_GENOMES}")
    ds = dataclasses.replace(ref, root=out_dir, collections=cols)
    ref_csv = os.path.join(out_dir, "host.csv")
    t0 = time.perf_counter()
    run_paired(cols, ref_csv, ds.num_reads, ds.num_genomes, ds.lineage_path,
               ds.read_len, LimeConfig(executor="host"), keep_results=False)
    log(f"[preprocess] executor='host' CSV in {time.perf_counter() - t0:.1f}"
        " s")
    launches, _ = drive("preprocess", ds, LimeConfig(fused=True), ref_csv,
                        card, dev, [pk, bk])
    if dev.type == "cuda" and not sum(launches[k] for k in CAP_OF):
        raise AssertionError(f"[preprocess] no pair-kernel launch: "
                             f"{launches}")
    return launches


def phase_sharded(ds, ref_csv: str, card: str, dev: torch.device) -> dict:
    """Both SPMD engines at world size 1 on NCCL, at the paper shape;
    returns each kernel's launches summed over the two runs, each counted
    from 0 just before its run."""
    cuda = dev.type == "cuda"
    # gloo only where a CPU rehearsal runs the phase
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
        timeout=datetime.timedelta(minutes=10))
    total = {name: 0 for name in REPLACES}
    try:
        mesh = make_mesh()
        runs = (("banded", sharded.run_sharded, LimeConfig(dense_threshold=0)),
                ("pair", sharded.run_sharded_pairs, LimeConfig()))
        for label, runner, cfg in runs:
            out_csv = os.path.join(ds.root, f"torch_sharded_{label}.csv")
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            for c in (pk, bk):
                c.reset_launches()
            t0 = time.perf_counter()
            runner(ds.collections, out_csv, ds.num_reads, ds.num_genomes,
                   ds.lineage_path, ds.read_len, cfg, mesh=mesh, device=dev)
            wall = time.perf_counter() - t0
            launches = {**pk.LAUNCHES, **bk.LAUNCHES}
            pair = {k: launches[k] for k in CAP_OF}
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            st = sharded.LAST_RUN
            if label == "banded":
                ok = (launches["banded"] == len(ds.collections)
                      and not any(pair.values()))
                what = (f"K3 launches {launches['banded']} (one per "
                        f"collection), dense chunks {st['dense_chunks']}, "
                        f"window {st['window']}")
            else:
                want = dict(zip(CAP_OF, st["chunks_per_bucket"]))
                ok = (not launches["banded"] and any(want.values())
                      and pair == want)
                what = (f"pair-kernel launches {pair} = planned chunks per "
                        f"bucket {st['chunks_per_bucket']}")
            if (cuda and not ok) or st["planner"] != "native":
                raise AssertionError(f"[sharded] {label}: launches "
                                     f"{launches}; {what}; planner "
                                     f"{st['planner']}")
            with open(ref_csv, "rb") as a, open(out_csv, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"[sharded] {label} engine's CSV "
                                         "differs from the host reference")
            phases = " ".join(f"{k}={v:.3f}s"
                              for k, v in st["phases"].items())
            partial = (len(ds.collections),
                       fused_pipeline._r_pad_for(ds.num_reads),
                       fused_pipeline._g_pad_for(ds.num_genomes))
            log(f"[sharded] {label} engine, mesh {st['mesh']} on "
                f"{dist.get_backend()} (one rank): {wall:.3f} s wall = "
                f"{ds.num_reads / wall:.0f} reads/s; spans: {phases}; peak "
                f"device memory {peak} B (the int8 partial {partial} is "
                f"{int(np.prod(partial))} B); {what}; CSV byte-identical to "
                f"the host reference ({card})")
            for name in REPLACES:
                total[name] += launches[name]
    finally:
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()
    return total


#: one rank of the dry run, with jax and the JAX package blocked
RANK_CMD = [sys.executable, "-c",
            "import sys; sys.modules['jax'] = None; "
            "sys.modules['lime_tpu'] = None; "
            "from lime_tpu_torch.parallel.dryrun import main; "
            "sys.exit(main())"]


def _dryrun_ranks(world: int, args: list, timeout: float) -> list:
    """Spawn ``world`` dry-run ranks on this host; their results."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    outs = spawn_ranks(RANK_CMD + args, world, timeout, env=env, cwd=ROOT)
    res = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
        if len(lines) != 1:
            raise AssertionError(
                f"a rank printed no result:\n{out[-2000:]}")
        res.append(json.loads(lines[0][len("DRYRUN "):]))
    return sorted(res, key=lambda r: r["rank"])


def phase_sharded_ranks(card: str, dev: torch.device,
                        pairs: int = 100_000) -> dict:
    """The dry run in 4 gloo ranks on the one card (2x2, both engines),
    then the pair engine in 3 ranks (1x3); returns each kernel's launches
    summed over every rank and run."""
    root = os.path.join(ROOT, "build", f"dryrun_{pairs}")
    common = ["--backend", "gloo", "--device", dev.type, "--pairs",
              str(pairs), "--root", root]
    total = {name: 0 for name in REPLACES}
    for world, extra in ((4, ["--mesh", "2x2"]),
                         (3, ["--mesh", "1x3", "--engines", "pair",
                              "--no-blocked"])):
        t0 = time.perf_counter()
        res = _dryrun_ranks(world, common + extra, 300)
        wall = time.perf_counter() - t0
        r0 = res[0]
        for engine in r0["engines"]:
            per_rank = [r["engines"][engine]["launches"] for r in res]
            names = ["banded"] if engine == "banded" else list(CAP_OF)
            counts = [sum(lc[k] for k in names) for lc in per_rank]
            planners = {r["engines"][engine]["planner"] for r in res}
            if planners != {"native"} or dev.type == "cuda" and (
                    not all(counts)
                    or engine == "banded" and counts != [4] * world):
                raise AssertionError(f"[sharded_ranks] {engine} engine: "
                                     f"launches per rank {per_rank}, "
                                     f"planners {planners}")
            for lc in per_rank:
                for name in REPLACES:
                    total[name] += lc[name]
            walls = [round(r["engines"][engine]["wall_s"], 3) for r in res]
            log(f"[sharded_ranks] {extra[1]} ({world} gloo ranks on one "
                f"card) {engine} engine: walls per rank {walls} s; "
                f"{names} launches per rank {counts}; CSV byte-identical to "
                f"the host reference ({card})")
        extra_s = (f"; dataset and host reference "
                   f"{r0.get('dataset_s', 0):.1f} s; forced row-blocked "
                   f"fused run on rank 0 {r0['blocked_s']:.3f} s, "
                   f"byte-identical" if "blocked_s" in r0 else "")
        log(f"[sharded_ranks] {extra[1]}: {r0['dataset'][0]} pairs x "
            f"{r0['dataset'][1]} genomes, rescued clusters {r0['rescued']} "
            f"(count, longest); comm model {r0['comm_model']}; "
            f"{wall:.1f} s with the ranks' start{extra_s} ({card})")
    return total


def phase_profile(ds, ref_csv: str, card: str, dev: torch.device) -> dict:
    """[e2e]'s fused run under ``LIME_PROFILE_DIR`` and a memory profiler;
    returns each kernel's launches, counted from 0 just before it."""
    with tempfile.TemporaryDirectory() as prof_dir:
        with environ({"LIME_PROFILE_DIR": prof_dir}), MemoryProfiler(
                interval=0.5, track_hbm=True) as mem:
            launches, _ = drive("profile", ds, LimeConfig(fused=True),
                                ref_csv, card, dev, [pk, bk])
        path, events = read_trace(prof_dir)
        size = os.path.getsize(path)
    summary = trace_summary(events)
    seen = pair_kernel_launches(summary["kernels"])
    want = {CAP_OF[name]: launches[name] for name in CAP_OF
            if launches[name]}
    if seen != want or launches["banded"]:
        raise AssertionError(f"[profile] pair-hit kernel events per cap "
                             f"{seen} in the trace, launches {want}; K3 "
                             f"{launches['banded']}")
    log(f"[profile] trace {os.path.basename(path)}: {size} B, "
        f"{len(events)} events, exported in "
        f"{fused_pipeline.LAST_RUN['trace_export_s']:.3f} s; pair-hit "
        f"kernel events per cap {seen} = launches ({card})")
    pair_us = sum(us for name, (_, us) in summary["kernels"].items()
                  if "pair_hits_count_kernel" in name)
    log(f"[profile] pair-hit kernel {pair_us / 1e3:.3f} ms of device time "
        f"in the trace over {sum(seen.values())} launches ({card})")
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in top[:10]:
        log(f"[profile] kernel {us / 1e3:.3f} ms in {n} launches: "
            f"{name[:110]}")
    log(f"[profile] device busy {summary['busy_us'] / 1e3:.3f} ms of the "
        f"{summary['window_us'] / 1e3:.3f} ms traced window = "
        f"{summary['busy_share']:.2%} (union of kernel and copy "
        f"intervals); {len(summary['kernels'])} kernel names, "
        f"{sum(n for n, _ in summary['kernels'].values())} launches; wall "
        f"{WALLS['profile']:.3f} s with the profiler, [e2e] "
        f"{WALLS['e2e']:.3f} s without ({card})")
    log(f"[profile] {mem.report()}")
    return launches


def phase_unpacked(ds, card: str, dev: torch.device) -> dict:
    """The 1F collection through the one-byte-per-row pair path, the
    dense path and the exact host scorer into one plane on ``dev``,
    against the native scorer on every cluster; returns each kernel's
    launches, counted from 0 just before the scoring."""
    fasta = ds.collections[0]
    lcp, da, ebwt = open_lcp(fasta), open_da(fasta), open_ebwt(fasta)
    R, G = ds.num_reads, ds.num_genomes
    g_pad = fused_pipeline._g_pad_for(G)
    alpha = LimeConfig().alpha
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    buckets, den_s, den_l, bad_s, bad_l = native.plan_pairs(
        lcp, da, ebwt, R, alpha, g_pad, SYMBOL_RANK_LUT,
        host._DEGENERATE_BYTE.astype(np.uint8))
    t_plan = time.perf_counter() - t0
    pk.reset_launches()
    bk.reset_launches()
    t0 = time.perf_counter()
    sim = torch.zeros((R + 1, g_pad), dtype=torch.int8, device=dev)
    tps.pair_score_into(sim, buckets, R, g_pad)
    sync()
    t_pair = time.perf_counter() - t0
    run = dict(tps.LAST_RUN)
    t0 = time.perf_counter()
    _, left_s, left_l = dense_score_into(sim, den_s, den_l, da, ebwt, R, G,
                                         g_pad)
    sync()
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = native.score_clusters_native(
        np.concatenate([bad_s, left_s]), np.concatenate([bad_l, left_l]),
        da, ebwt, R, G, SYMBOL_RANK_LUT, host._DEGENERATE_BYTE,
        IUPAC_WATERFALL_PAIRS, threads=0)
    sim[:R, :G] += torch.from_numpy(rest.view(np.int8)).to(dev)
    sync()
    t_host = time.perf_counter() - t0
    launches = {**pk.LAUNCHES, **bk.LAUNCHES}
    wall = t_plan + t_pair + t_dense + t_host
    got = sim[:R, :G].cpu().numpy().view(np.uint8)
    del sim, rest
    t0 = time.perf_counter()
    starts, lens = native.plan_clusters(lcp, da, R, alpha, threads=0)
    want = native.score_clusters_native(
        starts, lens, da, ebwt, R, G, SYMBOL_RANK_LUT,
        host._DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS, threads=0)
    t_ref = time.perf_counter() - t0
    if not np.array_equal(got, want):
        bad = np.argwhere(got != want)
        raise AssertionError(f"[unpacked] plane differs from the native "
                             f"scorer in {len(bad)} cells, first "
                             f"{bad[:3].tolist()}")
    expected = {name: run["chunks"][name] if cuda else 0 for name in CAP_OF}
    if ({name: launches[name] for name in CAP_OF} != expected
            or launches["banded"] or run["host_copies"]):
        raise AssertionError(f"[unpacked] launches {launches}, chunks "
                             f"{run['chunks']}, host copies "
                             f"{run['host_copies']} (0 expected)")
    # every chunk again, for the check and the reorder's time (these
    # launches are not the path's)
    reorder_ms, rows = 0.0, {name: 0 for name in CAP_OF}
    for chunk_p, _, window, cap, _, _ in tps.unpacked_chunks(buckets, R,
                                                             g_pad):
        packed = torch.from_numpy(chunk_p).to(dev)
        codes, _ = tps.kernel_codes(packed)
        name = pk._KERNEL_FOR_CAP[cap]
        _check_pair(name, codes, window, cap)
        rows[name] += len(chunk_p)
        reorder_ms += event_ms(lambda: tps.kernel_codes(packed))
    del packed, codes
    per_bucket = ", ".join(f"window {w}: {len(p)} rows"
                           for p, _, w in buckets)
    pair = {name: launches[name] for name in CAP_OF}
    log(f"[unpacked] 1F stream ({per_bucket}); chunks {run['chunks']} "
        f"({run['rows']} rows with pads), host copies "
        f"{run['host_copies']}; pair-hit launches {pair} = chunks, K3 0; "
        f"every chunk exact against the plain version on read rows "
        f"(rows per kernel {rows}); reorder and re-encode "
        f"{reorder_ms:.3f} ms summed per call ({card})")
    log(f"[unpacked] plane ({R + 1}, {g_pad}) int8 equal to "
        f"score_clusters_native on {len(starts)} clusters "
        f"({len(den_s)} dense, {len(left_s)} of them left to the host, "
        f"{len(bad_s)} rescued); {wall:.3f} s wall: plan {t_plan:.3f} s, "
        f"pair_score_into {t_pair:.3f} s, dense_score_into "
        f"{t_dense:.3f} s, host scorer {t_host:.3f} s; native reference "
        f"{t_ref:.3f} s ({card})")
    if cuda:
        torch.cuda.empty_cache()
    return launches


def _dump(out: str) -> str:
    lo = out.index("***FINAL***")
    return out[lo:out.index("***********", lo) + len("***********\n")]


def phase_dump_sim(card: str, dev: torch.device) -> dict:
    """``LIME_DUMP_SIM=1`` in ``cluster_bwt``, K3 on ``dev`` against the
    host executor; returns each kernel's launches in the device run."""
    root = os.path.join(ROOT, "build", "dump_sim")
    shutil.rmtree(root, ignore_errors=True)
    ds = make_dataset(root, num_pairs=40, read_len=60,
                      genome_lens=(2000, 1500), seed=13)
    col = ds.collections[0]
    staged_pipeline.cluster_lcp(col, ds.num_reads, ds.num_genomes,
                                LimeConfig())
    dumps, launches = {}, {}
    with environ({"LIME_DUMP_SIM": "1"}):
        for executor in ("host", "tpu"):
            pk.reset_launches()
            bk.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                staged_pipeline.cluster_bwt(
                    col, ds.read_len, LimeConfig(executor=executor),
                    device=dev)
            wall = time.perf_counter() - t0
            launches = {**pk.LAUNCHES, **bk.LAUNCHES}
            dumps[executor] = _dump(out.getvalue())
    k3_once = dev.type != "cuda" or launches["banded"] == 1
    if dumps["tpu"] != dumps["host"] or not k3_once:
        raise AssertionError(f"[dump_sim] device dump "
                             f"{len(dumps['tpu'])} B, host dump "
                             f"{len(dumps['host'])} B, equal "
                             f"{dumps['tpu'] == dumps['host']}; K3 "
                             f"launches {launches['banded']}")
    rows = dumps["tpu"].splitlines()[1:-1]
    log(f"[dump_sim] {ds.num_reads} reads x {ds.num_genomes} genomes: the "
        f"device dump ({len(dumps['tpu'])} B, {len(rows)} rows, "
        f"{sum(v != '0' for r in rows for v in r.split())} nonzero cells) "
        f"equals the host executor's byte for byte; K3 launches "
        f"{launches['banded']}; cluster_bwt {wall:.3f} s ({card})")
    shutil.rmtree(root, ignore_errors=True)
    return launches


@contextlib.contextmanager
def without_native():
    """The port as if its native library had failed to build:
    ``native.available()`` False and every binding raising (so a routing
    site that called the library without asking would fail here), only
    the numpy fallbacks left; the loaded library restored afterwards."""
    saved = native._load(), native.LOAD_ERROR
    native._lib = None
    native.LOAD_ERROR = "set aside by chip_smoke.py [no_native]"
    try:
        yield
    finally:
        native._lib, native.LOAD_ERROR = saved


def _no_native_streams(ds, card: str, dev: torch.device) -> dict:
    """K3 on each collection's numpy-planned stream, the stream the fused
    run without the library hands it: the 1F stream's first positions
    exact against the plain version, then each whole stream timed (per
    call and in a graph) into an int8 plane beside its bytes bound (5 B
    per position, 2 B per touched int8 cell, as ``[banded]``'s)."""
    cfg = LimeConfig(fused=True)
    R, G = ds.num_reads, ds.num_genomes
    g_pad = fused_pipeline._g_pad_for(G)
    acc = torch.zeros((R + 1, g_pad), dtype=torch.int32, device=dev)
    plane = torch.zeros((fused_pipeline._r_pad_for(R), g_pad),
                        dtype=torch.int8, device=dev)
    out = {"streams": 0, "positions": 0, "kept": 0, "ms": 0.0,
           "graph_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0}
    for i, fasta in enumerate(ds.collections):
        t0 = time.perf_counter()
        with without_native():
            packed, doc, nc, window, bad_s, bad_l = fused_pipeline.plan_banded(
                open_lcp(fasta), open_da(fasta), open_ebwt(fasta), R, G,
                cfg)[:6]
        t_plan = time.perf_counter() - t0
        codes_h = fused_pipeline.banded_codes(packed)
        doc_h = fused_pipeline._doc_i32(doc)
        kept = int(np.count_nonzero(doc_h != R + G))
        log(f"[no_native] {os.path.basename(fasta)} numpy plan in "
            f"{t_plan:.3f} s: {kept} kept positions in a stream of "
            f"{len(doc_h)} (pads to 2^20), window {window}; rescued "
            f"{len(bad_s)} clusters, {int(np.sum(bad_l))} positions; runs: "
            f"{run_stats(codes_h, doc_h, R, g_pad, window)}")
        codes = torch.from_numpy(codes_h).to(dev)
        docs = torch.from_numpy(doc_h).to(dev)
        del packed, doc, codes_h, doc_h
        n = codes.shape[0]
        if i == 0:
            # K3 against its plain version on the stream's first positions
            m = 1 << 20
            got = torch.zeros((R + 1, g_pad), dtype=torch.int32, device=dev)
            bk.banded_sim_into(got, codes[:m], docs[:m], window, R)
            bk.banded_sim_plain(acc, codes[:m], docs[:m], window, R)
            err = int((got - acc).abs().max().item())
            if err:
                raise AssertionError(f"[no_native] K3 != plain on the 1F "
                                     f"stream (max abs err {err})")
            out["max_abs_err"] = err
            log(f"[no_native] K3 exact against the plain version on the "
                f"first {m} positions of the 1F stream "
                f"({int(acc.sum().item())} pair counts)")
            del got
        acc.zero_()
        bk.banded_sim_into(acc, codes, docs, window, R)
        pairs = int(acc.sum().item())
        touched = int(torch.count_nonzero(acc).item())
        bound = bytes_bound_ms(5 * n + 2 * touched)

        def call():
            bk.banded_sim_into(plane, codes, docs, window, R)

        ms, g_ms = event_ms(call), graph_ms([call])
        out["streams"] += 1
        out["positions"] += n
        out["kept"] += kept
        out["ms"] += ms
        out["graph_ms"] += g_ms
        out["bound_ms"] += bound
        log(f"[no_native] K3 on the {os.path.basename(fasta)} numpy-planned "
            f"stream: {n} positions, window {window}, {pairs} pair counts, "
            f"{touched} cells, int8 plane: kernel {ms:.4f} ms per call, "
            f"{g_ms:.4f} ms in a graph ({share(bound, g_ms)} of the "
            f"{bound:.4f} ms bound) ({card})")
        del codes, docs
    del acc, plane
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _no_native_oracle(ods, card: str, dev: torch.device) -> dict:
    """The numpy exact scorer as an oracle on the 1F collection of
    ``ods``: its plane against the native scorer's and the port's K3
    plane (K3 and the numpy rescue, ``score_clusters_tpu`` without the
    library), cell for cell; returns each kernel's launches in the K3
    plane's run."""
    fasta = ods.collections[0]
    lcp, da, ebwt = open_lcp(fasta), open_da(fasta), open_ebwt(fasta)
    R, G = ods.num_reads, ods.num_genomes
    cfg = LimeConfig()
    t0 = time.perf_counter()
    starts, lens = native.plan_clusters(lcp, da, R, cfg.alpha, threads=0)
    want = native.score_clusters_native(
        starts, lens, da, ebwt, R, G, SYMBOL_RANK_LUT,
        host._DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS, threads=0)
    t_native = time.perf_counter() - t0
    with without_native():
        t0 = time.perf_counter()
        np_starts, np_lens = find_clusters(np.asarray(lcp), np.asarray(da),
                                           R, cfg.alpha)
        got = score_clusters(np_starts, np_lens, da, ebwt, R, G, cfg)
        t_numpy = time.perf_counter() - t0
        pk.reset_launches()
        bk.reset_launches()
        t0 = time.perf_counter()
        k3 = score_clusters_tpu(np_starts, np_lens, da, ebwt, R, G, cfg,
                                alpha=cfg.alpha, lcp=lcp, device=dev)
        t_k3 = time.perf_counter() - t0
        launches = {**pk.LAUNCHES, **bk.LAUNCHES}
    same_clusters = (np.array_equal(starts, np_starts)
                     and np.array_equal(lens, np_lens))
    for name, plane in (("native", want), ("K3", k3)):
        if not np.array_equal(got, plane):
            bad = np.argwhere(got != plane)
            raise AssertionError(f"[no_native] the numpy plane differs from "
                                 f"the {name} plane in {len(bad)} cells, "
                                 f"first {bad[:3].tolist()}")
    if not same_clusters or (dev.type == "cuda" and launches["banded"] != 1):
        raise AssertionError(f"[no_native] oracle: clusters equal "
                             f"{same_clusters}, launches {launches}")
    cut = "" if R == 1_000_000 else f" (cut from 1,000,000 pairs to {R})"
    log(f"[no_native] oracle on {os.path.basename(fasta)} of {R} pairs x "
        f"{G} genomes{cut}: {len(starts)} clusters, {int(lens.sum())} "
        f"positions, {int(np.count_nonzero(got))} nonzero cells; the numpy "
        f"plane (find_clusters + score_clusters, {t_numpy:.3f} s) equals "
        f"the native scorer's (plan_clusters + score_clusters_native, "
        f"{t_native:.3f} s) and the port's K3 plane without the library "
        f"(score_clusters_tpu, K3 launches {launches['banded']}, "
        f"{t_k3:.3f} s) cell for cell ({card})")
    return launches


def phase_no_native(ds, ref_csv: str, card: str, dev: torch.device,
                    preprocess_pairs: int) -> tuple:
    """The no-native path at the paper shape: K3 on the numpy plan's
    streams, the fused and staged runs without the library, and the
    numpy oracle on ``[preprocess]``'s dataset; returns (each kernel's launches per run, K3's times on
    the numpy-planned streams)."""
    streams = _no_native_streams(ds, card, dev)
    out = {name: {} for name in REPLACES}
    for label, cfg in (("fused", LimeConfig(fused=True)),
                       ("staged", LimeConfig())):
        with without_native():
            launches, _ = drive(f"no_native_{label}", ds, cfg, ref_csv, card,
                                dev, [pk, bk], planner="numpy")
        pair = {name: launches[name] for name in CAP_OF}
        engine = fused_pipeline.LAST_RUN["engine"] if cfg.fused else "staged"
        if (engine not in ("banded", "staged") or any(pair.values())
                or dev.type == "cuda"
                and launches["banded"] != len(ds.collections)):
            raise AssertionError(f"[no_native_{label}] engine {engine}: "
                                 f"launches {launches} (K3 once per "
                                 f"collection, no pair-hit kernel)")
        for name in REPLACES:
            out[name][label] = launches[name]
    ods = paper_dataset(os.path.join(ROOT, "build"), preprocess_pairs)[0]
    oracle = _no_native_oracle(ods, card, dev)
    for name in REPLACES:
        out[name]["oracle"] = oracle[name]
    return out, streams


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1_000_000,
                    help="read pairs of the end-to-end dataset")
    ap.add_argument("--preprocess-pairs", type=int, default=50_000,
                    help="read pairs of the dataset of the [preprocess] "
                         "phase and of [no_native]'s numpy oracle")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    times = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        times[name] = time.perf_counter() - t0
        return out

    name, smi = timed("device", phase_device)
    timed("build", phase_build)
    dev = torch.device("cuda")
    timed("cascade", phase_cascade, dev)
    ds, ref_csv, launches = timed("e2e", phase_e2e, args.pairs, smi, dev)
    e2e_peak = fused_pipeline.LAST_RUN["memory"]["peak_bytes_in_use"]
    e2e_chunks = list(fused_pipeline.LAST_RUN["chunks_per_bucket"])
    records = timed("kernels", phase_kernels, ds, smi, dev, launches)
    records["banded"] = timed("kernels_banded", phase_banded_kernel, ds,
                              smi, dev)
    dense = timed("kernels_dense", phase_dense_kernel, ds, smi, dev,
                  launches)
    staged, _ = timed("staged", drive, "staged", ds, LimeConfig(), ref_csv,
                      smi, dev, [bk])
    banded, _ = timed("banded", drive, "banded", ds,
                      LimeConfig(fused=True, pair_stream=False,
                                 dense_threshold=0),
                      ref_csv, smi, dev, [bk])
    if staged["banded"] != len(ds.collections) or banded["banded"] == 0:
        raise AssertionError(f"K3 launches: staged {staged['banded']} "
                             f"(one per collection), banded "
                             f"{banded['banded']}")
    launches["banded"] = staged["banded"]
    blocked = timed("blocked", phase_blocked, ds, ref_csv, smi, dev,
                    e2e_peak)
    host_share = timed("host_share", phase_host_share, ds, ref_csv, smi, dev,
                       e2e_chunks, e2e_peak)
    timed("index", phase_index, ds, smi, dev)
    preprocess = timed("preprocess", phase_preprocess, args.preprocess_pairs,
                       smi, dev)
    on_sharded = timed("sharded", phase_sharded, ds, ref_csv, smi, dev)
    on_ranks = timed("sharded_ranks", phase_sharded_ranks, smi, dev)
    profile = timed("profile", phase_profile, ds, ref_csv, smi, dev)
    unpacked = timed("unpacked", phase_unpacked, ds, smi, dev)
    dump_sim = timed("dump_sim", phase_dump_sim, smi, dev)
    no_native, nn_streams = timed("no_native", phase_no_native, ds, ref_csv,
                                  smi, dev, args.preprocess_pairs)
    records["banded"]["max_abs_err"] = max(records["banded"]["max_abs_err"],
                                           nn_streams["max_abs_err"])
    records["banded"].update({
        "no_native_path_ms": round(nn_streams["ms"], 4),
        "no_native_path_graph_ms": round(nn_streams["graph_ms"], 4),
        "no_native_path_bound_ms": round(nn_streams["bound_ms"], 6),
        "no_native_path_positions": nn_streams["positions"]})
    kernels = [{"name": k, "route": "cuda",
                "source": f"lime_tpu_torch/csrc/{SOURCE[k]}.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                **records[k], "blocked_path_launches": blocked[k],
                "host_share_path_launches": host_share[k],
                "preprocess_path_launches": preprocess[k],
                "sharded_path_launches": {"sharded": on_sharded[k],
                                          "sharded_ranks": on_ranks[k]},
                "profile_path_launches": profile[k],
                "unpacked_path_launches": unpacked[k],
                "dump_sim_path_launches": dump_sim[k],
                "no_native_path_launches": no_native[k]}
               for k in REPLACES]
    kernels.append({"name": "dense", "route": "cuda",
                    "source": "lime_tpu_torch/csrc/dense_pairs.cu",
                    "replaces": "lime_tpu/ops/dense_score.py:67 (XLA ops, "
                                "no Pallas kernel)",
                    "launches": launches["dense"], **dense,
                    "blocked_path_launches": blocked["dense"],
                    "host_share_path_launches": host_share["dense"]})
    log(f"[memory] {memory_report()}".replace("\n", "; "))
    log("[done] phase times: " + " ".join(f"{k}={v:.1f}s"
                                          for k, v in times.items()))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
