#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--pairs N]

Phases, one line each (with its time); any failure raises and the exit
code is non-zero:

1. device: the card's name, and nvidia-smi's name and power limit;
2. build: compile (one nvcc per CUDA source, sm_90a, all at once) and
   load the pair-hit kernels and the banded kernel K3;
3. kernels: each pair-hit kernel against its plain torch version on
   planner-shaped streams (1M rows, seed 1, tiled to 32M), read rows
   exact, both timed with CUDA events (median of 3 after a warm-up);
4. cascade: the classify program on random (4, 65536, 1024) int8 planes,
   bit-equal to the numpy cascade on the same normalised rows;
5. e2e: the paper-shape dataset (N read pairs x 930 genomes of 8 kbp,
   100 bp reads; default N = 1,000,000), its jax-free host reference
   CSV, and the fused serving path ``run_paired(LimeConfig(fused=True),
   device="cuda")``: byte-identical, every pair-hit kernel launched;
6. kernels (banded): K3 on the first 4M positions of the dataset's real
   1F stream at G_pad 1024, int32 and int8 accumulators exact against
   the plain version (which walks V in ~1 GB position blocks), both
   timed with CUDA events;
7. staged: ``run_paired(LimeConfig(), device="cuda")``, the default
   entry point (cluster_lcp -> cluster_bwt with K3 -> classify, through
   the .clrs/.res checkpoints): byte-identical, K3 launched per
   collection;
8. banded: the fused banded engine, ``LimeConfig(fused=True,
   pair_stream=False, dense_threshold=0)``: byte-identical, K3 launched.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  No part of jax is imported.
"""

from __future__ import annotations

import sys

sys.modules["jax"] = None  # the port must run where jax is absent

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lime_tpu_torch import LimeConfig, run_paired  # noqa: E402
from lime_tpu_torch import pipeline as staged_pipeline  # noqa: E402
from lime_tpu_torch.ops import banded_kernels as bk  # noqa: E402
from lime_tpu_torch.ops import cuda_build  # noqa: E402
from lime_tpu_torch.ops import fused_pipeline  # noqa: E402
from lime_tpu_torch.ops import pair_kernels as pk  # noqa: E402
from lime_tpu_torch.ops.classify_torch import (  # noqa: E402
    _classify_program_planes, _unpack_triplet, alloc_planes)
from lime_tpu_torch import reference  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_GENOMES, GENOME_LEN, READ_LEN = 930, 8000, 100

#: the Pallas kernel each CUDA kernel replaces (body's first line)
REPLACES = {"scan16": "lime_tpu/ops/pallas_kernels.py:311",
            "scan64": "lime_tpu/ops/pallas_kernels.py:311",
            "band": "lime_tpu/ops/pallas_kernels.py:225",
            "banded": "lime_tpu/ops/pallas_kernels.py:73"}
SOURCE = {"scan16": "pair_hits", "scan64": "pair_hits", "band": "pair_hits",
          "banded": "banded_pairs"}
CAP_OF = {"scan16": 16, "scan64": 64, "band": 255}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def phase_build():
    t0 = time.perf_counter()
    for name, ptxas in cuda_build.compile_all(
            ["pair_hits", "banded_pairs"], verbose=True).items():
        log(f"[build] {name}: {ptxas.strip()}")
    pk.build()
    bk.build()
    log(f"[build] pair-hit kernels and K3 built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({cuda_build.BUILD_DIR})")


def phase_kernels(card: str):
    records = {}
    for name, cap in CAP_OF.items():
        base = pk.planner_shaped_stream(np.random.default_rng(1), 1 << 20,
                                        cap)
        codes_np = np.tile(base, 32)
        codes = torch.from_numpy(codes_np).cuda()
        window = cap
        got = pk.pair_hits(codes, window, cap)
        want = pk.pair_hits_plain(codes, window, cap)
        torch.cuda.synchronize()
        read = torch.from_numpy(((codes_np >> 4) & 1) == 0).cuda()
        err = int((got - want).abs()[read].max().item())
        n_hits = int(got[read].sum().item())
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain on read rows "
                                 f"(max abs err {err})")
        ms = time_ms(lambda: pk.pair_hits(codes, window, cap))
        plain_ms = time_ms(lambda: pk.pair_hits_plain(codes, window, cap))
        n = codes.shape[0]
        log(f"[kernels] {name}: {n} rows, cap {cap}, window {window}: "
            f"exact on read rows ({n_hits} hits); kernel {ms:.3f} ms "
            f"= {n / ms / 1e3:.1f} Mrows/s, plain {plain_ms:.3f} ms = "
            f"{n / plain_ms / 1e3:.1f} Mrows/s ({card})")
        records[name] = {"max_abs_err": err, "ms": round(ms, 4),
                         "plain_ms": round(plain_ms, 4)}
        del codes, got, want, read
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
    from tests.synth_big import BigDataset, make_big_dataset

    root = os.path.join(ROOT, "build", "paper_data" if pairs == 1_000_000
                        else f"paper_data_{pairs}")
    stamp = os.path.join(root, f"v1_{pairs}_{NUM_GENOMES}_{GENOME_LEN}.ok")
    t0 = time.perf_counter()
    if not os.path.exists(stamp):
        make_big_dataset(root, num_pairs=pairs, num_genomes=NUM_GENOMES,
                         genome_len=GENOME_LEN, seed=17)
        with open(stamp, "w") as f:
            f.write("ok")
        how = "built"
    else:
        how = "reused"
    log(f"[e2e] dataset {how}: {pairs} pairs x {NUM_GENOMES} genomes in "
        f"{time.perf_counter() - t0:.1f} s ({root})")
    return BigDataset(
        root=root, collections=[os.path.join(root, f"col_{t}.fasta")
                                for t in ("1F", "1RC", "2F", "2RC")],
        lineage_path=os.path.join(root, "LineageFile.csv"),
        num_reads=pairs, num_genomes=NUM_GENOMES, read_len=READ_LEN,
        positions_per_collection=0)


def drive(label: str, ds, cfg, ref_csv: str, card: str, dev, counters):
    """Run ``run_paired`` on ``dev`` with every launch count set to 0
    just before; return (launches, CSV bytes) after checking the CSV
    byte-identical to ``ref_csv``."""
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
    log(f"[{label}] run_paired(device='{dev}'): {wall:.3f} s wall = "
        f"{ds.num_reads / wall:.0f} reads/s; phases: {phases}; peak "
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
    from tests.synth_big import compute_truth

    ds = dataset(pairs)
    ref_csv = os.path.join(ds.root, "reference.csv")
    t0 = time.perf_counter()
    reference.reference_csv(ds.collections, ref_csv, ds.num_reads,
                            ds.num_genomes, ds.lineage_path, ds.read_len,
                            LimeConfig())
    log(f"[e2e] host reference CSV in {time.perf_counter() - t0:.1f} s")
    launches, out_csv = drive("e2e", ds, LimeConfig(fused=True), ref_csv,
                              card, dev, [pk])
    for name in pk.LAUNCHES:
        if dev.type == "cuda" and launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "fused serving path")
    origins = compute_truth(ds.root, ds.num_reads, ds.num_genomes,
                            GENOME_LEN)
    acc = reference.accuracy(out_csv, origins,
                             1000 + np.arange(ds.num_genomes))
    log(f"[e2e] accuracy {acc.summary()}")
    return ds, ref_csv, launches


def phase_banded_kernel(ds, card: str, dev: torch.device, n: int = 1 << 22):
    """K3 against its plain version on the first ``n`` positions of the
    1F collection's staged stream (the stream ``cluster_bwt`` scores)."""
    from lime_tpu import native
    from lime_tpu.formats.arrays import open_da, open_ebwt, open_lcp
    from lime_tpu_torch.ops.fused_pass import staged_stream

    cfg = LimeConfig()
    fasta = ds.collections[0]
    lcp, da = open_lcp(fasta), open_da(fasta)
    starts, lens = native.plan_clusters(lcp, da, ds.num_reads, cfg.alpha,
                                        threads=0)
    packed_h, doc_h, window, bad = staged_stream(
        starts, lens, da, open_ebwt(fasta), cfg, cfg.alpha, lcp)
    packed = torch.from_numpy(packed_h[:n]).to(dev)
    doc = torch.from_numpy(doc_h[:n]).to(dev)
    del lcp, da, packed_h, doc_h
    R = ds.num_reads
    g_pad = fused_pipeline._g_pad_for(ds.num_genomes)
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
    acc = sims["kernel32"]
    ms = time_ms(lambda: bk.banded_sim_into(acc, packed, doc, window, R))
    plain_ms = time_ms(
        lambda: bk.banded_sim_plain(acc, packed, doc, window, R), reps=1)
    log(f"[kernels] banded: {n} positions of the 1F stream, G_pad {g_pad}, "
        f"window {window}: int32 and int8 exact ({pairs} pair counts); "
        f"kernel {ms:.3f} ms = {n / ms / 1e3:.1f} Mpos/s, plain "
        f"{plain_ms:.3f} ms = {n / plain_ms / 1e3:.1f} Mpos/s ({card})")
    del sims, acc, packed, doc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1_000_000,
                    help="read pairs of the end-to-end dataset")
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
    records = timed("kernels", phase_kernels, smi)
    dev = torch.device("cuda")
    timed("cascade", phase_cascade, dev)
    ds, ref_csv, launches = timed("e2e", phase_e2e, args.pairs, smi, dev)
    records["banded"] = timed("kernels_banded", phase_banded_kernel, ds,
                              smi, dev)
    staged, _ = timed("staged", drive, "staged", ds, LimeConfig(), ref_csv,
                      smi, dev, [bk])
    banded, _ = timed("banded", drive, "banded", ds,
                      LimeConfig(fused=True, pair_stream=False,
                                 dense_threshold=0),
                      ref_csv, smi, dev, [bk])
    if staged["banded"] < 4 or banded["banded"] == 0:
        raise AssertionError(f"K3 launches: staged {staged['banded']} "
                             f"(needs >= 4), banded {banded['banded']}")
    launches["banded"] = staged["banded"]
    kernels = [{"name": k, "route": "cuda",
                "source": f"lime_tpu_torch/csrc/{SOURCE[k]}.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                **records[k]} for k in REPLACES]
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
