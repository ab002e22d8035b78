#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--pairs N]

Phases, one line each; any failure raises and the exit code is non-zero:

1. device: the card's name, and nvidia-smi's name and power limit;
2. build: compile (nvcc, sm_90a) and load the pair-hit kernels;
3. kernels: each pair-hit kernel against its plain torch version on
   planner-shaped streams (1M rows, seed 1, tiled to 32M), read rows
   exact, both timed with CUDA events (median of 3 after a warm-up);
4. cascade: the classify program on random (4, 65536, 1024) int8 planes,
   bit-equal to the numpy cascade on the same normalised rows;
5. end to end: the paper-shape dataset (N read pairs x 930 genomes of
   8 kbp, 100 bp reads; default N = 1,000,000) through
   ``lime_tpu_torch.run_paired(device="cuda")``, byte-identical to the
   jax-free host reference CSV, with every pair-hit kernel launched.

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
            "band": "lime_tpu/ops/pallas_kernels.py:225"}
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
    pk.build(verbose=True)
    log(f"[build] pair-hit kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({pk._LIB_PATH})")


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


def phase_e2e(pairs: int, card: str, dev: torch.device):
    from tests.synth_big import compute_truth

    ds = dataset(pairs)
    cfg = LimeConfig(fused=True)
    shape = (ds.num_reads, ds.num_genomes, ds.lineage_path, ds.read_len, cfg)
    ref_csv = os.path.join(ds.root, "reference.csv")
    t0 = time.perf_counter()
    reference.reference_csv(ds.collections, ref_csv, *shape)
    t_ref = time.perf_counter() - t0
    log(f"[e2e] host reference CSV in {t_ref:.1f} s")

    out_csv = os.path.join(ds.root, "torch.csv")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    t0 = time.perf_counter()
    summary = run_paired(ds.collections, out_csv, *shape, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = fused_pipeline.LAST_RUN
    phases = " ".join(f"{k}={v:.3f}s" for k, v in stats["phases"].items())
    log(f"[e2e] run_paired(device='{dev}'): {wall:.3f} s wall = "
        f"{ds.num_reads / wall:.0f} reads/s; phases: {phases}; peak "
        f"device memory {peak} B; pair chunks per bucket (caps 16/64/255) "
        f"{stats['chunks_per_bucket']}; launches {launches}; "
        f"C={summary.classified} H={summary.higher} A={summary.ambiguous} "
        f"U={summary.unclassified} ({card})")
    with open(ref_csv, "rb") as a, open(out_csv, "rb") as b:
        ref_bytes, out_bytes = a.read(), b.read()
    if ref_bytes != out_bytes:
        raise AssertionError("port CSV differs from the host reference "
                             f"({len(out_bytes)} vs {len(ref_bytes)} B)")
    for name in launches:
        if cuda and launches[name] == 0:
            raise AssertionError(
                f"kernel {name} was not launched on the main path (chunks "
                f"per bucket {stats['chunks_per_bucket']})")
    origins = compute_truth(ds.root, ds.num_reads, ds.num_genomes,
                            GENOME_LEN)
    acc = reference.accuracy(out_csv, origins,
                             1000 + np.arange(ds.num_genomes))
    log(f"[e2e] CSV byte-identical to the host reference "
        f"({len(out_bytes)} B); accuracy {acc.summary()}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1_000_000,
                    help="read pairs of the end-to-end dataset")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    records = phase_kernels(smi)
    dev = torch.device("cuda")
    phase_cascade(dev)
    launches = phase_e2e(args.pairs, smi, dev)
    kernels = [{"name": k, "route": "cuda",
                "source": "lime_tpu_torch/csrc/pair_hits.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                **records[k]} for k in CAP_OF]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
