"""Dry runs of the SPMD engines (the port of ``__graft_entry__.py``).

- :func:`entry`: ``banded_fused_step`` and example arguments, the
  single-device compile-and-run check;
- :func:`dryrun_multichip`: inside every rank of an initialised process
  group, both SPMD engines on a 100,000-pair dataset with planted
  clusters longer than 255 rows and IUPAC-degenerate symbols, held byte
  for byte against each other, the host reference and the forced
  row-blocked fused run, with ``pair_comm_model``'s bookkeeping checked;
- :func:`spawn_ranks`: start one process per rank on this host, each with
  a timeout; ``python -m lime_tpu_torch.parallel.dryrun --rank R --world
  W --port P ...`` is one rank of a dry run::

      python -m lime_tpu_torch.parallel.dryrun --world 4 --mesh 2x2 \\
          --backend gloo --device cuda --root build/dryrun

  (with ``--world`` and no ``--rank`` it spawns the ranks itself).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import native, reference
from ..config import LimeConfig
from ..constants import SYMBOL_RANK_LUT
from ..device import resolve_device
from ..formats.arrays import open_da, open_ebwt
from ..host import _DEGENERATE_BYTE, classify_block_size
from ..ops import banded_kernels, pair_kernels
from ..pipeline import run_paired
from ..synth import SynthDataset, make_dataset
from .mesh import Mesh, make_mesh
from .multihost import init_distributed
from .sharded import (LAST_RUN, banded_fused_step, pair_comm_model,
                      run_sharded, run_sharded_pairs)

#: the dry run's dataset: ``MULTICHIP_r05.json``'s shape
PAIRS, READ_LEN, GENOME_LENS, SEED, DEGENERATE_RATE = (
    100_000, 100, (30_000, 25_000), 3, 0.002)

#: kernel launch counters, by kernel name (``LAUNCHES`` of each module)
COUNTERS = (pair_kernels, banded_kernels)


def _synthetic_stream(rng, n, num_reads, num_refs, read_len, alpha,
                      max_run):
    """Random (lcp, da, sym) stream with bounded cluster runs."""
    lcp = rng.integers(0, alpha + 8, size=n).astype(np.int32)
    lcp[0] = 0
    # break any run of lcp >= alpha longer than max_run
    run = 0
    m = lcp >= alpha
    for i in range(n):  # small n only
        run = run + 1 if m[i] else 0
        if run >= max_run:
            lcp[i] = 0
            run = 0
    da = rng.integers(0, num_reads + num_refs, size=n).astype(np.int32)
    sym = rng.integers(0, 4, size=n).astype(np.int32)
    return lcp, da, sym


def entry(device="cuda"):
    """(fn, example_args): the fused scan+score forward step on a random
    16,384-position stream on ``device``."""
    dev = resolve_device(device)
    num_reads, num_refs, alpha, window = 256, 128, 16, 16
    rng = np.random.default_rng(0)
    lcp, da, sym = _synthetic_stream(rng, 16384, num_reads, num_refs,
                                     100, alpha, window)
    fn = functools.partial(banded_fused_step, num_reads=num_reads,
                           num_refs=num_refs, alpha=alpha, window=window)
    return fn, tuple(torch.from_numpy(a).to(dev) for a in (lcp, da, sym))


def _launches() -> dict:
    return {k: v for c in COUNTERS for k, v in c.LAUNCHES.items()}


def _reset_launches() -> None:
    for c in COUNTERS:
        c.reset_launches()


def _dataset_at(root: str) -> SynthDataset:
    """The dataset :func:`build_dataset` wrote under ``root``."""
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    return SynthDataset(
        root=root, collections=[os.path.join(root, f"col_{t}.fasta")
                                for t in ("1F", "1RC", "2F", "2RC")],
        lineage_path=os.path.join(root, "LineageFile.csv"),
        num_reads=meta["num_reads"], num_genomes=meta["num_genomes"],
        read_len=meta["read_len"], genomes=[], reads1=[], reads2=[])


def build_dataset(root: str, num_pairs: int = PAIRS) -> SynthDataset:
    """The dry run's dataset under ``root`` and its host reference CSV
    (``reference.csv``, ``assign_higher=True``), built once: a finished
    build leaves ``meta.json``.

    Alpha-runs longer than 255 rows (host-rescue COO routing, the
    reference's sizeMaxBuf domain, src/Tools.h:35) and near-window-cap
    runs with one genome row (long banded clusters across shard edges)
    are planted in the 1F collection, as ``__graft_entry__.py`` does."""
    if os.path.exists(os.path.join(root, "meta.json")):
        return _dataset_at(root)
    ds = make_dataset(root, num_pairs=num_pairs, read_len=READ_LEN,
                      genome_lens=GENOME_LENS, seed=SEED,
                      degenerate_rate=DEGENERATE_RATE)
    lcp_path = ds.collections[0] + ".lcp"
    lcp = np.fromfile(lcp_path, dtype=np.uint32)
    da = np.asarray(open_da(ds.collections[0])).copy()
    n = len(lcp)
    for frac, run in ((0.33, 400), (0.5, 330)):
        j = int(n * frac)
        lcp[j:j + run] = 20
        da[j - 1:j + run:2] = 0
        da[j:j + run:2] = ds.num_reads
    for frac, run in ((0.62, 250), (0.71, 200), (0.86, 180)):
        j = int(n * frac)
        lcp[j:j + run] = 20
        da[j - 1:j + run] = np.arange(run + 1) % ds.num_reads
        da[j + run // 2] = ds.num_reads  # the one genome row
    lcp.tofile(lcp_path)
    da.astype(np.uint32).tofile(ds.collections[0] + ".da")
    reference.reference_csv(ds.collections, os.path.join(root,
                                                         "reference.csv"),
                            ds.num_reads, ds.num_genomes, ds.lineage_path,
                            ds.read_len, LimeConfig(assign_higher=True))
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"num_reads": ds.num_reads, "num_genomes": ds.num_genomes,
                   "read_len": ds.read_len}, f)
    return ds


def _rescued(ds: SynthDataset, alpha: int):
    """The 1F clusters ``run_sharded``'s routing sends to the host rescue
    (``g_dense=0``: all banded, >255 and degenerate rescued)."""
    fasta = ds.collections[0]
    bad_s, bad_l = native.plan_native(
        np.fromfile(fasta + ".lcp", dtype=np.uint32),
        np.asarray(open_da(fasta)), np.asarray(open_ebwt(fasta)),
        ds.num_reads, alpha, SYMBOL_RANK_LUT, _DEGENERATE_BYTE,
        use_u16=False, g_dense=0)[4:6]
    return len(bad_s), int(bad_l.max()) if len(bad_l) else 0


def _agree(mesh: Mesh, ok: bool, dev: torch.device, what: str) -> None:
    """Raise on every rank unless every rank's ``ok`` holds (so no rank is
    left waiting in a collective for one that failed)."""
    flags = mesh.allgather_np(np.array([int(ok)], np.int64), dev)
    if not flags.all():
        raise AssertionError(f"{what} (failed on ranks "
                             f"{np.flatnonzero(flags[:, 0] == 0).tolist()})")


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name)
        else:
            os.environ[name] = saved


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def dryrun_multichip(device="cuda", num_pairs: int = PAIRS,
                     root: Optional[str] = None,
                     mesh: Optional[Mesh] = None,
                     engines: Sequence[str] = ("banded", "pair"),
                     blocked: bool = True) -> dict:
    """Run the SPMD engines end to end on this rank's part of ``mesh``
    (default: every rank of the process group) and check them.

    Rank 0 builds the dataset under ``root`` (reused when it is there; a
    temporary directory when None) with its host reference CSV.  Every
    engine in ``engines`` (``"banded"``: :func:`run_sharded`, ``"pair"``:
    :func:`run_sharded_pairs`) then runs with ``assign_higher=True`` and
    must write the reference's bytes; ``pair_comm_model``'s partition is
    checked; with ``blocked``, rank 0 also runs the fused path in the
    forced row-blocked mode (``LIME_HBM_BUDGET=1``) on its device, which
    must agree too.  A failed check raises on every rank.  Returns the
    mesh, the dataset's shape, the rescued clusters, and per engine its
    wall, this rank's kernel launches (counted from 0 just before it), the
    assignment counts and the planner that ran (``"native"`` or
    ``"numpy"``).
    """
    dev = resolve_device(device)
    mesh = mesh or make_mesh()
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    own_root = root is None
    if own_root:
        root = [tempfile.mkdtemp(prefix="lime_dryrun_")
                if mesh.rank == 0 else None]
        if mesh.distributed:
            dist.broadcast_object_list(root, src=0)
        root = root[0]
    cfg = LimeConfig(assign_higher=True)
    out = {"mesh": [sp, dp], "rank": mesh.rank, "engines": {}}
    try:
        if mesh.rank == 0:
            t0 = time.perf_counter()
            ds = build_dataset(root, num_pairs)
            out["dataset_s"] = time.perf_counter() - t0
            n_bad, max_bad = _rescued(ds, cfg.alpha)
            out["rescued"] = [n_bad, max_bad]
            rescued_ok = n_bad > 0 and max_bad > 255
        else:
            rescued_ok = True
        _agree(mesh, rescued_ok, dev, "planted rescue clusters did not "
               "route to the host rescue")
        ds = _dataset_at(root)
        out["dataset"] = [ds.num_reads, ds.num_genomes]
        ref_csv = os.path.join(root, "reference.csv")
        runners = {"banded": run_sharded, "pair": run_sharded_pairs}
        for engine in engines:
            csv = os.path.join(root, f"out_{engine}_{sp}x{dp}.csv")
            mesh.barrier()
            _reset_launches()
            t0 = time.perf_counter()
            res = runners[engine](ds.collections, csv, ds.num_reads,
                                  ds.num_genomes, ds.lineage_path,
                                  ds.read_len, cfg, mesh=mesh, device=dev)
            wall = time.perf_counter() - t0
            out["engines"][engine] = {"wall_s": wall,
                                      "launches": _launches(),
                                      "counts": res.counts(),
                                      "planner": LAST_RUN["planner"]}
            _agree(mesh, mesh.rank != 0 or _same_bytes(csv, ref_csv), dev,
                   f"{engine} engine's CSV differs from the host reference")

        # the dp-sliced engine's bookkeeping: rows_local is the minimal
        # cascade-block-aligned cover of the even split, the dp shards
        # cover every read row, and the per-rank block is exactly
        # F * rows_local * g_pad cells
        cm = pair_comm_model(mesh, 4, ds.num_reads, ds.num_genomes)
        g_pad = max(128, -(-ds.num_genomes // 128) * 128)
        need = -(-(ds.num_reads + 1) // dp)
        blk = classify_block_size(need)
        assert cm["rows_local"] == -(-need // blk) * blk, \
            "rows_local must be the minimal block-aligned cover"
        assert dp * cm["rows_local"] >= ds.num_reads + 1, \
            "dp shards must cover every read row"
        assert cm["per_device_hbm_bytes"] == 4 * cm["rows_local"] * g_pad, \
            "per-rank memory must be exactly the local stack"
        out["comm_model"] = cm

        if blocked:
            ok = True
            if mesh.rank == 0:
                csv = os.path.join(root, "out_blocked.csv")
                t0 = time.perf_counter()
                with _env("LIME_HBM_BUDGET", "1"):
                    run_paired(ds.collections, csv, ds.num_reads,
                               ds.num_genomes, ds.lineage_path, ds.read_len,
                               LimeConfig(assign_higher=True, fused=True),
                               device=dev)
                out["blocked_s"] = time.perf_counter() - t0
                ok = _same_bytes(csv, ref_csv)
            _agree(mesh, ok, dev, "the row-blocked fused run differs from "
                   "the host reference")
    finally:
        mesh.barrier()
        if own_root and mesh.rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    return out


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: Sequence[str], world: int, timeout: float,
                env: Optional[dict] = None, cwd: Optional[str] = None
                ) -> list:
    """Run ``cmd --rank R --world W --port P`` once per rank on this host
    and wait for every rank.

    Returns each rank's output (stdout and stderr).  Raises
    ``RuntimeError`` with the output tails when a rank exits non-zero or
    ``timeout`` seconds pass; every rank still running is then killed (a
    rank waiting in a collective for a dead peer would wait out the
    process group's timeout)."""
    port = free_port()
    logs, procs = [], []
    try:
        for r in range(world):
            log = tempfile.TemporaryFile()
            logs.append(log)
            procs.append(subprocess.Popen(
                [*cmd, "--rank", str(r), "--world", str(world), "--port",
                 str(port)], stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=cwd))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks did not finish within {timeout:.0f} s"
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode(errors="replace"))
        if failed is None and any(p.returncode for p in procs):
            failed = "a rank exited non-zero"
        if failed:
            tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                              f"{o[-3000:]}"
                              for r, (p, o) in enumerate(zip(procs, outs)))
            raise RuntimeError(f"{failed}\n{tails}")
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="SPxDP")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--root", default=None,
                    help="dataset directory (reused when built)")
    ap.add_argument("--engines", default="banded,pair")
    ap.add_argument("--no-blocked", action="store_true")
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds the spawned ranks may take")
    args = ap.parse_args(argv)
    if args.rank is None:
        # spawn the ranks of this host, each running this module
        cmd = [sys.executable, "-m", "lime_tpu_torch.parallel.dryrun",
               *(argv if argv is not None else sys.argv[1:])]
        for out in spawn_ranks(cmd, args.world, args.timeout):
            print(out, end="")
        return 0
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    init_distributed(args.backend, f"127.0.0.1:{args.port}", args.world,
                     args.rank, device=args.device)
    try:
        shape = (None if args.mesh is None
                 else [int(v) for v in args.mesh.lower().split("x")])
        res = dryrun_multichip(args.device, args.pairs, args.root,
                               make_mesh(shape=shape),
                               args.engines.split(","), not args.no_blocked)
        print("DRYRUN " + json.dumps(res), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
