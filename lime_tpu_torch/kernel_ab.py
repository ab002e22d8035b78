"""Time this checkout's kernel against another checkout's, on one NVIDIA
GPU, in one process.

    python -m lime_tpu_torch.kernel_ab --other DIR
        [--kernel pair|banded|replay|dense] [--pairs N]
        [--index PATH --reads R --genomes G]

``DIR`` is the root of another checkout of this repository (for example
a ``git archive`` of an earlier commit, unpacked into a git-ignored
directory).  Both sides run on the same inputs in the order other, this,
this, other, each timed two ways: per call with CUDA events
(:func:`utils.timing.event_ms`, the host's launch gap included) and as
CUDA-graph replays of back-to-back launches (:func:`utils.timing.graph_ms`).
Prints the card's name and power limit, one line per run, and as the last
line a JSON record of both sides' times.

- ``pair`` (default): per cap (16, 64, 255), both checkouts'
  ``ops/pair_kernels.pair_hits`` on the planner-shaped stream
  ``chip_smoke.py`` builds (1M rows from seed 1, tiled 32 times), each
  run checked exact on read rows against this checkout's plain version.
- ``banded``: K3 on the whole 1F staged stream of the paper-shape dataset
  (``N`` pairs, default 1,000,000; made under ``build/`` as
  ``chip_smoke.py`` makes it, or reused) into an int32 accumulator.  The
  other checkout's ``csrc/banded_pairs.cu`` is compiled by its own
  ``ops/cuda_build.py`` into its ``build/`` and bound with this
  checkout's ``banded_kernels.bind`` (the C interface is the same).
  Before timing, both sides are checked exact against this checkout's
  plain version on the stream's first 4M positions, in int32 and int8,
  and equal to each other on the whole stream.
- ``replay``: the row-blocked mode's replays of the same dataset's 1F
  collection, as ``chip_smoke.py``'s ``[blocked]`` phase runs them (8
  blocks of 131,072 reads): both checkouts' ``pair_score_packed_offset``
  over every pair chunk, and ``_dense_chunk_offset`` over every dense
  chunk, into one int8 plane, each block checked equal between the
  sides.  Times are of all 8 blocks' replays, per call only (the
  replays may wait for the device, which a graph cannot hold).
- ``dense``: every dense chunk of one collection index (``--index``, a
  collection of ``--reads`` reads and ``--genomes`` genomes, planned as
  the fused path plans it) by both checkouts' ``ops/dense_score.
  _dense_chunk`` into one int8 plane of the run's shape, checked equal
  between the sides, then timed per call (all the collection's chunks
  in one timing, so the host's launch time counts as on the main path)
  and given per chunk; this checkout's launches also as a CUDA-graph
  replay (the kernel's device time).

The other checkout builds its kernel into its own ``build/``.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

from .ops import banded_kernels as bk
from .ops import pair_kernels as pk
from .utils.timing import event_ms, graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("other", "this", "this", "other")


def load_other(root: str, name: str = "pair_kernels"):
    """``lime_tpu_torch/ops/<name>.py`` of the checkout at ``root``,
    imported as ``_other.ops.<name>``: that checkout's package under a
    name of its own, whose top ``__init__`` is not run, so only what
    ``name`` imports loads.  A new ``root`` drops the modules loaded
    from the previous one."""
    path = os.path.join(os.path.abspath(root), "lime_tpu_torch")
    if getattr(sys.modules.get("_other"), "__path__", None) != [path]:
        for mod in [m for m in sys.modules if m.split(".")[0] == "_other"]:
            del sys.modules[mod]
        pkg = types.ModuleType("_other")
        pkg.__path__ = [path]
        sys.modules["_other"] = pkg
    return importlib.import_module(f"_other.ops.{name}")


def other_banded_lib(root: str):
    """The other checkout's K3, built from its own source into its own
    ``build/`` and bound with this checkout's signature."""
    cb = load_other(root, "cuda_build")
    cb.compile_all(["banded_pairs"])
    return bk.bind(cb.lib_path("banded_pairs"))


def _pair_ab(other_root: str, smi: str) -> list:
    sides = {"other": load_other(other_root), "this": pk}
    for mod in sides.values():
        mod.build()
    records = []
    for cap in pk.BUCKET_CAPS:
        base = pk.planner_shaped_chunk(np.random.default_rng(1), 1 << 20,
                                       cap)
        codes = torch.from_numpy(np.tile(base, 32)).cuda()
        read = ((codes >> 4) & 1) == 0
        want = pk.pair_hits_plain(codes, cap, cap)
        rec = {"cap": cap, "rows": codes.shape[0]}
        for side in ORDER:
            mod = sides[side]
            err = int((mod.pair_hits(codes, cap, cap) - want).abs()[read]
                      .max().item())
            if err:
                raise AssertionError(f"{side} cap {cap}: kernel != plain on "
                                     f"read rows (max abs err {err})")
            ev = event_ms(lambda: mod.pair_hits(codes, cap, cap))
            gr = graph_ms([lambda: mod.pair_hits(codes, cap, cap)])
            rec.setdefault(f"{side}_event_ms", []).append(round(ev, 4))
            rec.setdefault(f"{side}_graph_ms", []).append(round(gr, 4))
            print(f"[ab] cap {cap}, {side}: exact on read rows; per-call "
                  f"events {ev:.4f} ms, graph replay {gr:.4f} ms ({smi})",
                  flush=True)
        records.append(rec)
        del codes, read, want
    return records


def _banded_ab(other_root: str, pairs: int, smi: str) -> dict:
    from .config import LimeConfig
    from .formats.arrays import open_da, open_ebwt, open_lcp
    from .host import _g_pad_for
    from .native import plan_clusters
    from .ops.fused_pass import staged_stream
    from .synth_big import paper_dataset

    libs = {"other": other_banded_lib(other_root), "this": bk.build()}
    ds = paper_dataset(os.path.join(ROOT, "build"), pairs)[0]
    cfg, fasta, R = LimeConfig(), ds.collections[0], ds.num_reads
    lcp, da = open_lcp(fasta), open_da(fasta)
    starts, lens = plan_clusters(lcp, da, R, cfg.alpha, threads=0)
    packed_h, doc_h, window, _ = staged_stream(
        starts, lens, da, open_ebwt(fasta), cfg, cfg.alpha, lcp)
    packed, doc = torch.from_numpy(packed_h).cuda(), \
        torch.from_numpy(doc_h).cuda()
    del packed_h, doc_h, lcp, da
    g_pad = _g_pad_for(ds.num_genomes)
    n4 = 1 << 22
    want = torch.zeros((R + 1, g_pad), dtype=torch.int32, device="cuda")
    bk.banded_sim_plain(want, packed[:n4], doc[:n4], window, R)
    whole = {}
    for side, lib in libs.items():
        for dt in (torch.int32, torch.int8):
            got = torch.zeros((R + 1, g_pad), dtype=dt, device="cuda")
            bk.launch(lib, got, packed[:n4], doc[:n4], window, R)
            ref = want if dt == torch.int32 else (want & 255).to(torch.uint8)
            if not torch.equal(got.view(ref.dtype), ref):
                raise AssertionError(f"{side} {dt}: K3 != plain on the "
                                     f"first {n4} positions")
        acc = torch.zeros((R + 1, g_pad), dtype=torch.int32, device="cuda")
        bk.launch(lib, acc, packed, doc, window, R)
        whole[side] = acc
    if not torch.equal(whole["other"], whole["this"]):
        raise AssertionError("the two sides differ on the whole stream")
    pair_counts = int(whole["this"].sum().item())
    acc = whole.pop("this")
    del want, whole
    rec = {"stream": os.path.basename(fasta), "positions": packed.shape[0],
           "window": window, "pair_counts": pair_counts}
    for side in ORDER:
        lib = libs[side]

        def call():
            bk.launch(lib, acc, packed, doc, window, R)

        ev, gr = event_ms(call), graph_ms([call])
        rec.setdefault(f"{side}_event_ms", []).append(round(ev, 4))
        rec.setdefault(f"{side}_graph_ms", []).append(round(gr, 4))
        print(f"[ab] K3 on the whole {rec['stream']} staged stream "
              f"({rec['positions']} positions, window {window}), {side}: "
              f"per-call events {ev:.4f} ms, graph replay {gr:.4f} ms "
              f"({smi})", flush=True)
    for timer in ("event", "graph"):
        o = np.mean(rec[f"other_{timer}_ms"])
        t = np.mean(rec[f"this_{timer}_ms"])
        rec[f"speedup_{timer}"] = round(float(o / t), 3)
    print(f"[ab] K3: this checkout {rec['speedup_event']}x per call and "
          f"{rec['speedup_graph']}x by graph against the other ({smi})",
          flush=True)
    return rec


#: reads per row block of ``[blocked]`` (a 1 GiB LIME_HBM_BUDGET)
REPLAY_BLOCK = 131_072


def _taken(fn, **kw) -> dict:
    """The arguments of ``kw`` that ``fn`` takes: a checkout older than
    the dense kernel takes neither a chunk's sorted host rows nor a
    status."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in params}


def _replay_ab(other_root: str, pairs: int, smi: str,
               dev: torch.device = torch.device("cuda")) -> dict:
    from .config import LimeConfig
    from .formats.arrays import open_da, open_ebwt, open_lcp
    from .host import B_BLK, C_BLK, K, PR, _g_pad_for, pack_chunks
    from .ops import dense_kernels, dense_score, pair_score
    from .ops.fused_pipeline import _plan_pairs
    from .synth_big import paper_dataset

    if dev.type == "cuda":
        load_other(other_root).build()
        pk.build()
    sides = {"other": (load_other(other_root, "pair_score"),
                       load_other(other_root, "dense_score")),
             "this": (pair_score, dense_score)}
    ds = paper_dataset(os.path.join(ROOT, "build"), pairs)[0]
    cfg = LimeConfig(fused=True)
    fasta, R, G = ds.collections[0], ds.num_reads, ds.num_genomes
    g_pad = _g_pad_for(G)
    da, ebwt = open_da(fasta), open_ebwt(fasta)
    arrays, chunks, windows, row_bits, den_s, den_l = _plan_pairs(
        open_lcp(fasta), da, ebwt, R, G, cfg)[:6]
    keep = []
    uploaded = pair_score.pair_upload(arrays, chunks, dev, keep)
    dense = [(tuple(pair_score.to_device(a, dev, keep) for a in c),
              np.unique(c[3]))
             for c in pack_chunks(den_s, den_l, da, ebwt, R, G, g_pad)[0]]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    keep.clear()
    B, f_feat = REPLAY_BLOCK, (4 if cfg.use_ebwt else 1) * K
    status = dense_kernels.new_status(dev)
    bases = range(0, R + 1, B)
    stack = torch.zeros((1, B, g_pad), dtype=torch.int8, device=dev)

    def replay(side, what, only=None):
        ps, dsc = sides[side]
        for base in (bases if only is None else [only]):
            if what == "pair":
                ps.pair_score_packed_offset(stack, 0, uploaded, chunks,
                                            windows, row_bits, base)
            else:
                for chunk, rows in dense:
                    dsc._dense_chunk_offset(
                        stack, 0, *chunk, base, B_BLK, C_BLK, PR, f_feat,
                        g_pad, **_taken(dsc._dense_chunk_offset,
                                        rid_sorted=rows, status=status))

    for what in ("pair", "dense"):
        for base in bases:
            got = {}
            for side in sides:
                stack.zero_()
                replay(side, what, base)
                got[side] = stack.clone()
            if not torch.equal(got["other"], got["this"]):
                raise AssertionError(f"{what} replay at block {base}: the "
                                     "two sides differ")
        del got
    dense_kernels.take(status)
    rec = {"stream": os.path.basename(fasta), "blocks": len(bases),
           "block_reads": B, "pair_chunks": len(chunks),
           "dense_chunks": len(dense)}
    for what in ("pair", "dense"):
        n = len(bases) * (len(chunks) if what == "pair" else len(dense))
        for side in ORDER:
            ms = event_ms(lambda: replay(side, what))
            rec.setdefault(f"{what}_{side}_ms", []).append(round(ms, 3))
            print(f"[ab] {what} replays of {rec['stream']}, {side}: {n} "
                  f"replays over {len(bases)} blocks in {ms:.3f} ms, "
                  f"{ms / n:.4f} ms each ({smi})", flush=True)
        o = np.mean(rec[f"{what}_other_ms"])
        t = np.mean(rec[f"{what}_this_ms"])
        rec[f"{what}_speedup"] = round(float(o / t), 3)
        print(f"[ab] {what} replays: this checkout {rec[f'{what}_speedup']}x "
              f"against the other ({smi})", flush=True)
    dense_kernels.take(status)
    return rec


def _dense_ab(other_root: str, index: str, R: int, G: int, smi: str,
              dev: torch.device = torch.device("cuda")) -> dict:
    from .config import LimeConfig
    from .formats.arrays import open_da, open_ebwt, open_lcp
    from .host import B_BLK, C_BLK, K, PR, _g_pad_for, _r_pad_for, pack_chunks
    from .ops import dense_kernels, dense_score, pair_score
    from .ops.fused_pipeline import _plan_pairs

    cfg = LimeConfig(fused=True)
    g_pad = _g_pad_for(G)
    da, ebwt = open_da(index), open_ebwt(index)
    den_s, den_l = _plan_pairs(open_lcp(index), da, ebwt, R, G, cfg)[4:6]
    keep = []
    dense = [tuple(pair_score.to_device(a, dev, keep) for a in c)
             for c in pack_chunks(den_s, den_l, da, ebwt, R, G, g_pad)[0]]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    keep.clear()
    f_feat = (4 if cfg.use_ebwt else 1) * K
    sides = {"other": load_other(other_root, "dense_score"),
             "this": dense_score}
    plane = torch.zeros((_r_pad_for(R), g_pad), dtype=torch.int8,
                        device=dev)
    status = dense_kernels.new_status(dev)
    # faults are read once a timing, not once a chunk
    kw = {side: _taken(m._dense_chunk, status=status)
          for side, m in sides.items()}

    def run(side):
        for chunk in dense:
            sides[side]._dense_chunk(plane, *chunk, B_BLK, C_BLK, PR,
                                     f_feat, g_pad, **kw[side])

    got = {}
    for side in sides:
        plane.zero_()
        run(side)
        got[side] = plane[:R].clone()
    dense_kernels.take(status)
    if not torch.equal(got["other"], got["this"]):
        raise AssertionError("dense chunks: the two sides' planes differ")
    del got
    rec = {"index": os.path.basename(index), "reads": R, "genomes": G,
           "g_pad": g_pad, "chunks": len(dense)}
    for side in ORDER:
        ms = event_ms(lambda: run(side))
        rec.setdefault(f"{side}_ms", []).append(round(ms, 3))
        print(f"[ab] dense chunks of {rec['index']} at G_pad {g_pad}, "
              f"{side}: {len(dense)} chunks in {ms:.3f} ms, "
              f"{ms / len(dense):.4f} ms each ({smi})", flush=True)
    # this side's device time alone: its launches replayed as a graph
    # (the other side's chain allocates, which a graph cannot hold)
    rec["this_graph_chunk_ms"] = round(
        graph_ms([lambda: run("this")]) / len(dense), 4)
    dense_kernels.take(status)
    o, t = (float(np.mean(rec[f"{side}_ms"])) for side in ("other",
                                                           "this"))
    rec["other_chunk_ms"] = round(o / len(dense), 4)
    rec["this_chunk_ms"] = round(t / len(dense), 4)
    rec["speedup"] = round(o / t, 3)
    print(f"[ab] dense chunks: this checkout {rec['speedup']}x against "
          f"the other ({smi})", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--kernel", choices=("pair", "banded", "replay",
                                         "dense"),
                    default="pair",
                    help="the kernel to compare (default: pair)")
    ap.add_argument("--pairs", type=int, default=1_000_000,
                    help="read pairs of the paper-shape dataset (banded, "
                    "replay)")
    ap.add_argument("--index", help="collection index (dense)")
    ap.add_argument("--reads", type=int, help="its reads (dense)")
    ap.add_argument("--genomes", type=int, help="its genomes (dense)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this "
                         "comparison needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.kernel == "pair":
        out = {"pair_hits_ab": _pair_ab(args.other, smi)}
    elif args.kernel == "banded":
        out = {"banded_ab": _banded_ab(args.other, args.pairs, smi)}
    elif args.kernel == "replay":
        out = {"replay_ab": _replay_ab(args.other, args.pairs, smi)}
    else:
        if None in (args.index, args.reads, args.genomes):
            ap.error("--kernel dense needs --index, --reads and --genomes")
        out = {"dense_ab": _dense_ab(args.other, args.index, args.reads,
                                     args.genomes, smi)}
    print(smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
