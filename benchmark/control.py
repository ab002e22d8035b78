#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with its classify arithmetic in
bfloat16, the precision below the configuration's float32.  It writes
what a window job writes (the CSV, and in a staged cell the ``.clrs`` and
``.res`` checkpoints beside the collections) and the harness judges it
as it judges the program (``harness.judge``).  It has to come out not
correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, at the cell's own size: the cell's data, the control's
outputs, and one JSON line with ``correct`` and each number compared
beside its limit.  Needs a CUDA device, or ``--device cpu`` for a small
cell.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

if __name__ == "__main__":  # import from the checkout's root
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from benchmark import harness  # noqa: E402


def write_control(ds, config: dict, staged: bool, csv_path: str, device,
                  dtype) -> None:
    """The reference's outputs in ``dtype`` where the program writes its
    own: the CSV at ``csv_path`` and, if ``staged``, each collection's
    ``.clrs`` (u64 first row, u64 rows) and ``.res.pos``/``.res.bin``."""
    from benchmark.reference import plain

    alpha, beta = int(config["alpha"]), float(config["beta"])
    planes = []
    for path in ds.collections:
        ebwt, lcp, da = plain.load_index(path, device)
        p_start, lens = plain.find_clusters(lcp, da, ds.num_reads, alpha)
        del lcp
        planes.append(plain.score_matrix(ebwt, da, p_start, lens,
                                         ds.num_reads, ds.num_genomes))
        del ebwt, da
        if staged:
            np.stack([p_start.cpu().numpy(), lens.cpu().numpy()],
                     axis=1).astype(np.uint64).tofile(
                         f"{path}.{alpha}.clrs")
            pos, recs = plain.res_records(planes[-1], ds.read_len, alpha,
                                          beta, dtype=dtype)
            pos.tofile(path + ".res.pos")
            recs.tofile(path + ".res.bin")
    lines = plain.csv_lines(*plain.classify(
        planes, ds.read_len, alpha, beta, float(config["error_tolerance"]),
        ds.taxa_at(int(config["tax_rank"])), dtype=dtype))
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def control_run(cell: str, seed: int, device, root: str,
                dtype=None) -> dict:
    """The cell's data from ``seed``, the control in the program's place
    (``dtype``, bfloat16 by default) and the harness's verdict on it."""
    import torch
    from benchmark.data.dataset import make_dataset

    dtype = torch.bfloat16 if dtype is None else dtype
    spec = harness.resolve(harness.load_spec(root), cell, root)
    config, traffic = spec["config"], spec["traffic"]
    staged = not traffic["lime_config"].get("fused", False)
    dev = torch.device(device)
    work = tempfile.mkdtemp(prefix="lime-control-")
    try:
        t0 = time.perf_counter()
        ds = make_dataset(config, traffic, seed, os.path.join(work, "data"),
                          dev)
        job = {"csv": os.path.join(work, "job_0.csv")}
        write_control(ds, config, staged, job["csv"], dev, dtype)
        checks, _ = harness.judge(ds, config, staged, [job], dev)
        return {"workload": cell, "seed": seed, "reads": ds.num_reads,
                "dtype": str(dtype).replace("torch.", ""),
                "correct": harness.verdict(checks), "checks": checks,
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.meta_path.insert(0, harness.RefuseForbidden())
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, args.device,
                                     harness.ROOT)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
