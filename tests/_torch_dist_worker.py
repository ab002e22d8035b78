"""One rank of a torch.distributed test run (gloo on the CPU).

Usage: python -m tests._torch_dist_worker SPEC.json --rank R --world W
       --port P

``SPEC.json`` names the task and where to write this rank's result:

- ``device``: the ranks' device (default ``cpu``; ``cuda``: every rank
  on the one card, gloo between them);
- ``run``: ``run_sharded`` (``engine: banded``) or ``run_sharded_pairs``
  (``pair``) on the dataset ``ds`` over the mesh ``mesh``, with
  ``LimeConfig(**config)`` and the environment ``env``; rank 0 writes
  ``csv``;
- ``step`` / ``pair_step``: the port's per-rank step of the banded /
  pair engine on this rank's shard of the inputs in ``inputs`` (an
  ``.npz`` of ``lime_tpu``'s step arguments, captured from its
  single-process run on the same mesh);
- ``cli``: the port's CLI with ``argv``, the process group started by
  ``init_distributed`` from the ``LIME_*`` variables;
- ``wrap``: int8 sums of ``100 + rank`` through ``all_reduce`` and the
  mesh's ``reduce_scatter_dp`` (``mesh`` is 1 x world), which must wrap
  mod 256.

With ``no_native`` set, the rank runs as if the native library had
failed to build: ``native.available()`` is False and every binding
raises, so only the numpy fallbacks can run.

Every rank writes ``out.<rank>.json`` (and ``out.<rank>.npz`` for the
steps) beside ``SPEC.json``.  ``jax`` and ``lime_tpu`` are blocked: the
ranks run the port alone.
"""

import sys

sys.modules["jax"] = None
sys.modules["lime_tpu"] = None

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _step(spec, mesh, rank, world):
    from lime_tpu_torch.parallel import sharded

    a = dict(np.load(spec["inputs"]))
    F = spec["num_files"]
    common = dict(num_files=F, num_reads=spec["num_reads"],
                  num_refs=spec["num_refs"], read_len=spec["read_len"],
                  alpha=spec["alpha"], beta=spec["beta"],
                  tax_rank=spec["tax_rank"],
                  assign_higher=spec["assign_higher"],
                  wide_sim=spec["wide_sim"], device=spec.get("device", "cpu"))
    consts = (a["tax"], a["rank_matrix"], a["valid_t"],
              np.float32(a["error"]))
    if spec["task"] == "step":
        step = sharded.make_sharded_pipeline(mesh, dense_f=spec["dense_f"],
                                             **common)
        n_local = a["packed"].shape[1] // world
        cols = slice(rank * n_local, (rank + 1) * n_local)
        dense = None
        if "d_file" in a:
            n_cell = len(a["d_file"]) // world
            dense = [(int(a["d_file"][i]), a["d_ridx"][i], a["d_gidx"][i],
                      a["d_cmap"][i], a["d_rid"][i])
                     for i in range(rank * n_cell, (rank + 1) * n_cell)
                     if a["d_file"][i] < F]
        return step(a["packed"][:, cols], a["doc"][:, cols],
                    int(a["window"]), a["cfile"], a["crows"], a["ccols"],
                    a["cvals"], *consts, hostm=a.get("hostm"), dense=dense)
    step = sharded.make_pair_sharded_pipeline(
        mesh, row_bits=spec["row_bits"], **common)
    n_cell = len(a["cfile"]) // world
    # lime_tpu sends every chunk to the cap-255 kernel (bucket 2)
    chunks = [(int(a["cfile"][i]), 2, int(a["cwin"][i]), a["rows_w"][i],
               a["bits_b"][i], a["gcol"][i])
              for i in range(rank * n_cell, (rank + 1) * n_cell)
              if a["cfile"][i] < F]
    return step(chunks, a["crows"], a["ccols"], a["cvals"], a["corr_file"],
                *consts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args()
    with open(args.spec) as f:
        spec = json.load(f)
    device = spec.get("device", "cpu")
    if device == "cpu":
        torch.set_num_threads(1)
    os.environ.update(spec.get("env", {}))
    out_base = os.path.join(os.path.dirname(args.spec), f"out.{args.rank}")
    if spec.get("no_native"):
        from lime_tpu_torch import native

        native.LOAD_ERROR = "the library was not built (no_native)"

    from lime_tpu_torch import LimeConfig
    from lime_tpu_torch.ops import banded_kernels, pair_kernels
    from lime_tpu_torch.parallel import (init_distributed, make_mesh,
                                         run_sharded, run_sharded_pairs,
                                         sharded)

    result = {}
    if spec["task"] == "cli":
        from lime_tpu_torch.cli import main as cli_main

        os.environ.update({"LIME_COORDINATOR": f"127.0.0.1:{args.port}",
                           "LIME_NUM_PROCESSES": str(args.world),
                           "LIME_PROCESS_ID": str(args.rank)})
        result["rc"] = cli_main(spec["argv"])
    else:
        init_distributed("gloo", f"127.0.0.1:{args.port}", args.world,
                         args.rank, device=device)
        mesh = make_mesh(shape=spec["mesh"])
        if spec["task"] == "wrap":
            t = torch.full((8,), 100 + args.rank, dtype=torch.int8,
                           device=device)
            dist.all_reduce(t)
            blocks = torch.full((1, 4 * args.world, 2), 100 + args.rank,
                                dtype=torch.int8, device=device)
            result["all_reduce"] = t.tolist()
            result["reduce_scatter"] = \
                mesh.reduce_scatter_dp(blocks).view(-1).tolist()
        elif spec["task"] == "run":
            ds = spec["ds"]
            runner = run_sharded if spec["engine"] == "banded" \
                else run_sharded_pairs
            runner(ds["collections"], spec["csv"], ds["num_reads"],
                   ds["num_genomes"], ds["lineage_path"], ds["read_len"],
                   LimeConfig(**spec.get("config", {})), mesh=mesh,
                   device=device)
        else:
            types, taxid, sim = _step(spec, mesh, args.rank, args.world)
            np.savez(out_base + ".npz", types=types.cpu().numpy(),
                     taxid=taxid.cpu().numpy(), sim=sim.cpu().numpy())
        result["sp_dp"] = [mesh.sp_i, mesh.dp_j]
    result["last_run"] = {k: v for k, v in sharded.LAST_RUN.items()
                          if k != "phases"}
    result["launches"] = {**pair_kernels.LAUNCHES,
                          **banded_kernels.LAUNCHES}
    result["blocked"] = sorted(k for k in ("jax", "lime_tpu")
                               if sys.modules.get(k) is None)
    with open(out_base + ".json", "w") as f:
        json.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
