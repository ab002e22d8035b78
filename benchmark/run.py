#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``lime_tpu_torch``) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (:mod:`benchmark.harness`) and prints
its result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error).  Exits non-zero with no result
when there is no CUDA device, too few of them for the cell, when the
port cannot be loaded from this checkout, or when a module of ``jax``,
``jaxlib``, ``flax`` or ``lime_tpu`` is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# import from the checkout's root, not from this directory
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

sys.meta_path.insert(0, harness.RefuseForbidden())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.load_spec()
    chips = harness.resolve(spec, args.workload)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available():
        harness.log("torch.cuda.is_available() is False: this benchmark "
                    "measures an NVIDIA GPU")
        return 2
    if torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA devices, "
                    f"{torch.cuda.device_count()} found")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        harness.log(f"forbidden modules loaded: {loaded}")
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
