"""A temporary copy of the benchmark with tiny cells added as files only,
for tests: the configuration ``tiny`` (24 genomes of 3 kbp), the traffic
mixes ``tiny_fused`` and ``tiny_staged`` (400 pairs a job) and the cells
``tiny-fused`` and ``tiny-staged``, which every per-layer metric lists.
The port and its build directory are linked in, so the harness loads
the port from the copy."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"genomes": 24, "genome_len": 3000,
        "taxa": {"species": 16, "genus": 8, "family": 4, "order": 3,
                 "class": 2, "phylum": 2}}
CELLS = {"tiny-fused": ("tiny_fused", {"fused": True}, False),
         "tiny-staged": ("tiny_staged", {}, True)}


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "setB2_930.json")) as f:
        config = json.load(f)
    config.update(name="tiny", **TINY)
    return config


def tiny_traffic(name: str) -> dict:
    traffic, lime, keep = next(v for v in CELLS.values() if v[0] == name)
    return {"name": traffic, "pairs_per_job": 400, "lime_config": lime,
            "keep_results": keep}


def copy_benchmark(dest: str) -> str:
    """``dest`` holding BENCHMARK.json, benchmark/ with the tiny cells, and
    links to the port and its builds; returns ``dest``."""
    os.makedirs(dest, exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("lime_tpu_torch", "build"):
        os.makedirs(os.path.join(ROOT, name), exist_ok=True)
        os.symlink(os.path.join(ROOT, name), os.path.join(dest, name))
    bench = os.path.join(dest, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    for traffic, _, _ in CELLS.values():
        with open(os.path.join(bench, "traffic", f"{traffic}.json"),
                  "w") as f:
            json.dump(tiny_traffic(traffic), f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    for cell, (traffic, _, _) in CELLS.items():
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
    for m in spec["per_layer"]:
        m["workloads"] += list(CELLS)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dest
