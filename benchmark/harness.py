"""The benchmark of ``lime_tpu_torch``: one cell, one seed, one run.

A run is a batch of classification jobs in a closed loop on one card:

1. set-up (``setup_s``, from the process's start): the cell's sample and
   database made from the seed (:mod:`benchmark.data`), the four
   collection indexes built on the card and written under a fresh
   directory in ``TMPDIR``, the port loaded (its g++ and nvcc builds are
   cached under ``build/`` in the checkout), and one warm-up job;
2. the window: ``pipeline.run_paired`` one job after another on those
   files, each into a fresh CSV; the last job started before the window's
   seconds run out is finished and counted;
3. the comparison (:mod:`benchmark.reference`): every job's CSV, and in a
   staged cell the last job's ``.clrs`` and ``.res`` checkpoints, against
   the plain reference, once the window has closed and the program's
   state is freed.

Everything that belongs to one cell is found by name: the configuration
file its ``BENCHMARK.json`` entry names, ``traffic/<traffic>.json``, and
for each per-layer metric ``metrics/<metric>.py``, whose ``read(ctx)``
returns the metric's value or None when it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.abc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that no run may load: the JAX reference package
#: and JAX itself (the port is ``lime_tpu_torch``, a different name)
FORBIDDEN = ("jax", "jaxlib", "flax", "lime_tpu")


class RefuseForbidden(importlib.abc.MetaPathFinder):
    """Fails any import whose top-level name is in :data:`FORBIDDEN`."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name}: the benchmark runs lime_tpu_torch "
                              "alone")
        return None


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose whole top-level name is forbidden."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# What a cell is made of, found by name
# ---------------------------------------------------------------------------

def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} {name!r}; there are "
                   f"{[e['name'] for e in entries]}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, cell_name: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and metric entries."""
    cell = _named(spec["workloads"], cell_name, "workload")
    entry = _named(spec["configs"], cell["config"], "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell_name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer}


def load_reader(name: str, root: str = ROOT):
    """``metrics/<name>.py`` of the benchmark at ``root``, as a module."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a metric reader reads: each window job's phase spans (the
    port's ``LAST_RUN`` dicts, copied after the job), the trace's
    summary (None without ``--trace 1``) and the least device time of one
    job's work."""

    def __init__(self, jobs: List[dict], trace: Optional[dict],
                 least_job_s: float):
        self.jobs = jobs
        self.n_jobs = len(jobs)
        self.trace = trace
        self.least_job_s = least_job_s

    def phase_mean(self, kind: str, *keys) -> Optional[float]:
        """Mean per job of the span at ``keys`` in each job's ``kind``
        record (``fused`` or ``staged``); a job without it counts 0, and
        None if no job has it."""
        vals, seen = [], False
        for job in self.jobs:
            v = job.get(kind)
            for k in keys:
                v = v.get(k) if isinstance(v, dict) else None
            seen |= v is not None
            vals.append(float(v or 0.0))
        return sum(vals) / len(vals) if seen else None


# ---------------------------------------------------------------------------
# The port, its jobs and their spans
# ---------------------------------------------------------------------------

def load_port(root: str = ROOT):
    """``lime_tpu_torch``'s pipeline and fused pipeline modules, which
    must come from this checkout."""
    import lime_tpu_torch
    from lime_tpu_torch import pipeline
    from lime_tpu_torch.ops import fused_pipeline

    where = os.path.realpath(os.path.dirname(lime_tpu_torch.__file__))
    if where != os.path.realpath(os.path.join(root, "lime_tpu_torch")):
        raise ImportError(f"lime_tpu_torch from {where}, not from the "
                          f"checkout at {root}")
    return pipeline, fused_pipeline


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _copy(d: dict) -> dict:
    return json.loads(json.dumps(d, default=float))


def _bytes_since(root: str, t_epoch: float) -> int:
    """Bytes of the files under ``root`` written at or after ``t_epoch``
    (the host's wall clock): what one step of the run wrote to disk."""
    total = 0
    for d, _, files in os.walk(root):
        for name in files:
            st = os.stat(os.path.join(d, name))
            if st.st_mtime >= t_epoch:
                total += st.st_size
    return total


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             root: str = ROOT) -> dict:
    """Run one cell and return its result line as a dict.  ``t_start``
    (the process's start on the host clock) opens ``setup_s``."""
    import torch
    from benchmark import roofline
    from benchmark.data.dataset import make_dataset
    from benchmark.reference import compare

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spec = resolve(load_spec(root), cell_name, root)
    config, traffic = spec["config"], spec["traffic"]
    work = tempfile.mkdtemp(prefix="lime-bench-")
    try:
        pipeline, fused_pipeline = load_port(root)
        from lime_tpu_torch import LimeConfig

        t0 = time.perf_counter()
        ds = make_dataset(config, traffic, seed, os.path.join(work, "data"),
                          dev)
        written = [_bytes_since(work, 0.0)]
        _sync(dev)
        t_data = time.perf_counter() - t0
        log(f"[setup] {ds.num_reads} pairs x {ds.num_genomes} genomes, "
            f"{ds.positions} positions a collection, in {t_data:.3f} s: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in ds.seconds.items()))

        t0 = time.perf_counter()
        cfg = LimeConfig(alpha=int(config["alpha"]),
                         beta=float(config["beta"]),
                         tax_rank=int(config["tax_rank"]),
                         **traffic["lime_config"])
        keep = bool(traffic["keep_results"])

        def job(tag: str) -> dict:
            t_epoch = time.time()
            out = os.path.join(work, f"job_{tag}.csv")
            pipeline.run_paired(ds.collections, out, ds.num_reads,
                                ds.num_genomes, ds.lineage_path,
                                ds.read_len, cfg, keep_results=keep,
                                device=dev)
            _sync(dev)
            rec = {"csv": out}
            written.append(_bytes_since(work, t_epoch))
            if cfg.fused:
                rec["fused"] = _copy(fused_pipeline.LAST_RUN)
            else:
                rec["staged"] = _copy(pipeline.LAST_RUN)
            return rec

        warm = job("warm")
        os.remove(warm["csv"])
        t_warm = time.perf_counter() - t0
        log(f"[setup] port loaded and one warm-up job in {t_warm:.3f} s")

        prof = None
        if trace:
            # the profiler's first start initialises CUPTI: pay it here
            with torch.profiler.profile(activities=_activities(dev)):
                torch.zeros(1, device=dev).add_(1)
            prof = torch.profiler.profile(activities=_activities(dev))
        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        jobs: List[dict] = []
        with contextlib.ExitStack() as stack:
            if prof is not None:
                stack.enter_context(prof)
                stack.enter_context(
                    torch.profiler.record_function("bench.window"))
            t_window = time.perf_counter()
            setup_s = t_window - t_start
            deadline = t_window + seconds
            while not jobs or time.perf_counter() < deadline:
                t0 = time.perf_counter()
                with (torch.profiler.record_function("bench.job")
                      if prof is not None else contextlib.nullcontext()):
                    rec = job(str(len(jobs)))
                rec["wall_s"] = time.perf_counter() - t0
                jobs.append(rec)
                log(_job_line(len(jobs) - 1, rec))
            window_s = time.perf_counter() - t_window
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(f"[window] {len(jobs)} jobs in {window_s:.3f} s: " + " ".join(
            f"{j['wall_s']:.3f}" for j in jobs))

        summary = None
        if prof is not None:
            t0 = time.perf_counter()
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            from benchmark.device_trace import load_events, summarize
            summary = summarize(load_events(path))
            os.remove(path)
            log(f"[trace] read in {time.perf_counter() - t0:.3f} s: device "
                f"busy {summary['busy_s']:.6f} s of {summary['window_s']:.6f}"
                " s")
            if cuda and summary["busy_s"] <= 0:
                raise RuntimeError("the trace holds no device activity")
        fused_pipeline.LAST_RUN.clear()
        pipeline.LAST_RUN.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        checks, rows = judge(ds, config, not cfg.fused, jobs, dev)
        log(f"[reference] compared in {time.perf_counter() - t0:.3f} s")
        acc = compare.accuracy(jobs[0]["csv"],
                               ds.truth_taxa(int(config["tax_rank"])))
        log(f"[accuracy] first job: sensitivity {acc['sensitivity']:.6f}, "
            f"precision {acc['precision']:.6f}")

        least = roofline.least_seconds(roofline.job_bytes(
            rows, ds.num_reads, ds.num_genomes, len(ds.collections)))
        if trace:
            ctx = Context(jobs, summary, least)
            metrics = {}
            for m in spec["per_layer"]:
                value = load_reader(m["name"], root).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = {"pairs_per_s": len(jobs) * ds.num_reads / window_s,
                      "peak_dev_gib": peak / (1 << 30),
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in spec["end_to_end"]}
        device_info = {"platform": "gpu" if cuda else dev.type,
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": 1, "memory_peak_bytes": peak,
                       "power": _power_limit() if cuda else "none"}
        result = {"correct": verdict(checks),
                  "attempted": len(jobs), "failed": 0, "metrics": metrics,
                  "device": device_info}
        if summary is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        log(f"[setup] setup_s {setup_s:.3f}, least device time of a job "
            f"{least:.6f} s ({rows} cluster rows)")
        log(f"[run] {time.perf_counter() - t_start:.3f} s from the start; "
            f"{sum(written)} B written to disk (index {written[0]} B, "
            f"then {max(written[1:])} B a job at most)")
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _job_line(k: int, rec: dict) -> str:
    """One window job's wall and the port's own spans, for the log."""
    if "fused" in rec:
        run = rec["fused"]
        spans = run.get("phases", {})
        extra = (f"engine {run.get('engine')}, dense chunks "
                 f"{run.get('dense_chunks')}, host plane bytes "
                 f"{run.get('host_plane_bytes')}")
    else:
        spans = {f"{stage}.{phase}": v for stage, phases in
                 rec["staged"].get("stages", {}).items()
                 for phase, v in phases.items()}
        extra = ""
    return (f"[job] {k}: {rec['wall_s']:.3f} s; " + " ".join(
        f"{name}={v:.3f}" for name, v in spans.items()) + f"; {extra}")


def _activities(dev):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def judge(ds, config: dict, staged: bool, jobs: List[dict], dev) -> tuple:
    """(checks, kept cluster rows of all four collections): each number
    compared, with its limit, and the work count the roofline needs.
    Compared are each job's CSV (``jobs[k]["csv"]``) and, in a ``staged``
    cell, the ``.clrs`` and ``.res`` checkpoints beside the collections."""
    import torch
    from benchmark.reference import compare, plain

    alpha, beta = int(config["alpha"]), float(config["beta"])
    planes, rows = [], 0
    checks: Dict[str, dict] = {}
    clusters = res = 0
    spent = dict.fromkeys(("scan", "score", "clusters", "res_lists",
                           "res_compare", "classify", "csv"), 0.0)

    def lap(step: str, t0: float) -> float:
        _sync(dev)
        t1 = time.perf_counter()
        spent[step] += t1 - t0
        return t1

    for path in ds.collections:
        t0 = time.perf_counter()
        ebwt, lcp, da = plain.load_index(path, dev)
        p_start, lens = plain.find_clusters(lcp, da, ds.num_reads, alpha)
        del lcp
        rows += int(lens.sum())
        t0 = lap("scan", t0)
        planes.append(plain.score_matrix(ebwt, da, p_start, lens,
                                         ds.num_reads, ds.num_genomes))
        del ebwt, da
        t0 = lap("score", t0)
        if staged:
            clusters += compare.clusters_wrong(
                f"{path}.{alpha}.clrs", p_start.cpu().numpy(),
                lens.cpu().numpy())
            t0 = lap("clusters", t0)
            pos, recs = plain.res_records(planes[-1], ds.read_len, alpha,
                                          beta)
            t0 = lap("res_lists", t0)
            res += compare.res_reads_wrong(path + ".res", pos, recs)
            lap("res_compare", t0)
    t0 = time.perf_counter()
    want = plain.csv_lines(*plain.classify(
        planes, ds.read_len, alpha, beta, float(config["error_tolerance"]),
        ds.taxa_at(int(config["tax_rank"]))))
    del planes
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = lap("classify", t0)
    checks["csv_rows_wrong"] = {
        "value": sum(compare.csv_rows_wrong(j["csv"], want) for j in jobs),
        "limit": 0}
    lap("csv", t0)
    if staged:
        checks["clusters_wrong"] = {"value": clusters, "limit": 0}
        checks["res_reads_wrong"] = {"value": res, "limit": 0}
    log("[reference] " + ", ".join(f"{k} {v:.3f} s"
                                   for k, v in spent.items()))
    return checks, rows


def verdict(checks: Dict[str, dict]) -> bool:
    """``correct``: every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_result(result: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
