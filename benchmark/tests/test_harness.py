"""The harness on the CPU, in a temporary copy of the benchmark: a cell,
a configuration, a traffic mix and a metric reader added as new files
and entries only are found and run; sound runs are correct; and with the
timed path broken underneath, ``correct`` comes out false."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from .tiny import ROOT, copy_benchmark


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    dest = copy_benchmark(str(tmp_path / "copy"))
    before = _digests(ROOT)
    bench = os.path.join(dest, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        config = json.load(f)
    config.update(name="found", genomes=40)
    with open(os.path.join(bench, "configs", "found.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "found_mix.json"), "w") as f:
        json.dump({"name": "found_mix", "pairs_per_job": 300,
                   "lime_config": {"fused": True}, "keep_results": False}, f)
    with open(os.path.join(bench, "metrics", "jobs_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.n_jobs)\n")
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "found", "source": "tests",
                            "file": "benchmark/configs/found.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "found-cell", "config": "found",
                              "traffic": "found_mix", "chips": 1,
                              "why": "tests"})
    spec["per_layer"].append({"name": "jobs_seen", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "pairs_per_s",
                              "workloads": ["found-cell"]})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    code = ("import json, sys\n"
            "sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "sys.meta_path.insert(0, harness.RefuseForbidden())\n"
            "out = [harness.run_cell('found-cell', 5, 0.5, t, 'cpu',"
            " root='.') for t in (False, True)]\n"
            "assert not harness.forbidden_loaded()\n"
            "print(json.dumps(out))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=dest,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    plain_run, traced = json.loads(run.stdout.strip().splitlines()[-1])
    assert plain_run["correct"] and traced["correct"]
    assert set(plain_run["metrics"]) == {"pairs_per_s", "peak_dev_gib",
                                         "setup_s"}
    assert traced["metrics"]["jobs_seen"]["value"] == traced["attempted"]
    assert set(traced["metrics"]) == {"jobs_seen"}
    assert list(traced)[-1] == "checks"
    assert "40 genomes" in run.stderr
    # nothing the benchmark already had was edited
    after = _digests(dest)
    assert all(after[k] == v for k, v in before.items())


@pytest.fixture(scope="module")
def harness_copy(tmp_path_factory):
    from benchmark import harness
    return harness, copy_benchmark(str(tmp_path_factory.mktemp("copy")))


def _run(harness_copy, cell, device="cpu", trace=False):
    harness, dest = harness_copy
    return harness.run_cell(cell, 2**31 + 99, 0.3, trace, device, root=dest)


@pytest.mark.parametrize("cell", ["tiny-fused", "tiny-staged"])
def test_sound_runs_are_correct(harness_copy, cell):
    result = _run(harness_copy, cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1


def _alter_taxid(res):
    i = int((res.types == 1).nonzero()[0][0])
    res.taxid[i] += 1
    return res


def test_fused_answer_altered_is_not_correct(harness_copy, monkeypatch):
    from lime_tpu_torch import pipeline
    real = pipeline.run_fused
    monkeypatch.setattr(pipeline, "run_fused",
                        lambda *a, **k: _alter_taxid(real(*a, **k)))
    result = _run(harness_copy, "tiny-fused")
    assert not result["correct"]
    assert result["checks"]["csv_rows_wrong"]["value"] == result["attempted"]


def test_staged_answer_altered_is_not_correct(harness_copy, monkeypatch):
    from lime_tpu_torch import pipeline
    real = pipeline.classify_reads_torch
    monkeypatch.setattr(pipeline, "classify_reads_torch",
                        lambda *a, **k: _alter_taxid(real(*a, **k)))
    result = _run(harness_copy, "tiny-staged")
    assert not result["correct"]
    assert result["checks"]["csv_rows_wrong"]["value"] > 0


def test_staged_score_altered_is_not_correct(harness_copy, monkeypatch):
    from lime_tpu_torch import pipeline
    real = pipeline.write_results_bin

    def altered(prefix, rows, beta):
        rows = rows.copy()
        r = int((rows.max(axis=1) > 0.5).nonzero()[0][0])
        rows[r, rows[r].argmax()] *= 0.99
        return real(prefix, rows, beta)

    monkeypatch.setattr(pipeline, "write_results_bin", altered)
    result = _run(harness_copy, "tiny-staged")
    assert not result["correct"]
    assert result["checks"]["res_reads_wrong"]["value"] > 0


def test_staged_cluster_dropped_is_not_correct(harness_copy, monkeypatch):
    from lime_tpu_torch import native
    real = native.plan_clusters

    def dropped(*a, **k):
        starts, lens = real(*a, **k)
        return starts[:-1], lens[:-1]

    monkeypatch.setattr(native, "plan_clusters", dropped)
    result = _run(harness_copy, "tiny-staged")
    assert not result["correct"]
    assert result["checks"]["clusters_wrong"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-fused", "tiny-staged"])
def test_tiny_cells_on_the_card_are_correct(harness_copy, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = _run(harness_copy, cell, device="cuda", trace=True)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["device_roofline"]["value"] <= 100
