"""The plain reference against the port on a tiny dataset, its control,
and its independence from the program."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.data.dataset import make_dataset
from benchmark.reference import compare, plain

from .tiny import ROOT, copy_benchmark, tiny_config, tiny_traffic

ISOLATED = ("reference", "data")
FORBIDDEN = ("jax", "jaxlib", "flax", "lime_tpu", "lime_tpu_torch")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_dataset(tiny_config(), tiny_traffic("tiny_fused"), 123,
                        str(tmp_path_factory.mktemp("tiny")), "cpu")


def reference(ds, device="cpu", dtype=torch.float32):
    """(planes, clusters per collection, CSV lines) of the reference."""
    config = tiny_config()
    planes, clusters = [], []
    for path in ds.collections:
        ebwt, lcp, da = plain.load_index(path, device)
        p_start, lens = plain.find_clusters(lcp, da, ds.num_reads, 16)
        clusters.append((p_start.cpu().numpy(), lens.cpu().numpy()))
        planes.append(plain.score_matrix(ebwt, da, p_start, lens,
                                         ds.num_reads, ds.num_genomes,
                                         pair_chunk=1 << 12))
    lines = plain.csv_lines(*plain.classify(
        planes, ds.read_len, 16, config["beta"], config["error_tolerance"],
        ds.taxids[0], dtype=dtype, block=128))
    return planes, clusters, lines


def _port_run(ds, tmp_path, fused: bool):
    from lime_tpu_torch import LimeConfig, run_paired
    out = str(tmp_path / ("fused.csv" if fused else "staged.csv"))
    run_paired(ds.collections, out, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, LimeConfig(fused=fused),
               keep_results=True, device="cpu")
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_reference_agrees_with_run_paired(tiny, tmp_path, fused):
    planes, clusters, lines = reference(tiny)
    out = _port_run(tiny, tmp_path, fused)
    assert compare.csv_rows_wrong(out, lines) == 0
    with open(out) as f:
        assert f.read() == "\n".join(lines) + "\n"
    kinds = {line.split(",")[0] for line in lines[1:]}
    assert {"C", "U"} <= kinds
    if not fused:
        for path, plane, (p_start, lens) in zip(tiny.collections, planes,
                                                clusters):
            assert compare.clusters_wrong(f"{path}.16.clrs", p_start,
                                          lens) == 0
            pos, recs = plain.res_records(plane, tiny.read_len, 16, 0.25)
            assert compare.res_reads_wrong(path + ".res", pos, recs) == 0


def test_scorer_agrees_with_the_ports_numpy_scorer(tiny):
    from lime_tpu_torch import LimeConfig
    from lime_tpu_torch.ops.cluster_scan import find_clusters
    from lime_tpu_torch.ops.scoring import score_clusters
    planes, clusters, _ = reference(tiny)
    for path, plane, (p_start, lens) in zip(tiny.collections, planes,
                                            clusters):
        lcp = np.fromfile(path + ".lcp", "<u4")
        da = np.fromfile(path + ".da", "<u4")
        ebwt = np.fromfile(path + ".ebwt", np.uint8)
        s, n = find_clusters(lcp, da, tiny.num_reads, 16)
        np.testing.assert_array_equal(s, p_start)
        np.testing.assert_array_equal(n, lens)
        want = score_clusters(s, n, da, ebwt, tiny.num_reads,
                              tiny.num_genomes, LimeConfig())
        np.testing.assert_array_equal(plane.numpy(), want)


def test_scorer_wraps_saturates_and_runs_the_waterfall():
    """One cluster: a read row of 300 'A' symbols (its counter wraps to
    44), genome rows of 300 'A' (saturating at 255) and an IUPAC 'R'."""
    ebwt = torch.tensor([ord("A")] * 300 + [ord("A")] * 300 + [ord("R")] * 3
                        + [ord("C")] * 2, dtype=torch.uint8)
    da = torch.tensor([0] * 300 + [1] * 300 + [2] * 3 + [0] * 2)
    plane = plain.score_matrix(ebwt, da, torch.tensor([0]),
                               torch.tensor([605]), 1, 2)
    # genome 0: min(300 % 256, min(300, 255)) = 44
    # genome 1: min(44, 0) for A; the waterfall lets R absorb 3 of the
    # read's leftover A; the read's 2 C find nothing
    assert plane.tolist() == [[44, 3]]


@pytest.mark.parametrize("cell", ["tiny-fused", "tiny-staged"])
def test_control_in_bfloat16_is_not_correct(tmp_path, cell):
    """The reference in the program's place, judged by the harness: in
    bfloat16 it fails, in float32 it passes."""
    from benchmark import control
    root = copy_benchmark(str(tmp_path / "copy"))
    out = control.control_run(cell, 123, "cpu", root)
    assert not out["correct"], out["checks"]
    assert out["checks"]["csv_rows_wrong"]["value"] > 0
    if cell == "tiny-staged":
        assert out["checks"]["clusters_wrong"]["value"] == 0
        assert out["checks"]["res_reads_wrong"]["value"] > 0
    sound = control.control_run(cell, 123, "cpu", root, torch.float32)
    assert sound["correct"], sound["checks"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_and_data_import_nothing_of_the_program():
    bad = []
    for sub in ISOLATED:
        d = os.path.join(ROOT, "benchmark", sub)
        for name in os.listdir(d):
            if name.endswith(".py"):
                bad += [f"{sub}/{name}: {m}"
                        for m in _imports(os.path.join(d, name))
                        if m.split(".")[0] in FORBIDDEN]
    assert not bad
    code = ("import sys\n"
            f"for n in {FORBIDDEN!r}: sys.modules[n] = None\n"
            "import benchmark.reference.plain, benchmark.reference.compare\n"
            "import benchmark.data.dataset, benchmark.roofline\n"
            "import benchmark.device_trace\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_cpu(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    planes_c, _, lines_c = reference(tiny)
    planes_g, _, lines_g = reference(tiny, "cuda")
    for a, b in zip(planes_c, planes_g):
        assert torch.equal(a, b.cpu())
    assert lines_c == lines_g
