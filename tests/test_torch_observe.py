"""The port's observation switches against the JAX package's.

``LIME_DUMP_SIM=1`` in ``pipeline.cluster_bwt`` (both executors) prints
the similarity matrix byte for byte as ``lime_tpu``'s does;
``LIME_PROFILE_DIR`` around ``run_fused`` writes a ``torch.profiler``
trace and leaves the CSV as it was; ``utils/memory.py`` reports in
``lime_tpu``'s formats.
"""

import glob
import io
import sys

import numpy as np
import pytest
import torch

from lime_tpu import pipeline as jpipeline
from lime_tpu.config import LimeConfig as JaxConfig
from lime_tpu.utils import memory as jmemory
from lime_tpu_torch import LimeConfig, pipeline, run_paired
from lime_tpu_torch.ops import fused_pipeline
from lime_tpu_torch.utils import memory
from lime_tpu_torch.utils.timing import read_trace, trace_summary

from .synth import make_dataset
from .test_torch_selfcontained import ensure_reference_native

# build and load lime_tpu's native library before any test, whatever
# the other test processes do
ensure_reference_native()
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _dump(out: str) -> str:
    lo = out.index("***FINAL***")
    hi = out.index("***********", lo) + len("***********\n")
    return out[lo:hi]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """test_divergences.py's dump shape (40 pairs, read length 60,
    genomes of 2,000 and 1,500, seed 13), clustered, and ``lime_tpu``'s
    dumps for both executors, u8 and wide counters."""
    ds = make_dataset(str(tmp_path_factory.mktemp("dump")), num_pairs=40,
                      read_len=60, genome_lens=(2000, 1500), seed=13)
    col = ds.collections[0]
    jpipeline.cluster_lcp(col, ds.num_reads, ds.num_genomes, JaxConfig())
    want = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("LIME_DUMP_SIM", "1")
    try:
        for wide in (False, True):
            for executor in ("host", "tpu"):
                cap = _Capture()
                with cap:
                    jpipeline.cluster_bwt(col, ds.read_len, JaxConfig(
                        executor=executor, wide_sim=wide))
                want[executor, wide] = _dump(cap.text)
    finally:
        mp.undo()
    return ds, want


class _Capture:
    """stdout into a string (capsys is function-scoped)."""

    def __enter__(self):
        self._saved, sys.stdout = sys.stdout, io.StringIO()
        return self

    def __exit__(self, *exc):
        self.text = sys.stdout.getvalue()
        sys.stdout = self._saved


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("executor", ["host", "tpu"])
def test_dump_sim_matches_lime_tpu(dumps, executor, wide, monkeypatch,
                                   capsys):
    ds, want = dumps
    assert want["host", wide] == want["tpu", wide]
    col = ds.collections[0]
    pipeline.cluster_lcp(col, ds.num_reads, ds.num_genomes, LimeConfig())
    monkeypatch.setenv("LIME_DUMP_SIM", "1")
    pipeline.cluster_bwt(col, ds.read_len,
                         LimeConfig(executor=executor, wide_sim=wide),
                         device="cpu")
    got = _dump(capsys.readouterr().out)
    assert got == want[executor, wide]
    rows = got.splitlines()[1:-1]
    assert len(rows) == ds.num_reads
    assert all(r.endswith("\t") for r in rows)
    vals = np.array([[int(v) for v in r.split("\t")[:-1]] for r in rows])
    assert vals.shape == (ds.num_reads, ds.num_genomes)
    assert vals.min() >= 0 and vals.max() > 0


def test_dump_sim_off_prints_nothing(dumps, capsys, monkeypatch):
    ds, _ = dumps
    col = ds.collections[0]
    pipeline.cluster_lcp(col, ds.num_reads, ds.num_genomes, LimeConfig())
    monkeypatch.delenv("LIME_DUMP_SIM", raising=False)
    pipeline.cluster_bwt(col, ds.read_len, LimeConfig(executor="host"))
    assert "***FINAL***" not in capsys.readouterr().out


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("profile")),
                        num_pairs=300, read_len=100,
                        genome_lens=(3000, 2500), seed=5)


def _run(ds, path):
    run_paired(ds.collections, path, ds.num_reads, ds.num_genomes,
               ds.lineage_path, ds.read_len, LimeConfig(fused=True),
               device="cpu")
    with open(path, "rb") as f:
        return f.read()


def test_profile_dir_writes_a_trace_and_keeps_the_csv(small, tmp_path,
                                                       monkeypatch):
    plain = _run(small, str(tmp_path / "plain.csv"))
    prof = tmp_path / "trace"
    monkeypatch.setenv("LIME_PROFILE_DIR", str(prof))
    traced = _run(small, str(tmp_path / "traced.csv"))
    assert traced == plain
    path, events = read_trace(str(prof))
    assert path.endswith(".pt.trace.json")
    names = {e.get("name") for e in events}
    # host activity of the run: torch ops of the scoring and the cascade
    assert any(n and n.startswith("aten::") for n in names)
    summary = trace_summary(events)
    assert summary["window_us"] > 0
    assert summary["busy_us"] == 0 and not summary["kernels"]  # no card
    assert fused_pipeline.LAST_RUN["engine"] == "pair"
    assert fused_pipeline.LAST_RUN["trace_export_s"] > 0


def test_profile_dir_covers_the_row_blocked_branch(small, tmp_path,
                                                   monkeypatch):
    """The switch wraps the whole run: the row-blocked mode is traced."""
    plain = _run(small, str(tmp_path / "plain.csv"))
    monkeypatch.setenv("LIME_PROFILE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("LIME_HBM_BUDGET", "1")
    assert _run(small, str(tmp_path / "blocked.csv")) == plain
    assert fused_pipeline.LAST_RUN["engine"] == "blocked"
    assert glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))


def test_no_profiler_without_the_variable(small, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler was made")

    monkeypatch.delenv("LIME_PROFILE_DIR", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    assert _run(small, str(tmp_path / "a.csv"))


SAMPLES = [(0.0, 200_000_000, 0), (0.5, 1_234_567_890, 3_000_000_000),
           (1.0, 900_000_000, 5_500_000_000), (1.52, 100, 7)]


@pytest.mark.parametrize("samples", [SAMPLES, SAMPLES[:1],
                                     [(0.0, 5, 0), (2.25, 9, 0)], []])
def test_memory_profiler_formats_match(samples, tmp_path):
    got, want = memory.MemoryProfiler(), jmemory.MemoryProfiler()
    got._samples, want._samples = list(samples), list(samples)
    assert got.report() == want.report()
    assert got.series() == want.series() == samples
    got.write_csv(str(tmp_path / "a.csv"))
    want.write_csv(str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()


@pytest.mark.parametrize("devices", [
    {}, {"cuda:0": {"bytes_in_use": 3_500_000_000,
                    "peak_bytes_in_use": 9_100_000_000}}])
def test_memory_report_format_matches(devices, monkeypatch):
    host = {"rss_bytes": 1_500_000_000, "peak_rss_bytes": 2_250_000_000}
    for mod in (memory, jmemory):
        monkeypatch.setattr(mod, "host_memory_stats", lambda: dict(host))
    monkeypatch.setattr(memory, "_device_stats", lambda device=None: devices)
    monkeypatch.setattr("lime_tpu.utils.timing.device_memory_stats",
                        lambda: devices)
    assert memory.memory_report() == jmemory.memory_report()


def test_host_memory_stats_keys_and_cpu_sampling():
    got = memory.host_memory_stats()
    assert set(got) == set(jmemory.host_memory_stats())
    assert got["rss_bytes"] > 0 and got["peak_rss_bytes"] > 0
    assert memory._device_stats(CPU) == {}
    with memory.MemoryProfiler(interval=0.01, track_hbm=True,
                               device=CPU) as prof:
        np.ones(1 << 20).sum()
    series = prof.series()
    assert len(series) >= 2 and all(s[2] == 0 for s in series)
    assert "hbm" not in prof.report()
    assert memory.memory_report(CPU).startswith("host rss=")
