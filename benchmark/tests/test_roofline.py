"""The roofline's work count and the trace arithmetic on hand-counted
cases."""

import json

import pytest
import torch

from benchmark import device_trace, roofline
from benchmark.reference import plain


def test_kept_cluster_rows_and_plane_bytes_by_hand():
    # 2 reads (docs 0, 1), 3 genomes (docs 2-4), alpha 2:
    #   rows 0-2: lcp 0 3 2 -> cluster rows 0..2, docs 0 2 3: kept
    #   rows 3-4: lcp 0 5   -> cluster rows 3..4, docs 2 4: genomes only
    #   rows 5-7: lcp 1 4 4 -> cluster rows 5..7, docs 1 0 1: reads only
    #   rows 8-9: lcp 0 2   -> cluster rows 8..9, docs 1 3: kept
    lcp = torch.tensor([0, 3, 2, 0, 5, 1, 4, 4, 0, 2])
    da = torch.tensor([0, 2, 3, 2, 4, 1, 0, 1, 1, 3])
    p_start, lens = plain.find_clusters(lcp, da, 2, 2)
    assert p_start.tolist() == [0, 8] and lens.tolist() == [3, 2]
    rows = int(lens.sum())
    # 5 rows x 5 B, then 4 planes of 2 reads x 128 padded genome lanes,
    # written once and read once
    assert roofline.job_bytes(rows, 2, 3, 4) == 5 * 5 + 2 * 4 * 2 * 128
    assert roofline.g_pad(930) == 1024 and roofline.g_pad(3423) == 3456
    assert roofline.least_seconds(3_350_000_000_000) == pytest.approx(1.0)


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_idle_and_gaps_by_hand(tmp_path):
    events = [
        _x("user_annotation", "bench.window", 100, 100),  # [100, 200]
        _x("user_annotation", "bench.job", 100, 100),
        _x("user_annotation", "phase.torch_fused_pipeline.plan", 100, 30),
        _x("kernel", "k1", 90, 20),     # [100, 110] inside the window
        _x("kernel", "k2", 105, 10),    # overlaps k1: union [100, 115]
        _x("gpu_memcpy", "copy", 150, 10),  # [150, 160]
        _x("kernel", "k1", 195, 20),    # [195, 200] inside
        _x("cpu_op", "aten::add", 120, 50),  # host op: not device work
        _x("gpu_user_annotation", "bench.job", 100, 100),  # not work
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 130},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = device_trace.summarize(device_trace.load_events(str(path)))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((15 + 10 + 5) * 1e-6)
    ops = dict(s["device_ops"])
    assert ops["k1"] == pytest.approx(15e-6)  # 10 + 5 inside the window
    assert ops["k2"] == pytest.approx(10e-6)
    assert ops["copy"] == pytest.approx(10e-6)
    gaps = dict(s["idle_gaps"])
    # [115, 150] and [160, 195] lie inside the job; other host ranges,
    # such as the program's own, name no gap
    assert gaps == pytest.approx({"bench.job": 70e-6})
    events[1]["dur"] = 50  # the job [100, 150] holds 132.5, not 177.5
    events[2]["dur"] = 100  # a host range over both gaps
    path.write_text(json.dumps({"traceEvents": events}))
    gaps = dict(device_trace.summarize(
        device_trace.load_events(str(path)))["idle_gaps"])
    assert gaps == pytest.approx({"bench.job": 35e-6,
                                  "between jobs": 35e-6})
