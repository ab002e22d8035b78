"""The readers of the fused path's width counters, ``dense_gcells`` and
``dense_lane_fill``, on hand-made job records: each returns its mean per
job, and None where no job has the counters (a program without them,
as before they existed)."""

import pytest

from benchmark.harness import Context, load_reader


def _fused(counts=None):
    rec = {"phases": {"plan": 2.0, "dense": 1.5, "dispatch": 0.75}}
    if counts is not None:
        rec["counts"] = counts
    return {"fused": rec}


def _counts(chunks, lanes, cols):
    total = chunks * 2048 * 8
    return {"plan_passes": 4, "dense_cells": total * cols,
            "dense_lanes": lanes, "dense_lanes_total": total,
            "cascade_block": 2048}


# 300 and 100 chunks at G_pad 24,832, whose 8 tiles compute 25,600
# columns; half and a quarter of the lanes
JOBS = [_fused(_counts(300, 300 * 8192, 25600)),
        _fused(_counts(100, 100 * 4096, 25600))]
# the parent program's records: the planner's counter, none of these
OLD = [_fused({"plan_passes": 4}), _fused()]


def test_dense_gcells_reads_the_mean_per_job():
    reader = load_reader("dense_gcells")
    want = (300 + 100) / 2 * 16384 * 25600 / 1e9
    assert reader.read(Context(JOBS, None, 0.0)) == pytest.approx(want)
    # a job without the counter counts 0, as for the spans
    assert reader.read(Context(JOBS[:1] + OLD[:1], None, 0.0)) == \
        pytest.approx(300 * 16384 * 25600 / 1e9 / 2)


def test_dense_lane_fill_reads_the_mean_share():
    reader = load_reader("dense_lane_fill")
    assert reader.read(Context(JOBS, None, 0.0)) == pytest.approx(37.5)
    # a job with no dense product has no share, and is left out
    none = _fused(_counts(0, 0, 25600))
    assert reader.read(Context(JOBS[:1] + [none], None, 0.0)) == \
        pytest.approx(50.0)
    assert reader.read(Context([none], None, 0.0)) is None


@pytest.mark.parametrize("name", ["dense_gcells", "dense_lane_fill"])
def test_width_readers_find_nothing_in_the_parent(name):
    reader = load_reader(name)
    assert reader.read(Context(OLD, None, 0.0)) is None
    staged = [{"staged": {"phases": {"classify": 4.0}, "stages": {}}}]
    assert reader.read(Context(staged, None, 0.0)) is None
