"""What a ``torch.profiler`` chrome trace says of the device over the
measured window.

The union of device intervals is ``lime_tpu_torch.utils.timing.
trace_summary``'s arithmetic, copied: kernels, copies and sets are device
work, overlapping intervals count once.  Here it is clipped to the
window, which the harness marks with a ``bench.window`` range.  Idle gaps
are named by the host range open at their midpoint: the harness's
``bench.job`` around each job, else ``between jobs``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

#: chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGE = "user_annotation"


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _complete(events: List[dict], cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def window(events: List[dict], name: str = "bench.window"
           ) -> Tuple[float, float]:
    """(start, end) in us of the one host range called ``name``."""
    found = [e for e in _complete(events, (HOST_RANGE,))
             if e.get("name") == name]
    if len(found) != 1:
        raise RuntimeError(f"expected one {name!r} range, found "
                           f"{len(found)}")
    ts = float(found[0]["ts"])
    return ts, ts + float(found[0].get("dur", 0))


def busy_intervals(spans: List[Tuple[float, float]], lo: float, hi: float
                   ) -> List[Tuple[float, float]]:
    """The union of ``spans`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that ``busy`` leaves uncovered."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _label_gaps(gaps, ranges: List[dict]) -> Dict[str, float]:
    """Idle us per host range open at each gap's midpoint (the innermost
    where ranges nest)."""
    out: Dict[str, float] = {}
    if not gaps:
        return out
    start = np.array([float(r["ts"]) for r in ranges])
    end = start + np.array([float(r.get("dur", 0)) for r in ranges])
    names = [r["name"] for r in ranges]
    gaps = np.asarray(gaps, dtype=np.float64)
    for lo in range(0, len(gaps), 1024):
        g = gaps[lo:lo + 1024]
        mid = (g[:, 0] + g[:, 1]) / 2
        inside = (start[None, :] <= mid[:, None]) & (mid[:, None] <= end)
        dur = np.where(inside, (end - start)[None, :], np.inf)
        best = dur.argmin(axis=1)
        for k, (a, b) in enumerate(g):
            name = (names[best[k]] if inside[k].any() else "between jobs")
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def summarize(events: List[dict], top: int = 10) -> dict:
    """``window_s``, ``busy_s`` (union of device work in the window),
    ``device_ops`` (the ``top`` device operations by summed time in the
    window, ``[name, s]``) and ``idle_gaps`` (idle time by the host range
    it fell in, the ``top`` largest, ``[name, s]``)."""
    lo, hi = window(events)
    device = _complete(events, DEVICE_CATEGORIES)
    spans, per_op = [], {}
    for e in device:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        spans.append((a, b))
        clipped = min(b, hi) - max(a, lo)
        if clipped > 0:
            per_op[e["name"]] = per_op.get(e["name"], 0.0) + clipped
    busy = busy_intervals(spans, lo, hi)
    ranges = [r for r in _complete(events, (HOST_RANGE,))
              if r.get("name") == "bench.job"]
    idle = _label_gaps(idle_gaps(busy, lo, hi), ranges)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": [[name[:160], us / 1e6] for name, us in ops],
            "idle_gaps": [[name[:160], us / 1e6] for name, us in gaps]}
