"""Per-phase wall-clock timing and device memory statistics.

:class:`PhaseTimer` and :data:`LAST_RUN` are copies of
``lime_tpu/utils/timing.py``'s (host clock, framework-free).
:func:`device_memory_stats` reads torch's CUDA allocator in place of the
original's jax device statistics.  :func:`event_ms` and :func:`graph_ms`
time device work with CUDA events, per call or as CUDA-graph replays.
:func:`read_trace` and :func:`trace_summary` read the ``torch.profiler``
trace that ``LIME_PROFILE_DIR`` writes.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import logging
import os
import re
import threading
import time
from typing import Dict, List, Tuple

import torch

logger = logging.getLogger("lime_tpu_torch")

#: Phase breakdown of the most recent completed PhaseTimer.report(), for
#: benchmark tooling: {"phases": {label: seconds}, "gbps": {label: GB/s},
#: "total": seconds}.  The reference offers only per-thread wtime prints;
#: a bench that cannot see phases cannot be audited (round-2 lesson).
LAST_RUN: dict = {}


class PhaseTimer:
    def __init__(self, name: str):
        self.name = name
        self.phases: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self._start = time.perf_counter()
        # the job-shop engine times phases from concurrent worker
        # threads; unlocked read-modify-write would drop one worker's
        # seconds from the report the bench scoreboard reads
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, label: str, nbytes: int = 0):
        """Time a phase; ``nbytes`` of data streamed adds a GB/s figure to
        the report (the roofline view the reference lacks — its per-thread
        wtime prints give seconds only, src/ClusterLCP.cpp:273-278)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.phases[label] = self.phases.get(label, 0.0) + (
                    time.perf_counter() - t0)
                if nbytes:
                    self.bytes[label] = self.bytes.get(label, 0) + nbytes

    def add_bytes(self, label: str, nbytes: int) -> None:
        with self._lock:
            self.bytes[label] = self.bytes.get(label, 0) + nbytes

    def total(self) -> float:
        return time.perf_counter() - self._start

    def gbps(self, label: str) -> float:
        t = self.phases.get(label, 0.0)
        return (self.bytes.get(label, 0) / 1e9 / t) if t else 0.0

    def report(self) -> None:
        def fmt(k, v):
            if k in self.bytes:
                return f"{k}={v:.3f}s({self.gbps(k):.2f}GB/s)"
            return f"{k}={v:.3f}s"

        parts = " ".join(fmt(k, v) for k, v in self.phases.items())
        logger.info("%s: %s total=%.3fs", self.name, parts, self.total())
        LAST_RUN.clear()
        LAST_RUN.update({
            "name": self.name,
            "phases": {k: round(v, 3) for k, v in self.phases.items()},
            "gbps": {k: round(self.gbps(k), 3) for k in self.bytes},
            "total": round(self.total(), 3),
        })


def device_memory_stats(device) -> Dict[str, int]:
    """Bytes in use and peak bytes allocated by torch on ``device``
    (CUDA); empty for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0))}


def event_ms(fn, reps: int = 3) -> float:
    """Median time of one call of ``fn`` over ``reps`` calls after a
    warm-up, from CUDA events recorded just before and just after the
    call: the host's own time inside ``fn`` counts where the device waits
    for it."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return float(times[len(times) // 2])


def graph_ms(calls, repeat: int = 10) -> float:
    """Device time of one pass over ``calls`` (kernel launches) with no
    host work between the launches: a CUDA graph holds ``repeat`` passes
    back to back, and :func:`event_ms` of a replay is divided by
    ``repeat``."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeat):
            for call in calls:
                call()
    ms = event_ms(graph.replay) / repeat
    del graph
    return ms


#: chrome-trace categories of device activity in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(prof_dir: str) -> Tuple[str, List[dict]]:
    """``(path, events)`` of the one trace that
    ``torch.profiler.tensorboard_trace_handler`` wrote into ``prof_dir``
    (``*.pt.trace.json``, or ``.json.gz``); raises unless there is
    exactly one."""
    files = sorted(glob.glob(os.path.join(prof_dir, "*.pt.trace.json*")))
    if len(files) != 1:
        raise RuntimeError(f"expected one trace in {prof_dir}, found "
                           f"{files}")
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as f:
        return files[0], json.load(f)["traceEvents"]


def trace_summary(events: List[dict]) -> dict:
    """What a trace says of the device.

    ``window_us``: from the first to the last complete event of any kind;
    ``busy_us``: the union of the kernel and copy intervals, and
    ``busy_share`` its share of the window; ``kernels``: per kernel name,
    ``[launches, summed device us]``.
    """
    lo, hi = float("inf"), float("-inf")
    kernels: Dict[str, list] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if e.get("cat") in DEVICE_CATEGORIES:
            spans.append((ts, ts + dur))
            if e["cat"] == "kernel":
                k = kernels.setdefault(e["name"], [0, 0.0])
                k[0] += 1
                k[1] += dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(hi - lo, 0.0)
    return {"window_us": window, "busy_us": busy,
            "busy_share": busy / window if window > 0 else 0.0,
            "kernels": kernels}


def pair_kernel_launches(kernels: Dict[str, list]) -> Dict[int, int]:
    """Launches of ``pair_hits_count_kernel<CAP>`` per cap among
    :func:`trace_summary`'s kernels (names demangled or mangled)."""
    out: Dict[int, int] = {}
    for name, (count, _) in kernels.items():
        if "pair_hits_count_kernel" not in name:
            continue
        m = re.search(r"pair_hits_count_kernel(?:<|ILi)(\d+)", name)
        cap = int(m.group(1)) if m else -1
        out[cap] = out.get(cap, 0) + count
    return out
