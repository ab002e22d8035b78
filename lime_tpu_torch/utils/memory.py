"""Memory accounting: host RSS and device memory (torch's CUDA allocator).

Copy of ``lime_tpu/utils/memory.py``, the replacement for the original
tool's malloc_count interposition (external/malloc_count/, linked into
OMP=0 builds for the papers' memory measurements): current and peak host
resident set, and per-device bytes in use and peak.  The device numbers
come from :func:`lime_tpu_torch.utils.timing.device_memory_stats` (one
flat dict per CUDA device) where ``lime_tpu`` reads jax's per-device
statistics; a CPU device reports none, so its HBM column is 0, as
``lime_tpu`` prints when no device reports statistics.
"""

from __future__ import annotations

import resource
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .timing import device_memory_stats


def host_memory_stats() -> Dict[str, int]:
    """Current and peak host RSS in bytes."""
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    current = 0
    try:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * resource.getpagesize()
    except OSError:
        pass
    return {"rss_bytes": current, "peak_rss_bytes": peak_kb * 1024}


def _device_stats(device=None) -> Dict[str, Dict[str, int]]:
    """``{name: {"bytes_in_use", "peak_bytes_in_use"}}`` for ``device``,
    or for every visible CUDA device when it is None; devices that report
    nothing (the CPU) are left out."""
    if device is not None:
        devices = [torch.device(device)]
    elif torch.cuda.is_available():
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = []
    out = {}
    for d in devices:
        s = device_memory_stats(d)
        if s:
            out[str(d)] = s
    return out


class MemoryProfiler:
    """Sampling time-series memory profile — the malloc_count replacement.

    A daemon thread samples host RSS (and, with ``track_hbm``, the device
    bytes in use summed over ``device``, or over every visible CUDA device
    when it is None) every ``interval`` seconds.  Use as a context
    manager; ``series()`` returns ``(t, rss_bytes, hbm_bytes)`` tuples and
    ``report()`` a one-line summary with the peak and its timestamp.
    """

    def __init__(self, interval: float = 0.5, track_hbm: bool = False,
                 device=None):
        self.interval = interval
        self.track_hbm = track_hbm
        self.device = device
        self._samples: List[Tuple[float, int, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    def _sample_once(self) -> None:
        rss = host_memory_stats()["rss_bytes"]
        hbm = 0
        if self.track_hbm:
            hbm = sum(s["bytes_in_use"]
                      for s in _device_stats(self.device).values())
        self._samples.append((time.monotonic() - self._t0, rss, hbm))

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample_once()

    def __enter__(self) -> "MemoryProfiler":
        self._t0 = time.monotonic()
        self._sample_once()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self._sample_once()

    def series(self) -> List[Tuple[float, int, int]]:
        return list(self._samples)

    def report(self) -> str:
        if not self._samples:
            return "memory profile: no samples"
        t_peak, rss_peak, _ = max(self._samples, key=lambda s: s[1])
        hbm_peak = max(s[2] for s in self._samples)
        out = (f"memory profile: {len(self._samples)} samples over "
               f"{self._samples[-1][0]:.1f}s, host peak "
               f"{rss_peak / 1e9:.2f}GB @ {t_peak:.1f}s")
        if hbm_peak:
            out += f", hbm peak {hbm_peak / 1e9:.2f}GB"
        return out

    def write_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("t_s,rss_bytes,hbm_bytes\n")
            for t, rss, hbm in self._samples:
                f.write(f"{t:.3f},{rss},{hbm}\n")


def memory_report(device=None) -> str:
    """Human-readable one-shot memory report: the host, then ``device``
    (or every visible CUDA device when it is None)."""
    h = host_memory_stats()
    lines = [f"host rss={h['rss_bytes'] / 1e9:.2f}GB "
             f"peak={h['peak_rss_bytes'] / 1e9:.2f}GB"]
    for dev, s in _device_stats(device).items():
        lines.append(f"{dev} hbm={s['bytes_in_use'] / 1e9:.2f}GB "
                     f"peak={s['peak_bytes_in_use'] / 1e9:.2f}GB")
    return "\n".join(lines)
