"""Device memory statistics for the port's phase report.

Phase times come from ``lime_tpu.utils.timing.PhaseTimer`` (host clock,
framework-free).  This replaces ``lime_tpu.utils.timing
.device_memory_stats``, which reads jax's devices.
"""

from __future__ import annotations

from typing import Dict

import torch


def device_memory_stats(device) -> Dict[str, int]:
    """Bytes in use and peak bytes allocated by torch on ``device``
    (CUDA); empty for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0))}
