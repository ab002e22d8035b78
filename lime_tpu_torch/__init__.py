"""lime-tpu on PyTorch and CUDA, on one NVIDIA GPU.

A port of ``lime_tpu``'s staged executor (the default ``LimeConfig()``:
cluster_lcp -> cluster_bwt -> classify, with their checkpoint files), its
fused serving run (``LimeConfig(fused=True)``, every cluster scored on
the device) and its banded engine to torch, with the TPU's Pallas
kernels rewritten as CUDA C++ for Hopper (``csrc/pair_hits.cu``,
``csrc/banded_pairs.cu``).  The framework-free host layer — the C++
planners and scorer, the index formats, the config, the numpy cascade —
is ``lime_tpu``'s own and is imported from there; nothing here imports
jax.

Quick start::

    from lime_tpu_torch import LimeConfig, run_paired
    summary = run_paired([f1f, f1rc, f2f, f2rc], "out.csv",
                         num_reads, num_genomes, "LineageFile.csv",
                         read_len=100, config=LimeConfig(), device="cuda")
"""

from lime_tpu.config import DEFAULT_CONFIG, LimeConfig  # noqa: F401

from .pipeline import (  # noqa: F401
    classify,
    cluster_bwt,
    cluster_lcp,
    run_paired,
    run_single,
)

__version__ = "0.1.0"
