"""Operators of the port: the pair-hit, banded and dense-cluster kernels,
packed and one-byte-per-row pair scoring, the classify program and the fused pipeline on the device; on the host, copies of
``lime_tpu``'s cluster scan, numpy exact scorer and numpy cascade.

``find_clusters``, ``normalize_scores``, ``score_clusters`` and
``classify_reads`` are re-exported here, as ``lime_tpu.ops`` does, and
imported at first use: importing the package, which every
``ops.<module>`` import does, loads nothing else (no CUDA library either;
the kernels build at their first launch), so ``kernel_ab`` can load
another checkout's kernel modules alone.  The numpy ``find_clusters`` and
``score_clusters`` are what the stages run when the native library is
missing (``native.available()`` False), as in ``lime_tpu``.
"""

import importlib

__all__ = ["find_clusters", "normalize_scores", "score_clusters",
           "classify_reads"]

_EXPORTS = {"find_clusters": "cluster_scan", "normalize_scores": "scoring",
            "score_clusters": "scoring", "classify_reads": "classify_ops"}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
