"""Engines over position streams: the banded core of
``lime_tpu/parallel/sharded.py`` (the SPMD engines are not ported yet)."""
