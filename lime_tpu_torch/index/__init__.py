"""Index construction: multi-string eBWT / LCP / DA from FASTA (copy of
``lime_tpu/index/__init__.py``).

Replaces the reference's external L0 toolchain (Install_tools_preprocessing.sh
clones seqtk + BCR_LCP_GSA + egsa + eGap; Preprocessing.sh:81-196 drives them)
with self-contained builders producing the same three flat files:

- :func:`build_index` — vectorized numpy prefix-doubling builder (portable),
  the C++ SA-IS builder (``engine="native"``/``"auto"``) and the on-device
  prefix-doubling builder (``engine="tpu"``, :mod:`.torch_builder`).
- :mod:`.external` — blockwise build + on-disk merge beyond RAM.

Conventions (matching BCR/eGap): every sequence is terminated by '$'; the
terminator of sequence i sorts before every nucleotide and before the
terminator of sequence j>i; the merged collection has sum(len_i + 1) rows;
lcp[0] = 0 and terminators never match across sequences.
"""

from .builder import build_index, build_index_files, merge_collections  # noqa: F401
