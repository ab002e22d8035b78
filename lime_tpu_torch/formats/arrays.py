"""Readers/writers for the flat index arrays and cluster artifacts (copy of
``lime_tpu/formats/arrays.py``).

File layouts (all little-endian, no headers) interoperable with the
reference binaries:

- ``<fasta>.ebwt`` — u8 symbol per eBWT position (reference
  src/EGSAtoBCR.cpp:81)
- ``<fasta>.lcp``  — u32 per position (src/EGSAtoBCR.cpp:82)
- ``<fasta>.da``   — u32 document id per position (src/EGSAtoBCR.cpp:83)
- ``<fasta>.<alpha>.clrs`` — (u64 p_start, u64 len) per alpha-cluster
  (src/Tools.h:85-88, src/ClusterLCP.cpp:233-234)
- ``<prefix>.out`` — aux metadata handshake between stages 1 and 2:
  u32 num_reads, u32 num_genomes, u32 alpha, u64 max_len, u64 n_clusters
  (src/ClusterLCP.cpp:304-308)
- ``<fasta>.docs`` — u64 sequence count (reference create_docs.cpp:32)
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Tuple

import numpy as np

from ..constants import DT_CLUSTER, DT_DOC, DT_LCP, DT_SYMBOL


def _load(path: str, dtype: np.dtype, mmap: bool) -> np.ndarray:
    size = os.path.getsize(path)
    if size == 0:
        return np.empty(0, dtype=dtype)
    if mmap:
        return np.memmap(path, dtype=dtype, mode="r")
    # fromfile beats a memmap view for whole-array consumers: repeated
    # vector ops over a mapped view pay page-walk overhead every pass
    # (~20x slower on the pipeline's scan inputs).
    return np.fromfile(path, dtype=dtype)


def open_lcp(fasta_path: str, mmap: bool = False) -> np.ndarray:
    return _load(fasta_path + ".lcp", DT_LCP, mmap)


def open_da(fasta_path: str, mmap: bool = False) -> np.ndarray:
    return _load(fasta_path + ".da", DT_DOC, mmap)


def open_ebwt(fasta_path: str, mmap: bool = False) -> np.ndarray:
    return _load(fasta_path + ".ebwt", DT_SYMBOL, mmap)


def write_index_arrays(fasta_path: str, ebwt: np.ndarray, lcp: np.ndarray,
                       da: np.ndarray) -> None:
    """Write the three flat index files next to ``fasta_path``."""
    if not (len(ebwt) == len(lcp) == len(da)):
        raise ValueError("ebwt/lcp/da must have equal length")
    np.asarray(ebwt, dtype=DT_SYMBOL).tofile(fasta_path + ".ebwt")
    np.asarray(lcp, dtype=DT_LCP).tofile(fasta_path + ".lcp")
    np.asarray(da, dtype=DT_DOC).tofile(fasta_path + ".da")


def aux_path_for(fasta_path: str) -> str:
    """``<prefix>.out`` where prefix strips from the first '.fasta'.

    Mirrors ``fileFasta.substr(0, fileFasta.find(".fasta")) + ".out"``
    (reference src/ClusterLCP.cpp:294).  If '.fasta' does not occur the whole
    name is kept, as std::string::find==npos makes substr return everything.
    """
    idx = fasta_path.find(".fasta")
    prefix = fasta_path if idx < 0 else fasta_path[:idx]
    return prefix + ".out"


def clusters_path_for(fasta_path: str, alpha: int) -> str:
    return f"{fasta_path}.{alpha}.clrs"


@dataclasses.dataclass(frozen=True)
class AuxMetadata:
    num_reads: int
    num_genomes: int
    alpha: int
    max_len: int
    n_clusters: int


_AUX_STRUCT = struct.Struct("<IIIQQ")


def write_aux(path: str, meta: AuxMetadata) -> None:
    with open(path, "wb") as f:
        f.write(_AUX_STRUCT.pack(meta.num_reads, meta.num_genomes, meta.alpha,
                                 meta.max_len, meta.n_clusters))


def read_aux(path: str) -> AuxMetadata:
    with open(path, "rb") as f:
        data = f.read(_AUX_STRUCT.size)
    if len(data) != _AUX_STRUCT.size:
        raise ValueError(f"truncated aux file: {path}")
    return AuxMetadata(*_AUX_STRUCT.unpack(data))


def write_clusters(path: str, p_start: np.ndarray, lens: np.ndarray) -> None:
    rec = np.empty(len(p_start), dtype=DT_CLUSTER)
    rec["p_start"] = p_start
    rec["len"] = lens
    rec.tofile(path)


def read_clusters(path: str) -> Tuple[np.ndarray, np.ndarray]:
    rec = np.fromfile(path, dtype=DT_CLUSTER)
    return rec["p_start"].astype(np.int64), rec["len"].astype(np.int64)


def write_docs(fasta_path: str, num_seqs: int) -> None:
    with open(fasta_path + ".docs", "wb") as f:
        f.write(struct.pack("<Q", num_seqs))


def read_docs(fasta_path: str) -> int:
    with open(fasta_path + ".docs", "rb") as f:
        return struct.unpack("<Q", f.read(8))[0]
