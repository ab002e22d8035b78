"""egsa ``.gesa`` → flat ``.ebwt``/``.lcp``/``.da`` conversion (copy of
``lime_tpu/formats/gesa.py``).

The reference's EGSAtoBCR (src/EGSAtoBCR.cpp:72-91) streams 13-byte packed
records ``{u32 text, u32 suff, u32 lcp, u8 bwt}`` and splits them into the
three flat files.  This is the vectorized equivalent.
"""

from __future__ import annotations

import numpy as np

from ..constants import DT_DOC, DT_LCP, DT_SYMBOL

GESA_RECORD = np.dtype([
    ("text", "<u4"), ("suff", "<u4"), ("lcp", "<u4"), ("bwt", "u1"),
])


def convert_gesa(fasta_path: str, num_seqs: int,
                 chunk_records: int = 1 << 22) -> int:
    """Convert ``<fasta>.<numSeqs>.gesa`` into the three flat index files.

    Returns the number of records converted.
    """
    gesa_path = f"{fasta_path}.{num_seqs}.gesa"
    n = 0
    with open(gesa_path, "rb") as fin, \
            open(fasta_path + ".ebwt", "wb") as f_bwt, \
            open(fasta_path + ".lcp", "wb") as f_lcp, \
            open(fasta_path + ".da", "wb") as f_da:
        while True:
            buf = fin.read(chunk_records * GESA_RECORD.itemsize)
            if not buf:
                break
            usable = len(buf) - len(buf) % GESA_RECORD.itemsize
            recs = np.frombuffer(buf[:usable], dtype=GESA_RECORD)
            recs["bwt"].astype(DT_SYMBOL).tofile(f_bwt)
            recs["lcp"].astype(DT_LCP).tofile(f_lcp)
            recs["text"].astype(DT_DOC).tofile(f_da)
            n += len(recs)
    return n
