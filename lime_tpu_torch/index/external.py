"""Beyond-RAM index construction: blockwise build + external merge (copy
of ``lime_tpu/index/external.py``, on the port's native library).

The reference builds collection indexes beyond RAM with external-memory
tools under a fixed budget (eGap ``--em -m 4096``, reference
Preprocessing.sh:159-196); the in-process builders are RAM-bound
(~40 B/position for the native SA-IS).  This module closes that gap
self-containedly:

1. documents are partitioned CONTIGUOUSLY into blocks whose in-RAM
   SA-IS build fits the memory budget (native.lime_build_index_block:
   ebwt/da/local-SA per block, no per-block LCP);
2. the block eBWTs merge on disk by Holt/McMillan-style interleave
   refinement (native.lime_merge_blocks): one stable LF bucket pass per
   prefix depth, terminator rows pinned to the fixed first region in
   block order.  Cross-block suffix ties resolve by block order —
   exactly the in-RAM builder's ascending terminator ranks — so the
   merged ebwt/da/sa are bit-identical to a whole-collection build.
   Pass count is bounded by the longest CROSS-BLOCK common prefix + 2,
   so the block cut should keep long near-identical documents (genome
   sets) within one block; read-only cross sections converge in
   ~read_len passes;
3. the merged LCP is one Kasai pass over (text, SA) read from disk
   (native.lime_kasai_files), with the builder's terminator semantics
   (extension never crosses a terminator).

Peak RAM: the block SA-IS phase (~40 B/position x block_positions) and
the merge (~2 B/merged row) stay under ``mem_budget``; the final Kasai
pass however materializes text+SA+rank+LCP = 13 B/position of the WHOLE
collection in RAM (its access pattern — random sa/rank/text probes —
does not stream, unlike eGap's fully external LCP).  The build FAILS
FAST with a MemoryError before any block work when that floor exceeds
the machine (see _check_kasai_floor), rather than OOMing after hours of
merging; ``max_lcp`` (--trlcp) does not lower it.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Sequence

import numpy as np

from .. import native

# SA-IS temporaries per position (i64 string + SA + recursion slack)
_SAIS_BYTES_PER_POS = 40
# Kasai pass: text u8 + sa u32 + rank u32 + lcp u32
_KASAI_BYTES_PER_POS = 13


def plan_blocks(seq_lens: Sequence[int], mem_budget: int) -> List[int]:
    """Contiguous document partition: block end indexes (exclusive).

    Each block's terminator-augmented position count fits the SA-IS
    budget.  Runs of LONG documents (genome sets) are indivisible — a
    cut between near-identical genomes would blow the merge pass count
    up to their common-prefix length — so a long-document run beyond
    the budget is rejected with a clear message (the reference's eGap
    has the same single-phase memory floor).
    """
    cap_pos = max(1, (mem_budget // 2) // _SAIS_BYTES_PER_POS)
    # Long documents (genome sets) must stay within ONE block: the merge
    # pass count is bounded by the longest CROSS-BLOCK common prefix, so
    # a cut between two near-identical genomes would explode it.  Short
    # documents (reads) tie-break at their terminators within ~read_len
    # passes, so cuts between them are safe.
    long_thresh = 65536
    blocks: List[int] = []
    acc = 0
    i = 0
    n = len(seq_lens)
    while i < n:
        # group a maximal run of long documents as one indivisible unit
        j = i + 1
        if seq_lens[i] + 1 > long_thresh:
            while j < n and seq_lens[j] + 1 > long_thresh:
                j += 1
        unit = sum(int(seq_lens[k]) + 1 for k in range(i, j))
        if unit > cap_pos:
            raise MemoryError(
                f"documents [{i}, {j}) need {unit * _SAIS_BYTES_PER_POS / 1e9:.1f}"
                " GB to index as one block (long documents cannot be "
                "split across blocks without exploding the merge pass "
                "count); raise mem_budget")
        if acc and acc + unit > cap_pos:
            blocks.append(i)
            acc = 0
        acc += unit
        i = j
    blocks.append(n)
    if len(blocks) > 250:
        raise MemoryError(
            f"mem_budget would need {len(blocks)} blocks; the merge "
            "supports at most 250 — raise mem_budget to at least "
            f"{sum(int(l) + 1 for l in seq_lens) // 250 * 2 * _SAIS_BYTES_PER_POS} bytes")
    return blocks


def build_index_files_external(fasta_path: str, seqs: Sequence[bytes],
                               mem_budget: int = 4 << 30,
                               workdir: str | None = None,
                               max_passes: int = 4096,
                               max_lcp: int | None = None) -> int:
    """Write ``<fasta>.ebwt/.lcp/.da`` under a fixed memory budget.

    Bit-identical to :func:`lime_tpu_torch.index.builder.build_index_files`;
    returns the number of merge passes (1 when the whole collection fit
    one block).
    """
    if not native.available():
        raise RuntimeError("external build requires the native runtime")
    lib = native._load()
    lens = [len(s) for s in seqs]
    _check_kasai_floor(sum(lens) + len(lens))
    # the merge's bucket layout pins the '$' (0x24) terminator region;
    # any sequence byte below it (digits, control chars, stray
    # whitespace from unvalidated input) would silently clobber that
    # region and corrupt the merged index — reject it up front (the
    # in-RAM builder orders terminators below all symbols by
    # construction, so the two paths would otherwise diverge)
    for i, s in enumerate(seqs):
        if len(s):
            lo = int(np.frombuffer(s, np.uint8).min())
            if lo <= 0x24:
                raise ValueError(
                    f"sequence {i} contains byte 0x{lo:02x} <= '$' "
                    "(0x24): not a nucleotide/IUPAC code — clean the "
                    "input (the external merge reserves the low byte "
                    "range for terminators)")
    ends = plan_blocks(lens, mem_budget)
    own_tmp = workdir is None
    if own_tmp:
        tmp = tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(fasta_path)))
        workdir = tmp.name
    prefix = os.path.join(workdir, "xb")

    # the Kasai text: documents with one 0 byte per terminator slot
    total = sum(lens) + len(lens)
    text_path = prefix + ".text"
    with open(text_path, "wb") as f:
        for s in seqs:
            f.write(s)
            f.write(b"\0")

    block_rows, doc_base, text_base, nseqs = [], [], [], []
    start = 0
    tbase = 0
    for bi, end in enumerate(ends):
        blk = seqs[start:end]
        blens = np.asarray([len(s) for s in blk], np.int64)
        rows = int((blens + 1).sum())
        concat = np.frombuffer(b"".join(blk), np.uint8)
        ebwt = np.empty(rows, np.uint8)
        da = np.empty(rows, np.uint32)
        sa = np.empty(rows, np.uint32)
        rc = lib.lime_build_index_block(
            concat.ctypes.data, blens.ctypes.data, len(blk),
            ebwt.ctypes.data, da.ctypes.data, sa.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"lime_build_index_block failed: {rc}")
        ebwt.tofile(f"{prefix}.blk{bi}.ebwt")
        da.tofile(f"{prefix}.blk{bi}.da")
        sa.tofile(f"{prefix}.blk{bi}.sa")
        block_rows.append(rows)
        doc_base.append(start)
        text_base.append(tbase)
        nseqs.append(len(blk))
        tbase += rows
        start = end
    assert tbase == total

    br = np.asarray(block_rows, np.int64)
    db = np.asarray(doc_base, np.int64)
    tb = np.asarray(text_base, np.int64)
    ns = np.asarray(nseqs, np.int64)
    passes = lib.lime_merge_blocks(
        prefix.encode(), len(ends), br.ctypes.data, db.ctypes.data,
        tb.ctypes.data, ns.ctypes.data, prefix.encode(), max_passes)
    if passes == -8:
        raise RuntimeError(
            "lime_merge_blocks did not converge within max_passes — two "
            "blocks share a common prefix longer than the pass budget "
            "(near-identical long documents split across blocks?); "
            "raise mem_budget so related documents share a block")
    if passes < 0:
        raise RuntimeError(f"lime_merge_blocks failed: {passes}")
    rc = lib.lime_kasai_files(text_path.encode(),
                              (prefix + ".sa").encode(),
                              (prefix + ".lcp").encode(), total)
    if rc != 0:
        raise RuntimeError(f"lime_kasai_files failed: {rc}")

    if max_lcp is not None:
        # the reference's --trlcp: stored LCPs cap at max_lcp (safe for
        # any alpha <= max_lcp, reference Preprocessing.sh:24-28)
        with open(prefix + ".lcp", "r+b") as f:
            while True:
                pos = f.tell()
                chunk = np.frombuffer(f.read(1 << 22), np.uint32)
                if not len(chunk):
                    break
                f.seek(pos)
                np.minimum(chunk, np.uint32(max_lcp)).tofile(f)

    for ext in (".ebwt", ".da", ".lcp"):
        try:
            os.replace(prefix + ext, fasta_path + ext)
        except OSError:
            # workdir on another filesystem (scratch SSD): copy+remove
            import shutil

            shutil.move(prefix + ext, fasta_path + ext)
    if own_tmp:
        tmp.cleanup()
    else:
        # caller-provided workdir: clean the block intermediates too
        for name in os.listdir(workdir):
            if name.startswith("xb."):
                try:
                    os.remove(os.path.join(workdir, name))
                except OSError:
                    pass
    return int(passes)


def _check_kasai_floor(total_positions: int) -> None:
    """Fail fast when the final Kasai pass cannot fit this machine.

    lime_kasai_files needs 13 B/position (text u8 + sa/rank/lcp u32) of
    the WHOLE collection in RAM; discovering that after hours of block
    builds and merge passes would waste the entire run.
    """
    need = _KASAI_BYTES_PER_POS * total_positions
    avail = None
    try:
        # MemAvailable counts reclaimable page cache; free pages alone
        # would spuriously abort builds on machines whose RAM sits in
        # cache from prior index IO
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                    break
    except OSError:  # pragma: no cover - non-Linux
        pass
    if avail is None:
        try:
            avail = (os.sysconf("SC_AVPHYS_PAGES")
                     * os.sysconf("SC_PAGE_SIZE"))
        except (ValueError, OSError):  # pragma: no cover
            return
    # RLIMIT_AS (the test harness's budget enforcement) caps us harder
    # than physical memory when set
    try:
        import resource

        cap = resource.getrlimit(resource.RLIMIT_AS)[0]
        if cap != resource.RLIM_INFINITY:
            avail = min(avail, cap)
    except Exception:  # pragma: no cover
        pass
    if need > avail:
        raise MemoryError(
            f"the final LCP (Kasai) pass needs {need / 1e9:.1f} GB "
            f"({_KASAI_BYTES_PER_POS} B/position x {total_positions:,} "
            f"positions) but only {avail / 1e9:.1f} GB is available — "
            "the blockwise builder bounds the SA/merge phases, not the "
            "LCP pass; use a machine with more RAM or split the "
            "collection")
