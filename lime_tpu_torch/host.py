"""Framework-free host helpers of the fused serving path.

Each function here is a copy of a numpy-only helper whose original lives
in a ``lime_tpu`` module that imports jax at the top.  ``lime_tpu`` is
the reference and stays unchanged, so the port keeps these copies and
``tests/test_torch_fused.py`` pins each one equal to its original:

- ``_DEGENERATE_BYTE``                       lime_tpu/ops/fused_pass.py
- ``classify_block_size`` / ``pad_rows_for`` lime_tpu/ops/classify_tpu.py
- ``_g_pad_for`` / ``_r_pad_for`` / ``_classify_block_for``,
  ``_score_small_dense`` / ``_rescue_sparse`` / ``_rescue``
                                             lime_tpu/ops/fused_pipeline.py
- ``_gcol_padded`` / ``merge_coo_segments`` / ``_pack24``
                                             lime_tpu/ops/pair_score.py
- ``pack_chunks`` and its constants          lime_tpu/ops/dense_score.py
- ``_BLOCK`` / ``_bad_cluster_mask``          lime_tpu/ops/fused_pass.py
- ``_M_BIT`` / ``_dense_threshold_for`` / ``_dense_min_for``
                                             lime_tpu/ops/fused_pipeline.py
- ``pack_stream`` and its bit positions      lime_tpu/ops/pallas_kernels.py

``tests/test_torch_staged.py`` pins the last three rows.  Also here:
:func:`ensure_native`, which loads ``lime_tpu.native`` safely when many
processes start at once.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from typing import Tuple

import numpy as np

from lime_tpu import native
from lime_tpu.config import LimeConfig
from lime_tpu.constants import IUPAC_WATERFALL_PAIRS, SYMBOL_RANK_LUT
from lime_tpu.ops.scoring import _expand_positions, score_clusters

# bytes whose symbol rank is IUPAC-degenerate (4..14)
_DEGENERATE_BYTE = np.zeros(256, dtype=bool)
_DEGENERATE_BYTE[(SYMBOL_RANK_LUT >= 4) & (SYMBOL_RANK_LUT <= 14)] = True

_BLOCK = 1 << 20  # stream pad multiple of the staged and banded paths
_M_BIT = 6        # run-mask bit of the banded stream byte
PACK_M_BIT = 6
PACK_EMIT_BIT = 5


# ---------------------------------------------------------------------------
# The native library, loaded once per process even under concurrent starts
# ---------------------------------------------------------------------------

def _native_stamp() -> str:
    return native._LIB + ".ok"


def _native_fingerprint() -> str:
    st = os.stat(native._LIB)
    return f"{st.st_ino} {st.st_size} {st.st_mtime_ns}"


def _native_fresh() -> bool:
    """The library is complete (stamped by a lock holder) and current."""
    try:
        with open(_native_stamp()) as fh:
            stamped = fh.read() == _native_fingerprint()
    except OSError:
        return False
    return stamped and (os.path.getmtime(native._LIB)
                        >= os.path.getmtime(native._SRC))


def ensure_native():
    """Load ``lime_tpu.native``, building it if needed; raise if it cannot.

    ``lime_tpu.native._load`` compiles straight onto the library's final
    path without a lock and, if ``ctypes.CDLL`` then fails (say on a
    file another process is still writing), marks the library failed for
    the rest of the process.  Under an ``fcntl`` lock on
    ``build/native/``, this loads a library that a holder of the same
    lock finished (its fingerprint is stamped beside it); otherwise it
    compiles with ``_load``'s own command into a pid-suffixed temp file,
    renames it onto the library and stamps it.  Then it clears the
    failure and loads again.
    """
    if native._lib is not None:
        return native._lib
    os.makedirs(native._LIB_DIR, exist_ok=True)
    with open(os.path.join(native._LIB_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(3):
            if native._lib is not None:
                break
            if not _native_fresh():
                tmp = f"{native._LIB}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                     "-fPIC", "-std=c++17", native._SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, native._LIB)
                with open(_native_stamp(), "w") as fh:
                    fh.write(_native_fingerprint())
            native._failed = False
            native._load()
            if native._lib is None and os.path.exists(_native_stamp()):
                os.remove(_native_stamp())  # rebuild on the next round
    if native._lib is None:
        raise RuntimeError(f"native library {native._LIB} cannot be "
                           "loaded: the port needs g++ to build it")
    return native._lib


# ---------------------------------------------------------------------------
# Shapes of the device planes
# ---------------------------------------------------------------------------

def classify_block_size(rows: int) -> int:
    """Read-block size for the blockwise cascade."""
    want = 1 << 14
    if rows >= want:
        return want
    b = 256
    while b < rows:
        b <<= 1
    return b


def pad_rows_for(rows: int) -> int:
    block = classify_block_size(rows)
    return -(-rows // block) * block


def _g_pad_for(num_refs: int) -> int:
    return max(128, -(-num_refs // 128) * 128)


def _classify_block_for(num_reads: int) -> int:
    return classify_block_size(num_reads + 1)


def _r_pad_for(num_reads: int) -> int:
    return pad_rows_for(num_reads + 1)


# ---------------------------------------------------------------------------
# Packed pair streams and delta-COO chains
# ---------------------------------------------------------------------------

def _gcol_padded(gcol_all: np.ndarray, chunks) -> np.ndarray:
    """Pad the gcol buffer so every chunk's pow2-rounded device slice
    stays in bounds (entries past a chunk's own copies are never
    gathered — the copy-start cumsum cannot reach them)."""
    need = len(gcol_all)
    for _, _, _, _, _, go, gc in chunks:
        gcap = 4096
        while gcap < gc:
            gcap <<= 1
        need = max(need, go + gcap)
    if need > len(gcol_all):
        gcol_all = np.pad(gcol_all, (0, need - len(gcol_all)))
    return gcol_all


def merge_coo_segments(segs, max_drow: int = 255):
    """Concatenate native.coo_compact's per-thread segments into ONE
    delta chain.  Cross-segment gaps splice in bridge entries (row deltas
    capped at ``max_drow``, matching the compactor); returns
    ``(base_row, drow, col, val)`` or None if empty.
    """
    if not segs:
        return None
    parts_d, parts_c, parts_v = [], [], []
    base0 = segs[0][0]
    last = base0
    for base, drow, col, val in segs:
        seg_last = base + int(np.sum(drow.astype(np.int64)))
        first_abs = base + int(drow[0])
        gap = first_abs - last
        assert gap >= 0, "segments out of row order"
        n_bridge = 0
        while gap > max_drow:
            n_bridge += 1
            gap -= max_drow
        if n_bridge:
            parts_d.append(np.full(n_bridge, max_drow, np.uint8))
            parts_c.append(np.zeros(n_bridge, col.dtype))
            parts_v.append(np.zeros(n_bridge, val.dtype))
        drow = drow.copy()
        drow[0] = gap
        parts_d.append(drow)
        parts_c.append(col)
        parts_v.append(val)
        last = seg_last
    return (base0, np.concatenate(parts_d), np.concatenate(parts_c),
            np.concatenate(parts_v))


def _pack24(chain):
    """coo24 packing: one u8 buffer of three pow2-padded planes
    [drow4|colhi4][col_lo][val]; returns (base_row, buf, size)."""
    base0, drow, col, val = chain
    n = len(drow)
    size = 1 << 16
    while size < n:
        size <<= 1
    col = col.astype(np.uint16)
    buf = np.zeros(3 * size, np.uint8)
    buf[:n] = (drow << 4) | (col >> 8).astype(np.uint8)
    buf[size:size + n] = (col & 255).astype(np.uint8)
    buf[2 * size:2 * size + n] = val
    return base0, buf, size


# ---------------------------------------------------------------------------
# Dense (genome-dense cluster) chunk packing
# ---------------------------------------------------------------------------

K = 8        # occurrence-depth cap per (document, symbol)
PR = 8       # read lanes per matmul entry
MAX_ENT = 2048  # entries per cluster (=> up to 16384 distinct reads)

B_BLK = 2048      # entries per device dispatch
C_BLK = 1024      # clusters per device dispatch
RT_CAP = 1 << 19  # read triples per dispatch
GT_CAP = 1 << 19  # genome triples per dispatch


def _pad_p2(n: int, lo: int = 1 << 15) -> int:
    """Next power of two >= n (>= lo)."""
    k = lo
    while k < n:
        k <<= 1
    return k


def pack_chunks(starts: np.ndarray, lens: np.ndarray, da: np.ndarray,
                ebwt, num_reads: int, num_genomes: int, g_pad: int):
    """Plan dense clusters and pack them into fixed-shape chunks.

    Returns ``(chunks, left_starts, left_lens)``: a list of
    ``(ridx, gidx, cmap, rid)`` numpy tuples — each a complete, statically
    shaped dispatch — plus the clusters the identity could not express.
    Triple pads carry the index one past the feature buffer
    (``B_BLK*PR*f`` / ``C_BLK*g_pad*f``); pad entries' rows are the
    ``num_reads`` drop row.
    """
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    if len(starts) == 0:
        return [], starts, lens
    (rid, cmap, rb, rpf, gcl, ggf, ent_off, rt_off, gt_off,
     valid) = native.plan_dense(
        starts, lens, da, ebwt, num_reads, num_reads + num_genomes,
        SYMBOL_RANK_LUT, K=K, PR=PR, max_ent=MAX_ENT)
    nsym = 4 if ebwt is not None else 1
    f = nsym * K
    n = len(starts)
    rid_flat = rid.reshape(-1)
    chunks = []
    c0 = 0
    while c0 < n:
        c1 = int(min(
            np.searchsorted(ent_off, ent_off[c0] + B_BLK, side="right") - 1,
            np.searchsorted(rt_off, rt_off[c0] + RT_CAP, side="right") - 1,
            np.searchsorted(gt_off, gt_off[c0] + GT_CAP, side="right") - 1,
            c0 + C_BLK, n))
        if c1 <= c0:  # single cluster exceeds a cap — planner bounds forbid
            raise AssertionError("dense cluster exceeds chunk caps")
        e0, e1 = int(ent_off[c0]), int(ent_off[c1])
        r0, r1 = int(rt_off[c0]), int(rt_off[c1])
        g0, g1 = int(gt_off[c0]), int(gt_off[c1])
        if e1 == e0:
            c0 = c1
            continue
        ridx = np.full(_pad_p2(r1 - r0), B_BLK * PR * f, np.int32)
        ridx[:r1 - r0] = (rb[r0:r1] - e0) * (PR * f) + rpf[r0:r1]
        gidx = np.full(_pad_p2(g1 - g0), C_BLK * g_pad * f, np.int32)
        gidx[:g1 - g0] = (gcl[g0:g1] - c0) * (g_pad * f) + ggf[g0:g1]
        cmap_c = np.zeros(B_BLK, np.int32)
        cmap_c[:e1 - e0] = cmap[e0:e1] - c0
        rid_c = np.full(B_BLK * PR, num_reads, np.int32)
        rid_c[:(e1 - e0) * PR] = rid_flat[e0 * PR:e1 * PR]
        chunks.append((ridx, gidx, cmap_c, rid_c))
        c0 = c1
    bad = ~valid
    return chunks, starts[bad], lens[bad]


# ---------------------------------------------------------------------------
# Host rescue: exact scores for clusters no device path can express
# ---------------------------------------------------------------------------

# COO stays cheaper than a dense (R, G) upload while the rescued clusters
# cover few positions; past this, the native scorer fills a full matrix.
_COO_POSITION_CAP = 1 << 20


def _score_small_dense(starts, lens, da, ebwt, n_r, n_g,
                       config: LimeConfig) -> np.ndarray:
    """Exact scores for a (small, remapped) cluster set — native or numpy."""
    if native.available():
        return native.score_clusters_native(
            starts, lens, da, ebwt, n_r, n_g, SYMBOL_RANK_LUT,
            _DEGENERATE_BYTE, IUPAC_WATERFALL_PAIRS,
            wide=config.wide_sim,
            threads=0 if ebwt is None or len(starts) > 64 else 1)
    return score_clusters(starts, lens, da, ebwt, n_r, n_g,
                          config.replace(wide_sim=True))


def _rescue_sparse(bad_start, bad_len, da, ebwt, num_reads: int,
                   num_genomes: int, config: LimeConfig):
    """Exact host scores for rescued clusters, as COO (rows, cols, vals).

    The exact scorer runs on a remapped compact collection (unique
    documents only) and the nonzeros map back to global (read, genome)
    coordinates — no (R, G) buffer.
    """
    cid, gpos = _expand_positions(np.asarray(bad_start, np.int64),
                                  np.asarray(bad_len, np.int64))
    docs = np.asarray(da[gpos]).astype(np.int64)
    uniq, inv = np.unique(docs, return_inverse=True)
    n_r = int((uniq < num_reads).sum())
    # documents keep their relative order, so remapped ids preserve the
    # read-block-then-genome-block convention the scorer relies on
    da_small = inv.astype(np.uint32)
    eb_small = None if ebwt is None else np.asarray(ebwt[gpos])
    offs = np.concatenate([[0], np.cumsum(np.asarray(bad_len, np.int64))])
    dense = _score_small_dense(offs[:-1], np.asarray(bad_len, np.int64),
                               da_small, eb_small, n_r, len(uniq) - n_r,
                               config)
    r_i, g_i = np.nonzero(dense)
    rows = uniq[r_i].astype(np.int32)
    cols = (uniq[n_r + g_i] - num_reads).astype(np.int32)
    vals = dense[r_i, g_i].astype(np.int64)
    if config.sim_modulus:
        vals = vals % config.sim_modulus
    return rows, cols, vals.astype(np.int32)


def _rescue(bad_start, bad_len, da, ebwt, num_reads: int, num_genomes: int,
            config: LimeConfig):
    """Host-side exact scoring of routed clusters.

    Returns ``("coo", rows, cols, vals)`` for small rescue sets or
    ``("dense", matrix)`` (u8 with wrap / u32 wide) when the rescue set
    covers many positions.
    """
    total = int(np.asarray(bad_len, np.int64).sum())
    if (total <= _COO_POSITION_CAP and total < num_reads * num_genomes // 16
            ) or not native.available():
        return ("coo", *_rescue_sparse(bad_start, bad_len, da, ebwt,
                                       num_reads, num_genomes, config))
    mat = native.score_clusters_native(
        np.asarray(bad_start, np.int64), np.asarray(bad_len, np.int64),
        np.asarray(da), None if ebwt is None else np.asarray(ebwt),
        num_reads, num_genomes, SYMBOL_RANK_LUT, _DEGENERATE_BYTE,
        IUPAC_WATERFALL_PAIRS, wide=config.wide_sim, threads=0)
    return ("dense", mat)


# ---------------------------------------------------------------------------
# The banded engine: stream bytes, routing thresholds, host-routed clusters
# ---------------------------------------------------------------------------

def pack_stream(m, emit, sym):
    """Pack (m, emit, sym-rank) into the kernel's one-byte position code."""
    return (np.asarray(sym).astype(np.uint8)
            | (np.asarray(m).astype(np.uint8) << PACK_M_BIT)
            | (np.asarray(emit).astype(np.uint8) << PACK_EMIT_BIT))


def _bad_cluster_mask(p_start: np.ndarray, lens: np.ndarray,
                      ebwt: np.ndarray | None, window: int,
                      use_ebwt: bool, n: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(per-position emit gate, indices of host-rescored clusters)."""
    bad = lens > window
    if use_ebwt and ebwt is not None:
        deg_pos = np.flatnonzero(_DEGENERATE_BYTE[np.asarray(ebwt)])
        if len(deg_pos):
            cid = np.searchsorted(p_start, deg_pos, side="right") - 1
            inside = (cid >= 0) & (deg_pos < p_start[cid] + lens[cid])
            bad[np.unique(cid[inside])] = True
    bad_idx = np.flatnonzero(bad)
    ok = np.ones(n, dtype=bool)
    for c in bad_idx:  # rare
        ok[p_start[c]:p_start[c] + lens[c]] = False
    return ok, bad_idx


def _dense_threshold_for(num_genomes: int, config: LimeConfig) -> int:
    """Genome-position threshold for banded-kernel routing (see
    LimeConfig.dense_threshold): past G_pad 256 every cluster below it
    goes to the host scorer."""
    if config.dense_threshold is not None:
        return config.dense_threshold
    return 0 if _g_pad_for(num_genomes) <= 256 else (1 << 62)


def _dense_min_for(num_genomes: int, config: LimeConfig) -> int:
    """Genome-position threshold for the dense histogram-matmul routing
    of the banded engine (0 disables it)."""
    if not native.available():
        return 0
    if config.mxu_dense_min is not None:
        return config.mxu_dense_min
    return 0 if _g_pad_for(num_genomes) <= 256 else 16
