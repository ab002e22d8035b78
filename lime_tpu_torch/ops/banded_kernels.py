"""Banded pair kernel K3 (CUDA, sm_90a) and its plain PyTorch version.

``banded_sim_into(sim, packed, doc, window, num_reads)`` adds one
position stream's banded pair counts into a ``(rows, G_pad)``
accumulator: for every emitting read position, +1 at (its read id, the
genome of each partner in its cluster band with the same symbol and
occurrence index).  It replaces the Pallas TPU kernel
``lime_tpu/ops/pallas_kernels.py:_kernel`` (via ``banded_pair_matrix``)
together with the segment-sum its caller runs on the kernel's
``V (n, G_pad)`` output (``lime_tpu/parallel/sharded._scatter_sim``):

=========  ===========================================  ===================
counter    CUDA kernel (csrc/banded_pairs.cu)            replaces
=========  ===========================================  ===================
banded     ``banded_sim_kernel<int8_t | int32_t>`` (K3)  ``_kernel``
=========  ===========================================  ===================

The kernel never materialises V: the segment-sum is fused as atomic adds.
It scores each cluster run once (see the note at the top of the CUDA
source): in a run no longer than ``window + 1`` the band covers the
whole run, so an emitting read position of symbol s and occurrence rank
k meets exactly the run's genome positions of symbol s and rank k; a
block of ``TILE`` positions owns the runs that start in it, and longer
runs keep the band walk.  int8 accumulators wrap mod 256, the
reference's uchar counters; int32 ones do not.

A CUDA tensor launches the kernel on the current stream (the library is
built with nvcc at first use into ``build/lime_tpu_torch/``); a CPU
tensor takes :func:`banded_sim_plain`, the torch port of the XLA
formulation (``sharded.banded_partial_sim`` with ``impl="xla"``), which
materialises V in position blocks.  There is no fallback: a missing
nvcc, a failed build or a refused launch raises.

Stream byte (``pack_stream``): bit 6 m (the position continues the
previous one's cluster), bit 5 emit gate, bits 0-3 symbol rank.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..host import PACK_EMIT_BIT, PACK_M_BIT
from . import cuda_build

#: largest band window; clusters longer than this go to the host scorer
W_MAX = 255
#: positions whose runs one block of the CUDA kernel owns (kTile in
#: csrc/banded_pairs.cu: 2,048 in shared memory less a 256-position halo)
TILE = 1792
#: context a position block of the plain version needs: two windows left
#: (a backward partner's own occurrence index), one right
HALO_L, HALO_R = 512, 256
#: positions per plain-version block: V (block, G_pad) int16 near 1 GB
V_BLOCK_BYTES = 1 << 30

#: launches of the kernel since the last reset (a plain integer)
LAUNCHES = {"banded": 0}


def reset_launches() -> None:
    LAUNCHES["banded"] = 0


_LIB_PATH = cuda_build.lib_path("banded_pairs")
_lock = threading.Lock()
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (when the source is newer than the library) and load K3.
    Raises with nvcc's stderr on a failed build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        for log in cuda_build.compile_all(["banded_pairs"],
                                          verbose).values():
            if verbose and log:
                print(log, flush=True)
        _lib = bind(_LIB_PATH)
        return _lib


def bind(path: str) -> ctypes.CDLL:
    """Load a compiled K3 library (this checkout's or, for a comparison,
    another's: the C interface is the same) and declare its entry
    points."""
    lib = ctypes.CDLL(path)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("lime_banded_sim_i8", "lime_banded_sim_i32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, ll, i, i, i, vp, ll, vp]
        fn.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, sim: torch.Tensor, packed: torch.Tensor,
           doc: torch.Tensor, window: int, num_reads: int) -> None:
    """Launch ``lib``'s K3 on the current stream on inputs that
    :func:`banded_sim_into` has checked; raises if the launch is
    refused.  Counts nothing."""
    fn = (lib.lime_banded_sim_i8 if sim.dtype == torch.int8
          else lib.lime_banded_sim_i32)
    g_cols = sim.shape[1]
    stream = ctypes.c_void_p(torch.cuda.current_stream(packed.device)
                             .cuda_stream)
    with torch.cuda.device(packed.device):
        rc = fn(packed.data_ptr(), doc.data_ptr(), packed.shape[0], window,
                num_reads, g_cols, sim.data_ptr(), g_cols, stream)
    if rc != 0:
        raise RuntimeError(f"banded_sim launch failed: CUDA error {rc}")


def pack_positions(m: torch.Tensor, emit: torch.Tensor,
                   sym: torch.Tensor) -> torch.Tensor:
    """(m, emit, symbol rank) -> the kernel's one-byte position code
    (torch twin of ``host.pack_stream``)."""
    return (sym.to(torch.uint8) | (m.to(torch.uint8) << PACK_M_BIT)
            | (emit.to(torch.uint8) << PACK_EMIT_BIT))


def banded_sim_into(sim: torch.Tensor, packed: torch.Tensor,
                    doc: torch.Tensor, window: int,
                    num_reads: int) -> torch.Tensor:
    """Add the banded pair counts of one position stream into ``sim``.

    ``packed`` uint8 ``(n,)`` position codes, ``doc`` int32 ``(n,)``
    document ids, both contiguous and on ``sim``'s device; ``sim`` a
    contiguous int8 or int32 ``(rows, G_pad)`` accumulator with
    ``rows > num_reads`` (row ``num_reads`` is where non-emitting
    positions would scatter, and an emitting read row never reaches past
    it).  Partners whose genome column falls outside ``[0, G_pad)`` are
    not counted, as the one-hot compare of the TPU kernel counts none.
    Returns ``sim``.
    """
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError("packed must be a 1-D uint8 tensor")
    if doc.dtype != torch.int32 or doc.shape != packed.shape:
        raise ValueError("doc must be an int32 tensor shaped like packed")
    if sim.dtype not in (torch.int8, torch.int32) or sim.dim() != 2:
        raise ValueError("sim must be a 2-D int8 or int32 tensor")
    if not (packed.is_contiguous() and doc.is_contiguous()
            and sim.is_contiguous()):
        raise ValueError("packed, doc and sim must be contiguous")
    if not packed.device == doc.device == sim.device:
        raise ValueError("packed, doc and sim must share one device")
    if sim.shape[0] <= num_reads:
        raise ValueError(f"sim has {sim.shape[0]} rows: it needs more than "
                         f"num_reads={num_reads} (the drop row)")
    window = int(window)
    if not 0 <= window <= W_MAX:
        raise ValueError(f"window must be in [0, {W_MAX}], got {window}")
    if packed.device.type == "cpu":
        return banded_sim_plain(sim, packed, doc, window, num_reads)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if packed.shape[0] == 0 or window == 0:
        return sim
    if sim.data_ptr() % 4 or sim.shape[1] % 4:
        raise ValueError("the int8 byte-wrap needs a 4-byte aligned "
                         "accumulator with a row length divisible by 4")
    launch(build(), sim, packed, doc, window, num_reads)
    LAUNCHES["banded"] += 1
    return sim


# ---------------------------------------------------------------------------
# Plain version: the XLA formulation
# ---------------------------------------------------------------------------

_PAD_W = 256  # static pad of the band shifts; window <= 255


def banded_v_plain(m: torch.Tensor, doc: torch.Tensor, sym: torch.Tensor,
                   num_reads: int, g_cols: int,
                   window: int) -> torch.Tensor:
    """Per-position genome-match counts ``V (L, g_cols)`` int16.

    Torch port of the XLA formulation in
    ``lime_tpu.parallel.sharded.banded_partial_sim``: the occurrence pass
    and the pair pass over band offsets 1..window, positions outside the
    stream padded to match nothing.  V[i, g] counts the genome-``g``
    partners of position i with i's (symbol, occurrence index) in either
    direction; rows of non-read or non-emitting positions are the
    caller's to drop.  The one-hot compare of each offset is written as
    an accumulate of its nonzeros.
    """
    L = m.shape[0]
    dev = m.device
    m = m.bool()
    doc = doc.to(torch.int32)
    sym = sym.to(torch.int32)

    def pad2(x, fill):
        edge = torch.full((_PAD_W,), fill, dtype=x.dtype, device=dev)
        return torch.cat([edge, x, edge])

    def bwd(padded, o):
        return padded[_PAD_W - o:_PAD_W - o + L]

    def fwd(padded, o):
        return padded[_PAD_W + o:_PAD_W + o + L]

    pad_m = pad2(m, False)
    pad_doc = pad2(doc, -1)
    pad_sym = pad2(sym, -1)

    and_c = m.clone()
    occ = torch.zeros(L, dtype=torch.int32, device=dev)
    for o in range(1, window + 1):
        occ += and_c & (doc == bwd(pad_doc, o)) & (sym == bwd(pad_sym, o))
        and_c &= bwd(pad_m, o)
    pad_occ = pad2(occ, -1)

    v = torch.zeros((L, g_cols), dtype=torch.int16, device=dev)
    pos = torch.arange(L, device=dev)
    one = torch.ones((), dtype=torch.int16, device=dev)
    and_c = m.clone()
    for o in range(1, window + 1):
        db = bwd(pad_doc, o)
        hit_b = (and_c & (sym == bwd(pad_sym, o))
                 & (occ == bwd(pad_occ, o)) & (db >= num_reads))
        # same cluster over (i, i+o] = the backward AND at i+o
        and_f = fwd(pad2(and_c, False), o)
        df = fwd(pad_doc, o)
        hit_f = (and_f & (sym == fwd(pad_sym, o))
                 & (occ == fwd(pad_occ, o)) & (df >= num_reads))
        for hit, d in ((hit_b, db), (hit_f, df)):
            sel = hit & (d - num_reads < g_cols)
            idx = pos[sel]
            v.index_put_((idx, (d[sel] - num_reads).long()),
                         one.expand(idx.shape[0]), accumulate=True)
        and_c &= bwd(pad_m, o)
    return v


def scatter_sim(sim: torch.Tensor, v: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """Segment-sum V rows by read id into ``sim`` in place (torch port of
    ``sharded._scatter_sim``; its split into partial scatters is a TPU
    pipelining choice, and sums commute).  int8 adds wrap mod 256.  An
    index outside ``sim`` raises: nothing is dropped."""
    sim.index_add_(0, rows.to(torch.int64), v.to(sim.dtype))
    return sim


def banded_sim_plain(sim: torch.Tensor, packed: torch.Tensor,
                     doc: torch.Tensor, window: int, num_reads: int,
                     block: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`banded_sim_into` on any device.

    Walks the stream in blocks of ``block`` positions (default: V of
    about ``V_BLOCK_BYTES``) with ``HALO_L`` / ``HALO_R`` positions of
    real context on each side, so block boundaries never split a band
    (the role of ``_pallas_partial_sim``'s block loop); per block, V from
    :func:`banded_v_plain`, non-emitting rows zeroed and sent to the drop
    row ``num_reads``, then :func:`scatter_sim`.
    """
    L = packed.shape[0]
    g_cols = sim.shape[1]
    c = packed.to(torch.int32)
    m = ((c >> PACK_M_BIT) & 1).bool()
    emit = ((c >> PACK_EMIT_BIT) & 1).bool() & (doc >= 0) & (
        doc < num_reads)
    sym = c & 15
    if block is None:
        block = max(1 << 12, V_BLOCK_BYTES // (2 * g_cols) - HALO_L - HALO_R)
    for b0 in range(0, L, block):
        b1 = min(L, b0 + block)
        e0, e1 = max(0, b0 - HALO_L), min(L, b1 + HALO_R)
        v = banded_v_plain(m[e0:e1], doc[e0:e1], sym[e0:e1], num_reads,
                           g_cols, window)[b0 - e0:b1 - e0]
        em = emit[b0:b1]
        v[~em] = 0
        rows = torch.where(em, doc[b0:b1],
                           torch.full_like(doc[b0:b1], num_reads))
        scatter_sim(sim, v, rows)
    return sim
