"""Pair-hit kernels (CUDA, sm_90a) and their plain PyTorch versions.

``pair_hits(codes, window, cap)`` scores one chunk of a packed pair
stream: per row, the number of genome rows in its copy with the same
(symbol, occurrence index).  It replaces the two Pallas TPU kernels of
``lime_tpu/ops/pallas_kernels.py`` on the serving path:

=========  =====================================  ============================
counter    CUDA kernel (csrc/pair_hits.cu)         replaces
=========  =====================================  ============================
scan16     ``pair_hits_scan_kernel<16>`` (K1)      ``_pair_kernel_scan``, cap 16
scan64     ``pair_hits_scan_kernel<64>`` (K1)      ``_pair_kernel_scan``, cap 64
band       ``pair_hits_band_kernel`` (K2)          ``_pair_kernel``, cap 255
=========  =====================================  ============================

A row moves about 5 bytes (1 B code in, 4 B count out), so the kernels
are bound by integer work and shared-memory latency, not by device
memory bandwidth; see the note at the top of the CUDA source.

A CUDA tensor launches the kernel on the current stream (the library is
built with nvcc at first use into ``build/lime_tpu_torch/``); a CPU
tensor takes :func:`pair_hits_plain`, the vectorised torch port of
``lime_tpu.ops.pair_score._pair_hits_core``.  There is no fallback: a
missing nvcc, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_build

#: rows per Pallas grid step; a chunk's length must be a multiple of it
PAIR_TILE = 16384
#: copy-length caps per planner bucket (BUCKET_CAP in the C++ planner)
BUCKET_CAPS = (16, 64, 255)
_KERNEL_FOR_CAP = {16: "scan16", 64: "scan64", 255: "band"}

#: launches per kernel since the last reset (plain integers)
LAUNCHES = {"scan16": 0, "scan64": 0, "band": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB_PATH = cuda_build.lib_path("pair_hits")

_lock = threading.Lock()
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (when the source is newer than the library) and load the
    pair-hit kernels.  Raises with nvcc's stderr on a failed build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        for log in cuda_build.compile_all(["pair_hits"], verbose).values():
            if verbose and log:
                print(log, flush=True)
        lib = ctypes.CDLL(_LIB_PATH)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for name in ("lime_pair_hits_scan16", "lime_pair_hits_scan64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, ll, vp, vp]
            fn.restype = ctypes.c_int
        lib.lime_pair_hits_band.argtypes = [vp, ll, ctypes.c_int, vp, vp]
        lib.lime_pair_hits_band.restype = ctypes.c_int
        _lib = lib
        return lib


def pair_hits(codes: torch.Tensor, window: int, cap: int) -> torch.Tensor:
    """Per-row genome-match counts of one pair-stream chunk.

    ``codes``: contiguous uint8 ``(n,)`` 5-bit row codes (bits 0-1 sym,
    2 m, 3 docrun, 4 side), ``n % PAIR_TILE == 0``.  ``window`` (<= 255)
    bounds the band walk of cap 255; ``cap`` is the chunk bucket's copy
    length bound and picks the kernel.  Returns int32 ``(n,)``, exact on
    read rows (genome rows are don't-care for the scan kernels).
    """
    if cap not in _KERNEL_FOR_CAP:
        raise ValueError(f"cap must be one of {BUCKET_CAPS}, got {cap}")
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError("codes must be a 1-D uint8 tensor")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n = codes.shape[0]
    if n % PAIR_TILE:
        raise ValueError(f"chunk length {n} is not a multiple of "
                         f"{PAIR_TILE}")
    window = int(window)
    if not 0 <= window <= 255:
        raise ValueError(f"window must be in [0, 255], got {window}")
    if codes.device.type == "cpu":
        return pair_hits_plain(codes, window, cap)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    out = torch.empty(n, dtype=torch.int32, device=codes.device)
    if n == 0:
        return out
    lib = build()
    name = _KERNEL_FOR_CAP[cap]
    stream = ctypes.c_void_p(torch.cuda.current_stream(codes.device)
                             .cuda_stream)
    with torch.cuda.device(codes.device):
        if name == "band":
            rc = lib.lime_pair_hits_band(codes.data_ptr(), n, window,
                                         out.data_ptr(), stream)
        else:
            rc = getattr(lib, f"lime_pair_hits_{name}")(
                codes.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pair_hits_{name} launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

_PAD_W = 256  # halo of the plain band loops; window <= 255


def _pair_hits_core(m: torch.Tensor, dr: torch.Tensor, gs: torch.Tensor,
                    sym: torch.Tensor, window: int) -> torch.Tensor:
    """Occurrence pass + match pass over decoded chain/side/symbol rows.

    Torch port of ``lime_tpu.ops.pair_score._pair_hits_core``: ``m``,
    ``dr``, ``gs`` bool, ``sym`` integer, all ``(L,)``; rows outside the
    stream never match (sym -1, no chain bits).  Returns int32 hits.
    """
    L = m.shape[-1]
    dev = m.device
    sym = sym.to(torch.int32)

    def pad2(x, fill):
        edge = torch.full((_PAD_W,), fill, dtype=x.dtype, device=dev)
        return torch.cat([edge, x, edge])

    def bwd(padded, o):
        return padded[_PAD_W - o:_PAD_W - o + L]

    def fwd(padded, o):
        return padded[_PAD_W + o:_PAD_W + o + L]

    pad_sym = pad2(sym, -1)
    pad_dr = pad2(dr, False)
    pad_m = pad2(m, False)
    pad_gs = pad2(gs, False)

    chain = dr.clone()
    occ = torch.zeros(L, dtype=torch.int32, device=dev)
    for o in range(1, window + 1):
        occ += chain & (sym == bwd(pad_sym, o))
        chain &= bwd(pad_dr, o)
    pad_occ = pad2(occ, -1)

    chain = m.clone()
    hits = torch.zeros(L, dtype=torch.int32, device=dev)
    for o in range(1, window + 1):
        hit_b = (chain & bwd(pad_gs, o) & (sym == bwd(pad_sym, o))
                 & (occ == bwd(pad_occ, o)))
        # same copy over (i, i+o] = the backward chain evaluated at i+o
        chain_f = fwd(pad2(chain, False), o)
        hit_f = (chain_f & fwd(pad_gs, o) & (sym == fwd(pad_sym, o))
                 & (occ == fwd(pad_occ, o)))
        hits += hit_b
        hits += hit_f
        chain &= bwd(pad_m, o)
    return hits


def decode_codes(codes: torch.Tensor):
    """5-bit row codes -> (m, dr, gs) bool and sym int32."""
    c = codes.to(torch.int32)
    return (((c >> 2) & 1).bool(), ((c >> 3) & 1).bool(),
            ((c >> 4) & 1).bool(), c & 3)


def pair_hits_plain(codes: torch.Tensor, window: int,
                    cap: int = 255) -> torch.Tensor:
    """Plain torch version of :func:`pair_hits` (every cap): the band
    formulation over ``window`` offsets, exact on every row."""
    m, dr, gs, sym = decode_codes(codes)
    return _pair_hits_core(m, dr, gs, sym, int(window))


def planner_shaped_stream(rng, n, cap):
    """Synthesize codes with the packed planner's structural invariants:
    each copy = read rows (1+ docruns) then ONE genome docrun (gs=1);
    copy length <= cap; a copy's first row is read-side with m=0.

    Copy of ``lime_tpu.ops.pallas_kernels.planner_shaped_stream`` (same
    draws from ``rng``, same stream): the kernels' test and timing input.
    """
    codes = np.zeros(n, np.uint8)
    i = 0
    while i < n:
        n_read = int(rng.integers(1, max(2, cap // 2)))
        n_gen = int(rng.integers(1, cap - n_read + 1)) if cap > n_read \
            else 1
        copy = []
        for j in range(n_read):
            sym = int(rng.integers(0, 4))
            dr = 0 if (j == 0 or rng.random() < 0.3) else 1
            copy.append(sym | (dr << 3))
        for j in range(n_gen):
            sym = int(rng.integers(0, 4))
            dr = 0 if j == 0 else 1
            copy.append(sym | (dr << 3) | (1 << 4))
        for j, c in enumerate(copy[:n - i]):
            codes[i + j] = c | ((1 << 2) if j else 0)  # m bit
        i += len(copy)
    return codes
