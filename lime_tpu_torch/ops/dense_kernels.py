"""Dense-cluster kernel (CUDA, sm_90a) of the fused path.

``dense_pairs_into(plane, ridx, gidx, cmap, rid, ...)`` adds one chunk of
``host.pack_chunks`` into an int8 or int32 plane: for each read lane that
carries a read and each genome of its cluster, the score
``popc(phi_r & psi_g)`` of the planner's 32-bit indicator masks, where it
is nonzero (see the note at the top of ``csrc/dense_pairs.cu``).  It takes
the place, for CUDA planes, of the torch chain of
:func:`.dense_score._dense_rows` (feature scatters, a batched matmul over
the whole plane width, a row scatter-add), which stays the plain version
for CPU tensors; it replaces no Pallas kernel (``lime_tpu`` runs that
chain as XLA ops):

=========  =========================================  ====================
counter    CUDA kernel (csrc/dense_pairs.cu)           replaces
=========  =========================================  ====================
dense      ``dense_pairs_kernel<int8_t | int32_t>``    the torch chain
=========  =========================================  ====================

The kernel checks every index the torch chain would refuse and the order
of the triples it searches, and reports what it finds in a status the
caller makes (:func:`new_status`) beside its count of scored cells;
:func:`take` reads both (after a synchronisation the caller makes
anyway), resets them and raises on a fault.  There is no fallback: a
missing nvcc, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

#: launches of the kernel in this process (a plain integer)
LAUNCHES = {"dense": 0}


def reset_launches() -> None:
    LAUNCHES["dense"] = 0

_FAULTS = ((1, "a read triple past its buffer"),
           (2, "read triples out of order"),
           (4, "a genome triple past its buffer"),
           (8, "genome triples out of order"),
           (16, "an entry's cluster out of range"),
           (32, "a lane's read row outside the plane"))


_LIB_PATH = cuda_build.lib_path("dense_pairs")
_lock = threading.Lock()
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (when the source is newer than the library) and load the
    kernel.  Raises with nvcc's stderr on a failed build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        for log in cuda_build.compile_all(["dense_pairs"],
                                          verbose).values():
            if verbose and log:
                print(log, flush=True)
        lib = ctypes.CDLL(_LIB_PATH)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name in ("lime_dense_pairs_i8", "lime_dense_pairs_i32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, ll, vp, ll, vp, vp, i, i, i, i, i, vp, ll,
                           ll, ll, vp, vp]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def new_status(device: torch.device) -> torch.Tensor:
    """A status for chunks scored into planes on ``device``: int64
    ``(2,)``, the cells scored (the plain version adds its count there
    too) and the kernel's fault bits."""
    return torch.zeros(2, dtype=torch.int64, device=device)


def take(status: torch.Tensor) -> int:
    """The cells scored into ``status`` since it was made or last taken,
    which resets it; raises if a launch since then found a fault.  Reads
    the device: call it where the caller synchronises anyway."""
    cells, bits = status.tolist()
    status.zero_()
    if bits:
        raise RuntimeError("dense_pairs: " + "; ".join(
            what for bit, what in _FAULTS if bits & bit))
    return cells


def dense_pairs_into(plane: torch.Tensor, ridx: torch.Tensor,
                     gidx: torch.Tensor, cmap: torch.Tensor,
                     rid: torch.Tensor, b_blk: int, c_blk: int, pr: int,
                     f: int, g_pad: int, status: torch.Tensor,
                     row_base: int | None = None) -> None:
    """Add one dense chunk's scores into the CUDA ``plane`` (in place, on
    the current stream).

    ``plane``: contiguous int8 or int32 ``(rows, >= g_pad)``.  With
    ``row_base`` None every lane's ``rid`` must be a row of the plane;
    else the plane is the row block starting at read ``row_base`` and
    lanes outside it are dropped.  The chunk's arrays are contiguous int32
    on the plane's device, as :func:`host.pack_chunks` makes them.  The
    cells scored and the faults found add into ``status``
    (:func:`new_status` on the plane's device); they surface at its next
    :func:`take`.
    """
    arrays = (ridx, gidx, cmap, rid)
    if plane.device.type != "cuda":
        raise ValueError(f"dense_pairs_into needs a CUDA plane, got "
                         f"{plane.device}")
    if plane.dtype not in (torch.int8, torch.int32) or plane.dim() != 2:
        raise ValueError("plane must be a 2-D int8 or int32 tensor")
    if not plane.is_contiguous() or plane.shape[1] < g_pad:
        raise ValueError(f"plane must be contiguous with at least g_pad="
                         f"{g_pad} columns")
    if any(a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous()
           or a.device != plane.device for a in arrays):
        raise ValueError("ridx, gidx, cmap and rid must be contiguous 1-D "
                         "int32 tensors on the plane's device")
    if not (1 <= pr <= 32 and 1 <= f <= 32):
        raise ValueError(f"pr={pr} and f={f} must lie in [1, 32]")
    if cmap.shape[0] != b_blk or rid.shape[0] != b_blk * pr:
        raise ValueError(f"cmap needs {b_blk} entries and rid {b_blk * pr}")
    if plane.dtype == torch.int8 and (plane.data_ptr() % 4
                                      or plane.shape[1] % 4):
        raise ValueError("the int8 byte-wrap needs a 4-byte aligned plane "
                         "with a row length divisible by 4")
    if (status.dtype != torch.int64 or status.shape != (2,)
            or status.device != plane.device):
        raise ValueError("status must be new_status(plane.device)")
    if b_blk == 0 or plane.shape[0] == 0:
        return
    fn = (build().lime_dense_pairs_i8 if plane.dtype == torch.int8
          else build().lime_dense_pairs_i32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(plane.device)
                             .cuda_stream)
    with torch.cuda.device(plane.device):
        rc = fn(ridx.data_ptr(), ridx.shape[0], gidx.data_ptr(),
                gidx.shape[0], cmap.data_ptr(), rid.data_ptr(), b_blk,
                c_blk, pr, f, g_pad, plane.data_ptr(), plane.shape[0],
                plane.shape[1], -1 if row_base is None else row_base,
                status.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dense_pairs launch failed: CUDA error {rc}")
    LAUNCHES["dense"] += 1
