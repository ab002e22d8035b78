"""On-device eBWT/LCP/DA construction with torch (port of
``lime_tpu/index/tpu_builder.py``).

The prefix-doubling builder of :mod:`.builder`, with every O(n log n)
sort and scan on a torch device (the GPU by default):

- initial ranks: the terminator of sequence i has rank i and byte b the
  rank num_seqs + (distinct bytes of the collection below b), the dense
  ranks ``np.unique`` gives the numpy builder;
- each doubling round sorts one int64 key, ``rank[i] * (n + 1) +
  rank[i + k] + 1`` (``+ 0`` past the end): the order of the pair
  (rank[i], rank[i + k] or -1) that ``lime_tpu`` lexsorts, exact while
  (n + 1)^2 < 2^63.  The new dense rank is the cumsum of the sorted keys'
  change flags, scattered back through the order (a permutation); one
  host sync per round tests convergence;
- the LCP array comes from the rank history (int32, one array per level)
  by the greedy power-of-two descent, from the top level down;
- eBWT and DA are gathers by the suffix array, on the device, before one
  download.

``lime_tpu``'s builder is plain jnp (no Pallas kernel), so torch ops are
its port.  Ranks are int32 as in ``lime_tpu``: a collection of 2^31
positions or more raises.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..constants import DT_DOC, DT_LCP, DT_SYMBOL
from ..device import resolve_device
from .builder import TERMINATOR_BYTE

#: Positions, doubling rounds and phase times (seconds, host clock, each
#: phase ending on a device sync) of the most recent build.  Read by
#: chip_smoke.py.
LAST_RUN: dict = {}

#: int32 ranks hold positions below this
MAX_POSITIONS = 1 << 31


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _initial_ranks(seqs: Sequence[bytes], dev: torch.device):
    """(dense int32 ranks, text bytes with ``$`` at the terminators, the
    terminator positions) of the concatenated collection, on ``dev``."""
    num_seqs = len(seqs)
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int64)
    n = int(lens.sum()) + num_seqs
    if n >= MAX_POSITIONS:
        raise ValueError(
            f"{n:,} positions: the device builder keeps int32 ranks (as "
            f"lime_tpu's), which hold fewer than {MAX_POSITIONS:,}; build "
            "this collection with the native or the external builder")
    body = torch.from_numpy(
        np.frombuffer(b"".join(seqs), np.uint8).copy()).to(dev)
    ends = (torch.cumsum(lens + 1, 0) - 1).to(dev)
    is_body = torch.ones(n, dtype=torch.bool, device=dev)
    is_body[ends] = False
    text = torch.full((n,), TERMINATOR_BYTE, dtype=torch.uint8, device=dev)
    text[is_body] = body
    lut = torch.zeros(256, dtype=torch.int32, device=dev)
    present = torch.unique(body).to(torch.int64)
    lut[present] = num_seqs + torch.arange(
        len(present), dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[is_body] = lut.index_select(0, body.to(torch.int32))
    rank[ends] = torch.arange(num_seqs, dtype=torch.int32, device=dev)
    return rank, text, ends


def _double_round(rank: torch.Tensor, k: int):
    """One doubling round: (new int32 rank, order, distinct ranks)."""
    n = rank.shape[0]
    key = rank.to(torch.int64)
    key *= n + 1
    m = max(n - k, 0)
    key[:m] += rank[k:] + 1
    sorted_key, order = torch.sort(key)
    del key
    changed = torch.empty(n, dtype=torch.bool, device=rank.device)
    changed[0] = True
    changed[1:] = sorted_key[1:] != sorted_key[:-1]
    del sorted_key
    dense = torch.cumsum(changed, 0, dtype=torch.int32)
    del changed
    distinct = int(dense[-1])  # the round's one host sync
    dense -= 1
    new_rank = torch.empty_like(rank)
    new_rank[order] = dense
    return new_rank, order, distinct


def _lcp_descent(sa: torch.Tensor, history: List[torch.Tensor]
                 ) -> torch.Tensor:
    """int32 LCP of adjacent suffixes by the greedy descent over the rank
    history, which it empties (each level is freed once used); a block
    that would run past the end never matches, and its index is clamped
    to 0 (torch raises where jnp clamps)."""
    n = sa.shape[0]
    lcp = torch.zeros(n, dtype=torch.int32, device=sa.device)
    if n < 2:
        history.clear()
        return lcp
    a, b, acc = sa[:-1].clone(), sa[1:].clone(), lcp[1:]
    while history:
        span = 1 << (len(history) - 1)
        rank_l = history.pop()
        ok = torch.maximum(a, b) <= n - span
        match = ok & (rank_l[torch.where(ok, a, 0)]
                      == rank_l[torch.where(ok, b, 0)])
        del ok
        step = match.to(torch.int32) * span
        del match
        a += step
        b += step
        acc += step
    return lcp


def build_index_torch(seqs: Sequence[bytes], device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ebwt, lcp, da) for the merged collection of ``seqs``, built on the
    torch ``device``; byte-identical to the numpy and native builders.  A
    CUDA device without a card raises."""
    dev = resolve_device(device)
    LAST_RUN.clear()
    if not seqs:
        return (np.empty(0, DT_SYMBOL), np.empty(0, DT_LCP),
                np.empty(0, DT_DOC))
    phases = {}
    t0 = time.perf_counter()
    rank, text, ends = _initial_ranks(seqs, dev)
    n = rank.shape[0]
    _sync(dev)
    phases["setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    history = [rank]
    k = 1
    while True:
        rank, order, distinct = _double_round(rank, k)
        history.append(rank)
        if distinct == n:
            break
        k *= 2
        if k > 2 * n:  # safety net; cannot trigger for valid inputs
            raise RuntimeError("prefix doubling failed to converge")
    sa = order
    phases["doubling"] = time.perf_counter() - t0

    rounds = len(history) - 1
    del rank
    t0 = time.perf_counter()
    lcp = _lcp_descent(sa, history)
    _sync(dev)
    phases["lcp"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # the suffix's preceding byte; '$' where it starts the collection (any
    # other sequence start is preceded by its predecessor's terminator)
    ebwt = text[(sa - 1).clamp_(min=0)]
    ebwt.masked_fill_(sa == 0, TERMINATOR_BYTE)
    da = torch.searchsorted(ends, sa, out_int32=True)
    del sa, text
    out = (ebwt.cpu().numpy().view(DT_SYMBOL),
           lcp.cpu().numpy().view(DT_LCP), da.cpu().numpy().view(DT_DOC))
    phases["extract"] = time.perf_counter() - t0
    LAST_RUN.update(positions=n, rounds=rounds, phases=phases)
    return out
