"""The benchmark's index builder: a frozen copy of
``lime_tpu_torch/index/torch_builder.py`` (plain torch, prefix doubling on
the device), taking the collection as one byte array and its sequence
lengths instead of a list of sequences.  Imports nothing of the program.

- initial ranks: the terminator of sequence i has rank i and byte b the
  rank num_seqs + (distinct bytes of the collection below b);
- each doubling round sorts one int64 key, ``rank[i] * (n + 1) +
  rank[i + k] + 1`` (``+ 0`` past the end), exact while (n + 1)^2 < 2^63;
  the new dense rank is the cumsum of the sorted keys' change flags,
  scattered back through the order; one host sync per round tests
  convergence;
- the LCP array comes from the rank history (int32, one array per level)
  by the greedy power-of-two descent, from the top level down;
- eBWT (the byte before each suffix, ``$`` at terminators and before the
  collection's start) and DA (the sequence of each suffix) are gathers
  by the suffix array.

The output files are the ones the program reads: ``<fasta>.ebwt`` (u8),
``<fasta>.lcp`` (u32 LE) and ``<fasta>.da`` (u32 LE).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

TERMINATOR_BYTE = ord("$")

#: int32 ranks hold positions below this
MAX_POSITIONS = 1 << 31


def _initial_ranks(body: torch.Tensor, lens: np.ndarray):
    """(dense int32 ranks, text bytes with ``$`` at the terminators, the
    terminator positions) of the concatenated collection."""
    dev = body.device
    num_seqs = len(lens)
    n = int(lens.sum()) + num_seqs
    if n >= MAX_POSITIONS:
        raise ValueError(f"{n:,} positions: int32 ranks hold fewer than "
                         f"{MAX_POSITIONS:,}")
    ends = torch.from_numpy(np.cumsum(lens + 1) - 1).to(dev)
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
    history, which it empties; a block that would run past the end never
    matches, and its index is clamped to 0."""
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


def build_index(body: np.ndarray, lens: np.ndarray, device
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ebwt u8, lcp u32, da u32) of the merged collection whose
    sequences, without terminators, are ``body`` (ASCII bytes) cut at
    ``lens``; built on the torch ``device``."""
    dev = torch.device(device)
    lens = np.asarray(lens, np.int64)
    if len(lens) == 0:
        return (np.empty(0, np.uint8), np.empty(0, np.uint32),
                np.empty(0, np.uint32))
    body_d = torch.from_numpy(np.require(body, np.uint8, ["C", "W"])).to(dev)
    rank, text, ends = _initial_ranks(body_d, lens)
    del body_d
    n = rank.shape[0]
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
    del rank
    lcp = _lcp_descent(sa, history)
    ebwt = text[(sa - 1).clamp_(min=0)]
    ebwt.masked_fill_(sa == 0, TERMINATOR_BYTE)
    da = torch.searchsorted(ends, sa, out_int32=True)
    del sa, text
    return (ebwt.cpu().numpy(), lcp.cpu().numpy().view(np.uint32),
            da.cpu().numpy().view(np.uint32))
