"""Greedy CTC decoding and edit distance (the cv_eval metric).

The port's copy of the numpy-only part of ``lstm_ctc_tpu/ops/decode.py``
(lines 23-76): the reference's in-graph evaluation (nnet/graph.py:138-150),
``ctc_greedy_decoder(merge_repeated=True)`` followed by an *unnormalized*
``edit_distance`` summed over the batch, run on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def collapse_ctc(path: Sequence[int], blank_id: int) -> List[int]:
    """Merge repeats then drop blanks (merge_repeated=True semantics)."""
    out: List[int] = []
    prev = None
    for p in path:
        if p != prev:
            if p != blank_id:
                out.append(int(p))
            prev = p
    return out


def greedy_decode(logits: np.ndarray,
                  sequence_length: np.ndarray,
                  blank_id: Optional[int] = None) -> List[List[int]]:
    """logits [B, T, V] → list of label sequences."""
    logits = np.asarray(logits)
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    best = np.argmax(logits, axis=-1)                # [B, T]
    return [collapse_ctc(best[b, :int(sequence_length[b])], blank_id)
            for b in range(logits.shape[0])]


def edit_distance(hyp: Sequence[int], ref: Sequence[int]) -> int:
    """Levenshtein distance with unit costs."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = np.arange(len(ref) + 1, dtype=np.int64)
    ref_arr = np.asarray(ref)
    for i, h in enumerate(hyp, start=1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (ref_arr != h)
        for j in range(1, len(ref) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def edit_distance_batch(hyps: Sequence[Sequence[int]],
                        refs: Sequence[Sequence[int]]) -> int:
    """Summed, unnormalized distances (reference graph.py:143-150)."""
    if len(hyps) != len(refs):
        raise ValueError("hyps/refs length mismatch: %d vs %d"
                         % (len(hyps), len(refs)))
    return sum(edit_distance(h, r) for h, r in zip(hyps, refs))


def dense_targets_to_lists(targets: np.ndarray) -> List[List[int]]:
    """[B, U] padded with -1 → list of label lists."""
    return [[int(v) for v in row if v >= 0] for row in np.asarray(targets)]
