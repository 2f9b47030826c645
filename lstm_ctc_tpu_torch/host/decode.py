"""Greedy and beam CTC decoding, and edit distance (the cv_eval metric).

The port's copy of the numpy-only ``lstm_ctc_tpu/ops/decode.py``: the
reference's in-graph evaluation (nnet/graph.py:138-150),
``ctc_greedy_decoder(merge_repeated=True)`` followed by an *unnormalized*
``edit_distance`` summed over the batch, run on the host; and the prefix
beam search of ``nnet_decode`` (:79-151).
"""

from __future__ import annotations

import math
from collections import defaultdict
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


def beam_search_decode(log_probs: np.ndarray,
                       beam_width: int = 10,
                       blank_id: Optional[int] = None,
                       top_paths: int = 1) -> List[List[int]]:
    """CTC prefix beam search over one utterance's [T, V] log-posteriors.

    Returns up to ``top_paths`` label sequences, most probable first.
    Dispatches to the native C++ implementation (``libctc_beam.so`` of the
    port's native build, ``host/beam_native.py``) unless
    ``LSTM_CTC_TPU_NATIVE_BEAM=0``; ``beam_search_decode_py`` is the
    semantic specification."""
    from .beam_native import available, beam_search_decode_native
    if available():
        return beam_search_decode_native(
            log_probs, beam_width=beam_width, blank_id=blank_id,
            top_paths=top_paths)
    return beam_search_decode_py(
        log_probs, beam_width=beam_width, blank_id=blank_id,
        top_paths=top_paths)


def beam_search_decode_py(log_probs: np.ndarray,
                          beam_width: int = 10,
                          blank_id: Optional[int] = None,
                          top_paths: int = 1) -> List[List[int]]:
    """Pure-Python prefix beam search (the specification)."""
    log_probs = np.asarray(log_probs)
    num_classes = log_probs.shape[1]
    if blank_id is None:
        blank_id = num_classes - 1

    NEG = -math.inf

    def logadd(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + math.log1p(math.exp(min(a, b) - m))

    # beams: prefix tuple -> (log p ending in blank, log p ending in label)
    beams = {(): (0.0, NEG)}
    for t in range(log_probs.shape[0]):
        lp = log_probs[t]
        # keep only the most probable classes for speed
        topk = np.argsort(lp)[-max(beam_width * 2, 8):]
        new_beams: dict = defaultdict(lambda: (NEG, NEG))
        for prefix, (p_b, p_nb) in beams.items():
            p_tot = logadd(p_b, p_nb)
            for c in topk:
                c = int(c)
                c_lp = float(lp[c])
                if c == blank_id:
                    nb_b, nb_nb = new_beams[prefix]
                    new_beams[prefix] = (logadd(nb_b, p_tot + c_lp), nb_nb)
                elif prefix and c == prefix[-1]:
                    # repeat: extends the non-blank path of the same prefix…
                    nb_b, nb_nb = new_beams[prefix]
                    new_beams[prefix] = (nb_b, logadd(nb_nb, p_nb + c_lp))
                    # …or starts a new occurrence after a blank
                    ext = prefix + (c,)
                    eb_b, eb_nb = new_beams[ext]
                    new_beams[ext] = (eb_b, logadd(eb_nb, p_b + c_lp))
                else:
                    ext = prefix + (c,)
                    eb_b, eb_nb = new_beams[ext]
                    new_beams[ext] = (eb_b, logadd(eb_nb, p_tot + c_lp))
        scored = sorted(new_beams.items(),
                        key=lambda kv: -logadd(kv[1][0], kv[1][1]))
        beams = dict(scored[:beam_width])
    ranked = sorted(beams.items(), key=lambda kv: -logadd(kv[1][0], kv[1][1]))
    return [list(prefix) for prefix, _ in ranked[:top_paths]]
