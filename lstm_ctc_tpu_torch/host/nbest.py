"""N-best hypothesis utilities for discriminative-style training.

Intended-behavior mirror of reference nnet/utils.py:28-140 (which is
exported but unused by the mainline recipes): combine beam-search n-best
lists with the reference transcripts into dense training targets plus
their edit distances (the ingredients of MBR/MWE-style objectives), and
expand label sequences into framewise CTC paths.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .decode import beam_search_decode, edit_distance


def nbest_from_logits(log_probs: np.ndarray,
                      sequence_length: np.ndarray,
                      num_paths: int = 4,
                      beam_width: int = 8) -> List[List[List[int]]]:
    """Per-utterance n-best label sequences from [B, T, V] log-posteriors."""
    out = []
    for b in range(log_probs.shape[0]):
        t_len = int(sequence_length[b])
        out.append(beam_search_decode(log_probs[b, :t_len],
                                      beam_width=beam_width,
                                      top_paths=num_paths))
    return out


def combine_label_nbest(nbest: Sequence[Sequence[Sequence[int]]],
                        references: Sequence[Sequence[int]],
                        pad_value: int = -1
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge references with their n-best hypotheses into dense arrays.

    Returns (labels [B, N+1, U] padded with ``pad_value``,
    lengths [B, N+1], distances [B, N+1] — edit distance of each row to
    the reference; row 0 is the reference itself, distance 0).
    """
    batch = len(references)
    num_paths = max((len(h) for h in nbest), default=0)
    rows = num_paths + 1
    max_u = 1
    for b in range(batch):
        max_u = max(max_u, len(references[b]),
                    *(len(h) for h in nbest[b]) if nbest[b] else (1,))
    labels = np.full((batch, rows, max_u), pad_value, np.int32)
    lengths = np.zeros((batch, rows), np.int32)
    distances = np.zeros((batch, rows), np.float32)
    for b in range(batch):
        ref = list(references[b])
        labels[b, 0, :len(ref)] = ref
        lengths[b, 0] = len(ref)
        for k, hyp in enumerate(nbest[b][:num_paths], start=1):
            labels[b, k, :len(hyp)] = hyp
            lengths[b, k] = len(hyp)
            distances[b, k] = edit_distance(hyp, ref)
    return labels, lengths, distances


def fill_blank_path(labels: Sequence[int], num_frames: int,
                    blank_id: int) -> List[int]:
    """Expand a label sequence into a valid framewise CTC path of exactly
    ``num_frames`` frames: labels spread evenly, blanks filling the gaps
    (reference nnet/utils.py:119-140 intent).  Raises if infeasible."""
    num_labels = len(labels)
    # CTC feasibility: a repeated label needs a separating blank, so the
    # minimal path length is U plus the number of adjacent repeats
    repeats = sum(1 for i in range(1, num_labels)
                  if labels[i] == labels[i - 1])
    if num_labels + repeats > num_frames:
        raise ValueError(
            "cannot fit %d labels (%d adjacent repeats) into %d frames"
            % (num_labels, repeats, num_frames))
    path = [blank_id] * num_frames
    if num_labels == 0:
        return path
    # minimal positions: gap 1 between distinct labels, 2 across repeats
    pos = []
    cur = 0
    for i, lab in enumerate(labels):
        if i > 0:
            cur += 2 if lab == labels[i - 1] else 1
        pos.append(cur)
    # spread the slack evenly (a non-decreasing offset preserves gaps)
    slack = (num_frames - 1) - pos[-1]
    for i, lab in enumerate(labels):
        path[pos[i] + slack * (i + 1) // (num_labels + 1)] = lab
    return path
